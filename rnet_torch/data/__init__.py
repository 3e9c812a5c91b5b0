"""Data encoders of the port (counterpart: ``rnet/data/``)."""
