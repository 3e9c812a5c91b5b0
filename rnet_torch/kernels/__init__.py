"""Hand-written CUDA kernels of the port and their plain versions
(counterpart: ``rnet/kernels/``)."""
