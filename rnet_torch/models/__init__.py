"""Model modules of the port (counterpart: ``rnet/models/``)."""

from .rn import RN  # noqa: F401
