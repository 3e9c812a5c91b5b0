"""rnet_torch — the PyTorch/CUDA port of rnet (Relation Networks for CLEVR).

The package grows beside ``rnet/`` (the JAX reference) slice by slice. It
imports torch, numpy and the standard library only: nothing of JAX and
nothing of ``rnet``. Each module names its ``rnet`` counterpart by file.

Implemented so far: the serving path (``rnet_torch.serve``), with the
pairwise g_theta forward in a hand-written CUDA kernel
(``rnet_torch/csrc/pairwise_fwd.cu``, replacing
``rnet/kernels/pairwise.py::_fwd_kernel``).

Entry points run on CUDA unless the caller asks for the CPU; they never fall
back to the CPU on their own.
"""

__version__ = "0.1.0"
