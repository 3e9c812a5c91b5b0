"""rnet_torch — the PyTorch/CUDA port of rnet (Relation Networks for CLEVR).

The package grows beside ``rnet/`` (the JAX reference) slice by slice. It
imports torch, numpy and the standard library only: nothing of JAX and
nothing of ``rnet``. Each module names its ``rnet`` counterpart by file.

Implemented so far: serving (``rnet_torch.serve``) and training
(``python -m rnet_torch.train``), with hand-written CUDA kernels for the
pairwise g_theta forward and backward (``rnet_torch/csrc/pairwise_fwd.cu``,
``pairwise_bwd.cu``, in-kernel Philox pair dropout) and the train-time
gather + rotate + crop augmentation (``rnet_torch/csrc/augment.cu``).

Entry points run on CUDA unless the caller asks for the CPU; they never fall
back to the CPU on their own.
"""

__version__ = "0.1.0"
