"""g_theta's device milliseconds a state-description training step, on the
plain ``xla`` route that 12 objects take: the device time of the traced
slice's kernels that compute in bf16, over the traced steps. In
``original-sd`` only g_theta runs in bf16 (the LSTM, f_phi and Adam run in
fp32), so these are its forward and backward: the cuBLAS bf16 GEMMs and
the elementwise kernels over the (B, n^2, H) bf16 pair activations (the
layer-0 sum and ReLU, the ReLU's backward, the bias gradients' sums, the
casts to and from bf16). Any hand-written pairwise kernel of csrc/ is
counted too, should the route change. ``is_g`` names the kernels counted."""

import re

from portbench.readers import HANDWRITTEN

# bf16 kernels by their names in an H100 trace of the cell (torch 2.11,
# CUDA 12.8): cuBLASLt's Hopper GEMMs "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT"
# (and _TNT, "nvjet_tst_128x128_64x6_2x1_v_bz_splitK_NTT"; the step's fp32
# GEMMs run as "sm80_xmma_gemm_f32f32_..." and "cutlass_80_simt_sgemm_..."),
# their "cublasLt::splitKreduce_kernel<..., __nv_bfloat16, ...>", CUTLASS's
# "cutlass_80_tensorop_bf16_s16816gemm_...", and PyTorch's elementwise and
# reduction kernels by their functor's element type ("c10::BFloat16",
# "bfloat16_copy_kernel_cuda").
BF16 = re.compile(r"bf16|bfloat16|BFloat16|nvjet")
CSRC = re.compile(r"\b(?:" + "|".join(re.escape(n) for n in HANDWRITTEN if n != "augment_kernel") + r")\b")


def is_g(name):
    return bool(BF16.search(name) or CSRC.search(name))


def read(ctx):
    steps = ctx.counts.get("steps", 0)
    if ctx.slice is None or not steps:
        return None
    return sum(b - a for n, a, b in ctx.slice.device if is_g(n)) / 1e3 / steps
