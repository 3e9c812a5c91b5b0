"""The g_theta backward's share of its roofline (csrc/pairwise_bwd.cu): the
least time of the chain's gradient products and bytes at the bf16 peak
over the device time of one call, its reductions and dW GEMM included."""

from portbench import ops
from portbench.readers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, ["pairwise_bwd_kernel"], ["reduce_partials_kernel", "reduce_dw_kernel",
                                                           "dw_gemm_kernel"], ops.pairwise_bwd_work, "bfloat16")
