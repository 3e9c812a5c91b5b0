"""The bf16 g_theta forward's share of its roofline (csrc/pairwise_fwd.cu):
the least time of the L-1 layers' products and bytes at the bf16 peak over
the device time of one call, its pooling of partial sums included."""

from portbench import ops
from portbench.readers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, ["pairwise_fwd_kernel"], ["pool_partials_kernel"], ops.pairwise_fwd_work, "bfloat16")
