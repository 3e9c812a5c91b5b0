"""The int8 g_theta forward's share of its roofline
(csrc/pairwise_fwd_int8.cu): the least time of the L-1 layers' int8
products and the folded inputs' bytes at the int8 peak over the device
time of one call, its pooling of partial sums included (the calibration
and folding before it are PyTorch's, not counted)."""

from portbench import ops
from portbench.readers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, ["pairwise_fwd_int8_kernel", "pairwise_fwd_int8_pair"], ["pool_partials_kernel"],
                            ops.pairwise_fwd_int8_work, "int8")
