"""Device milliseconds a training step spends outside the port's
hand-written kernels (Adam, the fp32 adds, the embedding backward, the
conv stem, the LSTM, f_phi): busy time per step of the traced slice minus
the time of every kernel of csrc/."""

from portbench.readers import HANDWRITTEN


def read(ctx):
    steps = ctx.counts.get("steps", 0)
    if ctx.slice is None or not steps:
        return None
    return 1e3 * (ctx.slice.busy_s() - ctx.slice.kernel_s(HANDWRITTEN)) / steps
