"""The state-description training step's share of the card's peak: the
questions/s of the traced slice times the least seconds a question's
products take at the peak of each one's dtype (``ops_sd.forward_products``:
the LSTM and f_phi in fp32, g_theta in the compute dtype; forward and a
backward of twice its products, no recompute counted), in %."""

from portbench import ops, ops_sd


def read(ctx):
    questions = ctx.counts.get("steps", 0) * ctx.counts.get("batch_size", 0)
    if ctx.slice is None or not questions:
        return None
    least = ops.seconds_at_peak(ops_sd.forward_products(ctx.widths, ctx.traffic["compute_dtype"]), 3.0)
    return 100.0 * questions / ctx.slice.window_s * least
