"""The training step's share of the card's peak: the questions/s of the
traced slice times the least seconds a question's products take at the
peak of each one's dtype (forward and a backward of twice its products;
no recompute counted), in %."""

from portbench.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, ctx.counts.get("steps", 0) * ctx.counts.get("batch_size", 0), 3.0)
