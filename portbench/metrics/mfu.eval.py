"""The evaluation forward's share of the card's peak: the valid questions/s
of the traced epoch times the least seconds a question's forward products
take at the peak of each one's dtype (int8 for the int8 chain), in %."""

from portbench.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, ctx.counts.get("questions", 0), 1.0)
