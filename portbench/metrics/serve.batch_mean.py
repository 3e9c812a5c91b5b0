"""Requests per served micro-batch, the mean over the traced run's window
(the ``batch`` the server reports for each call of ``answer``)."""


def read(ctx):
    batches = [b for b in ctx.counts.get("batches", []) if b]
    return sum(batches) / len(batches) if batches else None
