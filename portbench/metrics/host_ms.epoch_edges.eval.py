"""Host ms at the edges of a traced eval epoch: its ``rn.eval.upload`` (the
index and valid arrays built and uploaded, before the first chunk is
dispatched) plus its ``rn.eval.accumulate`` (the ``EvalAccumulator`` update
and the log line, after the one fetch), the host work through which the
device has nothing queued; a mean over the traced epochs."""

from portbench import spans


def read(ctx):
    up, acc = spans.named(ctx, "eval.upload"), spans.named(ctx, "eval.accumulate")
    if not up or len(acc) != len(up):
        return None
    return sum(spans.host_ms(r) for r in up + acc) / len(up)
