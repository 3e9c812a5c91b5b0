"""The median host milliseconds of one request's encode
(``InferenceServer.encode``: the PNG decoded and resized, the question
tokenised), over the traced run's window."""

from portbench.readers import median


def read(ctx):
    return median(ctx.counts.get("encode_ms", []))
