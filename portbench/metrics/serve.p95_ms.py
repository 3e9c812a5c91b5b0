"""The 95th percentile of a request's latency, from when it was due to when
its answer was back, in ms, over the traced run's requests that the
profiler left alone: none served while it records, or after its start or
stop before the backlog that left has cleared."""

import math


def read(ctx):
    v = ctx.counts.get("p95_ms")
    return None if v is None or math.isnan(v) else v
