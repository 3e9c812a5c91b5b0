"""The median host ms of one ``rn.graph.replay`` span over the traced train
slice: the ``CUDAGraph.replay()`` call that launches one chunk's graph of
``log_interval`` steps, under the profiler. The profiler's CUDA tracing
slows that launch: on an H100 a 10-step graph's launch took 1.3-2.0 ms
untraced and 150-290 ms traced, so this reads the traced launch, and the
device runs the graph's first kernels while the host is still in it."""

from portbench import spans
from portbench.readers import median


def read(ctx):
    return median([spans.host_ms(r) for r in spans.named(ctx, "graph.replay")])
