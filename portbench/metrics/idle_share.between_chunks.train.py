"""The device's idle share between the train loop's chunks: over the traced
slice's consecutive ``rn.graph.run`` spans (one dispatch of a chunk's
graph), the device ms from one span's exit event to the next one's entry
event, summed, over the slice's length, in %. That is the loop's own host
work between dispatches (the fetch of the previous chunk's metrics, its log
line, the next dispatch's Python) through which the device has nothing
queued; the graph's launch and the idle inside a replay are not in it."""

from portbench import spans


def read(ctx):
    runs = spans.named(ctx, "graph.run")
    gaps = [spans.device_gap_ms(a, b) for a, b in zip(runs, runs[1:])]
    if not gaps or None in gaps:
        return None
    return 100.0 * sum(gaps) / 1e3 / ctx.slice.window_s
