"""What the readers of the port's own spans share.

The port records a span (``rnet_torch.utils.profiling.span``) only while a
``torch.profiler`` records, so in a ``--trace 1`` run its records are those
of the traced slice; the readers run after the window, in the same
process. A port without the recorder, a run without a trace, or a slice in
which no span of a name ended, gives nothing to read: the readers return
None."""

from __future__ import annotations

from typing import List, Optional


def records(ctx) -> List:
    """The port's records (``profiling.Span``: ``name``, ``parent``,
    ``t0_ns``, ``t1_ns``, ``events``), or [] where there are none to read."""
    if ctx.slice is None:
        return []
    try:
        from rnet_torch.utils import profiling
    except ImportError:
        return []
    get = getattr(profiling, "records", None)
    return list(get()) if get is not None else []


def named(ctx, name: str) -> List:
    """The records of span ``name`` (without ``rn.``), by host start."""
    return sorted((r for r in records(ctx) if r.name == name), key=lambda r: r.t0_ns)


def host_ms(record) -> float:
    return (record.t1_ns - record.t0_ns) / 1e6


def device_gap_ms(before, after) -> Optional[float]:
    """Device ms from ``before``'s exit event to ``after``'s entry event on
    their stream, or None where either has no events."""
    if before.events is None or after.events is None:
        return None
    end, start = before.events[1], after.events[0]
    start.synchronize()
    return end.elapsed_time(start)
