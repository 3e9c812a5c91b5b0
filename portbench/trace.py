"""The traced slice of a window and its reduction.

A ``Tracer`` profiles one bounded, steady slice of a ``--trace 1`` window
with ``torch.profiler`` (CPU and CUDA activity; it sees the kernels inside
CUDA graph replays), exports the Chrome trace to a temporary file, reads it
back and deletes it. The harness's own host spans (``span``) are
``record_function`` ranges named ``pb.<name>``, so they share the
profiler's clock with the device's activity.

``Slice`` holds the device intervals (kernels, copies, sets) and the host
spans inside the slice, and reduces them: busy seconds (the union of the
device intervals), time and count by kernel name, the top operations and
the longest idle gaps labelled by the host span they began in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "pb.slice"

Interval = Tuple[str, float, float]  # (name, start us, end us)


def _matcher(names: Sequence[str]):
    return re.compile(r"\b(?:" + "|".join(re.escape(n) for n in names) + r")\b")


@dataclasses.dataclass
class Slice:
    start_us: float
    end_us: float
    device: List[Interval]
    spans: List[Interval]

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def _union(self, intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for a, b in sorted(intervals):
            a, b = max(a, self.start_us), min(b, self.end_us)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union((a, b) for _, a, b in self.device)) / 1e6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def kernel_s(self, names: Sequence[str]) -> float:
        """Seconds of the device intervals whose name has any of ``names`` as
        a whole word."""
        pat = _matcher(names)
        return sum(b - a for n, a, b in self.device if pat.search(n)) / 1e6

    def kernel_count(self, names: Sequence[str]) -> int:
        pat = _matcher(names)
        return sum(1 for n, _, _ in self.device if pat.search(n))

    def top_ops(self, k: int = 10) -> List[List]:
        total: Dict[str, float] = {}
        for n, a, b in self.device:
            total[n] = total.get(n, 0.0) + (b - a) / 1e6
        return [[n[:160], s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest gaps between device activity, each named by the
        innermost host span open where it began."""
        busy = self._union((a, b) for _, a, b in self.device)
        edges = [self.start_us] + [x for ab in busy for x in ab] + [self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            open_spans = [(e - s, n) for n, s, e in self.spans if s <= a < e]
            out.append([min(open_spans)[1] if open_spans else "no span", (b - a) / 1e6])
        return out


def read_chrome_trace(path: str) -> Slice:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, spans, bounds = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = (e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(iv)
        elif cat == "user_annotation" and iv[0].startswith("pb."):
            if iv[0] == SLICE:
                bounds = iv
            else:
                spans.append(iv)
    if bounds is None:
        raise RuntimeError(f"the trace has no {SLICE} range")
    return Slice(bounds[1], bounds[2], device, spans)


class Tracer:
    """Profiles the slice between ``start()`` and ``stop()`` when enabled;
    ``span(name)`` marks host work while it profiles."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.slice: Optional[Slice] = None
        self._prof = self._range = None

    def _sync(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def start(self) -> None:
        if not self.enabled or self.slice is not None or self.active:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        self._sync()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.slice = read_chrome_trace(path)
        finally:
            os.remove(path)
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        with torch.profiler.record_function(f"pb.{name}"):
            yield


def now() -> float:
    return time.perf_counter()
