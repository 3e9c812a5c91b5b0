"""Tracing and scalar logging for training.

Port of ``rnet/utils/profiling.py``:
  * ``profile_trace`` — a ``torch.profiler`` trace (CPU and, where there is
    a card, CUDA activity) of the enclosed work, written as a Chrome trace
    ``trace.json`` into ``logdir``; a no-op without a logdir;
  * ``ScalarWriter`` — TensorBoard scalars where ``tensorboardX`` is
    installed, always mirrored to ``scalars.csv``.

and the port's own spans, which rnet does not have:
  * ``span(name, device=False)`` — while a ``torch.profiler`` records (and
    only then), a ``record_function`` range ``rn.<name>`` on the profiler's
    timeline, the clock of the kernels and copies in its device trace, and a
    ``Span`` record of the host start and end; with ``device=True`` also a
    CUDA event on the current stream at entry and at exit. While no profiler
    records it returns one shared no-op context after a single flag read: an
    ungated ``record_function`` costs microseconds even with no profiler.
    ``records()`` returns what was recorded, ``clear()`` forgets it;
    ``profile_trace`` clears on entry.

The span sites, from the loop down to a graph's launch (each trace written
by ``profile_trace`` carries these ranges):
  * ``rn.train.order`` (``Trainer._train_steps_device``): the epoch's host
    permutation and its upload;
  * ``rn.train.fetch`` (``Trainer._drain``): ``rn.train.fetch_wait``, the
    previous chunk's metrics fetched (the host waits for the device), then
    ``rn.train.log``, the log line and scalars;
  * ``rn.eval.upload`` (``Trainer._eval_device``): the epoch's index and
    valid arrays built and uploaded; ``rn.eval.fetch`` (``eval_epoch``): the
    outputs stacked and fetched once; ``rn.eval.accumulate``: the
    ``EvalAccumulator`` update and the epoch's log line;
  * ``rn.graph.run`` (``StepGraphs.run``, with device events): one dispatch
    of a captured step or chunk, with ``rn.graph.copy_in`` (the inputs into
    the static buffers), ``rn.graph.replay`` (the host call that launches
    the graph) and ``rn.graph.copy_out`` (the output clones) inside it;
    ``rn.graph.capture`` (``StepGraphs._capture``): a capture.

Spans are entered from one thread: a span's parent is the span open around
it when it was entered.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


class Span(NamedTuple):
    """One recorded span: its name (without the ``rn.`` prefix), the name of
    the span open around it (None at the top), its host start and end in
    ``time.perf_counter_ns`` nanoseconds, and for a device span the CUDA
    events recorded on the current stream at its entry and its exit (None
    where there are none)."""

    name: str
    parent: Optional[str]
    t0_ns: int
    t1_ns: int
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None


_RECORDS: List[Span] = []
_OPEN: List[str] = []
_OFF = contextlib.nullcontext()


class _Span:
    """A span while the profiler records (``span``)."""

    __slots__ = ("name", "device", "parent", "t0", "start", "range")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        self.parent = _OPEN[-1] if _OPEN else None
        _OPEN.append(self.name)
        self.range = torch.profiler.record_function("rn." + self.name)
        self.range.__enter__()
        self.start = None
        if self.device and torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        events = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events = (self.start, end)
        self.range.__exit__(*exc)
        _OPEN.pop()
        _RECORDS.append(Span(self.name, self.parent, self.t0, t1, events))
        return False


def span(name: str, device: bool = False):
    """The span ``rn.<name>`` while a ``torch.profiler`` records, else a
    shared no-op context (see the module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def records() -> List[Span]:
    """The spans recorded since the last ``clear()``, in the order they ended."""
    return list(_RECORDS)


def clear() -> None:
    _RECORDS.clear()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler trace into ``logdir/trace.json`` if a logdir is given;
    the records of ``span`` start empty and hold the trace's spans after."""
    if not logdir:
        yield
        return
    clear()
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class ScalarWriter:
    """TensorBoard scalars when available; always mirrors to CSV."""

    def __init__(self, logdir: Optional[str]):
        self.logdir = logdir
        self._tb = None
        self._csv_path = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._csv_path = os.path.join(logdir, "scalars.csv")
            try:
                from tensorboardX import SummaryWriter  # type: ignore
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir)

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if not self.logdir:
            return
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        new = not os.path.exists(self._csv_path)
        with open(self._csv_path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["step", *scalars.keys()])
            w.writerow([step, *[f"{v:.6g}" for v in scalars.values()]])

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
