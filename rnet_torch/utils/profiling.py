"""Tracing and scalar logging for training.

Port of ``rnet/utils/profiling.py``:
  * ``profile_trace`` — a ``torch.profiler`` trace (CPU and, where there is
    a card, CUDA activity) of the enclosed work, written as a Chrome trace
    ``trace.json`` into ``logdir``; a no-op without a logdir;
  * ``ScalarWriter`` — TensorBoard scalars where ``tensorboardX`` is
    installed, always mirrored to ``scalars.csv``.
"""

from __future__ import annotations

import contextlib
import csv
import os
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler trace into ``logdir/trace.json`` if a logdir is given."""
    if not logdir:
        yield
        return
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
