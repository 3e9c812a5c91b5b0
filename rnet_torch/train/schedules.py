"""Progressive LR- and batch-size-doubling schedules.

Port of ``rnet/train/schedules.py``: every ``step`` epochs the value is
multiplied by ``gamma`` until ``max``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DoublingSchedule:
    """value(epoch) = min(base * gamma^((epoch-1)//step), max) (epochs 1-based)."""

    base: float
    gamma: float = 2.0
    step: int = 20
    max: Optional[float] = None

    def value(self, epoch: int) -> float:
        if self.step <= 0 or self.gamma == 1.0:
            v = self.base
        else:
            v = self.base * (self.gamma ** ((max(epoch, 1) - 1) // self.step))
        if self.max is not None:
            v = min(v, self.max)
        return v

    def int_value(self, epoch: int) -> int:
        return int(round(self.value(epoch)))
