"""PyTorch-default weight initializers, drawn from an explicit generator.

Port of ``rnet/models/initializers.py``: the same bounds (Linear/Conv
U(+-1/sqrt(fan_in)) for weights and biases, LSTM U(+-1/sqrt(hidden)),
Embedding N(0, 1)). Every draw takes a ``torch.Generator``, so a model built
from a seed is the same on every machine and never touches the global RNG.
The two packages draw different numbers from the same seed; tests carry
weights across with ``rnet_torch.convert`` instead.
"""

from __future__ import annotations

from typing import Sequence

import torch


def uniform(shape: Sequence[int], bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(tuple(shape)).uniform_(-bound, bound, generator=generator)


def fan_in_uniform(shape: Sequence[int], fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """U(+-1/sqrt(fan_in)): torch's Linear/Conv weight and bias default."""
    return uniform(shape, 1.0 / fan_in ** 0.5, generator)


def linear_kernel(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """(in, out) kernel, flax layout: fan_in is the product of all but the last dim."""
    fan_in = 1
    for d in shape[:-1]:
        fan_in *= d
    return fan_in_uniform(shape, fan_in, generator)


def lstm_uniform(shape: Sequence[int], hidden: int, generator: torch.Generator) -> torch.Tensor:
    return uniform(shape, 1.0 / hidden ** 0.5, generator)


def embedding_normal(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator)
