"""ConvInputModel: the strided conv feature extractor.

Port of ``rnet/models/conv.py``: per entry of ``channels``, Conv2d(k=3,
stride 2, padding 1) in the compute dtype -> cast to fp32 -> BatchNorm (eps
1e-5) -> ReLU -> cast back. (B,128,128,3) -> (B,8,8,24). The public layout
stays NHWC as in rnet; inside, the convs run NCHW, torch's own layout.

BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9)``: in eval mode it
normalises with the running statistics; in train mode with the batch mean
and the *biased* batch variance (fp32, with gradient), and it updates the
running buffers as ``ra = 0.9 * ra + 0.1 * stat`` with that biased variance
(``nn.BatchNorm2d`` would store the unbiased one).

Parameter names follow the flax tree (``conv{i}``, ``bn{i}`` with ``scale``,
``bias`` and the ``mean``/``var`` buffers), so ``rnet_torch.convert`` only
transposes the conv kernels (flax HWIO -> torch OIHW).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import fan_in_uniform

BN_MOMENTUM = 0.9  # flax's: the weight of the old running value


class Conv2d(nn.Module):
    """Weight (O, I, kh, kw) and bias, torch-default init from a generator."""

    def __init__(self, c_in: int, c_out: int, kernel: int, generator: torch.Generator):
        super().__init__()
        fan_in = c_in * kernel * kernel
        self.weight = nn.Parameter(fan_in_uniform((c_out, c_in, kernel, kernel), fan_in, generator))
        self.bias = nn.Parameter(fan_in_uniform((c_out,), fan_in, generator))


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1 with flax's parameter names and update."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.mean, self.var, self.scale, self.bias, training=False, eps=self.eps
            )
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
            self.var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        return F.batch_norm(x, None, None, self.scale, self.bias, training=True, eps=self.eps)


class ConvInputModel(nn.Module):
    def __init__(
        self,
        channels: Tuple[int, ...] = (24, 24, 24, 24),
        kernel: int = 3,
        stride: int = 2,
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.n_layers = len(channels)
        c_prev = 3  # RGB
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", Conv2d(c_prev, ch, kernel, gen))
            self.add_module(f"bn{i}", BatchNorm(ch))
            c_prev = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) float in [0, 1] -> (B, g, g, C) in the compute dtype."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        pad = self.kernel // 2
        for i in range(self.n_layers):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            y = F.conv2d(
                x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                stride=self.stride, padding=pad,
            )
            x = torch.relu(bn(y.float())).to(self.dtype)
        return x.permute(0, 2, 3, 1)
