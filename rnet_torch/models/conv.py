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

Under a mesh with a ``data`` axis of more than one rank the train-mode
moments are those of the global batch, as GSPMD gives flax's BatchNorm:
each rank's per-channel count, mean and centred sum of squares go into its
row of a (D, 3, C) buffer, one all-reduce (``parallel.mesh.sum_over``,
whose backward is an all-reduce too: every rank's loss reads the global
moments) gives every rank all of them, and they are combined as Chan et
al.'s parallel variance (flax's E[x^2] - E[x]^2 loses digits on flat
images); the running buffers then move identically on every rank.

Parameter names follow the flax tree (``conv{i}``, ``bn{i}`` with ``scale``,
``bias`` and the ``mean``/``var`` buffers), so ``rnet_torch.convert`` only
transposes the conv kernels (flax HWIO -> torch OIHW).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import Mesh, sum_over
from .initializers import fan_in_uniform

BN_MOMENTUM = 0.9  # flax's: the weight of the old running value


class Conv2d(nn.Module):
    """Weight (O, I, kh, kw) and bias, torch-default init from a generator."""

    def __init__(self, c_in: int, c_out: int, kernel: int, generator: torch.Generator):
        super().__init__()
        fan_in = c_in * kernel * kernel
        self.weight = nn.Parameter(fan_in_uniform((c_out, c_in, kernel, kernel), fan_in, generator))
        self.bias = nn.Parameter(fan_in_uniform((c_out,), fan_in, generator))


def global_moments(x: torch.Tensor, mesh: Mesh):
    """(mean, biased var) per channel (dim 1) of fp32 x over the global batch
    of the ``data`` ranks, differentiable in every rank's x."""
    C = x.shape[1]
    D, d = mesh.size("data"), mesh.index("data")
    mean = x.mean(dim=(0, 2, 3))
    m2 = (x - mean[None, :, None, None]).square().sum(dim=(0, 2, 3))
    mine = torch.stack([torch.full_like(mean, x.numel() / C), mean, m2])  # (3, C)
    rows = [mine if r == d else torch.zeros_like(mine) for r in range(D)]
    count, means, m2s = sum_over(torch.stack(rows), mesh, "data").unbind(1)  # each (D, C)
    n = count.sum(0)
    mean = (count * means).sum(0) / n
    var = (m2s.sum(0) + (count * (means - mean).square()).sum(0)) / n
    return mean, var


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1 with flax's parameter names and update;
    under a ``mesh`` with several ``data`` ranks, global-batch moments."""

    def __init__(self, channels: int, eps: float = 1e-5, mesh: Optional[Mesh] = None):
        super().__init__()
        self.eps = eps
        self.mesh = mesh
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
            self.var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.mean, self.var, self.scale, self.bias, training=False, eps=self.eps
            )
        if self.mesh is not None and self.mesh.size("data") > 1:
            mean, var = global_moments(x, self.mesh)
            self._update_running(mean, var)
            inv = torch.rsqrt(var + self.eps) * self.scale
            return (x - mean[None, :, None, None]) * inv[None, :, None, None] + self.bias[None, :, None, None]
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.scale, self.bias, training=True, eps=self.eps)


class ConvInputModel(nn.Module):
    def __init__(
        self,
        channels: Tuple[int, ...] = (24, 24, 24, 24),
        kernel: int = 3,
        stride: int = 2,
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
        mesh: Optional[Mesh] = None,
    ):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.n_layers = len(channels)
        c_prev = 3  # RGB
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", Conv2d(c_prev, ch, kernel, gen))
            self.add_module(f"bn{i}", BatchNorm(ch, mesh=mesh))
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
