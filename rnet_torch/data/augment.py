"""On-device image augmentation without the kernel: random crop + small rotation.

Port of ``rnet/data/augment.py``, the ``augment_impl="xla"`` path (and the
CPU path under ``auto``): the model crops a padded uint8 batch first, with
one offset per group of samples, casts to the compute dtype, divides by 255,
and rotates each sample about the image centre by the three-shear
decomposition, in the compute dtype. It is a different function from the
fused kernel (``rnet_torch/kernels/augment.py``), which rotates the whole
canvas about the crop centre in fp32 before it crops.

Each random function is a draw (``draw_rotation_angles``,
``draw_crop_offsets``, from a ``torch.Generator``) followed by an apply
(``rotate_shear_batch``, ``crop_batch``) that takes the draws as arguments.
``rotate_bilinear`` is the tests' oracle of the rotation.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.mesh import Mesh, global_batch, local_rows


def rotate_bilinear(img: torch.Tensor, angle_rad) -> torch.Tensor:
    """Reference rotation (bilinear resample, edge-clamped) of one (S, S, C)
    float image about its centre — the oracle of the tests."""
    S = img.shape[0]
    c = (S - 1) / 2.0
    ar = torch.arange(S, dtype=img.dtype, device=img.device) - c
    ys, xs = torch.meshgrid(ar, ar, indexing="ij")
    angle = torch.as_tensor(angle_rad, dtype=img.dtype, device=img.device)
    cos, sin = torch.cos(angle), torch.sin(angle)
    src_y = sin * xs + cos * ys + c
    src_x = cos * xs - sin * ys + c
    y0 = torch.clamp(torch.floor(src_y), 0, S - 2).long()
    x0 = torch.clamp(torch.floor(src_x), 0, S - 2).long()
    wy = torch.clamp(src_y - y0, 0.0, 1.0)[..., None]
    wx = torch.clamp(src_x - x0, 0.0, 1.0)[..., None]
    top = img[y0, x0] * (1 - wx) + img[y0, x0 + 1] * wx
    bot = img[y0 + 1, x0] * (1 - wx) + img[y0 + 1, x0 + 1] * wx
    return top * (1 - wy) + bot * wy


def _shear(images: torch.Tensor, shifts: torch.Tensor, axis: int, k_max: int) -> torch.Tensor:
    """Displace along ``axis`` by per-sample, per-line fractional ``shifts``.

    images (B, H, W, C); shifts (B, L), L the size of the axis perpendicular
    to the displacement (rows for axis=2, columns for axis=1).
    out = sum_k hat(shift - k) * roll(images, k, axis), in images' dtype:
    linear interpolation as a sum of 2*k_max+1 rolled copies.
    """
    if axis == 2:  # horizontal displacement, varying per row
        w_shape = (images.shape[0], shifts.shape[1], 1, 1)
    elif axis == 1:  # vertical displacement, varying per column
        w_shape = (images.shape[0], 1, shifts.shape[1], 1)
    else:
        raise ValueError(axis)
    out = torch.zeros_like(images)
    for k in range(-k_max, k_max + 1):
        w = torch.clamp(1.0 - (shifts - k).abs(), min=0.0).reshape(w_shape)
        out = out + w.to(images.dtype) * torch.roll(images, k, dims=axis)
    return out


def rotate_shear_batch(images: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Per-sample small rotation about the image centre (three shears).

    images (B, S, S, C) float; angles (B,) radians (small, < ~0.1), in
    images' dtype as everything here is:
    rot(a) = shear_x(tan(a/2)) . shear_y(-sin(a)) . shear_x(tan(a/2)).
    """
    B, H, W, _ = images.shape
    dt = images.dtype
    a = torch.tan(angles.to(dt) / 2.0)  # (B,)
    b = -torch.sin(angles.to(dt))
    rows = torch.arange(H, dtype=dt, device=images.device) - (H - 1) / 2.0
    cols = torch.arange(W, dtype=dt, device=images.device) - (W - 1) / 2.0
    sx = a[:, None] * rows[None, :]  # (B, H) horizontal shift per row
    sy = b[:, None] * cols[None, :]  # (B, W) vertical shift per column
    # roll radii from the largest angle these draws take (3 deg at S <= 160)
    kx = math.ceil(0.0265 * max(H, W) / 2) + 1
    ky = math.ceil(0.0525 * max(H, W) / 2) + 1
    out = _shear(images, sx, axis=2, k_max=kx)
    out = _shear(out, sy, axis=1, k_max=ky)
    return _shear(out, sx, axis=2, k_max=kx)


def draw_rotation_angles(B: int, generator: torch.Generator, device, max_deg: float = 2.8) -> torch.Tensor:
    """(B,) fp32 radians, uniform in [-max_deg, max_deg] degrees."""
    u = torch.rand(B, generator=generator, device=device)
    return (-max_deg + 2.0 * max_deg * u) * (math.pi / 180.0)


def random_rotate_batch(images: torch.Tensor, generator: torch.Generator, max_deg: float = 2.8,
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Per-sample random rotation in [-max_deg, +max_deg] degrees (under a
    mesh drawn for the global batch; this rank's rows kept)."""
    angles = draw_rotation_angles(global_batch(images.shape[0], mesh), generator, images.device, max_deg)
    return rotate_shear_batch(images, local_rows(angles, mesh).to(images.dtype))


def crop_groups(B: int, groups: int = 32) -> int:
    """The number of offset groups: the largest power-of-two divisor of
    ``groups`` that divides B (rnet halves ``groups`` until it does)."""
    G = groups
    while B % G:
        G //= 2
    return max(G, 1)


def draw_crop_offsets(B: int, canvas: int, out_size: int, generator: torch.Generator, device,
                      groups: int = 32) -> torch.Tensor:
    """(G, 2) int64 (row, col) offsets in [0, canvas - out_size], one per group."""
    G = crop_groups(B, groups)
    return torch.randint(0, canvas - out_size + 1, (G, 2), generator=generator, device=device)


def crop_batch(images: torch.Tensor, offs: torch.Tensor, out_size: int) -> torch.Tensor:
    """Crop (B, S, S, C) to (B, out, out, C): the batch splits into G = len(offs)
    consecutive groups, group g cropped at offs[g] (drawn in [0, S - out]; a
    start past S - out is clamped to it, as ``jax.lax.dynamic_slice``
    clamps). A gather on the images' device: no offset is fetched to the
    host."""
    B, S = images.shape[:2]
    starts = offs.long().clamp(0, S - out_size).repeat_interleave(B // offs.shape[0], dim=0)  # (B, 2)
    span = torch.arange(out_size, device=images.device)
    rows = starts[:, 0, None] + span  # (B, out)
    cols = starts[:, 1, None] + span
    b = torch.arange(B, device=images.device)[:, None, None]
    return images[b, rows[:, :, None], cols[:, None, :]]


def random_crop_batch(images: torch.Tensor, generator: torch.Generator, out_size: int, groups: int = 32,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Crop jitter with per-group offsets (rnet's gather workaround: the
    samples of a group share the step's offset). Under a mesh the groups
    are the global batch's, and this rank crops its rows at their groups'
    offsets."""
    B = global_batch(images.shape[0], mesh)
    offs = draw_crop_offsets(B, images.shape[1], out_size, generator, images.device, groups)
    if mesh is not None:  # one offset per row of the global batch, then this rank's rows
        offs = local_rows(offs.repeat_interleave(B // offs.shape[0], dim=0), mesh)
    return crop_batch(images, offs, out_size)


def center_crop_batch(images: torch.Tensor, out_size: int) -> torch.Tensor:
    p = (images.shape[1] - out_size) // 2
    return images[:, p : p + out_size, p : p + out_size, :]
