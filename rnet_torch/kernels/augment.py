"""Fused gather + crop + rotate + normalize: CUDA kernel wrapper + plain version.

Port of ``rnet/kernels/augment.py``. For each sample b the kernel reads
canvas ``idx[b]`` of the uint8 cache (N, S, S, C), multiplies by 1/255 in
fp32, rotates it by ``angles[b]`` with three hat-weighted shears about the
crop centre (x by tan(a/2)·(r − cy), y by −sin(a)·(c − cx), x again; the
shifts wrap mod S as ``jnp.roll`` does), crops OUT×OUT at ``offs[b]`` (row,
col) and casts once to the output dtype.

* ``gather_augment_reference`` — the plain version, in the same module as
  the kernel: the CPU path and the oracle of the tests and ``chip_smoke.py``.
* ``augment_cuda`` — the wrapper of ``rnet_torch/csrc/augment.cu``; it counts
  its launches in ``launches["augment"]``.
* ``fused_augment`` — CPU tensors take the plain version, CUDA tensors the
  kernel (or an exception); there is no fallback from the card.
* ``gather_augment`` — draws the angles (uniform ±MAX_DEG degrees, then
  ×π/180) and the offsets (uniform integers in [0, S − OUT], row then
  column) from a ``torch.Generator`` on the cache's device, then
  ``fused_augment``.

The TPU layout and DMA pieces of the rnet module (``pad_flat_cache``,
``unflatten_rows``, ``dma_gather_schedule``, the slot ring) have no
counterpart: the kernel takes the plain 4-D cache and each block loads its
own index.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from ..data.augment import _shear, draw_rotation_angles
from ..parallel.mesh import Mesh, global_batch, local_rows
from . import build

KERNEL = "augment"
CHANNELS = 3  # the kernel's C: RGB canvases

# Largest rotation, degrees; the shear radii below cover it for any crop
# centre of the canvas.
MAX_DEG = 2.8

# Kernel launches since the last reset_launches() (the main-path proof in
# chip_smoke.py).
launches: Dict[str, int] = {KERNEL: 0}

_libs = {}


def reset_launches() -> None:
    launches[KERNEL] = 0


def _shear_radii(canvas: int, out_size: int) -> tuple:
    """(KX, KY): tap radii of the x and y shears for MAX_DEG about any crop
    centre; (2, 4) for a 144 canvas and a 128 crop."""
    reach = max(out_size / 2 + (canvas - out_size), out_size / 2)
    kx = math.ceil(reach * math.tan(math.radians(MAX_DEG / 2)))
    ky = math.ceil(reach * math.sin(math.radians(MAX_DEG)))
    return kx, ky


def gather_augment_reference(cache, idx, angles, offs, out_size: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: (B, out, out, C) in out_dtype. Shears on the whole
    canvas about the crop centre, then the crop, whose start is clamped to
    [0, S - out] as ``jax.lax.dynamic_slice`` clamps (the centres use offs as
    given)."""
    f32 = torch.float32
    imgs = cache[idx.long()].to(f32) * (1.0 / 255.0)  # (B, S, S, C)
    B, S, _, C = imgs.shape
    kx, ky = _shear_radii(S, out_size)
    ang = angles.to(f32)
    cy = offs[:, 0].to(f32) + (out_size - 1) / 2.0
    cx = offs[:, 1].to(f32) + (out_size - 1) / 2.0
    coord = torch.arange(S, dtype=f32, device=imgs.device)[None, :]
    sx = torch.tan(ang / 2.0)[:, None] * (coord - cy[:, None])  # (B, S) per row
    sy = -torch.sin(ang)[:, None] * (coord - cx[:, None])  # (B, S) per column
    x = _shear(imgs, sx, axis=2, k_max=kx)
    x = _shear(x, sy, axis=1, k_max=ky)
    x = _shear(x, sx, axis=2, k_max=kx)
    starts = offs.long().clamp(0, S - out_size)
    rows = starts[:, 0, None] + torch.arange(out_size, device=x.device)[None, :]  # (B, out)
    cols = starts[:, 1, None] + torch.arange(out_size, device=x.device)[None, :]
    b = torch.arange(B, device=x.device)[:, None, None]
    return x[b, rows[:, :, None], cols[:, None, :]].to(out_dtype)


def _kernel_lib() -> ctypes.CDLL:
    lib = _libs.get(KERNEL)
    if lib is None:
        lib = build.load(KERNEL)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rnet_augment.argtypes = [vp, i64, i32, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
        lib.rnet_augment.restype = i32
        lib.rnet_cuda_error_string.argtypes = [i32]
        lib.rnet_cuda_error_string.restype = ctypes.c_char_p
        _libs[KERNEL] = lib
    return lib


def check_kernel_inputs(cache, idx, angles, offs, out_size: int, out_dtype) -> tuple:
    """Validate what the kernel takes; (N, S, C, B) or ValueError."""
    want = {"cache": (cache, torch.uint8), "idx": (idx, torch.int32), "angles": (angles, torch.float32),
            "offs": (offs, torch.int32)}
    for name, (t, dt) in want.items():
        if t.dtype != dt:
            raise ValueError(f"augment kernel takes {name} as {dt}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"augment kernel takes contiguous tensors; {name} is not")
    if cache.dim() != 4 or cache.shape[1] != cache.shape[2] or cache.shape[3] != CHANNELS:
        raise ValueError(f"cache must be (N, S, S, {CHANNELS}); got {tuple(cache.shape)}")
    N, S, _, C = cache.shape
    if (S * C) % 16 or cache.data_ptr() % 16:
        raise ValueError(f"augment kernel loads canvas rows in 16 bytes: S*C must be a multiple of 16 "
                         f"and the cache 16-byte aligned; got S={S}")
    B = idx.shape[0]
    if idx.dim() != 1 or tuple(angles.shape) != (B,) or tuple(offs.shape) != (B, 2):
        raise ValueError(
            f"idx (B,), angles (B,) and offs (B, 2) expected; got {tuple(idx.shape)}, "
            f"{tuple(angles.shape)}, {tuple(offs.shape)}"
        )
    if not 1 <= out_size <= S:
        raise ValueError(f"out_size must be in [1, {S}], got {out_size}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"augment kernel writes float32 or bfloat16, not {out_dtype}")
    if not 1 <= B <= 2**31 - 1 or N < 1:
        raise ValueError(f"augment kernel needs B >= 1 and N >= 1; got B={B}, N={N}")
    return N, S, C, B


def augment_cuda(cache, idx, angles, offs, out_size: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch the kernel on the current stream; (B, out, out, C) in
    out_dtype. Raises on anything the kernel does not take, on CPU tensors,
    and on a failed build or launch. An index outside [0, N) gives NaN rows."""
    N, S, C, B = check_kernel_inputs(cache, idx, angles, offs, out_size, out_dtype)
    dev = cache.device
    if dev.type != "cuda" or any(t.device != dev for t in (idx, angles, offs)):
        raise ValueError(
            f"augment kernel takes CUDA tensors on one device; got "
            f"{sorted({str(t.device) for t in (cache, idx, angles, offs)})}"
        )
    lib = _kernel_lib()
    kx, ky = _shear_radii(S, out_size)
    out = torch.empty((B, out_size, out_size, C), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_augment(
            cache.data_ptr(), N, S, idx.data_ptr(), angles.data_ptr(), offs.data_ptr(), out.data_ptr(),
            B, out_size, kx, ky, int(out_dtype == torch.bfloat16), stream,
        )
    if err != 0:
        msg = lib.rnet_cuda_error_string(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} ({msg})")
    launches[KERNEL] += 1
    return out


def fused_augment(cache, idx, angles, offs, out_size: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel for a cache on the card, the plain version for one on the CPU."""
    if cache.device.type == "cpu":
        return gather_augment_reference(cache, idx, angles, offs, out_size, out_dtype)
    return augment_cuda(cache, idx, angles, offs, out_size, out_dtype)


def draw_augment_params(B: int, canvas: int, out_size: int, generator: torch.Generator, device):
    """(angles (B,) fp32 radians, offs (B, 2) int32 (row, col)) from ``generator``."""
    angles = draw_rotation_angles(B, generator, device, MAX_DEG)
    offs = torch.randint(0, canvas - out_size + 1, (B, 2), generator=generator, device=device, dtype=torch.int32)
    return angles, offs


def gather_augment(cache, idx, generator: torch.Generator, out_size: int, out_dtype=torch.bfloat16,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Random crop + rotation fused with the cache gather: (B, out, out, C)
    normalized [0, 1] images in out_dtype, with per-sample angles and
    offsets drawn from ``generator`` (on the cache's device).

    Under a ``mesh`` (rnet's ``gather_augment(mesh=)``) ``idx`` is this
    rank's ``data`` slice of the batch and the rank augments only those
    rows: of a replicated device cache (the device pipeline), or of its own
    batch of padded canvases (``idx = arange(B)``, rnet's ``batch_local``).
    The angles and offsets are drawn for the global batch and the rank keeps
    its rows (``parallel.mesh.local_rows``)."""
    B = global_batch(idx.shape[0], mesh)
    angles, offs = draw_augment_params(B, cache.shape[1], out_size, generator, cache.device)
    return fused_augment(cache, idx, local_rows(angles, mesh), local_rows(offs, mesh).contiguous(), out_size,
                         out_dtype)
