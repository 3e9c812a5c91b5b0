"""Fused pairwise g_theta core: CUDA kernel wrapper + plain torch version.

Port of ``rnet/kernels/pairwise.py`` (forward only). Because concatenation
feeds a linear layer, g layer 0 factors into per-object projections
u = x@W0[:c], v = x@W0[c:2c] and a per-sample shift s (plus an injection term
qa at a deeper layer), so the n^2-heavy part is

    out[b] = sum_{i,j} g_{L-1}(... g_1(relu(u[b,i] + v[b,j] + s[b])))   (B, H)

* ``pairwise_core_reference`` — the plain version, in the same module as the
  kernel: the CPU path, the tests' and ``chip_smoke.py``'s oracle. It repeats
  the kernel's rounding points (fp32 math on the input dtype's values, a cast
  back to that dtype after every relu, fp32 pooling).
* ``pairwise_core`` — the dispatch: CPU tensors take the plain version, CUDA
  tensors the kernel ``rnet_torch/csrc/pairwise_fwd.cu`` or an exception.
  There is no fallback from the card to the plain version.
* ``fused_pairwise_g`` — objects + question -> pooled g (B, H) through
  ``_project_pair_inputs`` and ``pairwise_core``.

In-kernel pair dropout (``pair_keep < 1``), the backward kernel, the int8
kernel and the sharded island come with later slices (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import build

KERNEL = "pairwise_fwd"
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper

# Kernel launches since the last reset (the main-path proof in chip_smoke.py).
launches = 0

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rnet_pairwise_fwd.argtypes = [vp] * 8 + [i32] * 6 + [vp]
        lib.rnet_pairwise_fwd.restype = i32
        lib.rnet_pairwise_fwd_block_rows.argtypes = []
        lib.rnet_pairwise_fwd_block_rows.restype = i32
        lib.rnet_pairwise_fwd_smem_bytes.argtypes = [i32]
        lib.rnet_pairwise_fwd_smem_bytes.restype = ctypes.c_longlong
        lib.rnet_cuda_error_string.argtypes = [i32]
        lib.rnet_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def pairwise_core_reference(u, v, s, qa, ws, bs, inject: int) -> torch.Tensor:
    """out[b] = sum_{i,j} g-chain(relu(u[b,i] + v[b,j] + s[b])), fp32 (B, H).

    Math in fp32; each relu output is cast back to u's dtype, as the kernel
    rounds it. With fp32 inputs this is rnet's ``pairwise_core_reference``.
    """
    dt = u.dtype
    B, ni, H = u.shape
    nj = v.shape[1]
    a = torch.relu(
        u.float()[:, :, None, :] + v.float()[:, None, :, :] + s.float()[:, None, None, :]
    ).to(dt).reshape(B, ni * nj, H)
    for l in range(1, ws.shape[0] + 1):
        pre = a.float() @ ws[l - 1].float() + bs[l - 1].float()
        if l == inject:
            pre = pre + qa.float()[:, None, :]
        a = torch.relu(pre).to(dt)
    return a.float().sum(dim=1)


def check_kernel_inputs(u, v, s, qa, ws, bs) -> Tuple[int, int, int, int, int]:
    """Validate what the kernel takes; (B, ni, nj, H, L) or ValueError."""
    ts = {"u": u, "v": v, "s": s, "qa": qa, "ws": ws, "bs": bs}
    for name, t in ts.items():
        if t.dtype != torch.bfloat16:
            raise ValueError(f"pairwise_fwd kernel takes bfloat16 tensors; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"pairwise_fwd kernel takes contiguous tensors; {name} is not")
    if u.dim() != 3 or v.dim() != 3:
        raise ValueError(f"u and v must be (B, n, H); got {tuple(u.shape)} and {tuple(v.shape)}")
    B, ni, H = u.shape
    nj = v.shape[1]
    L = ws.shape[0] + 1
    want = {"v": (B, nj, H), "s": (B, H), "qa": (B, H), "ws": (L - 1, H, H), "bs": (L - 1, H)}
    for name, shape in want.items():
        if tuple(ts[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(ts[name].shape)}")
    if H % 128 != 0:
        raise ValueError(f"pairwise_fwd kernel needs H % 128 == 0, got H={H}")
    if L < 2:
        raise ValueError(f"pairwise_fwd kernel needs L >= 2 layers, got L={L}")
    if ni < 1 or nj < 1 or not 1 <= B <= 65535:
        raise ValueError(f"pairwise_fwd kernel needs ni, nj >= 1 and 1 <= B <= 65535; got B={B}, ni={ni}, nj={nj}")
    return B, ni, nj, H, L


def pairwise_fwd_cuda(u, v, s, qa, ws, bs, *, inject: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; (B, H) fp32. Raises on
    anything the kernel does not take, on CPU tensors, and on a failed build
    or launch."""
    global launches
    B, ni, nj, H, L = check_kernel_inputs(u, v, s, qa, ws, bs)
    dev = u.device
    if dev.type != "cuda" or any(t.device != dev for t in (v, s, qa, ws, bs)):
        raise ValueError(
            "pairwise_fwd kernel takes CUDA tensors on one device; got "
            f"{sorted({str(t.device) for t in (u, v, s, qa, ws, bs)})}"
        )
    lib = _kernel_lib()
    smem = lib.rnet_pairwise_fwd_smem_bytes(H)
    if smem > SMEM_LIMIT:
        raise ValueError(f"pairwise_fwd kernel at H={H} needs {smem} B of shared memory (> {SMEM_LIMIT})")
    nblk = -(-ni * nj // lib.rnet_pairwise_fwd_block_rows())
    partial = torch.empty((B, nblk, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_fwd(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(),
            ws.data_ptr(), bs.data_ptr(), partial.data_ptr(), out.data_ptr(),
            B, ni, nj, H, L, int(inject), stream,
        )
    if err != 0:
        msg = lib.rnet_cuda_error_string(err).decode()
        raise RuntimeError(f"pairwise_fwd launch failed: CUDA error {err} ({msg})")
    launches += 1
    return out


def pairwise_core(u, v, s, qa, ws, bs, *, inject: int, pair_keep: float = 1.0) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors, the kernel for CUDA ones."""
    if pair_keep < 1.0:
        raise NotImplementedError(
            "in-kernel pair dropout (pair_keep < 1) comes with the training "
            "slice (ROADMAP.md); use the xla impl for pair dropout"
        )
    if u.device.type == "cpu":
        return pairwise_core_reference(u, v, s, qa, ws, bs, inject)
    return pairwise_fwd_cuda(u, v, s, qa, ws, bs, inject=inject)


def _project_pair_inputs(x, q, gw: Sequence[torch.Tensor], gb: Sequence[torch.Tensor], inject: int, dtype):
    """Thin projections feeding the core, in the compute dtype.

    u = x@W0[:c], v = x@W0[c:2c]; at inject = 0 the shift is
    s = b0 + q@W0[2c:] and qa = 0; at inject = p > 0, s = b0, W_p is split by
    rows (``[:h_prev]`` joins ``ws``) and qa = q@W_p[h_prev:].
    """
    B, n, c = x.shape
    H = gw[0].shape[-1]
    x = x.to(dtype)
    q = q.to(dtype)
    w0 = gw[0].to(dtype)
    u = x @ w0[:c]
    v = x @ w0[c : 2 * c]
    s = gb[0].to(dtype)[None, :].expand(B, H)
    if inject == 0:
        s = s + q @ w0[2 * c :]
        qa = torch.zeros((B, H), dtype=dtype, device=x.device)
        ws = torch.stack([gw[l].to(dtype) for l in range(1, len(gw))])
    else:
        h_prev = gw[inject].shape[0] - q.shape[-1]
        qa = q @ gw[inject][h_prev:].to(dtype)
        ws = torch.stack(
            [(gw[l][:h_prev] if l == inject else gw[l]).to(dtype) for l in range(1, len(gw))]
        )
    bs = torch.stack([gb[l].to(dtype) for l in range(1, len(gw))])
    return u.contiguous(), v.contiguous(), s.contiguous(), qa, ws, bs


def fused_pairwise_g(x, q, gw, gb, *, inject: int, dtype=torch.bfloat16, pair_keep: float = 1.0) -> torch.Tensor:
    """Pooled g_theta over all object pairs; (B, g_out) fp32."""
    u, v, s, qa, ws, bs = _project_pair_inputs(x, q, gw, gb, inject, dtype)
    return pairwise_core(u, v, s, qa, ws, bs, inject=inject, pair_keep=pair_keep)
