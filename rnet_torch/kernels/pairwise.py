"""Fused pairwise g_theta core: CUDA kernel wrappers + plain torch versions.

Port of ``rnet/kernels/pairwise.py`` (forward, recompute backward and pair
mask). Because concatenation feeds a linear layer, g layer 0 factors into
per-object projections u = x@W0[:c], v = x@W0[c:2c] and a per-sample shift
s (plus an injection term qa at a deeper layer), so the n^2-heavy part is

    out[b] = sum_{i,j} m_bij * g_{L-1}(... g_1(relu(u[b,i] + v[b,j] + s[b])))   (B, H)

with m_bij = 1, or under pair dropout (``pair_keep < 1``) 1/keep for a kept
pair and 0 for a dropped one, drawn by Philox4x32-10 from (seed, b, i, j)
(``rnet_torch/csrc/philox.cuh``).

* ``pair_mask_reference``, ``pairwise_core_reference`` and
  ``pairwise_core_bwd_reference`` — the plain versions, in the same module
  as the kernels: the CPU path, the tests' and ``chip_smoke.py``'s oracle.
  They repeat the kernels' rounding points (fp32 math on the input dtype's
  values, a cast back to that dtype after every relu and, in the backward,
  of every dpre_l with l >= 1) and the mask's integer arithmetic exactly.
* ``pairwise_fwd_cuda``, ``pairwise_bwd_cuda``, ``pair_mask_cuda`` — the
  wrappers of ``csrc/pairwise_fwd.cu`` and ``csrc/pairwise_bwd.cu``, each with
  its launch count in ``launches``.
* ``pairwise_core`` — a ``torch.autograd.Function`` (as ``_make_core``'s
  custom VJP): CPU tensors take the plain versions, CUDA tensors the kernels
  or an exception. It saves only its inputs and the seed; the backward
  recomputes the n^2 activations. There is no fallback from the card to the
  plain versions.
* ``fused_pairwise_g`` — objects + question -> pooled g (B, H) through
  ``_project_pair_inputs`` and ``pairwise_core``.

The int8 kernel and the sharded island come with later slices (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from . import build

KERNEL = "pairwise_fwd"
BWD_KERNEL = "pairwise_bwd"
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper

# Kernel launches since the last reset_launches() (the main-path proof in
# chip_smoke.py). "pair_mask" counts the launches that drew Philox pair-mask
# bits: a forward or backward launch with pair_keep < 1, or the mask kernel.
launches = {KERNEL: 0, BWD_KERNEL: 0, "pair_mask": 0}

_libs = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the C interface of library `name` (KERNEL or BWD_KERNEL)."""
    vp, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    if name == KERNEL:
        lib.rnet_pairwise_fwd.argtypes = [vp] * 8 + [i32] * 7 + [vp, u32, f32, vp]
        lib.rnet_pairwise_fwd.restype = i32
        lib.rnet_pairwise_fwd_block_rows.argtypes = []
        lib.rnet_pairwise_fwd_block_rows.restype = i32
        lib.rnet_pairwise_fwd_smem_bytes.argtypes = [i32]
        lib.rnet_pairwise_fwd_smem_bytes.restype = ctypes.c_longlong
        lib.rnet_pair_mask.argtypes = [vp, i32, i32, vp, u32, vp]
        lib.rnet_pair_mask.restype = i32
    else:
        lib.rnet_pairwise_bwd.argtypes = [vp] * 16 + [i32] * 9 + [vp, u32, f32, vp]
        lib.rnet_pairwise_bwd.restype = i32
        lib.rnet_pairwise_bwd_block_rows.argtypes = [i32, i32, ctypes.c_longlong]
        lib.rnet_pairwise_bwd_block_rows.restype = i32
    lib.rnet_cuda_error_string.argtypes = [i32]
    lib.rnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = _bind(build.load(name), name)
    return lib


def _raise_on_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.rnet_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# Pair mask (Philox4x32-10, counter (p, b, 0, 0), key = the 64-bit seed)
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def keep_threshold(keep: float) -> Tuple[int, float]:
    """(thr, inv_keep) for pair_keep `keep`: a pair is kept iff
    (bits >> 8) < thr, with thr = ceil(fp32(keep) * 2^24) — the same test as
    (bits >> 8) * 2^-24 < keep, in integers — and scaled by fp32(1/keep)."""
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"pair_keep must be in (0, 1], got {keep}")
    k32 = torch.tensor(keep, dtype=torch.float32).item()
    return math.ceil(k32 * 2**24), torch.tensor(1.0 / keep, dtype=torch.float32).item()


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x for uint32 values held in int64,
    through 16-bit halves of m so that no product leaves int64."""
    t = x * (m & 0xFFFF)
    s = x * (m >> 16) + (t >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (t & 0xFFFF)


def philox_word(c0: torch.Tensor, c1: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """First word of Philox4x32-10 at counter (c0, c1, 0, 0) under the key
    (seed & 0xffffffff, seed >> 32), in int64 torch ops (philox.cuh)."""
    k0 = seed & _U32
    k1 = (seed >> 32) & _U32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _U32
        k1 = (k1 + _W1) & _U32
    return c0


def pair_mask_reference(seed: torch.Tensor, B: int, ni: int, nj: int, keep: float) -> torch.Tensor:
    """(B, ni*nj) bool keep mask of pair p = i*nj + j of sample b: exactly the
    bits the kernels draw, on seed's device. `seed` is an int64 tensor (1,)."""
    thr, _ = keep_threshold(keep)
    dev = seed.device
    p = torch.arange(ni * nj, dtype=torch.int64, device=dev)[None, :]
    b = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    bits = philox_word(p.expand(B, -1), b.expand(-1, ni * nj), seed.reshape(1, 1).to(torch.int64))
    return (bits >> 8) < thr


def _pair_scale(seed, B, ni, nj, keep) -> torch.Tensor:
    """(B, ni*nj) fp32 inverted-dropout scale: 1/keep where kept, else 0."""
    _, inv_keep = keep_threshold(keep)
    return pair_mask_reference(seed, B, ni, nj, keep).float() * inv_keep


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _recompute(u, v, s, qa, ws, bs, inject: int):
    """The activations a_0 .. a_{L-1}, each (B, ni*nj, H) in u's dtype."""
    dt = u.dtype
    B, ni, H = u.shape
    nj = v.shape[1]
    a = torch.relu(
        u.float()[:, :, None, :] + v.float()[:, None, :, :] + s.float()[:, None, None, :]
    ).to(dt).reshape(B, ni * nj, H)
    acts = [a]
    for l in range(1, ws.shape[0] + 1):
        pre = a.float() @ ws[l - 1].float() + bs[l - 1].float()
        if l == inject:
            pre = pre + qa.float()[:, None, :]
        a = torch.relu(pre).to(dt)
        acts.append(a)
    return acts


def pairwise_core_reference(u, v, s, qa, ws, bs, inject: int, keep: float = 1.0, seed=None) -> torch.Tensor:
    """out[b] = sum_{i,j} m_bij * g-chain(relu(u[b,i] + v[b,j] + s[b])), fp32 (B, H).

    Math in fp32; each relu output is cast back to u's dtype, as the kernel
    rounds it; under pair dropout the last layer's fp32 rows are scaled
    before the pool, as ``_fwd_kernel`` does. With fp32 inputs and keep = 1
    this is rnet's ``pairwise_core_reference``.
    """
    a = _recompute(u, v, s, qa, ws, bs, inject)[-1].float()
    if keep < 1.0:
        a = a * _pair_scale(seed, u.shape[0], u.shape[1], v.shape[1], keep)[..., None]
    return a.sum(dim=1)


def pairwise_core_bwd_reference(u, v, s, qa, ws, bs, g, inject: int, keep: float = 1.0, seed=None):
    """(du, dv, ds, dqa, dws, dbs), all fp32: the VJP of the pooled core for
    the upstream gradient g (B, H), at ``_bwd_kernel``'s rounding points
    (:147-186): recomputed activations rounded after every relu; dpre_l =
    d * [a_l > 0] rounded to u's dtype for l >= 1; dW_l = a_{l-1}^T dpre_l and
    db_l = sum dpre_l in fp32; dqa = sum dpre at the inject layer; d = dpre_l
    W_l^T in fp32; dpre_0 kept in fp32 for ds, du (sum over j), dv (over i)."""
    dt = u.dtype
    B, ni, H = u.shape
    nj = v.shape[1]
    acts = _recompute(u, v, s, qa, ws, bs, inject)
    d = g.float()[:, None, :].expand(B, ni * nj, H)
    if keep < 1.0:
        d = d * _pair_scale(seed, B, ni, nj, keep)[..., None]
    n_l = ws.shape[0]
    dws, dbs = [None] * n_l, [None] * n_l
    dqa = torch.zeros((B, H), dtype=torch.float32, device=u.device)
    for l in range(n_l, 0, -1):
        dpre = torch.where(acts[l] > 0, d, 0.0).to(dt).float()
        dws[l - 1] = torch.einsum("bpk,bpn->kn", acts[l - 1].float(), dpre)
        dbs[l - 1] = dpre.sum(dim=(0, 1))
        if l == inject:
            dqa = dpre.sum(dim=1)
        d = dpre @ ws[l - 1].float().T
    dpre0 = torch.where(acts[0] > 0, d, 0.0).reshape(B, ni, nj, H)
    return dpre0.sum(dim=2), dpre0.sum(dim=1), dpre0.sum(dim=(1, 2)), dqa, torch.stack(dws), torch.stack(dbs)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def check_kernel_inputs(u, v, s, qa, ws, bs) -> Tuple[int, int, int, int, int]:
    """Validate what the kernels take; (B, ni, nj, H, L) or ValueError."""
    ts = {"u": u, "v": v, "s": s, "qa": qa, "ws": ws, "bs": bs}
    for name, t in ts.items():
        if t.dtype != torch.bfloat16:
            raise ValueError(f"pairwise kernels take bfloat16 tensors; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"pairwise kernels take contiguous tensors; {name} is not")
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
        raise ValueError(f"pairwise kernels need H % 128 == 0, got H={H}")
    if L < 2:
        raise ValueError(f"pairwise kernels need L >= 2 layers, got L={L}")
    if ni < 1 or nj < 1 or not 1 <= B <= 65535:
        raise ValueError(f"pairwise kernels need ni, nj >= 1 and 1 <= B <= 65535; got B={B}, ni={ni}, nj={nj}")
    return B, ni, nj, H, L


def _check_device(name: str, tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name} kernel takes CUDA tensors on one device; got "
            f"{sorted({str(t.device) for t in tensors})}"
        )
    return dev


def _drop_args(pair_keep: float, seed, dev) -> Tuple[int, Optional[int], int, float]:
    """(drop, seed pointer, thr, inv_keep) for the kernels' C interface."""
    if pair_keep >= 1.0:
        return 0, None, 0, 1.0
    if seed is None or seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != dev:
        raise ValueError(f"pair_keep < 1 needs seed as a (1,) int64 tensor on {dev}")
    thr, inv_keep = keep_threshold(pair_keep)
    return 1, seed.data_ptr(), thr, inv_keep


def pairwise_fwd_cuda(u, v, s, qa, ws, bs, *, inject: int, pair_keep: float = 1.0, seed=None) -> torch.Tensor:
    """Launch the forward kernel on the current stream; (B, H) fp32. Raises on
    anything the kernel does not take, on CPU tensors, and on a failed build
    or launch."""
    B, ni, nj, H, L = check_kernel_inputs(u, v, s, qa, ws, bs)
    dev = _check_device(KERNEL, (u, v, s, qa, ws, bs))
    drop, seed_ptr, thr, inv_keep = _drop_args(pair_keep, seed, dev)
    lib = _kernel_lib(KERNEL)
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
            B, ni, nj, H, L, int(inject), drop, seed_ptr, thr, inv_keep, stream,
        )
    _raise_on_error(lib, err, KERNEL)
    launches[KERNEL] += 1
    launches["pair_mask"] += drop
    return out


def pairwise_bwd_cuda(u, v, s, qa, ws, bs, g, *, inject: int, pair_keep: float = 1.0, seed=None):
    """Launch the backward kernel on the current stream for the upstream
    gradient g (B, H) fp32; (du, dv, ds, dqa, dws, dbs) in fp32. Raises as
    ``pairwise_fwd_cuda`` does."""
    B, ni, nj, H, L = check_kernel_inputs(u, v, s, qa, ws, bs)
    if g.dtype != torch.float32 or tuple(g.shape) != (B, H) or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous fp32 ({B}, {H}) tensor; got {g.dtype} {tuple(g.shape)}")
    dev = _check_device(BWD_KERNEL, (u, v, s, qa, ws, bs, g))
    drop, seed_ptr, thr, inv_keep = _drop_args(pair_keep, seed, dev)
    lib = _kernel_lib(BWD_KERNEL)
    bm = lib.rnet_pairwise_bwd_block_rows(H, L, SMEM_LIMIT)
    if bm == 0:
        raise ValueError(f"pairwise_bwd kernel at H={H}, L={L} does not fit {SMEM_LIMIT} B of shared memory")
    grid = min(B, torch.cuda.get_device_properties(dev).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=dev)
    du, dv = torch.zeros((B, ni, H), **f32), torch.zeros((B, nj, H), **f32)
    ds, dqa = torch.zeros((B, H), **f32), torch.zeros((B, H), **f32)
    dws, dbs = torch.empty((L - 1, H, H), **f32), torch.empty((L - 1, H), **f32)
    dw_part, db_part = torch.zeros((grid, L - 1, H, H), **f32), torch.zeros((grid, L - 1, H), **f32)
    scratch = torch.empty((grid, bm, H), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_bwd(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            g.data_ptr(), du.data_ptr(), dv.data_ptr(), ds.data_ptr(), dqa.data_ptr(),
            dws.data_ptr(), dbs.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(), scratch.data_ptr(),
            B, ni, nj, H, L, int(inject), bm, grid, drop, seed_ptr, thr, inv_keep, stream,
        )
    _raise_on_error(lib, err, BWD_KERNEL)
    launches[BWD_KERNEL] += 1
    launches["pair_mask"] += drop
    return du, dv, ds, dqa, dws, dbs


def pair_mask_cuda(seed: torch.Tensor, B: int, ni: int, nj: int, keep: float) -> torch.Tensor:
    """The kernels' keep mask (B, ni*nj) bool, written by the mask kernel of
    ``pairwise_fwd.cu`` from philox.cuh (the bits both pairwise kernels draw)."""
    if keep >= 1.0:
        raise ValueError("pair_mask_cuda needs pair_keep < 1")
    dev = _check_device("pair_mask", (seed,))
    _, seed_ptr, thr, _ = _drop_args(keep, seed, dev)
    lib = _kernel_lib(KERNEL)
    mask = torch.empty((B, ni * nj), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pair_mask(mask.data_ptr(), B, ni * nj, seed_ptr, thr, stream)
    _raise_on_error(lib, err, "pair_mask")
    launches["pair_mask"] += 1
    return mask.bool()


# ---------------------------------------------------------------------------
# Autograd: the custom VJP of rnet's _make_core
# ---------------------------------------------------------------------------


class _PairwiseCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, v, s, qa, ws, bs, inject: int, keep: float, seed):
        ctx.save_for_backward(u, v, s, qa, ws, bs, seed)
        ctx.inject, ctx.keep = inject, keep
        if u.device.type == "cpu":
            return pairwise_core_reference(u, v, s, qa, ws, bs, inject, keep, seed)
        return pairwise_fwd_cuda(u, v, s, qa, ws, bs, inject=inject, pair_keep=keep, seed=seed)

    @staticmethod
    def backward(ctx, g):
        u, v, s, qa, ws, bs, seed = ctx.saved_tensors
        g = g.float().contiguous()
        if u.device.type == "cpu":
            grads = pairwise_core_bwd_reference(u, v, s, qa, ws, bs, g, ctx.inject, ctx.keep, seed)
        else:
            grads = pairwise_bwd_cuda(u, v, s, qa, ws, bs, g, inject=ctx.inject, pair_keep=ctx.keep, seed=seed)
        # each gradient in its input's dtype, as _make_core.bwd returns them
        return (*(d.to(t.dtype) for d, t in zip(grads, (u, v, s, qa, ws, bs))), None, None, None)


def pairwise_core(u, v, s, qa, ws, bs, *, inject: int, pair_keep: float = 1.0, seed=None) -> torch.Tensor:
    """Differentiable pooled core: the plain versions for CPU tensors, the
    kernels for CUDA ones. pair_keep < 1 turns on pair dropout with `seed`,
    a (1,) int64 tensor on the inputs' device (fresh per step)."""
    if pair_keep < 1.0 and seed is None:
        raise ValueError("pair_keep < 1 needs a seed: a (1,) int64 tensor")
    return _PairwiseCore.apply(u, v, s, qa, ws, bs, int(inject), float(pair_keep), seed)


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


def fused_pairwise_g(
    x, q, gw, gb, *, inject: int, dtype=torch.bfloat16, pair_keep: float = 1.0, seed=None
) -> torch.Tensor:
    """Pooled g_theta over all object pairs; (B, g_out) fp32, differentiable
    in x, q, gw and gb."""
    u, v, s, qa, ws, bs = _project_pair_inputs(x, q, gw, gb, inject, dtype)
    return pairwise_core(u, v, s, qa, ws, bs, inject=inject, pair_keep=pair_keep, seed=seed)
