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
  its launch count in ``launches``. ``tile_plan`` decides how a kernel
  covers a shape (rows per block, W ring stages, shared memory, grid) and
  ``pack_weight_chunks`` lays W out as the kernels stream it; both are pure
  and tested on the CPU. A ``phases`` buffer selects the phase-timing build
  (``PHASE_DEFINES``).
* ``pairwise_core`` — a ``torch.autograd.Function`` (as ``_make_core``'s
  custom VJP): CPU tensors take the plain versions, CUDA tensors the kernels
  or an exception. It saves only its inputs and the seed; the backward
  recomputes the n^2 activations. There is no fallback from the card to the
  plain versions.
* ``fused_pairwise_g`` — objects + question -> pooled g (B, H) through
  ``_project_pair_inputs`` and ``pairwise_core`` (or, with ``int8=True``,
  ``pairwise_core_int8``).

The int8 inference path (rnet's ``pairwise_core_int8`` and
``_fwd_pallas_int8``): ``activation_scales`` calibrates per-layer activation
scales on a strided subsample of the batch, ``quantize_int8`` folds every
scale outside the kernel (int8 weights, inputs prescaled into layer 0's
int8 domain, one fp32 multiplier per layer), and
``pairwise_core_int8_reference`` / ``pairwise_fwd_int8_cuda`` (the kernel of
``csrc/pairwise_fwd_int8.cu``) run the int8 g-chain. ``int8_clip_fractions``
and ``pairwise_clip_fractions`` report the share of activations the
calibration would clip. The sharded island comes with a later slice
(ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import math
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from . import build

KERNEL = "pairwise_fwd"
BWD_KERNEL = "pairwise_bwd"
INT8_KERNEL = "pairwise_fwd_int8"
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
INT8_MARGIN = 1.2  # calibration margin over the subsample's activation maxima
# Largest width at which the plain int8 version's fp32 matmul of int8 codes
# is exact: every partial sum is an integer of magnitude <= 127 * 127 * H < 2^24.
INT8_EXACT_MAX_H = 1040

# Kernel launches since the last reset_launches() (the main-path proof in
# chip_smoke.py). "pair_mask" counts the launches that drew Philox pair-mask
# bits: a forward or backward launch with pair_keep < 1, or the mask kernel.
launches = {KERNEL: 0, BWD_KERNEL: 0, "pair_mask": 0, INT8_KERNEL: 0}

_libs = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the C interface of library `name` (KERNEL, BWD_KERNEL or INT8_KERNEL)."""
    vp, i32, u32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_longlong
    if name == KERNEL:
        lib.rnet_pairwise_fwd.argtypes = [vp] * 8 + [i32] * 9 + [i64, i32, vp, u32, f32, vp, vp]
        lib.rnet_pairwise_fwd.restype = i32
        lib.rnet_pair_mask.argtypes = [vp, i32, i32, vp, u32, vp]
        lib.rnet_pair_mask.restype = i32
    elif name == INT8_KERNEL:
        lib.rnet_pairwise_fwd_int8.argtypes = [vp] * 9 + [i32] * 6 + [vp]
        lib.rnet_pairwise_fwd_int8.restype = i32
        lib.rnet_pairwise_fwd_int8_block_rows.argtypes = []
        lib.rnet_pairwise_fwd_int8_block_rows.restype = i32
        lib.rnet_pairwise_fwd_int8_smem_bytes.argtypes = [i32]
        lib.rnet_pairwise_fwd_int8_smem_bytes.restype = i64
    else:
        lib.rnet_pairwise_bwd.argtypes = [vp] * 16 + [i32] * 10 + [i64, i32, vp, u32, f32, vp, vp]
        lib.rnet_pairwise_bwd.restype = i32
    lib.rnet_cuda_error_string.argtypes = [i32]
    lib.rnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_lib(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    key = (name, tuple(defines))
    lib = _libs.get(key)
    if lib is None:
        lib = _libs[key] = _bind(build.load(name, defines), name)
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
# Tile plan and weight packing of the bf16 kernels (csrc/pairwise_chain.cuh)
# ---------------------------------------------------------------------------

CHUNK_BYTES = 8192  # one streamed W chunk
WG_ROWS = 64  # pair rows of one consumer warpgroup (wgmma's M)
TILE_N = 128  # output columns of one wgmma tile, the rows of a W chunk
MIN_STAGES, MAX_STAGES = 3, 8  # depth of the W chunk ring
H100_SMS = 132
# The phase-timing build: -DRNET_PHASE_TIMES makes both kernels sum clock64()
# cycles per phase and CTA into a (grid, PHASE_SLOTS) int64 buffer.
PHASE_DEFINES = ("RNET_PHASE_TIMES",)
PHASE_SLOTS = 8
FWD_PHASES = ("products", "epilogues", "pool", "feed_wait", "a0", "barriers")
BWD_PHASES = ("recompute", "dW_products", "dW_flush", "d_products", "column_pass", "feed_wait", "a0", "barriers")


@dataclass(frozen=True)
class TilePlan:
    """How a bf16 pairwise kernel covers (B, ni, nj, H, L): ``wgs`` consumer
    warpgroups of 64 pair rows per CTA (``bm`` rows a block), a ring of
    ``stages`` 8 KB W chunks, ``slots`` activation tiles of bm x H bf16,
    ``grid`` persistent CTAs and ``smem`` bytes of shared memory each. The C
    launchers check it and refuse what they cannot take."""

    kind: str  # "fwd" or "bwd"
    B: int
    ni: int
    nj: int
    H: int
    L: int
    wgs: int
    stages: int
    slots: int
    grid: int
    smem: int

    @property
    def bm(self) -> int:
        return WG_ROWS * self.wgs

    @property
    def nblk(self) -> int:
        """Row blocks per sample; the last one is ragged when bm does not divide ni*nj."""
        return -(-self.ni * self.nj // self.bm)

    def blocks(self, cta: int):
        """(b, first pair row, valid rows) of every block CTA `cta` runs, in
        its order: the forward walks tiles t = cta, cta + grid, ... (t = b *
        nblk + block); the backward owns samples b = cta, cta + grid, ... and
        walks all their blocks."""
        npairs = self.ni * self.nj
        if self.kind == "fwd":
            tiles = range(cta, self.B * self.nblk, self.grid)
            return [(t // self.nblk, t % self.nblk * self.bm, min(self.bm, npairs - t % self.nblk * self.bm))
                    for t in tiles]
        return [(b, k * self.bm, min(self.bm, npairs - k * self.bm))
                for b in range(cta, self.B, self.grid) for k in range(self.nblk)]


def smem_bytes(kind: str, bm: int, H: int, L: int, slots: int, stages: int) -> int:
    """Shared memory of a CTA: the activation slots, the W ring, its full and
    empty mbarriers (8 B each) and a per-row fp32 scale; the forward adds the
    biases in fp32 and one row of H column sums per warp (bm / 16 warps), the
    backward a core matrix of ones."""
    n = slots * bm * H * 2 + stages * (CHUNK_BYTES + 16) + bm * 4
    if kind == "fwd":
        n += (L - 1) * H * 4 + bm // 16 * H * 4
    else:
        n += 128  # one 8 x 8 core matrix of ones (the column sums' wgmma operand)
    return n


def tile_plan(kind: str, B: int, ni: int, nj: int, H: int, L: int, sms: int = H100_SMS) -> TilePlan:
    """The tile plan of the forward (``kind="fwd"``) or backward kernel.

    Two warpgroups (128 rows a block) up to H=256; one at H > 256, where the
    activation tiles of 128 rows would not leave room for the ring, and in
    the forward when 128-row tiles would not give every SM one (serving
    buckets). The forward keeps two activation slots (ping-pong), the
    backward max(3, L-1). The ring takes what shared memory is left, up to
    MAX_STAGES. ValueError if the plan does not fit."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"kind must be 'fwd' or 'bwd', got {kind!r}")
    if H % 128 != 0:
        raise ValueError(f"the pairwise kernels need H % 128 == 0, got H={H}")
    wgs = 1 if H > 256 else 2
    if kind == "fwd" and wgs == 2 and B * -(-ni * nj // (2 * WG_ROWS)) < sms:
        wgs = 1
    bm = WG_ROWS * wgs
    slots = 2 if kind == "fwd" else max(3, L - 1)
    stages = min(MAX_STAGES, (SMEM_LIMIT - smem_bytes(kind, bm, H, L, slots, 0)) // (CHUNK_BYTES + 16))
    if stages < MIN_STAGES:
        raise ValueError(
            f"pairwise_{kind} kernel at H={H}, L={L} does not fit {SMEM_LIMIT} B of shared memory "
            f"({slots} activation tiles of {bm} x {H} bf16 and {MIN_STAGES} W stages)"
        )
    nblk = -(-ni * nj // bm)
    grid = min(B * nblk if kind == "fwd" else B, sms)
    return TilePlan(kind, B, ni, nj, H, L, wgs, stages, slots, grid, smem_bytes(kind, bm, H, L, slots, stages))


def pack_weight_chunks(x: torch.Tensor) -> torch.Tensor:
    """x (L-1, N, K), row n holding B^T's row (the K-major B operand of
    ``a . B``), packed as the kernels stream it: per layer, per tile of
    nt = TILE_N rows, per depth chunk of kc = 4096 / nt columns, one 8 KB
    chunk of 8 x 8 core matrices (8 rows of 8 contiguous bf16), the depth's
    core matrices innermost. Returns a contiguous (L-1, N/nt, K/kc, nt/8,
    kc/8, 8, 8)."""
    n_l, N, K = x.shape
    nt = TILE_N
    kc = CHUNK_BYTES // 2 // nt
    y = x.reshape(n_l, N // nt, nt // 8, 8, K // kc, kc // 8, 8)
    return y.permute(0, 1, 4, 2, 5, 3, 6).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_core_inputs(what: str, ts: dict, dtypes: dict) -> Tuple[int, int, int, int, int]:
    """Dtype, contiguity and shape checks of a pairwise kernel's inputs: ``ts``
    maps u, v, s, qa, the stacked weights (``ws`` or ``w8``, (L-1, H, H)), the
    biases ``bs`` and the int8 multipliers ``m`` to tensors; (B, ni, nj, H,
    L) or ValueError."""
    for name, t in ts.items():
        if t.dtype != dtypes[name]:
            raise ValueError(f"{what}: {name} must be {dtypes[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous; {name} is not")
    u, v = ts["u"], ts["v"]
    if u.dim() != 3 or v.dim() != 3:
        raise ValueError(f"u and v must be (B, n, H); got {tuple(u.shape)} and {tuple(v.shape)}")
    B, ni, H = u.shape
    nj = v.shape[1]
    L = ts["ws" if "ws" in ts else "w8"].shape[0] + 1
    want = {"v": (B, nj, H), "s": (B, H), "qa": (B, H), "ws": (L - 1, H, H), "w8": (L - 1, H, H),
            "bs": (L - 1, H), "m": (L - 1,)}
    for name, t in ts.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    if H % 128 != 0:
        raise ValueError(f"{what}: H % 128 == 0 is required, got H={H}")
    if L < 2:
        raise ValueError(f"{what}: L >= 2 layers are required, got L={L}")
    if ni < 1 or nj < 1 or not 1 <= B <= 65535:
        raise ValueError(f"{what}: ni, nj >= 1 and 1 <= B <= 65535 are required; got B={B}, ni={ni}, nj={nj}")
    return B, ni, nj, H, L


def check_kernel_inputs(u, v, s, qa, ws, bs) -> Tuple[int, int, int, int, int]:
    """Validate what the bf16 kernels take; (B, ni, nj, H, L) or ValueError."""
    ts = {"u": u, "v": v, "s": s, "qa": qa, "ws": ws, "bs": bs}
    return _check_core_inputs("the pairwise kernels", ts, dict.fromkeys(ts, torch.bfloat16))


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


def _phase_buffer(phases, grid: int, dev) -> Tuple[Optional[int], Tuple[str, ...]]:
    """(pointer, build defines) for an optional per-CTA phase-cycle buffer."""
    if phases is None:
        return None, ()
    if phases.dtype != torch.int64 or tuple(phases.shape) != (grid, PHASE_SLOTS) or phases.device != dev:
        raise ValueError(f"phases must be an int64 ({grid}, {PHASE_SLOTS}) tensor on {dev}")
    return phases.data_ptr(), PHASE_DEFINES


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def pairwise_fwd_cuda(u, v, s, qa, ws, bs, *, inject: int, pair_keep: float = 1.0, seed=None,
                      phases=None) -> torch.Tensor:
    """Launch the forward kernel on the current stream; (B, H) fp32. Raises on
    anything the kernel does not take, on CPU tensors, and on a failed build
    or launch. ``phases``, an int64 (grid, PHASE_SLOTS) tensor for the grid of
    ``tile_plan("fwd", ...)``, selects the build with -DRNET_PHASE_TIMES,
    which sums clock64() cycles per FWD_PHASES entry and CTA into it."""
    B, ni, nj, H, L = check_kernel_inputs(u, v, s, qa, ws, bs)
    dev = _check_device(KERNEL, (u, v, s, qa, ws, bs))
    drop, seed_ptr, thr, inv_keep = _drop_args(pair_keep, seed, dev)
    plan = tile_plan("fwd", B, ni, nj, H, L, _sms(dev))
    phase_ptr, defines = _phase_buffer(phases, plan.grid, dev)
    lib = _kernel_lib(KERNEL, defines)
    chunks = pack_weight_chunks(ws.transpose(1, 2))
    partial = torch.empty((B, plan.nblk * plan.wgs, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_fwd(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), chunks.data_ptr(), bs.data_ptr(),
            partial.data_ptr(), out.data_ptr(), B, ni, nj, H, L, int(inject), plan.wgs, plan.stages,
            plan.grid, plan.smem, drop, seed_ptr, thr, inv_keep, phase_ptr, stream,
        )
    _raise_on_error(lib, err, KERNEL)
    launches[KERNEL] += 1
    launches["pair_mask"] += drop
    return out


def pairwise_bwd_cuda(u, v, s, qa, ws, bs, g, *, inject: int, pair_keep: float = 1.0, seed=None, phases=None):
    """Launch the backward kernel on the current stream for the upstream
    gradient g (B, H) fp32; (du, dv, ds, dqa, dws, dbs) in fp32. Raises as
    ``pairwise_fwd_cuda`` does; ``phases`` as there, for the grid of
    ``tile_plan("bwd", ...)`` and the BWD_PHASES."""
    B, ni, nj, H, L = check_kernel_inputs(u, v, s, qa, ws, bs)
    if g.dtype != torch.float32 or tuple(g.shape) != (B, H) or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous fp32 ({B}, {H}) tensor; got {g.dtype} {tuple(g.shape)}")
    dev = _check_device(BWD_KERNEL, (u, v, s, qa, ws, bs, g))
    drop, seed_ptr, thr, inv_keep = _drop_args(pair_keep, seed, dev)
    plan = tile_plan("bwd", B, ni, nj, H, L, _sms(dev))
    phase_ptr, defines = _phase_buffer(phases, plan.grid, dev)
    lib = _kernel_lib(BWD_KERNEL, defines)
    wt_chunks = pack_weight_chunks(ws.transpose(1, 2))
    w_chunks = pack_weight_chunks(ws)
    f32 = dict(dtype=torch.float32, device=dev)
    du, dv = torch.zeros((B, ni, H), **f32), torch.zeros((B, nj, H), **f32)
    ds, dqa = torch.zeros((B, H), **f32), torch.zeros((B, H), **f32)
    dws, dbs = torch.empty((L - 1, H, H), **f32), torch.empty((L - 1, H), **f32)
    dw_part = torch.zeros((plan.grid, L - 1, H, H), **f32)
    db_part = torch.zeros((plan.grid, L - 1, H), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_bwd(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), wt_chunks.data_ptr(), w_chunks.data_ptr(),
            bs.data_ptr(), g.data_ptr(), du.data_ptr(), dv.data_ptr(), ds.data_ptr(), dqa.data_ptr(),
            dws.data_ptr(), dbs.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(), B, ni, nj, H, L, int(inject),
            plan.wgs, plan.slots, plan.stages, plan.grid, plan.smem, drop, seed_ptr, thr, inv_keep,
            phase_ptr, stream,
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
# Int8 inference path
# ---------------------------------------------------------------------------


def _subsample(u, v, s, qa, probe: bool):
    """The calibration subsample of ``_activation_scales`` (:253-260) in fp32:
    <= 4 samples x <= 16 i- and j-objects, ceil-strided over the batch and
    both object axes (a head subsample would miss the live maxima of sorted
    batches); ``probe`` starts each axis half a stride later, as
    ``int8_clip_fractions`` does, to reach rows the calibration never saw."""
    nb, no = min(u.shape[0], 4), min(u.shape[1], 16)
    sb, so, sv = -(-u.shape[0] // nb), -(-u.shape[1] // no), -(-v.shape[1] // no)
    ob, oo, ov = (sb // 2, so // 2, sv // 2) if probe else (0, 0, 0)
    ub = u[ob::sb][:nb, oo::so][:, :no].float()
    vb = v[ob::sb][:nb, ov::sv][:, :no].float()
    return ub, vb, s[ob::sb][:nb].float(), qa[ob::sb][:nb].float()


def _subsample_acts(ub, vb, sb, qb, ws, bs, inject: int):
    """The fp32 activations of layers 0 .. L-2 on a subsample (the points the
    int8 chain quantizes), each (rows, pairs, H) — rows is the ACTUAL number of
    strided samples (B=5 gives 3)."""
    a = torch.relu(ub[:, :, None, :] + vb[:, None, :, :] + sb[:, None, None, :])
    a = a.reshape(ub.shape[0], -1, ub.shape[-1])
    acts = [a]
    for l in range(1, ws.shape[0]):
        pre = a @ ws[l - 1].float() + bs[l - 1].float()
        if l == inject:
            pre = pre + qb[:, None, :]
        a = torch.relu(pre)
        acts.append(a)
    return acts


def activation_scales(u, v, s, qa, ws, bs, inject: int, margin: float = INT8_MARGIN) -> torch.Tensor:
    """Per-layer activation scales (L-1,) fp32 (rnet's ``_activation_scales``):
    the maxima of the fp32 chain on the calibration subsample, floored at
    1e-6, times ``margin`` (values beyond it clip at 127)."""
    acts = _subsample_acts(*_subsample(u, v, s, qa, probe=False), ws, bs, inject)
    return torch.stack([a.amax() for a in acts]).clamp_min(1e-6) * margin


def int8_clip_fractions(u, v, s, qa, ws, bs, inject: int, margin: float = INT8_MARGIN) -> torch.Tensor:
    """Calibration-drift diagnostic (L-1,): per layer, the fraction of probe
    activations above the scale ``activation_scales`` gives this batch, i.e.
    that the int8 chain would clip at 127. When B <= 4 and both object axes
    are <= 16 the probe is the calibration subsample, which then covers the
    whole input: with margin >= 1 the result is exactly 0."""
    c = activation_scales(u, v, s, qa, ws, bs, inject, margin=margin)
    acts = _subsample_acts(*_subsample(u, v, s, qa, probe=True), ws, bs, inject)
    return torch.stack([(a > c[l]).float().mean() for l, a in enumerate(acts)])


def quantize_int8(u, v, s, qa, ws, bs, inject: int):
    """Fold every scale of the int8 chain outside the kernel, as
    ``_fwd_pallas_int8`` (:333-352) does, in its dtypes; returns
    (u, v, s, qa_f, w8, m, b_f):

    * sw = max|W_l| in ws's dtype (floored at 1e-9), w8 = clip(round(W_l /
      sw * 127), +-127) int8 (symmetric, per layer);
    * c = ``activation_scales``; u, v, s scaled by 127 / c_0 in fp32 and cast
      back to their dtype (layer 0's int8 domain);
    * requant = [127 / c_1, ..., 127 / c_{L-2}, 1] (the last layer dequantizes
      to real values), m = c * (sw / 127 in ws's dtype) / 127 * requant and
      b_f = b * requant in fp32; qa scaled by requant[inject - 1] when
      0 < inject < L.
    """
    L = ws.shape[0] + 1
    sw = ws.abs().amax(dim=(1, 2)).clamp_min(1e-9)
    w8 = torch.round(ws.float() / sw.float()[:, None, None] * 127.0).clamp(-127, 127).to(torch.int8)
    c = activation_scales(u, v, s, qa, ws, bs, inject)
    # 127 / c as a true division: torch computes `127.0 / c` as 127 * (1 / c),
    # which can differ from it by an ulp
    q127 = torch.full_like(c, 127.0) / c
    u, v, s = ((t.float() * q127[0]).to(t.dtype) for t in (u, v, s))
    requant = torch.cat([q127[1:], torch.ones(1, dtype=torch.float32, device=c.device)])
    m = (c * (sw / 127.0).float() / 127.0) * requant
    b_f = bs.float() * requant[:, None]
    qa_f = qa.float()
    if 0 < inject < L:
        qa_f = qa_f * requant[inject - 1]
    return u.contiguous(), v.contiguous(), s.contiguous(), qa_f.contiguous(), w8, m, b_f


def _requant(a: torch.Tensor) -> torch.Tensor:
    """int8(min(a + 0.5, 127)); the cast truncates as astype does (a >= 0)."""
    return torch.clamp(a + 0.5, max=127.0).to(torch.int8)


def pairwise_core_int8_reference(u, v, s, qa, w8, m, bs, inject: int) -> torch.Tensor:
    """The plain version of the int8 kernel (rnet's ``_fwd_kernel_int8``,
    :190-238) on folded inputs; (B, H) fp32:

        a0 = int8(min(relu((u + v) + s) + 0.5, 127))             (fp32 math)
        pre = fma(float(a8 . w8_l), m_l, b_l) [+ qa at the inject layer]
        a = relu(pre); requantized except at the last layer, which is pooled
        in fp32.

    ``float(acc) * m_l + b_l`` is rounded once, as one fused multiply-add:
    XLA contracts it so when it compiles rnet's kernel (interpret mode on the
    CPU), and two roundings move a few int8 codes across a rounding boundary,
    past the 1e-5 agreement of tests/test_torch_int8.py. The fma is
    emulated in float64: the product of an integer below 2^24 and an fp32
    value is exact there, and rounding the float64 sum to fp32 gives the
    fused result unless that sum was itself rounded onto an fp32 tie (double
    rounding). The int8 product runs as an fp32 matmul of the int8
    codes: exact, since every partial sum is an integer below 2^24 for
    H <= INT8_EXACT_MAX_H (and codes of at most 127 are exact in TF32 too)."""
    B, ni, H = u.shape
    nj = v.shape[1]
    if H > INT8_EXACT_MAX_H:
        raise ValueError(f"the plain int8 version is exact only for H <= {INT8_EXACT_MAX_H}, got H={H}")
    a = torch.relu(u.float()[:, :, None, :] + v.float()[:, None, :, :] + s.float()[:, None, None, :])
    a8 = _requant(a.reshape(B, ni * nj, H))
    n_l = w8.shape[0]
    for l in range(1, n_l + 1):
        acc = a8.float() @ w8[l - 1].float()
        pre = (acc.double() * m[l - 1].double() + bs[l - 1].double()).float()
        if l == inject:
            pre = pre + qa[:, None, :]
        a = torch.relu(pre)
        if l < n_l:
            a8 = _requant(a)
    return a.sum(dim=1)


def check_int8_inputs(u, v, s, qa, w8, m, bs) -> Tuple[int, int, int, int, int]:
    """Validate what the int8 kernel takes; (B, ni, nj, H, L), or
    NotImplementedError for fp32 u/v/s and ValueError for anything else."""
    if any(t.dtype == torch.float32 for t in (u, v, s)):
        raise NotImplementedError(
            "the int8 kernel takes bfloat16 u, v, s: int8 with fp32 compute on the "
            "card is not ported (ROADMAP.md)"
        )
    f32, bf16 = torch.float32, torch.bfloat16
    dtypes = {"u": bf16, "v": bf16, "s": bf16, "qa": f32, "w8": torch.int8, "m": f32, "bs": f32}
    ts = {"u": u, "v": v, "s": s, "qa": qa, "w8": w8, "m": m, "bs": bs}
    B, ni, nj, H, L = _check_core_inputs("the int8 kernel", ts, dtypes)
    if any(t.data_ptr() % 16 for t in (u, v, s)):
        raise ValueError("the int8 kernel reads u, v, s in 16-byte vectors: their storage must be 16-byte aligned")
    return B, ni, nj, H, L


def pairwise_fwd_int8_cuda(u, v, s, qa, w8, m, bs, *, inject: int) -> torch.Tensor:
    """Launch the int8 kernel on the current stream for folded inputs (those
    of ``quantize_int8``); (B, H) fp32. Raises on anything the kernel does
    not take, on CPU tensors, and on a failed build or launch."""
    B, ni, nj, H, L = check_int8_inputs(u, v, s, qa, w8, m, bs)
    dev = _check_device(INT8_KERNEL, (u, v, s, qa, w8, m, bs))
    lib = _kernel_lib(INT8_KERNEL)
    smem = lib.rnet_pairwise_fwd_int8_smem_bytes(H)
    if smem > SMEM_LIMIT:
        raise ValueError(f"pairwise_fwd_int8 kernel at H={H} needs {smem} B of shared memory (> {SMEM_LIMIT})")
    nblk = -(-ni * nj // lib.rnet_pairwise_fwd_int8_block_rows())
    w8t = w8.transpose(1, 2).contiguous()  # row n = column n of W_l: the kernel's B-fragment layout
    partial = torch.empty((B, nblk, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_fwd_int8(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), w8t.data_ptr(), m.data_ptr(),
            bs.data_ptr(), partial.data_ptr(), out.data_ptr(), B, ni, nj, H, L, int(inject), stream,
        )
    _raise_on_error(lib, err, INT8_KERNEL)
    launches[INT8_KERNEL] += 1
    return out


def int8_supported(ni: int, nj: int, H: int, L: int) -> bool:
    """rnet's ``_supported`` (:449-451) as a shape predicate: H % 128 == 0,
    L >= 2, ni a multiple of 8 and nj either <= 128 or a multiple of 128
    (``_tiles``' tiling, without its model of the TPU's VMEM)."""
    tj = nj if nj <= 128 else 128
    return H % 128 == 0 and L >= 2 and ni % 8 == 0 and tj > 0 and nj % tj == 0


def pairwise_core_int8(u, v, s, qa, ws, bs, *, inject: int) -> torch.Tensor:
    """Int8 inference core (no gradient): calibrate, fold, then the plain
    version for CPU tensors or the kernel for CUDA tensors. On shapes rnet's
    kernel does not take it warns ("NOT int8"), as rnet's
    ``pairwise_core_int8`` does, and runs the fp core ``pairwise_core``
    instead (the bf16 kernel on the card, the plain version on the CPU)."""
    ni, nj, H, L = u.shape[1], v.shape[1], u.shape[-1], ws.shape[0] + 1
    with torch.no_grad():
        if not int8_supported(ni, nj, H, L):
            warnings.warn(
                f"pallas_int8 requested but the shape is unsupported by the int8 kernel (ni={ni}, "
                f"nj={nj}, H={H}, L={L}: needs H%128==0, L>=2 and tileable object counts); running "
                "the fp pairwise core instead — reported numbers are NOT int8",
                stacklevel=2,
            )
            return pairwise_core(u, v, s, qa, ws, bs, inject=inject)
        folded = quantize_int8(u, v, s, qa, ws, bs, inject)
        if u.device.type == "cpu":
            return pairwise_core_int8_reference(*folded, inject=inject)
        return pairwise_fwd_int8_cuda(*folded, inject=inject)


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


@torch.no_grad()
def pairwise_clip_fractions(x, q, gw, gb, *, inject: int, dtype=torch.bfloat16, margin: float = INT8_MARGIN):
    """``int8_clip_fractions`` from objects + question: per layer, the share
    of probe activations this batch's int8 scales would clip (the drift
    report ``python -m rnet_torch.evaluate --rl-impl pallas_int8`` prints)."""
    u, v, s, qa, ws, bs = _project_pair_inputs(x, q, gw, gb, inject, dtype)
    return int8_clip_fractions(u, v, s, qa, ws, bs, inject, margin=margin)


def fused_pairwise_g(
    x, q, gw, gb, *, inject: int, dtype=torch.bfloat16, pair_keep: float = 1.0, seed=None, int8: bool = False
) -> torch.Tensor:
    """Pooled g_theta over all object pairs; (B, g_out) fp32, differentiable
    in x, q, gw and gb — except with ``int8=True`` (inference only:
    ``pairwise_core_int8``, no gradient)."""
    if int8 and pair_keep < 1.0:
        raise ValueError("int8 is inference-only; pair dropout cannot be active")
    u, v, s, qa, ws, bs = _project_pair_inputs(x, q, gw, gb, inject, dtype)
    if int8:
        return pairwise_core_int8(u, v, s, qa, ws, bs, inject=inject)
    return pairwise_core(u, v, s, qa, ws, bs, inject=inject, pair_keep=pair_keep, seed=seed)
