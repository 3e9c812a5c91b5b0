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
  wrappers of ``csrc/pairwise_fwd.cu`` and ``csrc/pairwise_bwd.cu`` (bf16
  inputs) and of ``csrc/pairwise_f32.cu`` (fp32 inputs: the same function
  in fp32, 3xTF32 products), each with its launch count in ``launches``.
  ``tile_plan`` decides how a kernel covers a shape (rows per block, W ring
  stages, shared memory, grid; ``esize=4`` for the fp32 kernels),
  ``pack_weight_chunks`` lays W out as the bf16 and int8 kernels stream it
  and ``pack_f32_weights`` splits W into tf32 hi / lo stages for the fp32
  ring kernels (``pair_halves`` first cuts W for each CTA of the H=512
  kernels' clusters of two; ``dw_splits`` splits the rows of the
  backward's dW GEMM in bf16); all are pure and tested on the CPU. A ``phases`` buffer
  selects the phase-timing build (``PHASE_DEFINES``) of the bf16, int8 and
  fp32 ring kernels.
* ``pairwise_core`` — a ``torch.autograd.Function`` (as ``_make_core``'s
  custom VJP): CPU tensors take the plain versions, CUDA tensors the kernels
  or an exception. It saves only its inputs and the seed; the backward
  recomputes the n^2 activations. There is no fallback from the card to the
  plain versions.
* ``fused_pairwise_g`` — objects + question -> pooled g (B, H) through
  ``_project_pair_inputs`` and ``pairwise_core`` (or, with ``int8=True``,
  ``pairwise_core_int8``), by way of ``pairwise_core_sharded``.

The int8 inference path (rnet's ``pairwise_core_int8`` and
``_fwd_pallas_int8``): ``activation_scales`` calibrates per-layer activation
scales on a strided subsample of the batch, ``quantize_int8`` folds every
scale outside the kernel (int8 weights, inputs prescaled into layer 0's
int8 domain, one fp32 multiplier per layer), and
``pairwise_core_int8_reference`` / ``pairwise_fwd_int8_cuda`` (the kernel of
``csrc/pairwise_fwd_int8.cu``) run the int8 g-chain. ``int8_clip_fractions``
and ``pairwise_clip_fractions`` report the share of activations the
calibration would clip.

Under a mesh (``rnet_torch/parallel/mesh.py``) ``pairwise_core_sharded``
is rnet's shard_map island: each rank holds its ``data`` slice of the
batch, runs the core (or the int8 core) on its ``pairs`` shard of u's
i-rows through the same wrappers, and the pooled partial sums are
all-reduced over ``pairs``.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..parallel.mesh import SHARD_SEED_STRIDE, Mesh, all_reduce_flat, reduce_pairs
from . import build

KERNEL = "pairwise_fwd"
BWD_KERNEL = "pairwise_bwd"
INT8_KERNEL = "pairwise_fwd_int8"
F32_KERNEL = "pairwise_fwd_f32"
F32_BWD_KERNEL = "pairwise_bwd_f32"
F32_LIB = "pairwise_f32"  # csrc/pairwise_f32.cu: both fp32 kernels
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
INT8_MARGIN = 1.2  # calibration margin over the subsample's activation maxima
# Largest width at which the plain int8 version's fp32 matmul of int8 codes
# is exact: every partial sum is an integer of magnitude <= 127 * 127 * H < 2^24.
INT8_EXACT_MAX_H = 1040

# Kernel launches since the last reset_launches() (the main-path proof in
# chip_smoke.py). "pair_mask" counts the launches that drew Philox pair-mask
# bits: a forward or backward launch with pair_keep < 1, or the mask kernel.
launches = {KERNEL: 0, BWD_KERNEL: 0, "pair_mask": 0, INT8_KERNEL: 0, F32_KERNEL: 0, F32_BWD_KERNEL: 0}

_libs = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the C interface of library `name` (KERNEL, BWD_KERNEL, INT8_KERNEL or F32_LIB)."""
    vp, i32, u32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_longlong
    if name == KERNEL:
        lib.rnet_pairwise_fwd.argtypes = [vp] * 8 + [i32] * 11 + [i64, i32, vp, u32, f32, vp, vp]
        lib.rnet_pairwise_fwd.restype = i32
        lib.rnet_pair_mask.argtypes = [vp, i32, i32, vp, u32, vp]
        lib.rnet_pair_mask.restype = i32
    elif name == INT8_KERNEL:
        lib.rnet_pairwise_fwd_int8.argtypes = [vp] * 9 + [i32] * 9 + [i64, i32, vp, vp]
        lib.rnet_pairwise_fwd_int8.restype = i32
    elif name == F32_LIB:
        lib.rnet_pairwise_fwd_f32.argtypes = [vp] * 9 + [i32] * 12 + [i64, i32, vp, u32, f32, vp, vp]
        lib.rnet_pairwise_fwd_f32.restype = i32
        lib.rnet_pairwise_bwd_f32.argtypes = [vp] * 19 + [i32] * 12 + [i64, i32, vp, u32, f32, vp, vp]
        lib.rnet_pairwise_bwd_f32.restype = i32
    else:
        lib.rnet_pairwise_bwd.argtypes = [vp] * 17 + [i32] * 12 + [i64, i32, vp, u32, f32, vp, vp]
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
# Tile plan and weight packing of the kernels on csrc/pairwise_chain.cuh
# ---------------------------------------------------------------------------

CHUNK_BYTES = 8192  # one streamed W chunk
WG_ROWS = 64  # pair rows of one consumer warpgroup (wgmma's M)
TILE_N = 128  # output columns of one wgmma tile, the rows of a W chunk
MIN_STAGES, MAX_STAGES = 3, 8  # depth of the W chunk ring
INT8_MAX_WGS = 3  # consumer warpgroups of an int8 CTA, each on its own tile
# The fp32 kernels (csrc/pairwise_f32.cu). At H = F32_RING_WIDTH the ring
# kernels: blocks of F32_RING_ROWS[kind] pair rows, two consumer warpgroups
# on tf32 wgmma, W split into tf32 hi / lo once per call (pack_f32_weights)
# and streamed in F32_STAGE_BYTES stages through a ring of >= 2 stages (at H
# = PAIR_WIDTH on clusters of PAIR CTAs, each with the tiles of H = 256). At H
# = 128, or where the ring backward's tiles do not fit, the wide kernels: 8
# warps, each with at most two 16 x 64 output tiles of a layer (H / 64
# divides 8), W streamed as fp32 through two chunks of F32_CHUNK_FLOATS / H
# rows of H + 8 floats, activation tiles of rows of H + 4 floats.
F32_WIDTHS = (128, 256, 512)
# The ring kernels' blocks: the forward keeps one tile of 64 rows per
# warpgroup over all H columns, the backward max(2, L-1) tiles of 64 rows
# (each warpgroup on 128 of the columns).
F32_RING_WIDTH = 256
F32_RING_ROWS = {"fwd": 128, "bwd": 64}
F32_STAGE_BYTES = 16384  # one ring stage: KD = F32_STAGE_BYTES / 8 / H rows of depth, hi and lo
F32_MAX_STAGES = 8
F32_ROWS = (64, 32, 16)  # the wide kernels' block rows, the largest that fits first
F32_MAX_TILE = 2 * 8 * 16 * 64  # bm * H: two 16 x 64 tiles for each of the 8 warps
F32_CHUNK_FLOATS = 8192
H100_SMS = 132
# The forward and backward at H = PAIR_WIDTH (bf16 and fp32): a cluster of
# PAIR CTAs on neighbouring SMs shares each block of rows, CTA c on the output
# columns c * H / PAIR .. of every product, with H / PAIR = 256 columns of
# every activation tile in its shared memory (the layout of the H=256
# kernels) and the peer's half read through distributed shared memory; each
# CTA streams only its rows of W (``pair_halves``). In the backward, bf16: each CTA
# stores a_{l-1} and dpre_l of its columns for every block (bf16, the tiles
# as they are) and a GEMM kernel sums dW over all rows afterwards
# (``dw_splits``). fp32: its dW partial is (L-1) x H x H / PAIR, so a block
# of rows costs half the flush of one CTA holding all of dW, over four
# times the rows.
PAIR_WIDTH = 512
PAIR = 2
KINDS = ("fwd", "bwd", "int8")
# The phase-timing build: -DRNET_PHASE_TIMES makes the kernels sum clock64()
# cycles per phase and CTA into a (grid, PHASE_SLOTS) int64 buffer.
PHASE_DEFINES = ("RNET_PHASE_TIMES",)
PHASE_SLOTS = 9
# "pair_wait": a cluster kernel's waits for its peer CTA (0 in the one-CTA
# kernels). In the bf16 cluster backward "dW_products" holds the column sums'
# products and "dW_flush" the stores of a_{l-1} and dpre_l (their dW is a
# second kernel).
FWD_PHASES = ("products", "epilogues", "pool", "feed_wait", "a0", "barriers", "pair_wait")
BWD_PHASES = ("recompute", "dW_products", "dW_flush", "d_products", "column_pass", "feed_wait", "a0", "barriers",
              "pair_wait")
INT8_PHASES = FWD_PHASES[:6]


@dataclass(frozen=True)
class TilePlan:
    """How a pairwise kernel covers (B, ni, nj, H, L): ``wgs`` consumer
    warpgroups of 64 pair rows per CTA, a ring of ``stages`` 8 KB W chunks,
    ``slots`` activation tiles per block, ``grid`` persistent CTAs and
    ``smem`` bytes of shared memory each. The bf16 kernels' warpgroups share
    a block of ``bm`` = 64 * wgs rows (the cluster forward's two warpgroups
    split the columns of blocks of ``bm`` = 64 or 128); the int8 kernel's
    each take their own 64-row block (``bm`` = 64), wgs consecutive blocks a
    round of the CTA's contiguous range. The fp32 kernels (``esize`` = 4) run two warpgroups
    (``wgs`` = 2): the ring kernels (``ring``) on blocks of ``bm`` =
    F32_RING_ROWS[kind] rows with ``stages`` ring stages of F32_STAGE_BYTES,
    the wide kernels on blocks of ``bm`` = 64, 32 or 16 rows with W streamed
    through ``stages`` = 2 chunks. The C launchers check the plan and refuse
    what they cannot take."""

    kind: str  # one of KINDS
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
    bm: int  # pair rows of one block
    esize: int = 2  # bytes of an input element: 4 for the fp32 kernels
    ring: bool = False  # the fp32 ring kernels (H = F32_RING_WIDTH, or PAIR_WIDTH on clusters); else the wide ones
    cluster: int = 1  # CTAs of a cluster that share a block of rows, each on H / cluster columns

    @property
    def width(self) -> int:
        """Output columns of one CTA: its share of every product and activation tile."""
        return self.H // self.cluster

    def columns(self, cta: int) -> range:
        """The output columns CTA `cta` computes (its rank in the cluster's share)."""
        c0 = cta % self.cluster * self.width
        return range(c0, c0 + self.width)

    @property
    def nblk(self) -> int:
        """Row blocks per sample; the last one is ragged when bm does not divide ni*nj."""
        return -(-self.ni * self.nj // self.bm)

    def blocks(self, cta: int):
        """(b, first pair row, valid rows) of every block CTA `cta` runs, in
        its order: the forward walks tiles t = cta, cta + grid, ... (t = b *
        nblk + block); the int8 forward the contiguous range [cta * tiles //
        grid, (cta + 1) * tiles // grid), wgs tiles a round; the backward
        owns samples b = cta, cta + grid, ... and walks all their blocks (with a
        cluster, both CTAs of cluster q = cta // cluster own the samples q, q +
        grid / cluster, ... and walk the same blocks, each on its columns)."""
        npairs = self.ni * self.nj
        ntiles = self.B * self.nblk
        if self.kind == "bwd":
            owner, owners = cta // self.cluster, self.grid // self.cluster
            return [(b, k * self.bm, min(self.bm, npairs - k * self.bm))
                    for b in range(owner, self.B, owners) for k in range(self.nblk)]
        if self.kind == "fwd":  # with a cluster, both CTAs of cluster cta // cluster walk its tiles
            tiles = range(cta // self.cluster, ntiles, self.grid // self.cluster)
        else:
            tiles = range(cta * ntiles // self.grid, (cta + 1) * ntiles // self.grid)
        return [(t // self.nblk, t % self.nblk * self.bm, min(self.bm, npairs - t % self.nblk * self.bm))
                for t in tiles]


def smem_bytes(kind: str, wgs: int, H: int, L: int, slots: int, stages: int, esize: int = 2, bm: int = 0,
               ring: bool = False, cluster: int = 1) -> int:
    """Shared memory of a CTA with `wgs` consumer warpgroups: the activation
    slots, the W ring and its full and empty mbarriers (8 B each). The bf16
    kernels' slots are (64 * wgs) x H bf16 (``bm`` x H / cluster in the
    cluster forward) and they keep a per-row fp32 scale; the forward adds
    the biases in fp32 and one row of H column sums per warp (the cluster
    forward: a row-scale copy per warpgroup and rows of TILE_N column sums),
    the backward a core matrix of ones. The int8 kernel keeps
    `slots` tiles of 64 x H int8 per warpgroup, the biases in fp32 and one
    row of H column sums per warp. The fp32 kernels (``esize`` = 4) keep
    `slots` tiles of `bm` x H floats (the ring kernels, ``ring``; H + 4
    floats a row in the wide ones), `stages` ring stages of F32_STAGE_BYTES
    with their mbarriers and, in the backward, one more (wide: W chunks of
    F32_CHUNK_FLOATS / H rows of H + 8 floats) and a per-row scale. A CTA of
    a ``cluster`` of PAIR (H = PAIR_WIDTH) keeps H / cluster columns of each
    tile (bf16 forward: of the biases and column sums too) and two more
    mbarriers, for its peer's arrivals."""
    pair = 16 if cluster > 1 else 0
    H //= cluster
    if esize == 4 and ring:  # the backward adds the mbarrier of its dW products
        return slots * bm * H * 4 + stages * (F32_STAGE_BYTES + 16) + (8 if kind == "bwd" else 0) + bm * 4 + pair
    if esize == 4:
        return 4 * (slots * bm * (H + 4) + stages * (F32_CHUNK_FLOATS // H) * (H + 8) + bm)
    ring = stages * (CHUNK_BYTES + 16)
    warps_sums = 4 * wgs * H * 4
    if kind == "int8":
        return slots * wgs * WG_ROWS * H + ring + (L - 1) * H * 4 + warps_sums
    bm = bm or WG_ROWS * wgs
    n = slots * bm * H * 2 + ring + bm * 4 + pair
    if kind == "fwd" and cluster > 1:  # a row-scale copy per warpgroup, one row of TILE_N column sums per warp
        n += bm * 4 + (L - 1) * H * 4 + 4 * wgs * TILE_N * 4
    elif kind == "fwd":
        n += (L - 1) * H * 4 + warps_sums
    else:
        n += 128  # one 8 x 8 core matrix of ones (the column sums' wgmma operand)
    return n


def tile_plan(kind: str, B: int, ni: int, nj: int, H: int, L: int, sms: int = H100_SMS, esize: int = 2) -> TilePlan:
    """The tile plan of the bf16 forward (``kind="fwd"``), backward
    (``"bwd"``) or int8 forward (``"int8"``) kernel; with ``esize=4`` that
    of the fp32 forward or backward (``_tile_plan_f32``).

    bf16: two warpgroups (128 rows a block) up to H=256; one at H=384,
    where the activation tiles of 128 rows would not leave room for the ring,
    and in the forward when 128-row tiles would not give every SM one
    (serving buckets). The forward keeps two activation slots (ping-pong),
    the backward max(3, L-1). int8: two slots per warpgroup, and as many
    warpgroups (up to INT8_MAX_WGS) as leave room for MIN_STAGES W chunks;
    one when 128-row tiles would not give every SM one. The ring takes what
    shared memory is left, up to MAX_STAGES. The forward and backward at H =
    PAIR_WIDTH run on clusters of PAIR CTAs where their tiles fit
    (``_pair_plan``; the forward's always do), and on one CTA where they do
    not (deeper chains in the backward). ValueError if the plan does not
    fit."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if H % 128 != 0:
        raise ValueError(f"the pairwise kernels need H % 128 == 0, got H={H}")
    if kind in ("fwd", "bwd") and H == PAIR_WIDTH:
        plan = _pair_plan(kind, B, ni, nj, H, L, sms, esize)
        if plan is not None:
            return plan
    if esize == 4:
        return _tile_plan_f32(kind, B, ni, nj, H, L, sms)
    few_tiles = B * -(-ni * nj // (2 * WG_ROWS)) < sms
    slots = 2 if kind in ("fwd", "int8") else max(3, L - 1)

    def stages_for(wgs):
        return min(MAX_STAGES, (SMEM_LIMIT - smem_bytes(kind, wgs, H, L, slots, 0)) // (CHUNK_BYTES + 16))

    if kind == "int8":
        wgs = next((w for w in range(INT8_MAX_WGS, 1, -1) if stages_for(w) >= MIN_STAGES), 1)
        if few_tiles:
            wgs = 1
    else:
        wgs = 1 if H > 256 or (kind == "fwd" and few_tiles) else 2
    stages = stages_for(wgs)
    if stages < MIN_STAGES:
        rows = WG_ROWS * wgs
        raise ValueError(
            f"pairwise_{kind} kernel at H={H}, L={L} does not fit {SMEM_LIMIT} B of shared memory "
            f"({slots} activation tiles of {rows} x {H} and {MIN_STAGES} W stages)"
        )
    nblk = -(-ni * nj // (WG_ROWS if kind == "int8" else WG_ROWS * wgs))
    if kind == "bwd":
        grid = min(B, sms)
    else:
        grid = min(-(-B * nblk // (wgs if kind == "int8" else 1)), sms)
    bm = WG_ROWS if kind == "int8" else WG_ROWS * wgs
    return TilePlan(kind, B, ni, nj, H, L, wgs, stages, slots, grid, smem_bytes(kind, wgs, H, L, slots, stages), bm)


DW_TILE = (128, 256)  # the output tile of the bf16 cluster backward's dW GEMM (dw_gemm_kernel)


def dw_splits(plan: TilePlan, sms: int = H100_SMS) -> int:
    """Splits of the pair rows in the bf16 cluster backward's dW GEMM: as
    many as give every SM two of its (L-1) x (H / 128) x (H / 256) output
    tiles, at most one per 64-row chunk."""
    tiles = (plan.L - 1) * (plan.H // DW_TILE[0]) * (plan.H // DW_TILE[1])
    return max(1, min(2 * plan.B * plan.nblk, 2 * sms // tiles))


def _pair_plan(kind: str, B: int, ni: int, nj: int, H: int, L: int, sms: int, esize: int) -> Optional[TilePlan]:
    """The forward or backward on clusters of PAIR CTAs at H = PAIR_WIDTH,
    or None where its tiles do not fit. Each CTA keeps the tiles of the
    H=256 kernels on its H / PAIR columns. Forward: fp32 the ring forward's
    one tile of 128 rows (a warpgroup on 64 of them) and >= 2 stages; bf16
    two slots (ping-pong) of blocks of 128 rows, or of 64 where 128-row
    tiles would not give every cluster one (serving buckets), two consumer
    warpgroups each on TILE_N of the columns of all the block's rows, each
    with its own ring of stages / 2 >= MIN_STAGES - 1 W chunks; grid PAIR *
    min(tiles, sms // PAIR), both CTAs of a cluster on the same tiles. Backward: bf16
    two consumer warpgroups on blocks of 128 rows, max(3, L-1) slots and >=
    MIN_STAGES W chunks; fp32 the ring backward's 64-row blocks, max(2,
    L-1) tiles and >= 2 stages; grid PAIR * min(B, sms // PAIR), one owner
    cluster per sample."""
    if esize == 4:
        bm, unit, lo, hi = F32_RING_ROWS[kind], F32_STAGE_BYTES + 16, 2, F32_MAX_STAGES
        slots = 1 if kind == "fwd" else max(2, L - 1)
    else:
        bm, unit, lo, hi = 2 * WG_ROWS, CHUNK_BYTES + 16, MIN_STAGES, MAX_STAGES
        if kind == "fwd" and B * -(-ni * nj // bm) < sms // PAIR:
            bm = WG_ROWS
        slots = 2 if kind == "fwd" else max(3, L - 1)

    def smem(stages):
        return smem_bytes(kind, 2, H, L, slots, stages, esize, bm, ring=esize == 4, cluster=PAIR)

    stages = min(hi, (SMEM_LIMIT - smem(0)) // unit)
    if kind == "fwd" and esize == 2:  # a ring of stages / 2 chunks per consumer warpgroup
        stages, lo = stages - stages % 2, 2 * (MIN_STAGES - 1)
    if stages < lo:
        return None
    units = B if kind == "bwd" else B * -(-ni * nj // bm)
    grid = PAIR * min(units, sms // PAIR)
    return TilePlan(kind, B, ni, nj, H, L, 2, stages, slots, grid, smem(stages), bm, esize, esize == 4, PAIR)


def _tile_plan_f32(kind: str, B: int, ni: int, nj: int, H: int, L: int, sms: int) -> TilePlan:
    """The fp32 kernels' plan where H = PAIR_WIDTH's clusters (``_pair_plan``)
    do not take the shape. At H = F32_RING_WIDTH the ring kernels, where
    they fit: blocks of F32_RING_ROWS[kind] rows, one activation tile in the
    forward (each layer in place) and max(2, L-1) in the backward (a_0 ..
    a_{L-2}, dpre_{L-1} in a_0's tile, a_0 rebuilt), and as many ring
    stages (at least 2, at most F32_MAX_STAGES) as shared memory leaves.
    Else the wide kernels: two tiles in the forward, L in the backward, and
    the most rows of F32_ROWS that leave at most two 16 x 64 output tiles a
    warp and fit beside the two W chunks. The forward walks (sample, block)
    tiles over min(tiles, SMs) CTAs, the backward gives each sample one
    owner CTA of min(B, SMs). ValueError if no plan fits."""
    if kind == "int8":
        raise ValueError("the int8 kernel has no fp32 plan (esize=4)")
    if H not in F32_WIDTHS:
        raise ValueError(f"the fp32 pairwise kernels take H in {F32_WIDTHS}, got H={H}")
    stages, ring = 0, H == F32_RING_WIDTH
    if ring:
        bm = F32_RING_ROWS[kind]
        slots = 1 if kind == "fwd" else max(2, L - 1)
        free = SMEM_LIMIT - smem_bytes(kind, 2, H, L, slots, 0, 4, bm, ring=True)
        stages = min(F32_MAX_STAGES, free // (F32_STAGE_BYTES + 16))
        ring = stages >= 2
    if not ring:
        slots, stages = (2 if kind == "fwd" else L), 2
        fits = [bm for bm in F32_ROWS
                if bm * H <= F32_MAX_TILE and smem_bytes(kind, 2, H, L, slots, 2, 4, bm) <= SMEM_LIMIT]
        if not fits:
            raise ValueError(
                f"pairwise_{kind} fp32 kernel at H={H}, L={L} does not fit {SMEM_LIMIT} B of shared memory "
                f"({slots} activation tiles of {F32_ROWS[-1]} x {H} fp32 and two W chunks)"
            )
        bm = fits[0]
    nblk = -(-ni * nj // bm)
    grid = min(B, sms) if kind == "bwd" else min(B * nblk, sms)
    return TilePlan(kind, B, ni, nj, H, L, 2, stages, slots, grid,
                    smem_bytes(kind, 2, H, L, slots, stages, 4, bm, ring=ring), bm, 4, ring)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: the kept bits of the fp32 pattern, the
    13 low bits zero (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_f32_weights(x: torch.Tensor) -> torch.Tensor:
    """x (L-1, N, K) fp32, N and K multiples of 128 (N = K = H, or N = H / 2
    for a CTA of a cluster), row n holding B^T's
    row (the K-major B operand of ``a . B``), split into tf32 hi =
    tf32_round(x) and lo = tf32_round(x - hi) and packed as the fp32 ring
    kernels stream it: per layer, per depth slice of KD = F32_STAGE_BYTES /
    8 / N columns, one F32_STAGE_BYTES stage holding hi, then lo, each as
    N / 128 column tiles of 128 rows, each of core matrices (8 rows of 4
    contiguous fp32 of depth), the depth's core matrices innermost. Returns
    a contiguous (L-1, K/KD, 2, N/128, 16, KD/4, 8, 4)."""
    n_l, N, K = x.shape
    kd = F32_STAGE_BYTES // 8 // N
    hi = tf32_round(x)
    lo = tf32_round(x.float() - hi)
    y = torch.stack([hi, lo], dim=1).reshape(n_l, 2, N // 128, 16, 8, K // kd, kd // 4, 4)
    return y.permute(0, 5, 1, 2, 3, 6, 4, 7).contiguous()


def pair_halves(x: torch.Tensor, cluster: int = PAIR) -> torch.Tensor:
    """x (L-1, N, K) as the CTAs of a cluster stream it: CTA c's share of the
    rows (its output columns c * N / cluster ..), the depth reordered to its
    own share of K first (the operand in its shared memory), then the
    others' in rank order from c + 1 (read from their shared memory).
    Returns a contiguous (cluster, L-1, N / cluster, K); each CTA's slice is
    packed by ``pack_weight_chunks`` or ``pack_f32_weights``."""
    n_l, N, K = x.shape
    rn, rk = N // cluster, K // cluster
    out = []
    for c in range(cluster):
        rows = x[:, c * rn:(c + 1) * rn]
        order = [(c + q) % cluster for q in range(cluster)]
        out.append(torch.cat([rows[:, :, k * rk:(k + 1) * rk] for k in order], dim=2))
    return torch.stack(out).contiguous()


def pack_weight_chunks(x: torch.Tensor) -> torch.Tensor:
    """x (L-1, N, K), row n holding B^T's row (the K-major B operand of
    ``a . B``), packed as the kernels stream it: per layer, per tile of nt =
    TILE_N rows, per depth chunk of kc = 8192 / (nt * size) columns (64
    bytes), one 8 KB chunk of core matrices (8 rows of 16 contiguous bytes:
    ce = 16 / size elements), the depth's core matrices innermost, where size
    is 1 byte for int8 and 2 for every other dtype (the bf16 operands'
    layout). Returns a contiguous (L-1, N/nt, K/kc, nt/8, kc/ce, 8, ce)."""
    n_l, N, K = x.shape
    nt = TILE_N
    size = 1 if x.dtype in (torch.int8, torch.uint8) else 2
    kc = CHUNK_BYTES // size // nt
    ce = 16 // size
    y = x.reshape(n_l, N // nt, nt // 8, 8, K // kc, kc // ce, ce)
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
    """Validate what the pairwise kernels take: u, v, s, qa, ws and bs all
    bf16 (the bf16 kernels) or all fp32 (the fp32 kernels, which also read
    u, v, s and ws in 16-byte vectors); (B, ni, nj, H, L) or ValueError."""
    dt = u.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the pairwise kernels: u must be {torch.bfloat16} or {torch.float32}, got {dt}")
    ts = {"u": u, "v": v, "s": s, "qa": qa, "ws": ws, "bs": bs}
    for name, t in ts.items():
        if t.dtype != dt:
            raise ValueError(f"the pairwise kernels take inputs all of one dtype: {name} is {t.dtype}, u is {dt}")
    dims = _check_core_inputs("the pairwise kernels", ts, dict.fromkeys(ts, dt))
    if dt == torch.float32 and any(t.data_ptr() % 16 for t in (u, v, s, ws)):
        raise ValueError("the fp32 kernels read u, v, s, ws in 16-byte vectors: their storage must be 16-byte aligned")
    return dims


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
    """Launch the forward kernel for the inputs' dtype (bf16: pairwise_fwd.cu,
    fp32: pairwise_f32.cu) on the current stream; (B, H) fp32. Raises on
    anything the kernel does not take, on CPU tensors, and on a failed build
    or launch. ``phases``, an int64 (grid, PHASE_SLOTS) tensor for the grid of
    ``tile_plan("fwd", ...)`` (``esize=4`` for fp32), selects the build with
    -DRNET_PHASE_TIMES, which sums clock64() cycles per FWD_PHASES entry and
    CTA into it (bf16, and the fp32 ring kernels)."""
    B, ni, nj, H, L = check_kernel_inputs(u, v, s, qa, ws, bs)
    dev = _check_device(KERNEL, (u, v, s, qa, ws, bs))
    drop, seed_ptr, thr, inv_keep = _drop_args(pair_keep, seed, dev)
    if u.dtype == torch.float32:
        return _fwd_f32(u, v, s, qa, ws, bs, int(inject), B, ni, nj, H, L, dev, drop, seed_ptr, thr, inv_keep,
                        phases)
    plan = tile_plan("fwd", B, ni, nj, H, L, _sms(dev))
    phase_ptr, defines = _phase_buffer(phases, plan.grid, dev)
    lib = _kernel_lib(KERNEL, defines)
    chunks = _pack_for(ws.transpose(1, 2), plan, pack_weight_chunks)
    parts = 1 if plan.cluster > 1 else plan.wgs  # pooled rows per block: one per warpgroup of a one-CTA block
    partial = torch.empty((B, plan.nblk * parts, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_fwd(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), chunks.data_ptr(), bs.data_ptr(),
            partial.data_ptr(), out.data_ptr(), B, ni, nj, H, L, int(inject), plan.wgs, plan.bm, plan.stages,
            plan.grid, plan.cluster, plan.smem, drop, seed_ptr, thr, inv_keep, phase_ptr, stream,
        )
    _raise_on_error(lib, err, KERNEL)
    launches[KERNEL] += 1
    launches["pair_mask"] += drop
    return out


def pairwise_bwd_cuda(u, v, s, qa, ws, bs, g, *, inject: int, pair_keep: float = 1.0, seed=None, phases=None):
    """Launch the backward kernel for the inputs' dtype (bf16:
    pairwise_bwd.cu, fp32: pairwise_f32.cu) on the current stream for the
    upstream gradient g (B, H) fp32; (du, dv, ds, dqa, dws, dbs) in fp32.
    Raises as ``pairwise_fwd_cuda`` does; ``phases`` as there, for the grid
    of ``tile_plan("bwd", ...)`` and the BWD_PHASES."""
    B, ni, nj, H, L = check_kernel_inputs(u, v, s, qa, ws, bs)
    if g.dtype != torch.float32 or tuple(g.shape) != (B, H) or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous fp32 ({B}, {H}) tensor; got {g.dtype} {tuple(g.shape)}")
    dev = _check_device(BWD_KERNEL, (u, v, s, qa, ws, bs, g))
    drop, seed_ptr, thr, inv_keep = _drop_args(pair_keep, seed, dev)
    if u.dtype == torch.float32:
        return _bwd_f32(u, v, s, qa, ws, bs, g, int(inject), B, ni, nj, H, L, dev, drop, seed_ptr, thr, inv_keep,
                        phases)
    plan = tile_plan("bwd", B, ni, nj, H, L, _sms(dev))
    phase_ptr, defines = _phase_buffer(phases, plan.grid, dev)
    lib = _kernel_lib(BWD_KERNEL, defines)
    wt_chunks, w_chunks = (_pack_for(x, plan, pack_weight_chunks) for x in (ws.transpose(1, 2), ws))
    f32 = dict(dtype=torch.float32, device=dev)
    du, dv = torch.zeros((B, ni, H), **f32), torch.zeros((B, nj, H), **f32)
    ds, dqa = torch.zeros((B, H), **f32), torch.zeros((B, H), **f32)
    dws, dbs = torch.empty((L - 1, H, H), **f32), torch.empty((L - 1, H), **f32)
    splits, act = 0, None
    if plan.cluster > 1:  # the stored a_{l-1}, dpre_l tiles and the GEMM's split partials of dW
        splits = dw_splits(plan, _sms(dev))
        act = torch.empty((2, L - 1, B * plan.nblk, plan.cluster, plan.bm * plan.width), dtype=torch.bfloat16,
                          device=dev)
        dw_part = torch.empty((splits, L - 1, H, H), **f32)
    else:
        dw_part = torch.zeros((plan.grid, L - 1, H, H), **f32)
    db_part = torch.zeros((plan.grid, L - 1, H), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_bwd(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), wt_chunks.data_ptr(), w_chunks.data_ptr(),
            bs.data_ptr(), g.data_ptr(), du.data_ptr(), dv.data_ptr(), ds.data_ptr(), dqa.data_ptr(),
            dws.data_ptr(), dbs.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(), _ptr(act), B, ni, nj, H, L,
            int(inject), plan.wgs, plan.slots, plan.stages, plan.grid, plan.cluster, splits, plan.smem, drop,
            seed_ptr, thr, inv_keep, phase_ptr, stream,
        )
    _raise_on_error(lib, err, BWD_KERNEL)
    launches[BWD_KERNEL] += 1
    launches["pair_mask"] += drop
    return du, dv, ds, dqa, dws, dbs


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _pack_for(x: torch.Tensor, plan: TilePlan, pack) -> torch.Tensor:
    """x (L-1, N, K) packed by `pack` for the plan's kernel: as it is for one
    CTA, or each cluster CTA's ``pair_halves`` slice, rank after rank."""
    if plan.cluster == 1:
        return pack(x)
    halves = pair_halves(x, plan.cluster)
    return pack(halves.reshape(-1, *halves.shape[2:]))


def _f32_plan(kind, B, ni, nj, H, L, dev, phases):
    """The fp32 plan, the phase buffer's pointer and the library (the
    phase-timing build when ``phases`` is given; the ring kernels only)."""
    plan = tile_plan(kind, B, ni, nj, H, L, _sms(dev), esize=4)
    phase_ptr, defines = _phase_buffer(phases, plan.grid, dev)
    if phases is not None and not plan.ring:
        raise ValueError(f"the wide fp32 kernels (H={H}, L={L}) have no phase-timing build: phases must be None")
    return plan, phase_ptr, _kernel_lib(F32_LIB, defines)


def _fwd_f32(u, v, s, qa, ws, bs, inject, B, ni, nj, H, L, dev, drop, seed_ptr, thr, inv_keep, phases):
    """The fp32 forward's launch (``pairwise_fwd_cuda`` for fp32 inputs): the
    ring kernel reads W^T split and packed by pack_f32_weights (each cluster
    CTA its ``pair_halves`` slice), the wide one W itself."""
    plan, phase_ptr, lib = _f32_plan("fwd", B, ni, nj, H, L, dev, phases)
    chain = _pack_for(ws.transpose(1, 2), plan, pack_f32_weights) if plan.ring else None
    partial = torch.empty((B, plan.nblk, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_fwd_f32(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), ws.data_ptr(), _ptr(chain),
            bs.data_ptr(), partial.data_ptr(), out.data_ptr(),
            B, ni, nj, H, L, inject, int(plan.ring), plan.bm, plan.slots, plan.stages, plan.grid, plan.cluster,
            plan.smem, drop, seed_ptr, thr, inv_keep, phase_ptr, stream,
        )
    _raise_on_error(lib, err, F32_KERNEL)
    launches[F32_KERNEL] += 1
    launches["pair_mask"] += drop
    return out


def _bwd_f32(u, v, s, qa, ws, bs, g, inject, B, ni, nj, H, L, dev, drop, seed_ptr, thr, inv_keep, phases):
    """The fp32 backward's launch (``pairwise_bwd_cuda`` for fp32 inputs):
    the ring kernels read W^T (the chain) and W (the d products) split and
    packed by pack_f32_weights (each cluster CTA its ``pair_halves`` slice),
    the wide one W and W^T."""
    plan, phase_ptr, lib = _f32_plan("bwd", B, ni, nj, H, L, dev, phases)
    if plan.ring:
        wt = None
        chain, dstages = (_pack_for(x, plan, pack_f32_weights) for x in (ws.transpose(1, 2), ws))
    else:
        wt, chain, dstages = ws.transpose(1, 2).contiguous(), None, None
    f32 = dict(dtype=torch.float32, device=dev)
    du, dv = torch.zeros((B, ni, H), **f32), torch.zeros((B, nj, H), **f32)
    ds, dqa = torch.empty((B, H), **f32), torch.zeros((B, H), **f32)
    dws, dbs = torch.empty((L - 1, H, H), **f32), torch.empty((L - 1, H), **f32)
    dw_part = torch.zeros((plan.grid, L - 1, H, plan.width), **f32)
    # sums over a CTA's or a sample's blocks in fp64 (thousands of addends of one sign at n = 1024)
    db_part = torch.zeros((plan.grid, L - 1, H), dtype=torch.float64, device=dev)
    sums = torch.zeros((B, 2, H), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_bwd_f32(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), ws.data_ptr(), _ptr(wt), _ptr(chain),
            _ptr(dstages), bs.data_ptr(), g.data_ptr(), du.data_ptr(), dv.data_ptr(), ds.data_ptr(), dqa.data_ptr(),
            dws.data_ptr(), dbs.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(), sums.data_ptr(), B, ni, nj, H,
            L, inject, int(plan.ring), plan.bm, plan.slots, plan.stages, plan.grid, plan.cluster, plan.smem, drop,
            seed_ptr, thr, inv_keep, phase_ptr, stream,
        )
    _raise_on_error(lib, err, F32_BWD_KERNEL)
    launches[F32_BWD_KERNEL] += 1
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
    """Validate what the int8 kernel takes: u, v, s all bf16 or all fp32 (as
    rnet's kernel reads either), qa, m, bs fp32, w8 int8; (B, ni, nj, H, L)
    or ValueError."""
    f32, bf16 = torch.float32, torch.bfloat16
    if u.dtype not in (f32, bf16):
        raise ValueError(f"the int8 kernel: u must be {bf16} or {f32}, got {u.dtype}")
    dt = u.dtype
    dtypes = {"u": dt, "v": dt, "s": dt, "qa": f32, "w8": torch.int8, "m": f32, "bs": f32}
    ts = {"u": u, "v": v, "s": s, "qa": qa, "w8": w8, "m": m, "bs": bs}
    B, ni, nj, H, L = _check_core_inputs("the int8 kernel", ts, dtypes)
    if any(t.data_ptr() % 16 for t in (u, v, s)):
        raise ValueError("the int8 kernel reads u, v, s in 16-byte vectors: their storage must be 16-byte aligned")
    return B, ni, nj, H, L


def pairwise_fwd_int8_cuda(u, v, s, qa, w8, m, bs, *, inject: int, phases=None) -> torch.Tensor:
    """Launch the int8 kernel on the current stream for folded inputs (those
    of ``quantize_int8``); (B, H) fp32. Raises on anything the kernel does
    not take, on CPU tensors, and on a failed build or launch. ``phases`` as
    ``pairwise_fwd_cuda``'s, for the grid of ``tile_plan("int8", ...)`` and
    the INT8_PHASES."""
    B, ni, nj, H, L = check_int8_inputs(u, v, s, qa, w8, m, bs)
    dev = _check_device(INT8_KERNEL, (u, v, s, qa, w8, m, bs))
    plan = tile_plan("int8", B, ni, nj, H, L, _sms(dev))
    phase_ptr, defines = _phase_buffer(phases, plan.grid, dev)
    lib = _kernel_lib(INT8_KERNEL, defines)
    chunks = pack_weight_chunks(w8.transpose(1, 2))  # row n = column n of W_l: the K-major B operand
    partial = torch.empty((B, plan.nblk, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_fwd_int8(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), chunks.data_ptr(), m.data_ptr(),
            bs.data_ptr(), partial.data_ptr(), out.data_ptr(), B, ni, nj, H, L, int(inject), plan.wgs,
            plan.stages, plan.grid, plan.smem, int(u.dtype == torch.float32), phase_ptr, stream,
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


def _core_fwd(u, v, s, qa, ws, bs, inject: int, keep: float, seed) -> torch.Tensor:
    """The pooled core: the plain version for CPU tensors, the kernel for CUDA ones."""
    if u.device.type == "cpu":
        return pairwise_core_reference(u, v, s, qa, ws, bs, inject, keep, seed)
    return pairwise_fwd_cuda(u, v, s, qa, ws, bs, inject=inject, pair_keep=keep, seed=seed)


def _core_bwd(u, v, s, qa, ws, bs, g, inject: int, keep: float, seed):
    """Its VJP (du, dv, ds, dqa, dws, dbs) in fp32, likewise."""
    g = g.float().contiguous()
    if u.device.type == "cpu":
        return pairwise_core_bwd_reference(u, v, s, qa, ws, bs, g, inject, keep, seed)
    return pairwise_bwd_cuda(u, v, s, qa, ws, bs, g, inject=inject, pair_keep=keep, seed=seed)


class _PairwiseCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, v, s, qa, ws, bs, inject: int, keep: float, seed):
        ctx.save_for_backward(u, v, s, qa, ws, bs, seed)
        ctx.inject, ctx.keep = inject, keep
        return _core_fwd(u, v, s, qa, ws, bs, inject, keep, seed)

    @staticmethod
    def backward(ctx, g):
        u, v, s, qa, ws, bs, seed = ctx.saved_tensors
        grads = _core_bwd(u, v, s, qa, ws, bs, g, ctx.inject, ctx.keep, seed)
        # each gradient in its input's dtype, as _make_core.bwd returns them
        return (*(d.to(t.dtype) for d, t in zip(grads, (u, v, s, qa, ws, bs))), None, None, None)


def pairwise_core(u, v, s, qa, ws, bs, *, inject: int, pair_keep: float = 1.0, seed=None) -> torch.Tensor:
    """Differentiable pooled core: the plain versions for CPU tensors, the
    kernels for CUDA ones. pair_keep < 1 turns on pair dropout with `seed`,
    a (1,) int64 tensor on the inputs' device (fresh per step)."""
    if pair_keep < 1.0 and seed is None:
        raise ValueError("pair_keep < 1 needs a seed: a (1,) int64 tensor")
    return _PairwiseCore.apply(u, v, s, qa, ws, bs, int(inject), float(pair_keep), seed)


class _ShardedCore(torch.autograd.Function):
    """The core on this rank's ``pairs`` shard of u's i-rows, the pooled
    partials all-reduced over ``pairs``. The backward returns replicated
    full gradients, as shard_map's transpose does: du's rows in a zero
    (B, n, H) buffer, and du, dv, ds, dqa, dws and dbs summed over ``pairs``
    in one all-reduce."""

    @staticmethod
    def forward(ctx, u, v, s, qa, ws, bs, inject: int, keep: float, seed, mesh: Mesh):
        rows = mesh.pair_rows(u.shape[1], exact=True)
        u_l = u[:, rows].contiguous()
        ctx.save_for_backward(u_l, v, s, qa, ws, bs, seed)
        ctx.inject, ctx.keep, ctx.mesh, ctx.rows, ctx.u_shape, ctx.u_dtype = inject, keep, mesh, rows, u.shape, u.dtype
        out = _core_fwd(u_l, v, s, qa, ws, bs, inject, keep, seed)
        return reduce_pairs(out, mesh)

    @staticmethod
    def backward(ctx, g):
        u_l, v, s, qa, ws, bs, seed = ctx.saved_tensors
        du_l, *rest = _core_bwd(u_l, v, s, qa, ws, bs, g, ctx.inject, ctx.keep, seed)
        du = du_l.new_zeros(ctx.u_shape)
        du[:, ctx.rows] = du_l
        grads = all_reduce_flat([du, *rest], ctx.mesh.group("pairs"))
        dtypes = (ctx.u_dtype, v.dtype, s.dtype, qa.dtype, ws.dtype, bs.dtype)
        return (*(d.to(dt) for d, dt in zip(grads, dtypes)), None, None, None, None)


def pairwise_core_sharded(u, v, s, qa, ws, bs, *, inject: int, mesh: Optional[Mesh], pair_keep: float = 1.0,
                          seed=None, int8: bool = False) -> torch.Tensor:
    """rnet's shard_map island (``pairwise_core_sharded``, :596-683) on this
    rank: u, v, s, qa are its ``data`` slice of the batch, ws and bs
    replicated. Under a ``pairs`` axis u's i-rows split over it (P must
    divide them) and the pooled (B, H) sums are all-reduced over it; the
    gradients come back replicated over ``pairs`` (their sum over ``data``
    is the train step's). Pair dropout draws with ``seed + shard_id *
    1_000_003``, so every shard's mask differs; ``int8=True`` runs the int8
    core per shard, each calibrating on its own rows. One process (no mesh,
    or a mesh of one rank) runs ``pairwise_core`` / ``pairwise_core_int8``."""
    if int8 and pair_keep < 1.0:
        raise ValueError("int8 is inference-only; pair dropout cannot be active")
    if pair_keep < 1.0 and seed is None:
        raise ValueError("pair_keep < 1 needs a seed: a (1,) int64 tensor")
    if mesh is not None and mesh.world > 1 and pair_keep < 1.0:
        seed = seed + mesh.shard_id * SHARD_SEED_STRIDE
    if mesh is None or mesh.size("pairs") == 1:
        if int8:
            return pairwise_core_int8(u, v, s, qa, ws, bs, inject=inject)
        return pairwise_core(u, v, s, qa, ws, bs, inject=inject, pair_keep=pair_keep, seed=seed)
    if int8:
        with torch.no_grad():
            u_l = u[:, mesh.pair_rows(u.shape[1], exact=True)].contiguous()
            return reduce_pairs(pairwise_core_int8(u_l, v, s, qa, ws, bs, inject=inject), mesh)
    return _ShardedCore.apply(u, v, s, qa, ws, bs, int(inject), float(pair_keep), seed, mesh)


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
    x, q, gw, gb, *, inject: int, dtype=torch.bfloat16, pair_keep: float = 1.0, seed=None, int8: bool = False,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Pooled g_theta over all object pairs; (B, g_out) fp32, differentiable
    in x, q, gw and gb — except with ``int8=True`` (inference only:
    ``pairwise_core_int8``, no gradient). The core is
    ``pairwise_core_sharded``: ``pairwise_core`` (or the int8 core) in one
    process, its shard of them under a ``mesh``."""
    u, v, s, qa, ws, bs = _project_pair_inputs(x, q, gw, gb, inject, dtype)
    return pairwise_core_sharded(u, v, s, qa, ws, bs, inject=inject, mesh=mesh, pair_keep=pair_keep, seed=seed,
                                 int8=int8)
