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
  kernels' clusters of two, and ``pair_chunk_index`` gathers the bf16 and
  int8 cluster kernels' streams in one launch; ``dw_splits`` splits the rows
  of the backward's dW GEMM in bf16); all are pure and tested on the CPU.
  ``f32_supported`` says which shapes the fp32 kernels take. A ``phases``
  buffer selects the phase-timing build (``PHASE_DEFINES``) of the bf16,
  int8 and fp32 ring kernels.
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
# STORED_GROUPS counts the bf16 backward's sample groups (``bwd_groups``): one
# fused launch and one dW GEMM each, so BWD_KERNEL calls or more. XLA_ROUTE
# counts the g_theta calls of ``RelationalLayer.forward`` that took the plain
# ``xla`` route, on any device (no kernel of this module runs there).
STORED_GROUPS = "bwd_stored_groups"
XLA_ROUTE = "g_xla"
launches = {KERNEL: 0, BWD_KERNEL: 0, STORED_GROUPS: 0, "pair_mask": 0, INT8_KERNEL: 0, F32_KERNEL: 0,
            F32_BWD_KERNEL: 0, XLA_ROUTE: 0}

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
        lib.rnet_pairwise_fwd_int8.argtypes = [vp] * 9 + [i32] * 10 + [i64, i32, vp, vp]
        lib.rnet_pairwise_fwd_int8.restype = i32
    elif name == F32_LIB:
        lib.rnet_pairwise_fwd_f32.argtypes = [vp] * 8 + [i32] * 11 + [i64, i32, vp, u32, f32, vp, vp]
        lib.rnet_pairwise_fwd_f32.restype = i32
        lib.rnet_pairwise_bwd_f32.argtypes = [vp] * 15 + [i32] * 12 + [i64, i32, vp, u32, f32, vp, vp]
        lib.rnet_pairwise_bwd_f32.restype = i32
    else:
        lib.rnet_pairwise_bwd.argtypes = [vp] * 15 + [i32] * 16 + [i64, i32, vp, u32, f32, vp, vp]
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
    B, ni, nj = u.shape[0], u.shape[1], v.shape[1]
    d = g.float()[:, None, :].expand(B, ni * nj, g.shape[1])
    if keep < 1.0:
        d = d * _pair_scale(seed, B, ni, nj, keep)[..., None]
    return _bwd_chain(_recompute(u, v, s, qa, ws, bs, inject), ws, d, u.dtype, ni, nj, inject)


def split_bwd_reference(plan: TilePlan, u, v, s, qa, ws, bs, g, inject: int, keep: float = 1.0, seed=None):
    """The backward as the kernels decompose it under ``plan`` (a
    ``tile_plan("bwd", ...)``): split k of every sample, the rows of its
    blocks ``plan.split_blocks(k)``, through ``pairwise_core_bwd_reference``'s
    arithmetic on those rows alone, and the splits' gradients added in split
    order, as the kernels add their per-split slices of du, dv, ds and dqa.
    (du, dv, ds, dqa, dws, dbs) fp32; with one split, the plain backward."""
    B, ni, nj = u.shape[0], u.shape[1], v.shape[1]
    npairs = ni * nj
    acts = _recompute(u, v, s, qa, ws, bs, inject)
    scale = _pair_scale(seed, B, ni, nj, keep) if keep < 1.0 else torch.ones((B, npairs), device=u.device)
    total = None
    for k in range(plan.splits):
        blocks = plan.split_blocks(k)
        rows = torch.zeros(npairs, device=u.device)
        rows[blocks.start * plan.bm:min(blocks.stop * plan.bm, npairs)] = 1.0
        d = g.float()[:, None, :] * (scale * rows)[..., None]
        part = _bwd_chain(acts, ws, d, u.dtype, ni, nj, inject)
        total = part if total is None else tuple(a + b for a, b in zip(total, part))
    return total


def _bwd_chain(acts, ws, d, dt, ni: int, nj: int, inject: int):
    """The backward of the recomputed chain ``acts`` for the per-row
    upstream gradient d (B, ni*nj, H) fp32, at ``pairwise_core_bwd_reference``'s
    rounding points; (du, dv, ds, dqa, dws, dbs) fp32."""
    B, _, H = d.shape
    n_l = ws.shape[0]
    dws, dbs = [None] * n_l, [None] * n_l
    dqa = torch.zeros((B, H), dtype=torch.float32, device=d.device)
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
# The fp32 ring kernels (csrc/pairwise_f32.cu) at H = F32_RING_WIDTH, and at
# H = PAIR_WIDTH on clusters of PAIR CTAs, each with the tiles of H = 256:
# blocks of F32_RING_ROWS[kind] pair rows, two consumer warpgroups on tf32
# wgmma, W split into tf32 hi / lo once per call (pack_f32_weights) and
# streamed in F32_STAGE_BYTES stages through a ring of >= 2 stages. The
# forward keeps one tile of 64 rows per warpgroup over all H columns, the
# backward max(2, L-1) tiles of 64 rows (each warpgroup on 128 of the
# columns), which fit beside two stages up to L = 4.
F32_RING_WIDTH = 256
F32_RING_ROWS = {"fwd": 128, "bwd": 64}
F32_STAGE_BYTES = 16384  # one ring stage: KD = F32_STAGE_BYTES / 8 / H rows of depth, hi and lo
F32_MAX_STAGES = 8
H100_SMS = 132
# The forward and backward at H = PAIR_WIDTH (bf16 and fp32): a cluster of
# PAIR CTAs on neighbouring SMs shares each block of rows, CTA c on the output
# columns c * H / PAIR .. of every product, with H / PAIR = 256 columns of
# every activation tile in its shared memory (the layout of the H=256
# kernels) and the peer's half read through distributed shared memory; each
# CTA streams only its rows of W (``pair_halves``). In the fp32 backward its
# dW partial is (L-1) x H x H / PAIR, so a block of rows costs half the flush
# of one CTA holding all of dW, over four times the rows. (The bf16 backward,
# one CTA or a cluster, stores a_{l-1} and dpre_l of every block and sums dW
# in a GEMM: ``bwd_groups``, ``dw_splits``.)
PAIR_WIDTH = 512
PAIR = 2
KINDS = ("fwd", "bwd", "int8")
# The phase-timing build: -DRNET_PHASE_TIMES makes the kernels sum clock64()
# cycles per phase and CTA into a (grid, PHASE_SLOTS) int64 buffer.
PHASE_DEFINES = ("RNET_PHASE_TIMES",)
PHASE_SLOTS = 9
# "pair_wait": a cluster kernel's waits for its peer CTA (0 in the one-CTA
# kernels). In the bf16 backward "column_sums" holds the db / dqa products
# and "store" the issue of a_{l-1} and dpre_l's bulk stores and the wait for
# them to be read (dW is a second kernel); the fp32 backward's slots 1 and 2
# are its dW products and the flush of its dW partial (F32_BWD_PHASES).
FWD_PHASES = ("products", "epilogues", "pool", "feed_wait", "a0", "barriers", "pair_wait")
BWD_PHASES = ("recompute", "column_sums", "store", "d_products", "column_pass", "feed_wait", "a0", "barriers",
              "pair_wait")
F32_BWD_PHASES = ("recompute", "dW_products", "dW_flush", *BWD_PHASES[3:])
INT8_PHASES = FWD_PHASES  # "pair_wait": the cluster kernel's waits for its peer's half of a slot


@dataclass(frozen=True)
class TilePlan:
    """How a pairwise kernel covers (B, ni, nj, H, L): ``wgs`` consumer
    warpgroups of 64 pair rows per CTA, a ring of ``stages`` 8 KB W chunks,
    ``slots`` activation tiles per block, ``grid`` persistent CTAs and
    ``smem`` bytes of shared memory each. The bf16 kernels' warpgroups share
    a block of ``bm`` = 64 * wgs rows (the cluster forward's two warpgroups
    split the columns of blocks of ``bm`` = 64 or 128); the int8 kernel's
    each take their own 64-row block (``bm`` = 64), wgs consecutive blocks a
    round of the CTA's contiguous range. The fp32 ring kernels (``esize`` =
    4) run two warpgroups (``wgs`` = 2) on blocks of ``bm`` =
    F32_RING_ROWS[kind] rows with ``stages`` ring stages of F32_STAGE_BYTES.
    The one-CTA backwards (bf16 and fp32) give each sample ``splits`` CTAs
    when the batch is smaller than the card (``sample_splits``), each on a
    contiguous share of its blocks (``split_blocks``). The C launchers check
    the plan and refuse what they cannot take."""

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
    cluster: int = 1  # CTAs of a cluster that share a block of rows, each on H / cluster columns
    splits: int = 1  # the backward's CTAs per sample (S), each on a contiguous share of its blocks

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

    def split_blocks(self, k: int) -> range:
        """The blocks of split k of a sample in the backward: [k * nblk / S,
        (k + 1) * nblk / S), in order (S = ``splits``; one split, all)."""
        return range(k * self.nblk // self.splits, (k + 1) * self.nblk // self.splits)

    def blocks(self, cta: int):
        """(b, first pair row, valid rows) of every block CTA `cta` runs, in
        its order: the forward walks tiles t = cta, cta + grid, ... (t = b *
        nblk + block); the int8 forward the contiguous range [cta * tiles //
        grid, (cta + 1) * tiles // grid), wgs tiles a round (with a cluster,
        both CTAs of cluster q of Q = grid / cluster the range [q * tq +
        min(q, tr), (q + 1) * tq + min(q + 1, tr)), tq, tr = divmod(tiles,
        Q), each on its columns); the backward
        walks the units u = cta, cta + grid, ... (unit u = b * splits + k:
        split k of sample b, the blocks ``split_blocks(k)``; with one split,
        all the blocks of the samples it owns; with a cluster, both CTAs of
        cluster q = cta // cluster walk the units q, q + grid / cluster, ...,
        each on its columns)."""
        npairs = self.ni * self.nj
        ntiles = self.B * self.nblk
        if self.kind == "bwd":
            owner, owners = cta // self.cluster, self.grid // self.cluster
            return [(u // self.splits, k * self.bm, min(self.bm, npairs - k * self.bm))
                    for u in range(owner, self.B * self.splits, owners) for k in self.split_blocks(u % self.splits)]
        if self.kind == "fwd":  # with a cluster, both CTAs of cluster cta // cluster walk its tiles
            tiles = range(cta // self.cluster, ntiles, self.grid // self.cluster)
        elif self.cluster > 1:  # int8: cluster q of Q the tiles [q * tq + min(q, tr), ...), tq = tiles // Q
            q, (tq, tr) = cta // self.cluster, divmod(ntiles, self.grid // self.cluster)
            tiles = range(q * tq + min(q, tr), (q + 1) * tq + min(q + 1, tr))
        else:
            tiles = range(cta * ntiles // self.grid, (cta + 1) * ntiles // self.grid)
        return [(t // self.nblk, t % self.nblk * self.bm, min(self.bm, npairs - t % self.nblk * self.bm))
                for t in tiles]


def smem_bytes(kind: str, wgs: int, H: int, L: int, slots: int, stages: int, esize: int = 2, bm: int = 0,
               cluster: int = 1) -> int:
    """Shared memory of a CTA with `wgs` consumer warpgroups: the activation
    slots, the W ring and its full and empty mbarriers (8 B each). The bf16
    kernels' slots are (64 * wgs) x H bf16 (``bm`` x H / cluster in the
    cluster forward) and they keep a per-row fp32 scale; the forward adds
    the biases in fp32 and one row of H column sums per warp (the cluster
    forward: a row-scale copy per warpgroup and rows of TILE_N column sums),
    the backward a core matrix of ones. The int8 kernel keeps
    `slots` tiles of 64 x H int8 per warpgroup, the biases in fp32 and one
    row of H column sums per warp (a CTA of its cluster: slots of all H
    columns and four mbarriers per warpgroup; its biases come from global
    memory and its column sums go to a slot). The fp32 kernels (``esize`` =
    4) keep `slots` tiles of `bm` x H floats, `stages` ring stages of
    F32_STAGE_BYTES with their mbarriers and, in the backward, one more and
    a per-row scale. A CTA of a ``cluster`` of PAIR (H = PAIR_WIDTH) keeps H
    / cluster columns of each tile (bf16 forward: of the biases and column
    sums too) and two more mbarriers, for its peer's arrivals."""
    pair = 16 if cluster > 1 else 0
    H //= cluster
    if esize == 4:  # the backward adds the mbarrier of its dW products
        return slots * bm * H * 4 + stages * (F32_STAGE_BYTES + 16) + (8 if kind == "bwd" else 0) + bm * 4 + pair
    ring = stages * (CHUNK_BYTES + 16)
    warps_sums = 4 * wgs * H * 4
    if kind == "int8" and cluster > 1:  # all H columns of the slots and four mbarriers a warpgroup
        return slots * wgs * WG_ROWS * H * cluster + ring + wgs * 4 * 8
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
    (``_pair_plan``; the forward's always do); deeper chains in the backward
    have no plan there. The one-CTA backward gives each sample
    ``sample_splits(B, nblk, sms)`` CTAs: a grid of min(B, sms) owner CTAs
    when B >= sms, else B * S. ValueError if the plan does not fit."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if H % 128 != 0:
        raise ValueError(f"the pairwise kernels need H % 128 == 0, got H={H}")
    if H == PAIR_WIDTH and esize == 2:
        plan = _int8_pair_plan(B, ni, nj, H, L, sms) if kind == "int8" else None
        if plan is not None:
            return plan
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
        splits = sample_splits(B, nblk, sms)
        grid = min(B * splits, sms)
    else:
        splits, grid = 1, min(-(-B * nblk // (wgs if kind == "int8" else 1)), sms)
    bm = WG_ROWS if kind == "int8" else WG_ROWS * wgs
    return TilePlan(kind, B, ni, nj, H, L, wgs, stages, slots, grid, smem_bytes(kind, wgs, H, L, slots, stages), bm,
                    splits=splits)


def sample_splits(B: int, nblk: int, sms: int = H100_SMS) -> int:
    """CTAs per sample of the one-CTA backwards (bf16 H <= 384, fp32 H =
    256): 1 when the batch fills the card (B >= sms: a CTA owns whole
    samples), else sms // B, so that B * S CTAs cover the card, and never
    more than the sample's nblk blocks (no split without a block)."""
    return max(1, min(sms // B, nblk))


# Bytes of stored a_{l-1} and dpre_l tiles (the ``act`` buffer) one call of
# the bf16 backward may hold: ``bwd_groups`` runs a batch whose tiles would
# not fit in groups of samples. It holds wide-fp's 12.9 GB at B=512, so that
# the B=512 train steps of both widths (original-fp's 6.44 GB) run as one.
BWD_STORE_BUDGET = 16 << 30


def stored_bytes(plan: TilePlan) -> int:
    """Bytes of the bf16 backward's stored tiles a sample: a_{l-1} and
    dpre_l (l = 1 .. L-1) of each of its nblk blocks of bm rows, all H
    columns (every rank's share in a cluster), in bf16."""
    return 2 * (plan.L - 1) * plan.nblk * plan.bm * plan.H * 2


def bwd_groups(B: int, ni: int, nj: int, H: int, L: int, sms: int = H100_SMS) -> Tuple[Tuple[int, TilePlan], ...]:
    """The sample groups of the bf16 backward: (first sample, the group's
    ``tile_plan("bwd", ...)``) for consecutive groups that cover the batch in
    order. One group when the batch's stored tiles fit BWD_STORE_BUDGET;
    else groups of the most samples that fit (at least one), rounded down to
    fill the card: to whole multiples of ``sms`` samples when that many fit,
    else to sms // ceil(sms / n), whose sample splits give one CTA a unit on
    (nearly) every SM. The last group takes what is left. The shape alone
    decides."""
    per = stored_bytes(tile_plan("bwd", 1, ni, nj, H, L, sms))
    n = max(1, min(B, BWD_STORE_BUDGET // per))
    if n < B:
        n = n // sms * sms if n >= sms else sms // -(-sms // n)
    return tuple((b0, tile_plan("bwd", min(n, B - b0), ni, nj, H, L, sms)) for b0 in range(0, B, n))


def dw_tile(H: int) -> Tuple[int, int]:
    """The output tile (rows, columns) of the bf16 backward's dW GEMM
    (dw_gemm_kernel): 128 x 256, or 128 x 128 where 256 does not divide H."""
    return 128, (256 if H % 256 == 0 else 128)


def dw_splits(plan: TilePlan, sms: int = H100_SMS) -> int:
    """Splits of the pair rows in the bf16 backward's dW GEMM: as many as
    give every SM two of its (L-1) x (H / rows) x (H / columns) output tiles
    (``dw_tile``), at most one per 64-row chunk of the plan's blocks."""
    gm, gn = dw_tile(plan.H)
    tiles = (plan.L - 1) * (plan.H // gm) * (plan.H // gn)
    return max(1, min(plan.B * plan.nblk * plan.bm // WG_ROWS, 2 * sms // tiles))


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
        return smem_bytes(kind, 2, H, L, slots, stages, esize, bm, cluster=PAIR)

    stages = min(hi, (SMEM_LIMIT - smem(0)) // unit)
    if kind == "fwd" and esize == 2:  # a ring of stages / 2 chunks per consumer warpgroup
        stages, lo = stages - stages % 2, 2 * (MIN_STAGES - 1)
    if stages < lo:
        return None
    units = B if kind == "bwd" else B * -(-ni * nj // bm)
    grid = PAIR * min(units, sms // PAIR)
    return TilePlan(kind, B, ni, nj, H, L, 2, stages, slots, grid, smem(stages), bm, esize, PAIR)


def _int8_pair_plan(B: int, ni: int, nj: int, H: int, L: int, sms: int) -> Optional[TilePlan]:
    """The int8 forward at H = PAIR_WIDTH on clusters of PAIR CTAs, or None
    where its tiles do not fit (then the one-CTA kernel). Both CTAs of a
    cluster take the same 64-row tiles, each on H / PAIR of every layer's
    output columns, with two slots of all H columns per warpgroup; as many
    warpgroups (up to INT8_MAX_WGS, each on its own tile) as leave room for
    MIN_STAGES W chunks, one when 128-row tiles would not give every SM one
    (serving buckets: B=1 runs 64 clusters, 128 CTAs); the ring takes what
    is left, up to MAX_STAGES. Grid PAIR * min(ceil(tiles / wgs), sms //
    PAIR); cluster q takes a contiguous share of the tiles (``blocks``)."""

    def stages_for(wgs):
        free = SMEM_LIMIT - smem_bytes("int8", wgs, H, L, 2, 0, cluster=PAIR)
        return min(MAX_STAGES, free // (CHUNK_BYTES + 16))

    fits = [w for w in range(INT8_MAX_WGS, 0, -1) if stages_for(w) >= MIN_STAGES]
    if not fits:
        return None
    wgs = 1 if B * -(-ni * nj // (2 * WG_ROWS)) < sms else fits[0]
    tiles = B * -(-ni * nj // WG_ROWS)
    grid = PAIR * min(-(-tiles // wgs), sms // PAIR)
    stages = stages_for(wgs)
    return TilePlan("int8", B, ni, nj, H, L, wgs, stages, 2, grid,
                    smem_bytes("int8", wgs, H, L, 2, stages, cluster=PAIR), WG_ROWS, cluster=PAIR)


def _tile_plan_f32(kind: str, B: int, ni: int, nj: int, H: int, L: int, sms: int) -> TilePlan:
    """The fp32 ring kernels' plan at H = F32_RING_WIDTH (H = PAIR_WIDTH
    takes ``_pair_plan``'s clusters): blocks of F32_RING_ROWS[kind] rows,
    one activation tile in the forward (each layer in place) and max(2,
    L-1) in the backward (a_0 .. a_{L-2}, dpre_{L-1} in a_0's tile, a_0
    rebuilt), and as many ring stages (at least 2, at most F32_MAX_STAGES)
    as shared memory leaves. The forward walks (sample, block) tiles over
    min(tiles, SMs) CTAs; the backward gives each sample ``sample_splits``
    CTAs (one owner CTA of min(B, SMs) when B >= SMs). ValueError at other
    widths, and where the tiles and two stages do not fit (the backward at
    L > 4, at either width)."""
    if kind == "int8":
        raise ValueError("the int8 kernel has no fp32 plan (esize=4)")
    if H not in (F32_RING_WIDTH, PAIR_WIDTH):
        raise ValueError(f"the fp32 pairwise kernels take H in {(F32_RING_WIDTH, PAIR_WIDTH)}, got H={H}")
    bm = F32_RING_ROWS[kind]
    slots = 1 if kind == "fwd" else max(2, L - 1)
    stages = 0
    if H == F32_RING_WIDTH:
        free = SMEM_LIMIT - smem_bytes(kind, 2, H, L, slots, 0, 4, bm)
        stages = min(F32_MAX_STAGES, free // (F32_STAGE_BYTES + 16))
    if stages < 2:
        raise ValueError(
            f"pairwise_{kind} fp32 kernel at H={H}, L={L} does not fit {SMEM_LIMIT} B of shared memory "
            f"({slots} activation tiles of {bm} x {F32_RING_WIDTH} fp32 and two ring stages)"
        )
    nblk = -(-ni * nj // bm)
    splits = sample_splits(B, nblk, sms) if kind == "bwd" else 1
    grid = min(B * splits, sms) if kind == "bwd" else min(B * nblk, sms)
    return TilePlan(kind, B, ni, nj, H, L, 2, stages, slots, grid, smem_bytes(kind, 2, H, L, slots, stages, 4, bm),
                    bm, 4, splits=splits)


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


def pack_weight_chunks(x: torch.Tensor, size: Optional[int] = None) -> torch.Tensor:
    """x (L-1, N, K), row n holding B^T's row (the K-major B operand of
    ``a . B``), packed as the kernels stream it: per layer, per tile of nt =
    TILE_N rows, per depth chunk of kc = 8192 / (nt * size) columns (64
    bytes), one 8 KB chunk of core matrices (8 rows of 16 contiguous bytes:
    ce = 16 / size elements), the depth's core matrices innermost, where size
    is 1 byte for int8 and 2 for every other dtype (the bf16 operands'
    layout), unless given (``pair_chunk_index`` moves int32 positions in
    either layout). Returns a contiguous (L-1, N/nt, K/kc, nt/8, kc/ce, 8, ce)."""
    n_l, N, K = x.shape
    nt = TILE_N
    size = size or (1 if x.dtype in (torch.int8, torch.uint8) else 2)
    kc = CHUNK_BYTES // size // nt
    ce = 16 // size
    y = x.reshape(n_l, N // nt, nt // 8, 8, K // kc, kc // ce, ce)
    return y.permute(0, 1, 4, 2, 5, 3, 6).contiguous()


_pair_index = {}


def pair_chunk_index(H: int, L: int, size: int, transpose: bool, device) -> torch.Tensor:
    """The flat positions in ws (L-1, H, H) of a cluster kernel's W stream,
    in stream order: ``pack_weight_chunks`` (elements of ``size`` bytes: 1
    for int8, 2 for bf16) of each CTA's ``pair_halves`` slice of W^T
    (``transpose``, the chain's B operand) or of W (the bf16 backward's d
    products'), rank after rank. One ``index_select`` by it packs W in one
    launch where those functions take several. (L-1) * H * H int32, made
    once per shape, layout and device."""
    key = (H, L, size, transpose, str(device))
    idx = _pair_index.get(key)
    if idx is None:
        pos = torch.arange((L - 1) * H * H, dtype=torch.int32).view(L - 1, H, H)
        halves = pair_halves(pos.transpose(1, 2) if transpose else pos)
        idx = pack_weight_chunks(halves.reshape(-1, *halves.shape[2:]), size=size).reshape(-1)
        idx = _pair_index[key] = idx.to(device)
    return idx


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
    u, v and s in 16-byte vectors); (B, ni, nj, H, L) or ValueError."""
    dt = u.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the pairwise kernels: u must be {torch.bfloat16} or {torch.float32}, got {dt}")
    ts = {"u": u, "v": v, "s": s, "qa": qa, "ws": ws, "bs": bs}
    for name, t in ts.items():
        if t.dtype != dt:
            raise ValueError(f"the pairwise kernels take inputs all of one dtype: {name} is {t.dtype}, u is {dt}")
    dims = _check_core_inputs("the pairwise kernels", ts, dict.fromkeys(ts, dt))
    if dt == torch.float32 and any(t.data_ptr() % 16 for t in (u, v, s)):
        raise ValueError("the fp32 kernels read u, v, s in 16-byte vectors: their storage must be 16-byte aligned")
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
    chunks = _pack_for(ws, plan, transpose=True)
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
    upstream gradient g (B, H) fp32; (du, dv, ds, dqa, dws, dbs) in fp32,
    du, dv, ds and dqa views of one buffer. Raises as ``pairwise_fwd_cuda``
    does; ``phases`` as there, for the grid of ``tile_plan("bwd", ...)`` and
    the BWD_PHASES (F32_BWD_PHASES in fp32), where the batch is one sample
    group.

    bf16: each sample group of ``bwd_groups`` is one launch of the fused
    kernel and one of the dW GEMM (``launches[STORED_GROUPS]``), through one
    buffer of stored a_{l-1} and dpre_l tiles within BWD_STORE_BUDGET
    (``stored_bytes`` a sample: 6.44 GB at original-fp B=512).

    Memory: a plan of S = ``plan.splits`` > 1 CTAs per sample adds S zeroed
    fp32 slices of du, dv, ds and dqa (bf16; fp32: of du and dv, and S fp64
    (2, B, H) sums), which a second kernel adds in split order: at
    stretch-fp-32's B=8 (n = 1,024, H = 256) in fp32 (S = 16) the du and dv
    slices are 134 MB each."""
    B, ni, nj, H, L = check_kernel_inputs(u, v, s, qa, ws, bs)
    if g.dtype != torch.float32 or tuple(g.shape) != (B, H) or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous fp32 ({B}, {H}) tensor; got {g.dtype} {tuple(g.shape)}")
    dev = _check_device(BWD_KERNEL, (u, v, s, qa, ws, bs, g))
    drop, seed_ptr, thr, inv_keep = _drop_args(pair_keep, seed, dev)
    if u.dtype == torch.float32:
        return _bwd_f32(u, v, s, qa, ws, bs, g, int(inject), B, ni, nj, H, L, dev, drop, seed_ptr, thr, inv_keep,
                        phases)
    groups = bwd_groups(B, ni, nj, H, L, _sms(dev))
    first = groups[0][1]
    if phases is not None and len(groups) > 1:
        raise ValueError(f"phases: the backward at B={B} runs {len(groups)} sample groups; time one group")
    phase_ptr, defines = _phase_buffer(phases, first.grid, dev)
    lib = _kernel_lib(BWD_KERNEL, defines)
    wt_chunks, w_chunks = (_pack_for(ws, first, transpose) for transpose in (True, False))
    f32 = dict(dtype=torch.float32, device=dev)
    grads, views = _grad_buffer(B, ni, nj, H, dev)
    dws, dbs = torch.empty((L - 1, H, H), **f32), torch.empty((L - 1, H), **f32)
    gemm_splits = dw_splits(first, _sms(dev))
    # the stored a_{l-1}, dpre_l tiles of the largest group, the GEMM's split partials of dW, the CTAs' of db
    act = torch.empty((2, L - 1, first.B * first.nblk, first.cluster, first.bm * first.width), dtype=torch.bfloat16,
                      device=dev)
    dw_part = torch.empty((gemm_splits, L - 1, H, H), **f32)
    db_rows = max(plan.grid for _, plan in groups)
    db_part = torch.zeros((db_rows, L - 1, H), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0, plan in groups:
            # the splits' slices of the group's du | dv | ds | dqa, added in split order after the kernel
            grad_part = (torch.zeros((plan.splits, plan.B * (ni + nj + 2) * H), **f32) if plan.splits > 1
                         else None)
            err = lib.rnet_pairwise_bwd(
                u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), wt_chunks.data_ptr(), w_chunks.data_ptr(),
                bs.data_ptr(), g.data_ptr(), grads.data_ptr(), _ptr(grad_part), dws.data_ptr(), dbs.data_ptr(),
                dw_part.data_ptr(), db_part.data_ptr(), act.data_ptr(), B, b0, plan.B, ni, nj, H, L, int(inject),
                plan.wgs, plan.slots, plan.stages, plan.grid, plan.cluster, gemm_splits, db_rows, plan.splits,
                plan.smem, drop, seed_ptr, thr, inv_keep, phase_ptr, stream,
            )
            _raise_on_error(lib, err, BWD_KERNEL)
            launches[STORED_GROUPS] += 1
    launches[BWD_KERNEL] += 1
    launches["pair_mask"] += drop
    return (*views, dws, dbs)


def _grad_buffer(B: int, ni: int, nj: int, H: int, dev) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One zeroed fp32 buffer du (B, ni, H) | dv (B, nj, H) | ds (B, H) |
    dqa (B, H), as the backward launchers take it, and its four views."""
    grads = torch.zeros(B * (ni + nj + 2) * H, dtype=torch.float32, device=dev)
    du, dv, ds, dqa = grads.split([B * ni * H, B * nj * H, B * H, B * H])
    return grads, (du.view(B, ni, H), dv.view(B, nj, H), ds.view(B, H), dqa.view(B, H))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _pack_for(ws: torch.Tensor, plan: TilePlan, transpose: bool) -> torch.Tensor:
    """W^T (``transpose``) or W of ws (L-1, H, H) as the plan's bf16 or int8
    kernel streams it: ``pack_weight_chunks`` for one CTA; for a cluster,
    each CTA's ``pair_halves`` slice, rank after rank, in one
    ``index_select`` by ``pair_chunk_index``."""
    if plan.cluster == 1:
        return pack_weight_chunks(ws.transpose(1, 2) if transpose else ws)
    size = 1 if ws.dtype in (torch.int8, torch.uint8) else 2
    return ws.reshape(-1).index_select(0, pair_chunk_index(plan.H, plan.L, size, transpose, ws.device))


def _pack_f32_for(ws: torch.Tensor, plan: TilePlan, transpose: bool) -> torch.Tensor:
    """W^T (``transpose``, the chain's B operand) or W (the d products') of
    ws as the fp32 ring kernels stream it: ``pack_f32_weights``, for a
    cluster of each CTA's ``pair_halves`` slice, rank after rank."""
    x = ws.transpose(1, 2) if transpose else ws
    if plan.cluster > 1:
        halves = pair_halves(x, plan.cluster)
        x = halves.reshape(-1, *halves.shape[2:])
    return pack_f32_weights(x)


def _f32_plan(kind, B, ni, nj, H, L, dev, phases):
    """The fp32 plan, the phase buffer's pointer and the library (the
    phase-timing build when ``phases`` is given)."""
    plan = tile_plan(kind, B, ni, nj, H, L, _sms(dev), esize=4)
    phase_ptr, defines = _phase_buffer(phases, plan.grid, dev)
    return plan, phase_ptr, _kernel_lib(F32_LIB, defines)


def _fwd_f32(u, v, s, qa, ws, bs, inject, B, ni, nj, H, L, dev, drop, seed_ptr, thr, inv_keep, phases):
    """The fp32 forward's launch (``pairwise_fwd_cuda`` for fp32 inputs): the
    ring kernel reads W^T split and packed by ``_pack_f32_for``."""
    plan, phase_ptr, lib = _f32_plan("fwd", B, ni, nj, H, L, dev, phases)
    chain = _pack_f32_for(ws, plan, transpose=True)
    partial = torch.empty((B, plan.nblk, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_fwd_f32(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), chain.data_ptr(), bs.data_ptr(),
            partial.data_ptr(), out.data_ptr(), B, ni, nj, H, L, inject, plan.bm, plan.slots, plan.stages, plan.grid,
            plan.cluster, plan.smem, drop, seed_ptr, thr, inv_keep, phase_ptr, stream,
        )
    _raise_on_error(lib, err, F32_KERNEL)
    launches[F32_KERNEL] += 1
    launches["pair_mask"] += drop
    return out


def _bwd_f32(u, v, s, qa, ws, bs, g, inject, B, ni, nj, H, L, dev, drop, seed_ptr, thr, inv_keep, phases):
    """The fp32 backward's launch (``pairwise_bwd_cuda`` for fp32 inputs):
    the ring kernel reads W^T (the chain) and W (the d products) split and
    packed by ``_pack_f32_for``."""
    plan, phase_ptr, lib = _f32_plan("bwd", B, ni, nj, H, L, dev, phases)
    chain, dstages = (_pack_f32_for(ws, plan, transpose) for transpose in (True, False))
    f32 = dict(dtype=torch.float32, device=dev)
    grads, views = _grad_buffer(B, ni, nj, H, dev)
    # the splits' slices of du | dv (fp32), added in split order after the kernel
    grad_part = torch.zeros((plan.splits, B * (ni + nj) * H), **f32) if plan.splits > 1 else None
    dws, dbs = torch.empty((L - 1, H, H), **f32), torch.empty((L - 1, H), **f32)
    dw_part = torch.zeros((plan.grid, L - 1, H, plan.width), **f32)
    # sums over a CTA's or a split's blocks in fp64 (thousands of addends of one sign at n = 1024): db per
    # CTA; ds and dqa per split and sample
    db_part = torch.zeros((plan.grid, L - 1, H), dtype=torch.float64, device=dev)
    sums = torch.zeros((plan.splits, 2, B, H), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_bwd_f32(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), chain.data_ptr(), dstages.data_ptr(),
            bs.data_ptr(), g.data_ptr(), grads.data_ptr(), _ptr(grad_part), dws.data_ptr(), dbs.data_ptr(),
            dw_part.data_ptr(), db_part.data_ptr(), sums.data_ptr(), B, ni, nj, H, L, inject, plan.bm, plan.slots,
            plan.stages, plan.grid, plan.cluster, plan.splits, plan.smem, drop, seed_ptr, thr, inv_keep, phase_ptr,
            stream,
        )
    _raise_on_error(lib, err, F32_BWD_KERNEL)
    launches[F32_BWD_KERNEL] += 1
    launches["pair_mask"] += drop
    return (*views, dws, dbs)


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
    of ``quantize_int8``); (B, H) fp32: at H = PAIR_WIDTH the cluster kernel
    (W gathered by ``pair_chunk_index``), else the one-CTA kernel. Raises on
    anything the kernel does not take, on CPU tensors, and on a failed
    build or launch. ``phases`` as ``pairwise_fwd_cuda``'s, for the grid of
    ``tile_plan("int8", ...)`` and the INT8_PHASES."""
    B, ni, nj, H, L = check_int8_inputs(u, v, s, qa, w8, m, bs)
    dev = _check_device(INT8_KERNEL, (u, v, s, qa, w8, m, bs))
    plan = tile_plan("int8", B, ni, nj, H, L, _sms(dev))
    phase_ptr, defines = _phase_buffer(phases, plan.grid, dev)
    lib = _kernel_lib(INT8_KERNEL, defines)
    chunks = _pack_for(w8, plan, transpose=True)  # row n = column n of W_l: the K-major B operand
    partial = torch.empty((B, plan.nblk, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnet_pairwise_fwd_int8(
            u.data_ptr(), v.data_ptr(), s.data_ptr(), qa.data_ptr(), chunks.data_ptr(), m.data_ptr(),
            bs.data_ptr(), partial.data_ptr(), out.data_ptr(), B, ni, nj, H, L, int(inject), plan.wgs,
            plan.stages, plan.grid, plan.cluster, plan.smem, int(u.dtype == torch.float32), phase_ptr, stream,
        )
    _raise_on_error(lib, err, INT8_KERNEL)
    launches[INT8_KERNEL] += 1
    return out


def f32_supported(H: int, L: int) -> bool:
    """Whether the fp32 kernels take a g_theta chain of width H and L >= 2
    layers, as a shape predicate: ``tile_plan`` has both an fp32 forward and
    an fp32 backward plan for it. That is H in {256, 512} with L <= 4. At
    every other shape (H = 128, or L > 4) ``RelationalLayer``'s ``auto``
    takes ``xla`` and an explicit ``pallas`` raises the planner's
    ValueError."""
    try:
        for kind in ("fwd", "bwd"):
            tile_plan(kind, 1, 1, 1, H, L, esize=4)
    except ValueError:
        return False
    return L >= 2


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
