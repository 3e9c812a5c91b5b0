"""Tile plans and weight packing of the pairwise kernels, on the CPU.

``rnet_torch.kernels.pairwise.tile_plan`` decides how the CUDA kernels of
``csrc/pairwise_fwd.cu``, ``csrc/pairwise_bwd.cu``,
``csrc/pairwise_fwd_int8.cu`` and (``esize=4``) ``csrc/pairwise_f32.cu``
cover a shape: rows per block, warpgroups, ring stages, shared memory and
the persistent grid. The launchers refuse a plan they cannot take; these
tests hold every plan the repository can ask for (each g_theta width and
object grid of ``config.json``, and every agreement case of
``chip_smoke.py``, bf16, int8 and fp32) to what the kernels rely on:

* shared memory within the 232,448 bytes a CTA may use on Hopper;
* the pair rows of every sample tiled exactly once, only the last block of a
  sample ragged (its surplus rows masked);
* in the backward, one owner CTA per sample when the batch fills the card
  (du, dv, ds, dqa have one writer); with fewer samples than SMs, SMs // B
  CTAs per sample (at H <= 384 in bf16, H = 256 in fp32), each on a
  contiguous, ordered share of its blocks and its own slice of du, dv, ds
  and dqa; at H = 512 one owner cluster of two CTAs, each on its half of
  the output columns, so that every (row, column) still has one writer;
* at B >= SMs the backward's plan is the one-owner plan field for field;
* the bf16 backward's sample groups (``bwd_groups``) cover the batch in
  order, each group's stored tiles within BWD_STORE_BUDGET, and its dW
  GEMM's row splits cover every 64-row chunk once, in order;
* at H = 512 the forward on clusters of two CTAs too, both on the same
  tiles, each on its half of the columns.
"""

from __future__ import annotations

import itertools
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from rnet_torch.config import load_config
from rnet_torch.kernels import pairwise as tpw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = tpw.H100_SMS


def _config_shapes():
    """(name, ni, nj, H, L) of every model in config.json."""
    with open(os.path.join(ROOT, "config.json")) as f:
        names = list(json.load(f))
    out = []
    for name in names:
        cfg = load_config(name)
        out.append((name, cfg.n_objects, cfg.n_objects, cfg.g_layers[1], len(cfg.g_layers)))
    return out


CONFIGS = _config_shapes()
# (B, ni, nj, H, L): each config at the serving buckets, a batch above the SM
# count and the training batch (the 32 x 32 grid, a million pair rows a
# sample, at the buckets only: the row walk below enumerates every block);
# every agreement case of chip_smoke.py (bf16 and int8); the backward's
# batches below the SM count: stretch-fp-32 at B=16, as rnet trained it, and
# original-fp at B=66 (two CTAs a sample) and from 67 to 131 (one)
SMALL_BATCHES = {(16, 1024, 1024, 256, 4)} | {(B, 64, 64, 256, 4) for B in (66, 67, 100, 131)}
SHAPES = sorted(
    {(B, n, n, H, L) for _, n, _, H, L in CONFIGS for B in ((1, 8, 64, 140, 512) if n <= 256 else (1, 8))}
    | {(B, ni, nj, H, L) for B, ni, nj, H, L, _ in chip_smoke.CASES}
    | {case[:5] for case, _, _ in chip_smoke.INT8_CASES}
    | SMALL_BATCHES
)
KINDS = ["fwd", "bwd", "int8"]
F32_SHAPES = sorted(
    {(B, n, n, H, L) for _, n, _, H, L in CONFIGS for B in ((1, 8, 64, 140, 512) if n <= 256 else (1, 8))}
    | {case[:5] for case in chip_smoke.F32_CASES}
    | SMALL_BATCHES
)


def test_shapes_cover_the_configs_and_the_smoke_cases():
    widths = {H for _, _, _, H, _ in CONFIGS}
    grids = {n for _, n, _, _, _ in CONFIGS}
    assert widths == {256, 512} and {12, 64, 256, 1024} <= grids
    assert chip_smoke.TRAIN_CASE[:5] in SHAPES and any(B > SMS for B, *_ in SHAPES)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_plan_fits_shared_memory_and_the_kernels_limits(kind, shape):
    B, ni, nj, H, L = shape
    plan = tpw.tile_plan(kind, B, ni, nj, H, L, SMS)
    assert plan.smem <= tpw.SMEM_LIMIT
    assert plan.cluster == (tpw.PAIR if H == tpw.PAIR_WIDTH else 1)
    assert plan.smem == tpw.smem_bytes(kind, plan.wgs, H, L, plan.slots, plan.stages, bm=plan.bm,
                                       cluster=plan.cluster)
    assert tpw.MIN_STAGES <= plan.stages <= tpw.MAX_STAGES
    if kind == "int8":  # each warpgroup its own 64-row block
        assert 1 <= plan.wgs <= tpw.INT8_MAX_WGS and plan.bm == 64
    elif kind == "fwd" and plan.cluster > 1:  # two warpgroups on the columns of 64- or 128-row blocks
        assert plan.wgs == 2 and plan.bm in (64, 128)
    else:
        assert plan.wgs in (1, 2) and plan.bm == 64 * plan.wgs
    assert H % tpw.TILE_N == 0
    assert plan.slots == (max(3, L - 1) if kind == "bwd" else 2)
    assert 1 <= plan.grid <= SMS
    # the fp32 dpre_0 tile of the backward's column pass fits the dead slots
    if kind == "bwd":
        tile_bytes = plan.bm * tpw.TILE_N * 4
        free = (2 if plan.width == tpw.TILE_N else 1) * plan.bm * plan.width * 2
        assert tile_bytes <= free


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_plan_tiles_every_row_exactly_once(kind, shape):
    _assert_tiles_every_row_once(tpw.tile_plan(kind, *shape, SMS))


def _assert_tiles_every_row_once(plan):
    """Every (pair row, output column) of every sample in exactly one block
    of one CTA: the CTAs of a cluster walk the same rows, each on its own
    columns, and together cover all H."""
    B, npairs = plan.B, plan.ni * plan.nj
    covered = {}
    for cta in range(plan.grid):
        cols = plan.columns(cta)
        assert len(cols) == plan.width == plan.H // plan.cluster
        for b, p0, rows in plan.blocks(cta):
            assert 0 < rows <= plan.bm and p0 % plan.bm == 0
            assert rows == plan.bm or p0 + rows == npairs  # only a sample's last block is ragged
            covered.setdefault((b, cols.start), []).append((p0, rows))
    assert sorted(covered) == [(b, c) for b in range(B) for c in range(0, plan.H, plan.width)]
    for blocks in covered.values():
        blocks.sort()
        assert [p0 for p0, _ in blocks] == list(range(0, npairs, plan.bm))
        assert sum(rows for _, rows in blocks) == npairs
    for q in range(0, plan.grid, plan.cluster):  # a cluster's CTAs: every column once
        cols = sorted(c for cta in range(q, q + plan.cluster) for c in plan.columns(cta))
        assert cols == list(range(plan.H))
    assert plan.nblk == -(-npairs // plan.bm)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_backward_owns_or_splits_each_sample(shape):
    _assert_backward_units(tpw.tile_plan("bwd", *shape, SMS))


def _assert_backward_units(plan, sms=SMS):
    """The backward's units. B >= SMs, or a cluster (H = 512): one owner CTA
    per sample, or one owner cluster whose CTAs own the sample's columns one
    share each, on a grid of min(B, SMs) CTAs (clusters). One CTA and B <
    SMs: S = min(SMs // B, nblk) splits a sample, a grid of B * S CTAs, CTA
    b * S + k on split k of sample b alone: the contiguous blocks [k * nblk
    / S, (k + 1) * nblk / S) in order, the splits covering the sample's
    blocks once, in split order."""
    B, S = plan.B, plan.splits
    units = {}
    for cta in range(plan.grid):
        for b, p0, _ in plan.blocks(cta):
            units.setdefault(b, {}).setdefault(cta, []).append(p0 // plan.bm)
    assert sorted(units) == list(range(B))
    if B >= sms or plan.cluster > 1:
        assert S == 1 and plan.grid == plan.cluster * min(B, sms // plan.cluster)
        for ctas in units.values():
            assert len({cta // plan.cluster for cta in ctas}) == 1 and len(ctas) == plan.cluster
            assert sorted(plan.columns(cta).start for cta in ctas) == list(range(0, plan.H, plan.width))
            assert all(blocks == list(range(plan.nblk)) for blocks in ctas.values())
        return
    assert S == min(sms // B, plan.nblk) >= 1 and plan.grid == B * S <= sms
    for b, ctas in units.items():
        assert sorted(ctas) == [b * S + k for k in range(S)]  # one unit a CTA: split k of sample b
        for cta, blocks in ctas.items():
            k = cta - b * S
            assert blocks == list(plan.split_blocks(k)) == list(range(k * plan.nblk // S, (k + 1) * plan.nblk // S))
            assert blocks  # no split without a block
        assert [blk for k in range(S) for blk in ctas[b * S + k]] == list(range(plan.nblk))


# The parent's backward plans at B >= SMs (one owner CTA or cluster per
# sample), field for field: (B, ni, nj, H, L, esize) -> (wgs, stages, slots,
# grid, smem, bm, cluster), as tile_plan gave them before the sample
# splits; the split plan must leave every one of them as it was (bitwise the
# same gradients at B=512 and B=140).
ONE_OWNER_PLANS = {
    (140, 12, 12, 512, 4, 2): (2, 4, 3, 132, 230096, 128, 2),
    (140, 64, 64, 256, 4, 2): (2, 4, 3, 132, 230080, 128, 1),
    (140, 64, 64, 512, 4, 2): (2, 4, 3, 132, 230096, 128, 2),
    (140, 256, 256, 256, 4, 2): (2, 4, 3, 132, 230080, 128, 1),
    (512, 12, 12, 512, 4, 2): (2, 4, 3, 132, 230096, 128, 2),
    (512, 32, 64, 256, 4, 2): (2, 4, 3, 132, 230080, 128, 1),
    (512, 64, 64, 256, 4, 2): (2, 4, 3, 132, 230080, 128, 1),
    (512, 64, 64, 512, 4, 2): (2, 4, 3, 132, 230096, 128, 2),
    (512, 256, 256, 256, 4, 2): (2, 4, 3, 132, 230080, 128, 1),
    (140, 64, 64, 384, 4, 2): (1, 8, 3, 132, 213504, 64, 1),
    (140, 12, 12, 512, 4, 4): (2, 2, 3, 132, 229688, 64, 2),
    (512, 64, 64, 256, 2, 4): (2, 6, 2, 132, 229736, 64, 1),
    (512, 64, 64, 256, 3, 4): (2, 6, 2, 132, 229736, 64, 1),
    (140, 64, 64, 256, 4, 4): (2, 2, 3, 132, 229672, 64, 1),
    (140, 64, 64, 512, 4, 4): (2, 2, 3, 132, 229688, 64, 2),
    (140, 256, 256, 256, 4, 4): (2, 2, 3, 132, 229672, 64, 1),
    (512, 12, 12, 512, 4, 4): (2, 2, 3, 132, 229688, 64, 2),
    (512, 64, 64, 256, 4, 4): (2, 2, 3, 132, 229672, 64, 1),
    (512, 64, 64, 512, 4, 4): (2, 2, 3, 132, 229688, 64, 2),
    (512, 256, 256, 256, 4, 4): (2, 2, 3, 132, 229672, 64, 1),
}


@pytest.mark.parametrize("key", sorted(ONE_OWNER_PLANS), ids=lambda k: "B{}-{}x{}-H{}-L{}-e{}".format(*k))
def test_backward_plan_at_full_batches_is_the_one_owner_plan(key):
    """B >= SMs: the parent's plan field for field, one split, and each CTA
    the blocks of the samples c, c + grid, ... (the same launch)."""
    *shape, esize = key
    plan = tpw.tile_plan("bwd", *shape, SMS, esize=esize)
    assert (plan.wgs, plan.stages, plan.slots, plan.grid, plan.smem, plan.bm, plan.cluster) == ONE_OWNER_PLANS[key]
    assert plan.splits == 1 and plan.split_blocks(0) == range(plan.nblk)
    npairs = plan.ni * plan.nj
    for cta in (0, 1, plan.grid - 1):
        q, owners = cta // plan.cluster, plan.grid // plan.cluster
        assert plan.blocks(cta) == [(b, k * plan.bm, min(plan.bm, npairs - k * plan.bm))
                                    for b in range(q, plan.B, owners) for k in range(plan.nblk)]


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape, splits, grid", [
    ((8, 1024, 1024, 256, 4), 16, 128), ((16, 1024, 1024, 256, 4), 8, 128), ((64, 64, 64, 256, 4), 2, 128),
    ((66, 64, 64, 256, 4), 2, 132), ((67, 64, 64, 256, 4), 1, 67), ((100, 64, 64, 256, 4), 1, 100),
    ((131, 64, 64, 256, 4), 1, 131)], ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s) if isinstance(s, tuple) else "")
def test_backward_splits_small_batches_over_the_card(esize, shape, splits, grid):
    """Below the SM count the one-CTA backward covers the card: stretch-fp-32
    at B=8 and 16 and the CLI's default B=64 on 128 CTAs, B=66 on 132; from
    B = 67 to 131 one CTA a sample, a grid of B."""
    plan = tpw.tile_plan("bwd", *shape, SMS, esize=esize)
    assert (plan.splits, plan.grid) == (splits, grid)


@pytest.mark.parametrize("shape, esize", [
    pytest.param(shape, esize, id="B{}-{}x{}-H{}-L{}-".format(*shape) + name)
    for shape in [(1, 64, 64, 256, 4), (3, 12, 12, 128, 3), (3, 24, 24, 256, 4), (8, 256, 256, 256, 4),
                  (16, 64, 64, 256, 4)]
    for esize, name in ((2, "bf16"), (4, "fp32")) if esize == 2 or shape[3] != 128])
def test_backward_splits_on_a_smaller_card(esize, shape):
    """tile_plan(..., sms=16), the switch the CPU tests build split plans
    with: the same units on 16 SMs (B=3 at 12 x 12: 5 splits capped at the
    sample's blocks; B=16: one owner CTA). H=128 in bf16 alone: the fp32
    kernels have no plan there."""
    plan = tpw.tile_plan("bwd", *shape, 16, esize=esize)
    _assert_tiles_every_row_once(plan)
    _assert_backward_units(plan, sms=16)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", F32_SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_f32_plan_fits_shared_memory_and_the_kernels_limits(kind, shape):
    """The fp32 ring kernels. At H = 256: blocks of F32_RING_ROWS[kind] rows
    (64 per consumer warpgroup), one activation tile in the forward and
    max(2, L-1) in the backward, and as many 16 KB ring stages (2 ..
    F32_MAX_STAGES) as shared memory leaves; at H = 512 the same on clusters
    of two CTAs, each on 256 of the columns. Within shared memory."""
    B, ni, nj, H, L = shape
    plan = tpw.tile_plan(kind, B, ni, nj, H, L, SMS, esize=4)
    assert plan.esize == 4 and plan.smem <= tpw.SMEM_LIMIT and plan.wgs == 2
    assert plan.smem == tpw.smem_bytes(kind, 2, H, L, plan.slots, plan.stages, esize=4, bm=plan.bm,
                                       cluster=plan.cluster)
    assert 1 <= plan.grid <= SMS
    pair = H == tpw.PAIR_WIDTH
    assert plan.cluster == (tpw.PAIR if pair else 1)
    assert plan.width == tpw.F32_RING_WIDTH
    # two warpgroups: on their own 64 rows each (all H columns), or on 128 columns each of 64 rows
    assert plan.bm == tpw.F32_RING_ROWS[kind] == (128 if kind == "fwd" else 64)
    assert plan.slots == (max(2, L - 1) if kind == "bwd" else 1)
    assert 2 <= plan.stages <= tpw.F32_MAX_STAGES
    more = tpw.smem_bytes(kind, 2, H, L, plan.slots, plan.stages + 1, esize=4, bm=plan.bm, cluster=plan.cluster)
    assert plan.stages == tpw.F32_MAX_STAGES or more > tpw.SMEM_LIMIT
    assert H % (tpw.F32_STAGE_BYTES // 8 // plan.width) == 0  # whole stages a layer


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", F32_SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_f32_plan_tiles_every_row_exactly_once(kind, shape):
    """Every pair row of every sample in exactly one block, only a sample's
    last block ragged; in the backward each sample has one owner CTA, or
    below the SM count SMs // B CTAs on ordered shares of its blocks."""
    plan = tpw.tile_plan(kind, *shape, SMS, esize=4)
    _assert_tiles_every_row_once(plan)
    if kind == "bwd":
        _assert_backward_units(plan)


PAIR_SHAPES = sorted({shape for shape in SHAPES + F32_SHAPES if shape[3] == tpw.PAIR_WIDTH})


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_pair_plan_splits_the_columns_over_a_cluster(esize, shape):
    """The backward at H = 512 (wide-fp's and the SD models' g widths, and
    every H=512 case of chip_smoke.py), bf16 and fp32: clusters of two CTAs
    within shared memory, each on 256 of the columns with the H=256 kernels'
    tiles (bf16: 128-row blocks, two warpgroups, >= 3 W chunks; fp32: 64-row
    blocks, >= 2 ring stages), every (row, column) once, one owner cluster
    per sample. dW's bytes per pair row: fp32, each CTA reads and writes
    its (L-1) x H x H/2 partial once per 64 rows, a quarter of what the
    one-CTA wide kernel's (L-1) x H x H partial cost per row over its
    16-row blocks; bf16, each CTA writes a_{l-1} and dpre_l of its columns
    once and the GEMM reads them once, ``stored_bytes`` a sample, per row and
    column what the one-CTA route stores at H=256."""
    B, ni, nj, H, L = shape
    plan = tpw.tile_plan("bwd", *shape, SMS, esize=esize)
    assert (plan.cluster, plan.width, plan.wgs) == (tpw.PAIR, H // 2, 2) and plan.grid % 2 == 0
    assert plan.smem <= tpw.SMEM_LIMIT
    assert plan.smem == tpw.smem_bytes("bwd", 2, H, L, plan.slots, plan.stages, esize, plan.bm, tpw.PAIR)
    if esize == 2:
        assert (plan.bm, plan.slots) == (128, max(3, L - 1)) and plan.stages >= tpw.MIN_STAGES
    else:
        assert (plan.bm, plan.slots) == (64, max(2, L - 1)) and plan.stages >= 2
    _assert_tiles_every_row_once(plan)
    _assert_backward_units(plan)
    if esize == 2:  # a_{l-1} and dpre_l of each rank's columns in bf16, written once and read once, per pair row
        stored = 2 * plan.cluster * 2 * (L - 1) * plan.width * 2
        assert stored == 2 * tpw.stored_bytes(plan) / (plan.nblk * plan.bm)
        one = tpw.tile_plan("bwd", B, ni, nj, 256, L, SMS)
        assert one.cluster == 1 and stored / H == 2 * tpw.stored_bytes(one) / (one.nblk * one.bm) / 256
    else:  # the one-CTA wide kernel read and wrote an (L-1) x H x H fp32 partial per 16-row block
        one_cta = 2 * (L - 1) * H * H * 4 / 16
        flush = plan.cluster * 2 * (L - 1) * H * plan.width * 4 / plan.bm
        assert flush * 4 == one_cta


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_pair_forward_plan_splits_the_columns_over_a_cluster(esize, shape):
    """The forward at H = 512 (every config and serving bucket at H=512 and
    every H=512 case of chip_smoke.py), bf16 and fp32: clusters of two CTAs
    within shared memory, both CTAs of a cluster on the same tiles, each on
    256 of the columns with the H=256 kernels' tiles (fp32: the ring
    forward's one 128-row tile and >= 2 stages; bf16: two slots of 128 rows,
    or of 64 where 128-row tiles would not give every cluster one, two
    warpgroups on 128 columns each, and >= 3 W chunks), every (row, column) once, a grid
    of two CTAs per tile up to the card's SMs. W bytes per pair row against
    the one-CTA plans the pair replaced: fp32, tf32 hi and lo of each rank's
    half per 128-row block, half the wide kernel's fp32 W per 32-row block;
    bf16, each rank's half of W per block, half the one-warpgroup plan's
    all of W per 64-row block on 128-row blocks (the same on 64-row ones)."""
    B, ni, nj, H, L = shape
    plan = tpw.tile_plan("fwd", *shape, SMS, esize=esize)
    assert (plan.cluster, plan.width) == (tpw.PAIR, H // 2) and plan.grid % 2 == 0
    assert plan.smem <= tpw.SMEM_LIMIT
    assert plan.smem == tpw.smem_bytes("fwd", plan.wgs, H, L, plan.slots, plan.stages, esize, plan.bm, tpw.PAIR)
    tiles = B * plan.nblk
    assert plan.grid == tpw.PAIR * min(tiles, SMS // tpw.PAIR)
    for q in range(0, plan.grid, plan.cluster):
        assert plan.blocks(q) == plan.blocks(q + 1)  # both CTAs of a cluster walk the same tiles
        assert [plan.columns(c) for c in (q, q + 1)] == [range(0, H // 2), range(H // 2, H)]
    _assert_tiles_every_row_once(plan)
    if esize == 4:
        assert (plan.bm, plan.slots, plan.wgs) == (128, 1, 2)
        assert 2 <= plan.stages <= tpw.F32_MAX_STAGES
        old = H * H * 4 / 32  # fp32 W bytes per pair row of the one-CTA wide forward
        new = plan.cluster * plan.width * H * 8 / plan.bm  # tf32 hi and lo of each rank's rows
    else:
        few = B * -(-ni * nj // 128) < SMS // tpw.PAIR
        assert (plan.wgs, plan.bm, plan.slots) == ((2, 64, 2) if few else (2, 128, 2))
        assert 2 * (tpw.MIN_STAGES - 1) <= plan.stages <= tpw.MAX_STAGES and plan.stages % 2 == 0  # a ring each
        old = H * H * 2 / 64
        new = plan.cluster * plan.width * H * 2 / plan.bm
    assert new * (plan.bm // 64 if esize == 2 else 2) == old


# The bf16 backward's dW GEMM off the cluster width: original-fp at B=512 and
# 64 (128-row blocks, tiles of 128 x 256), H=384 (64-row blocks, 128 x 128)
# and H=128 (128-row blocks, 128 x 128)
ONE_CTA_GEMM_SHAPES = [(512, 64, 64, 256, 4), (64, 64, 64, 256, 4), (8, 64, 64, 384, 4), (140, 64, 64, 384, 4),
                       (3, 12, 12, 128, 3)]


@pytest.mark.parametrize("shape", PAIR_SHAPES + ONE_CTA_GEMM_SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_dw_gemm_splits_cover_the_rows_in_order(shape):
    """The bf16 backward's dW GEMM: (L-1) x (H/128) x (H/gn) output tiles
    (``dw_tile``: gn = 256, or 128 where 256 does not divide H) cover every
    dW element once, each within one rank's columns; the rows (B x nblk
    blocks of bm, bm / 64 chunks of 64 rows each) split into dw_splits
    contiguous ranges, in order, each chunk in one range, about two CTAs per
    SM and never more splits than chunks. At original-fp's H=256, 6 tiles
    and 44 splits: 264 CTAs, two full waves of the card."""
    plan = tpw.tile_plan("bwd", *shape, SMS)
    B, _, _, H, L = shape
    gm, gn = tpw.dw_tile(H)
    tiles = (L - 1) * (H // gm) * (H // gn)
    assert tiles * gm * gn == (L - 1) * H * H and plan.width % gn == 0 and gn == (256 if H % 256 == 0 else 128)
    splits = tpw.dw_splits(plan, SMS)
    nq = plan.bm // 64 * B * plan.nblk
    assert 1 <= splits <= nq and splits * tiles <= max(2 * SMS, tiles)
    assert splits == nq or (splits + 1) * tiles > 2 * SMS
    ranges = [range(nq * sp // splits, nq * (sp + 1) // splits) for sp in range(splits)]
    assert [q for r in ranges for q in r] == list(range(nq))
    if shape[1:] == (64, 64, 256, 4) and B == 512:
        assert (tiles, splits) == (6, 44)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_backward_sample_groups_cover_the_batch_within_the_budget(shape):
    """``bwd_groups``: consecutive groups of samples cover the batch in
    order, each with the plan ``tile_plan`` gives its size, and each group's
    stored tiles within BWD_STORE_BUDGET (a group of one sample where one
    alone is more); one group when the batch's tiles fit. Several groups
    are all of one size but the last, and fill the card: a whole multiple
    of the SMs, or one unit a CTA on at least 128 of the 132."""
    B, ni, nj, H, L = shape
    groups = tpw.bwd_groups(*shape, SMS)
    per = tpw.stored_bytes(tpw.tile_plan("bwd", 1, ni, nj, H, L, SMS))
    assert [b0 for b0, _ in groups] == list(itertools.accumulate([0] + [p.B for _, p in groups][:-1]))
    assert sum(p.B for _, p in groups) == B
    for b0, plan in groups:
        assert plan == tpw.tile_plan("bwd", plan.B, ni, nj, H, L, SMS)
        assert tpw.stored_bytes(plan) == per
        assert plan.B * per <= tpw.BWD_STORE_BUDGET or plan.B == 1
    assert (len(groups) == 1) == (B * per <= tpw.BWD_STORE_BUDGET)
    if len(groups) > 1:
        n = groups[0][1].B
        assert all(p.B == n for _, p in groups[:-1]) and groups[-1][1].B <= n
        assert n % SMS == 0 or (n < SMS and groups[0][1].grid >= 128)


@pytest.mark.parametrize("shape, n_groups", [
    ((512, 64, 64, 256, 4), 1), ((1024, 64, 64, 256, 4), 1), ((512, 64, 64, 512, 4), 1),
    ((8, 1024, 1024, 256, 4), 2), ((16, 1024, 1024, 256, 4), 4), ((512, 256, 256, 256, 4), 8),
    ((2048, 64, 64, 512, 4), 4)], ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s) if isinstance(s, tuple) else str(s))
def test_backward_sample_groups_by_shape(shape, n_groups):
    """original-fp at B=512 (6.44 GB of tiles) and 1024, and wide-fp at
    B=512 (12.9 GB), run as one group; stretch-fp-32 at B=8 and 16 (3.22 GB
    a sample) in groups of 4 on 33 CTAs a sample, stretch-fp-16 at B=512 (201
    MB a sample) in groups of 66 on 2, wide-fp at B=2048 in groups of 660."""
    groups = tpw.bwd_groups(*shape, SMS)
    assert len(groups) == n_groups
    if n_groups > 1:
        assert groups[0][1].grid == SMS


@pytest.mark.parametrize("esize", [2, 4])
def test_pair_plan_refuses_what_the_cluster_kernels_cannot_take(esize):
    """The plan picks the cluster from the shape alone: clusters of two only
    at H=512, in the backward where its tiles fit (L <= 4; at L=5 neither
    bf16 nor fp32 has a plan), in the forward at every depth (its tiles do
    not grow with L); the other widths and kinds run on one CTA."""
    assert tpw._pair_plan("bwd", 4, 8, 8, 512, 5, SMS, esize) is None
    with pytest.raises(ValueError, match="does not fit"):
        tpw.tile_plan("bwd", 4, 8, 8, 512, 5, SMS, esize=esize)
    assert tpw.tile_plan("bwd", 4, 8, 8, 256, 4, SMS, esize=esize).cluster == 1
    assert tpw.tile_plan("fwd", 4, 8, 8, 512, 4, SMS, esize=esize).cluster == 2
    assert tpw.tile_plan("fwd", 4, 8, 8, 512, 6, SMS, esize=esize).cluster == 2
    assert tpw.tile_plan("fwd", 4, 8, 8, 256, 4, SMS, esize=esize).cluster == 1
    if esize == 2:  # H=384: the one-CTA kernels on one warpgroup
        h384 = tpw.tile_plan("bwd", 4, 8, 8, 384, 4, SMS)
        assert (h384.cluster, h384.wgs) == (1, 1)
        assert tpw.tile_plan("fwd", 512, 64, 64, 384, 4, SMS).cluster == 1


def test_f32_plan_takes_the_most_rows_that_fit():
    """original-fp: the ring forward's 128-row blocks (a warpgroup on 64 rows
    of all 256 columns, one 128 KB tile, 6 stages), the ring backward's
    64-row blocks (two warpgroups on 128 columns each, 2 stages beside three
    64 KB tiles); H=512: the ring backward's 64-row blocks on a cluster of
    two CTAs (256 columns each), the ring forward's 128-row blocks on a
    cluster of two (one 128 KB tile of 256 columns each, 6 stages)."""
    plans = {(kind, H): tpw.tile_plan(kind, 512, 64, 64, H, 4, SMS, esize=4)
             for kind in ("fwd", "bwd") for H in (256, 512)}
    assert {k: p.bm for k, p in plans.items()} == {
        ("fwd", 256): 128, ("fwd", 512): 128, ("bwd", 256): 64, ("bwd", 512): 64}
    assert (plans[("bwd", 512)].cluster, plans[("bwd", 512)].stages, plans[("bwd", 512)].slots) == (2, 2, 3)
    assert (plans[("fwd", 512)].cluster, plans[("fwd", 512)].stages, plans[("fwd", 512)].slots) == (2, 6, 1)
    assert (plans[("fwd", 256)].stages, plans[("bwd", 256)].stages, plans[("bwd", 256)].slots) == (6, 2, 3)
    assert tpw.tile_plan("fwd", 1, 12, 12, 512, 4, SMS, esize=4).nblk == 2  # 144 rows: a ragged second block
    assert tpw.tile_plan("bwd", 1, 12, 12, 256, 4, SMS, esize=4).nblk == 3  # 144 rows in blocks of 64


@pytest.mark.parametrize("H, L, ring", [(256, 4, True), (256, 5, False), (128, 4, False), (512, 4, True),
                                        (256, 2, True), (256, 3, True)])
def test_f32_backward_takes_the_wide_kernel_where_the_ring_does_not_fit(H, L, ring):
    """The ring backward (H = 256, and H = 512 on clusters of two CTAs with
    256 columns each) keeps max(2, L-1) tiles of 64 x 256 fp32 (64 KB): up to
    L = 4 beside two stages. Where the ring does not fit (``ring`` False:
    deeper chains, and H = 128) there is no fp32 plan."""
    if not ring:
        with pytest.raises(ValueError):
            tpw.tile_plan("bwd", 140, 64, 64, H, L, SMS, esize=4)
        return
    plan = tpw.tile_plan("bwd", 140, 64, 64, H, L, SMS, esize=4)
    assert plan.smem <= tpw.SMEM_LIMIT
    assert plan.cluster == (2 if H == 512 else 1)
    assert plan.slots == max(2, L - 1)


@pytest.mark.parametrize("kind, H, L, match", [("fwd", 384, 4, "take H in"), ("bwd", 1024, 4, "take H in"),
                                               ("bwd", 512, 6, "does not fit"), ("int8", 256, 4, "no fp32 plan"),
                                               ("fwd", 96, 4, "H % 128")])
def test_f32_plan_refuses_what_the_kernels_cannot_take(kind, H, L, match):
    with pytest.raises(ValueError, match=match):
        tpw.tile_plan(kind, 4, 8, 8, H, L, SMS, esize=4)


@pytest.mark.parametrize("kind, H, L, match", [("fwd", 128, 3, "take H in"), ("bwd", 128, 3, "take H in"),
                                               ("bwd", 256, 5, "does not fit"), ("bwd", 512, 5, "does not fit")])
def test_f32_plan_has_no_plan_off_the_ring_kernels(kind, H, L, match):
    """The fp32 planner raises where the ring kernels do not run: H=128 (no
    configuration's width) and backward chains deeper than L = 4, whose
    tiles do not fit beside two ring stages, at H=256 and at H=512 (where
    the cluster's tiles do not fit either)."""
    with pytest.raises(ValueError, match=match):
        tpw.tile_plan(kind, 140, 64, 64, H, L, SMS, esize=4)


@pytest.mark.parametrize("H, L, want", [(256, 4, True), (512, 4, True), (256, 2, True), (512, 3, True),
                                        (128, 3, False), (384, 4, False), (256, 5, False), (512, 5, False),
                                        (256, 1, False)])
def test_f32_supported_is_where_both_fp32_plans_exist(H, L, want):
    """``f32_supported`` (the fp32 rule of ``RelationalLayer``'s ``auto``)
    holds exactly where the planner gives an fp32 forward and an fp32
    backward plan, and the chain has the two layers the kernels need."""
    assert tpw.f32_supported(H, L) == want

    def plans():
        return [tpw.tile_plan(kind, 8, 64, 64, H, L, SMS, esize=4) for kind in ("fwd", "bwd")]

    if want:
        assert all(p.esize == 4 for p in plans())
    elif L >= 2:
        with pytest.raises(ValueError):
            plans()


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 computed from the value (not its bits): the
    significand rounded to 11 bits, half away from zero, in float64."""
    m, e = np.frexp(x.astype(np.float64))
    r = np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def test_tf32_round_is_cvt_rna():
    """tf32_round keeps 10 mantissa bits, to nearest with ties away from
    zero, as cvt.rna.tf32.f32: against the rounding of the value, on random
    values, exact ties of both signs, and values that carry into the
    exponent."""
    rs = np.random.RandomState(0)
    x = (rs.randn(4096) * np.exp(rs.uniform(-20, 20, 4096))).astype(np.float32)
    ties = np.array([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-11, 2 - 2.0**-12, -(2 - 2.0**-12), 0.0],
                    dtype=np.float32)
    for arr in (x, ties):
        got = tpw.tf32_round(torch.from_numpy(arr)).numpy()
        assert np.array_equal(got, _tf32_reference(arr))
        assert not (got.view(np.int32) & 0x1FFF).any()
    assert tpw.tf32_round(torch.tensor([1 + 2.0**-11])).item() == 1 + 2.0**-10  # the tie goes away from zero


@pytest.mark.parametrize("H", [128, 256])  # the ring kernels read H = 256; the packing is defined for any H % 128 == 0
def test_f32_weights_split_into_hi_lo_in_stream_order(H):
    """pack_f32_weights: hi = tf32(x) and lo = tf32(x - hi), so hi + lo is x
    within 2^-21 |x|; stage q = l * (H / KD) + k // KD of the stream holds
    hi, then lo, of depth rows k0 .. k0 + KD - 1, each as column tiles of 128
    rows of 8 x 4 core matrices, the depth's innermost: entry (n, k) at
    (n // 128) * 128 KD + (n % 128) // 8 * 8 KD + (k % KD) // 4 * 32 + (n % 8)
    * 4 + k % 4 of its half."""
    kd = tpw.F32_STAGE_BYTES // 8 // H
    rs = np.random.RandomState(H)
    x = (rs.randn(3, H, H) / np.sqrt(H)).astype(np.float32)
    packed = tpw.pack_f32_weights(torch.from_numpy(x))
    assert packed.dtype == torch.float32 and packed.is_contiguous() and packed.numel() == 2 * x.size
    flat = packed.reshape(-1).numpy()
    stage = tpw.F32_STAGE_BYTES // 4
    hi_ref = _tf32_reference(x)
    lo_ref = _tf32_reference((x.astype(np.float64) - hi_ref).astype(np.float32))
    assert np.all(np.abs(x.astype(np.float64) - hi_ref - lo_ref) <= 2.0**-21 * np.abs(x))
    for l, n, k in zip(rs.randint(0, 3, 400), rs.randint(0, H, 400), rs.randint(0, H, 400)):
        q = l * (H // kd) + k // kd
        off = (n // 128) * 128 * kd + (n % 128) // 8 * 8 * kd + (k % kd) // 4 * 32 + (n % 8) * 4 + k % 4
        assert flat[q * stage + off] == hi_ref[l, n, k]
        assert flat[q * stage + stage // 2 + off] == lo_ref[l, n, k]
    w = torch.from_numpy(x)  # the wrappers pack W^T as a view
    assert torch.equal(tpw.pack_f32_weights(w.transpose(1, 2)), tpw.pack_f32_weights(w.transpose(1, 2).contiguous()))


def test_forward_fills_the_card_at_small_batches():
    """Serving buckets take 64-row tiles (one warpgroup), so that B=1 still
    gives 64 CTAs at original-fp; the training batch takes 128-row tiles."""
    small = tpw.tile_plan("fwd", 1, 64, 64, 256, 4, SMS)
    big = tpw.tile_plan("fwd", 512, 64, 64, 256, 4, SMS)
    assert (small.wgs, small.grid) == (1, 64)
    assert (big.wgs, big.bm, big.grid) == (2, 128, SMS)
    wide = tpw.tile_plan("bwd", 512, 64, 64, 512, 4, SMS)  # H=512: a cluster of two CTAs of two warpgroups
    assert (wide.wgs, wide.bm, wide.cluster, wide.grid) == (2, 128, 2, SMS)
    # the H=512 forward's clusters: wide-fp's bucket 1 (32 tiles of 128 rows < 66 clusters) on 64-row
    # blocks, 64 clusters; bucket 8 and the training batch on 128-row blocks
    assert [(p.bm, p.grid) for p in (tpw.tile_plan("fwd", B, 64, 64, 512, 4, SMS) for B in (1, 8, 512))] == [
        (64, 128), (128, SMS), (128, SMS)]
    assert tpw.tile_plan("bwd", 512, 64, 64, 384, 4, SMS).wgs == 1  # H=384: one CTA of one warpgroup


def test_int8_plan_fills_the_card_and_takes_what_fits():
    """The int8 forward: three warpgroups on their own 64-row tiles at
    original-fp (one round of 3 * 132 tiles at a time), one at serving
    bucket 1 (32 tiles of 128 rows < 132 SMs: 64 CTAs of one warpgroup);
    bucket 8 fills the card. At wide-fp's H=512 clusters of two CTAs of
    three warpgroups, each CTA on half of a tile's columns, and one
    warpgroup at bucket 1: 64 clusters, 128 CTAs."""
    small = tpw.tile_plan("int8", 1, 64, 64, 256, 4, SMS)
    assert (small.wgs, small.bm, small.grid) == (1, 64, 64)
    big = tpw.tile_plan("int8", 512, 64, 64, 256, 4, SMS)
    assert (big.wgs, big.bm, big.grid, big.stages) == (3, 64, SMS, tpw.MAX_STAGES)
    assert tpw.tile_plan("int8", 8, 64, 64, 256, 4, SMS).grid == SMS
    wide = tpw.tile_plan("int8", 64, 64, 64, 512, 4, SMS)
    assert (wide.wgs, wide.cluster, wide.grid) == (3, 2, SMS)
    assert wide.smem <= tpw.SMEM_LIMIT and wide.stages >= tpw.MIN_STAGES
    bucket1 = tpw.tile_plan("int8", 1, 64, 64, 512, 4, SMS)
    assert (bucket1.wgs, bucket1.cluster, bucket1.grid, bucket1.stages) == (1, 2, 128, tpw.MAX_STAGES)
    assert tpw.tile_plan("int8", 140, 64, 64, 1024, 4, SMS).wgs == 1  # one warpgroup's slots at H=1024


# The int8 plans off the cluster width (H != 512), field for field as
# tile_plan gave them before the H=512 clusters: (B, ni, nj, H, L) -> (wgs,
# stages, slots, grid, smem, bm, cluster). Every such shape launches the
# same one-CTA kernel instantiation as before, with the same grid.
INT8_ONE_CTA_PLANS = {
    (1, 64, 64, 256, 4): (1, 8, 2, 64, 105600, 64, 1),
    (1, 256, 256, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (1, 1024, 1024, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (2, 16, 40, 256, 3): (1, 8, 2, 20, 104576, 64, 1),
    (2, 16, 64, 256, 4): (1, 8, 2, 32, 105600, 64, 1),
    (3, 12, 12, 128, 3): (1, 8, 2, 9, 85120, 64, 1),
    (3, 24, 24, 256, 4): (1, 8, 2, 27, 105600, 64, 1),
    (8, 64, 64, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (8, 64, 64, 384, 4): (3, 7, 2, 132, 227952, 64, 1),
    (8, 256, 256, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (8, 1024, 1024, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (16, 1024, 1024, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (64, 64, 64, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (64, 256, 256, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (66, 64, 64, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (67, 64, 64, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (100, 64, 64, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (131, 64, 64, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (140, 64, 64, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (140, 256, 256, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (512, 32, 64, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (512, 64, 64, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
    (512, 256, 256, 256, 4): (3, 8, 2, 132, 179328, 64, 1),
}


def test_int8_one_cta_plans_cover_every_shape_off_the_cluster_width():
    assert {shape for shape in SHAPES if shape[3] != tpw.PAIR_WIDTH} == set(INT8_ONE_CTA_PLANS)


@pytest.mark.parametrize("shape", sorted(INT8_ONE_CTA_PLANS), ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_int8_plan_off_the_cluster_width_is_the_one_cta_plan(shape):
    p = tpw.tile_plan("int8", *shape, SMS)
    assert (p.wgs, p.stages, p.slots, p.grid, p.smem, p.bm, p.cluster) == INT8_ONE_CTA_PLANS[shape]


INT8_PAIR_SHAPES = [shape for shape in SHAPES if shape[3] == tpw.PAIR_WIDTH]


@pytest.mark.parametrize("shape", INT8_PAIR_SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_int8_pair_plan_shares_each_tile_over_a_cluster(shape):
    """The int8 forward at H=512: clusters of two CTAs (an even grid), both
    on the same contiguous, ordered range of 64-row tiles, each on its half
    of the columns, every cluster with a tile; as many rounds of wgs tiles
    in both CTAs; B=1 on 64 clusters (128 CTAs)."""
    plan = tpw.tile_plan("int8", *shape, SMS)
    assert plan.cluster == tpw.PAIR and plan.grid % tpw.PAIR == 0 and plan.bm == tpw.WG_ROWS
    assert plan.smem == tpw.smem_bytes("int8", plan.wgs, plan.H, plan.L, 2, plan.stages, cluster=tpw.PAIR)
    assert plan.smem <= tpw.SMEM_LIMIT and tpw.MIN_STAGES <= plan.stages <= tpw.MAX_STAGES
    ntiles = plan.B * plan.nblk
    assert plan.grid == tpw.PAIR * min(-(-ntiles // plan.wgs), SMS // tpw.PAIR)
    walked = []
    for q in range(plan.grid // tpw.PAIR):
        first, second = (plan.blocks(cta) for cta in (tpw.PAIR * q, tpw.PAIR * q + 1))
        assert first == second and first  # the same tiles, in the same order
        assert [plan.columns(cta).start for cta in (tpw.PAIR * q, tpw.PAIR * q + 1)] == [0, plan.width]
        walked += [b * plan.nblk + p0 // plan.bm for b, p0, _ in first]
    assert walked == list(range(ntiles))  # contiguous ranges, cluster after cluster
    if plan.B * -(-plan.ni * plan.nj // (2 * tpw.WG_ROWS)) < SMS:
        assert plan.wgs == 1  # serving buckets: one tile a CTA at a time
    if plan.B == 1 and plan.ni * plan.nj >= 64 * 64:
        assert plan.grid >= 120


@pytest.mark.parametrize("H, L, match", [(96, 4, "H % 128"), (1024, 4, "does not fit"), (512, 6, "does not fit")])
def test_plan_refuses_what_the_kernels_cannot_take(H, L, match):
    with pytest.raises(ValueError, match=match):
        tpw.tile_plan("bwd", 4, 8, 8, H, L, SMS)
    with pytest.raises(ValueError, match="kind"):
        tpw.tile_plan("both", 4, 8, 8, 128, 4, SMS)


@pytest.mark.parametrize("H", [128, 256, 384, 512])
def test_weight_chunks_hold_core_matrices_in_stream_order(H):
    """Chunk q of layer l (q = n_tile * (H / kc) + k_chunk) holds, at element
    ((n % nt) // 8 * (kc // 8) + (k % kc) // 8) * 64 + (n % 8) * 8 + k % 8,
    the entry (n, k) of the packed matrix: the K-major B operand that
    pairwise_chain.cuh's descriptors read."""
    nt = tpw.TILE_N
    kc = tpw.CHUNK_BYTES // 2 // nt
    x = torch.arange(2 * H * H, dtype=torch.float32).reshape(2, H, H)
    flat = tpw.pack_weight_chunks(x).reshape(2, -1)
    assert flat.shape[1] == H * H and tpw.pack_weight_chunks(x).is_contiguous()
    rs = np.random.RandomState(H)
    for l, n, k in zip(rs.randint(0, 2, 200), rs.randint(0, H, 200), rs.randint(0, H, 200)):
        q = (n // nt) * (H // kc) + k // kc
        off = (((n % nt) // 8) * (kc // 8) + (k % kc) // 8) * 64 + (n % 8) * 8 + k % 8
        assert flat[l, q * (tpw.CHUNK_BYTES // 2) + off].item() == x[l, n, k].item()


@pytest.mark.parametrize("H", [128, 256, 512])
def test_int8_weight_chunks_hold_core_matrices_in_stream_order(H):
    """int8 chunks: the same 8 KB chunks of 128-byte core matrices, each 8
    rows x 16 int8 (twice the bf16 depth), 64 columns of depth a chunk:
    entry (n, k) of the packed matrix at element ((n % nt) // 8 * 4 + (k %
    64) // 16) * 128 + (n % 8) * 16 + k % 16 of chunk (n // nt) * (H / 64)
    + k // 64."""
    nt, kc, ce = tpw.TILE_N, 64, 16
    x = torch.from_numpy(np.random.RandomState(H).randint(-127, 128, (2, H, H)).astype(np.int8))
    packed = tpw.pack_weight_chunks(x)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    flat = packed.reshape(2, -1)
    assert flat.shape[1] == H * H
    rs = np.random.RandomState(H + 1)
    for l, n, k in zip(rs.randint(0, 2, 300), rs.randint(0, H, 300), rs.randint(0, H, 300)):
        q = (n // nt) * (H // kc) + k // kc
        off = (((n % nt) // 8) * (kc // ce) + (k % kc) // ce) * 8 * ce + (n % 8) * ce + k % ce
        assert flat[l, q * tpw.CHUNK_BYTES + off].item() == x[l, n, k].item()
    # one byte layout for both element sizes: the int8 chunks are the 16-bit
    # packing of the same bytes read two at a time
    as16 = tpw.pack_weight_chunks(x.view(torch.int16)).view(torch.int8)
    assert torch.equal(as16.reshape(-1), packed.reshape(-1))


def test_weight_chunks_accept_a_transposed_view():
    """The wrappers pack W^T as a view (ws.transpose(1, 2)) for the chain."""
    w = torch.randn(3, 256, 256).to(torch.bfloat16)
    assert torch.equal(tpw.pack_weight_chunks(w.transpose(1, 2)),
                       tpw.pack_weight_chunks(w.transpose(1, 2).contiguous()))


def _pair_halves_packed(x):
    """The W stream of a cluster kernel built in steps: ``pack_weight_chunks``
    of each CTA's ``pair_halves`` slice of x, rank after rank, flat."""
    halves = tpw.pair_halves(x)
    return tpw.pack_weight_chunks(halves.reshape(-1, *halves.shape[2:])).reshape(-1)


@pytest.mark.parametrize("L", [2, 3, 4, 5])
def test_pair_chunk_index_gathers_the_packed_pair_halves(L):
    """The int8 cluster kernel's W stream, one gather of w8 by
    ``pair_chunk_index``, is bit for bit ``pack_weight_chunks`` of each
    CTA's ``pair_halves`` slice of W^T, rank after rank."""
    w8 = torch.from_numpy(np.random.RandomState(L).randint(-127, 128, (L - 1, 512, 512)).astype(np.int8))
    plan = tpw.tile_plan("int8", 8, 64, 64, 512, L, SMS)
    assert plan.cluster == tpw.PAIR
    got = w8.reshape(-1).index_select(0, tpw.pair_chunk_index(512, L, 1, True, "cpu"))
    assert got.dtype == torch.int8 and got.numel() == (L - 1) * 512 * 512
    assert torch.equal(got, _pair_halves_packed(w8.transpose(1, 2)))
    assert torch.equal(tpw._pack_for(w8, plan, transpose=True), got)


@pytest.mark.parametrize("transpose", [True, False], ids=["WT", "W"])
@pytest.mark.parametrize("L", [3, 4])
def test_pair_chunk_index_gathers_the_bf16_streams(L, transpose):
    """The bf16 cluster kernels' W^T (the chain's) and W (the backward's d
    products') streams at H=512, one gather of ws by ``pair_chunk_index``
    in ``_pack_for``, are bit for bit ``pack_weight_chunks`` of each CTA's
    ``pair_halves`` slice, rank after rank, for the forward's and the
    backward's plans alike."""
    ws = torch.from_numpy(np.random.RandomState(10 + L).randn(L - 1, 512, 512).astype(np.float32)).bfloat16()
    want = _pair_halves_packed(ws.transpose(1, 2) if transpose else ws)
    for kind in ("fwd", "bwd"):
        plan = tpw.tile_plan(kind, 8, 64, 64, 512, L, SMS)
        assert plan.cluster == tpw.PAIR
        got = tpw._pack_for(ws, plan, transpose)
        assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16), want.view(torch.int16))
