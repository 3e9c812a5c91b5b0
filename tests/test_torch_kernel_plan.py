"""Tile plans and weight packing of the bf16 pairwise kernels, on the CPU.

``rnet_torch.kernels.pairwise.tile_plan`` decides how the CUDA kernels of
``csrc/pairwise_fwd.cu`` and ``csrc/pairwise_bwd.cu`` cover a shape: rows
per block, ring stages, shared memory and the persistent grid. The launchers
refuse a plan they cannot take; these tests hold every plan the repository
can ask for (each g_theta width and object grid of ``config.json``, and every
agreement case of ``chip_smoke.py``) to what the kernels rely on:

* shared memory within the 232,448 bytes a CTA may use on Hopper;
* the pair rows of every sample tiled exactly once, only the last block of a
  sample ragged (its surplus rows masked);
* in the backward, one owner CTA per sample (du, dv, ds, dqa have one writer).
"""

from __future__ import annotations

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
# every agreement case of chip_smoke.py
SHAPES = sorted(
    {(B, n, n, H, L) for _, n, _, H, L in CONFIGS for B in ((1, 8, 64, 140, 512) if n <= 256 else (1, 8))}
    | {(B, ni, nj, H, L) for B, ni, nj, H, L, _ in chip_smoke.CASES}
)


def test_shapes_cover_the_configs_and_the_smoke_cases():
    widths = {H for _, _, _, H, _ in CONFIGS}
    grids = {n for _, n, _, _, _ in CONFIGS}
    assert widths == {256, 512} and {12, 64, 256, 1024} <= grids
    assert chip_smoke.TRAIN_CASE[:5] in SHAPES and any(B > SMS for B, *_ in SHAPES)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_plan_fits_shared_memory_and_the_kernels_limits(kind, shape):
    B, ni, nj, H, L = shape
    plan = tpw.tile_plan(kind, B, ni, nj, H, L, SMS)
    assert plan.smem <= tpw.SMEM_LIMIT
    assert plan.smem == tpw.smem_bytes(kind, plan.bm, H, L, plan.slots, plan.stages)
    assert tpw.MIN_STAGES <= plan.stages <= tpw.MAX_STAGES
    assert plan.wgs in (1, 2) and plan.bm == 64 * plan.wgs
    assert H % tpw.TILE_N == 0
    assert plan.slots == (2 if kind == "fwd" else max(3, L - 1))
    assert 1 <= plan.grid <= SMS
    # the fp32 dpre_0 tile of the backward's column pass fits the dead slots
    if kind == "bwd":
        tile_bytes = plan.bm * tpw.TILE_N * 4
        free = (2 if H == tpw.TILE_N else 1) * plan.bm * H * 2
        assert tile_bytes <= free


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_plan_tiles_every_row_exactly_once(kind, shape):
    B, ni, nj, H, L = shape
    plan = tpw.tile_plan(kind, B, ni, nj, H, L, SMS)
    npairs = ni * nj
    covered = {}
    for cta in range(plan.grid):
        for b, p0, rows in plan.blocks(cta):
            assert 0 < rows <= plan.bm and p0 % plan.bm == 0
            assert rows == plan.bm or p0 + rows == npairs  # only a sample's last block is ragged
            covered.setdefault(b, []).append((p0, rows))
    assert sorted(covered) == list(range(B))
    for b, blocks in covered.items():
        blocks.sort()
        assert [p0 for p0, _ in blocks] == list(range(0, npairs, plan.bm))
        assert sum(rows for _, rows in blocks) == npairs
    assert plan.nblk == -(-npairs // plan.bm)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-{}x{}-H{}-L{}".format(*s))
def test_backward_gives_each_sample_one_owner_cta(shape):
    B, ni, nj, H, L = shape
    plan = tpw.tile_plan("bwd", B, ni, nj, H, L, SMS)
    owners = {}
    for cta in range(plan.grid):
        for b, _, _ in plan.blocks(cta):
            owners.setdefault(b, set()).add(cta)
    assert sorted(owners) == list(range(B))
    assert all(len(c) == 1 for c in owners.values())
    assert plan.grid == min(B, SMS)


def test_forward_fills_the_card_at_small_batches():
    """Serving buckets take 64-row tiles (one warpgroup), so that B=1 still
    gives 64 CTAs at original-fp; the training batch takes 128-row tiles."""
    small = tpw.tile_plan("fwd", 1, 64, 64, 256, 4, SMS)
    big = tpw.tile_plan("fwd", 512, 64, 64, 256, 4, SMS)
    assert (small.wgs, small.grid) == (1, 64)
    assert (big.wgs, big.bm, big.grid) == (2, 128, SMS)
    assert tpw.tile_plan("bwd", 512, 64, 64, 512, 4, SMS).wgs == 1  # H=512: one warpgroup


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


def test_weight_chunks_accept_a_transposed_view():
    """The wrappers pack W^T as a view (ws.transpose(1, 2)) for the chain."""
    w = torch.randn(3, 256, 256).to(torch.bfloat16)
    assert torch.equal(tpw.pack_weight_chunks(w.transpose(1, 2)),
                       tpw.pack_weight_chunks(w.transpose(1, 2).contiguous()))
