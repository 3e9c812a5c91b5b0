"""The frozen operation and byte counts and the FLOP model against values
worked out by hand at small shapes (CPU)."""

from __future__ import annotations

import json
import os

import pytest

from portbench import core, ops


def test_forward_counts_at_a_small_shape():
    # B=2, ni=nj=4, H=8, L=3: 2 * 2*4*4 * 2 * 8*8 = 8192 flops
    flops, nbytes = ops.pairwise_fwd_work(2, 4, 4, 8, 3)
    assert flops == 8192.0
    # bf16: u 2*4*8 + v 2*4*8 + s, qa 2*2*8 + W 2*64 + b 2*8 = 304 elements; fp32 out 2*8
    assert nbytes == 2 * 304 + 4 * 16


def test_backward_counts_twice_the_forward_and_no_recompute():
    fwd, _ = ops.pairwise_fwd_work(512, 64, 64, 256, 4)
    bwd, nbytes = ops.pairwise_bwd_work(512, 64, 64, 256, 4)
    assert bwd == 2 * fwd
    n_in = 512 * 64 * 256 * 2 + 2 * 512 * 256 + 3 * 256 * 256 + 3 * 256
    assert nbytes == 2 * n_in + 4 * 512 * 256 + 4 * n_in


def test_int8_counts_at_a_small_shape():
    ops_, nbytes = ops.pairwise_fwd_int8_work(2, 4, 4, 8, 3)
    assert ops_ == 8192.0
    # u, v, s bf16: (8 + 8 + 2) * 8 * 2 bytes; qa, m, b, out fp32: (16 + 2*9 + 16) * 4; W int8 2*64
    assert nbytes == 2 * (64 + 64 + 16) + 4 * (16 + 18 + 16) + 128


def test_roofline_picks_the_larger_bound():
    t, by = ops.roofline_s(989e12, 1.0, ops.PEAK_OPS["bfloat16"])
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = ops.roofline_s(1.0, 3.35e12, ops.PEAK_OPS["bfloat16"])
    assert t == pytest.approx(1.0) and by == "bytes"


def test_original_fp_bounds_match_the_kernel_table():
    # PERF.md's table: the forward's bound 0.834 ms at B=512, n=64, H=256, L=4
    t, _ = ops.roofline_s(*ops.pairwise_fwd_work(512, 64, 64, 256, 4), ops.PEAK_OPS["bfloat16"])
    assert t * 1e3 == pytest.approx(0.834, abs=1e-3)
    t, _ = ops.roofline_s(*ops.pairwise_bwd_work(512, 64, 64, 256, 4), ops.PEAK_OPS["bfloat16"])
    assert t * 1e3 == pytest.approx(1.668, abs=1e-3)
    t, _ = ops.roofline_s(*ops.pairwise_fwd_int8_work(512, 64, 64, 512, 4), ops.PEAK_OPS["int8"])
    assert t * 1e3 == pytest.approx(1.667, abs=1e-3)


def test_flop_model_of_original_fp_by_hand():
    with open(os.path.join(core.ROOT, "configs", "original-fp.json")) as f:
        w = json.load(f)["widths"]
    got = {name: (flops, dt) for name, flops, dt in ops.forward_products(w)}
    # 128 -> 64 -> 32 -> 16 -> 8, 3x3 kernels, 24 channels
    assert got["conv0"] == (2.0 * 64 * 64 * 24 * 9 * 3, "bfloat16")
    assert got["conv3"] == (2.0 * 8 * 8 * 24 * 9 * 24, "bfloat16")
    assert got["lstm"] == (2.0 * 48 * 512 * (32 + 128), "float32")
    assert got["g_projections"] == (2.0 * (2 * 64 * 26 + 128) * 256, "bfloat16")
    assert got["g1"] == got["g3"] == (2.0 * 4096 * 256 * 256, "bfloat16")
    assert got["f_phi"] == (2.0 * (256 * 256 + 256 * 256 + 256 * 28), "float32")
    total = sum(f for f, _ in got.values())
    assert 1.6e9 < total < 1.7e9  # ~1.64 GFLOP a question forward, ~4.9 a training step
    int8 = {name: dt for name, _, dt in ops.forward_products(w, g_dtype="int8")}
    assert int8["g1"] == "int8" and int8["g_projections"] == "bfloat16"


def test_seconds_at_peak_weights_each_dtype():
    prods = [("a", 989e12, "bfloat16"), ("b", 67e12, "float32")]
    assert ops.seconds_at_peak(prods) == pytest.approx(2.0)
    assert ops.seconds_at_peak(prods, 3.0) == pytest.approx(6.0)


def test_slice_reduction_by_hand():
    from portbench.trace import Slice

    dev = [("void pairwise_bwd_kernel<2>(x)", 10.0, 30.0), ("reduce_partials_kernel(y)", 25.0, 40.0),
           ("void pairwise_fwd_int8_kernel<1>(z)", 60.0, 70.0), ("Memcpy HtoD", 95.0, 120.0)]
    spans = [("pb.dispatch", 0.0, 50.0), ("pb.fetch", 40.0, 45.0), ("pb.wait", 70.0, 100.0)]
    s = Slice(0.0, 100.0, dev, spans)
    assert s.window_s == pytest.approx(1e-4)
    assert s.busy_s() == pytest.approx((30 + 10 + 5) / 1e6)  # [10, 40], [60, 70], [95, 100] inside the slice
    assert s.idle_share() == pytest.approx(0.55)
    assert s.kernel_count(["pairwise_bwd_kernel"]) == 1 and s.kernel_count(["pairwise_fwd_kernel"]) == 0
    assert s.kernel_s(["pairwise_bwd_kernel", "reduce_partials_kernel"]) == pytest.approx(35 / 1e6)
    gaps = s.idle_gaps(3)  # [70, 95] in pb.wait, [40, 60] in pb.fetch (innermost), [0, 10] in pb.dispatch
    assert [g[0] for g in gaps] == ["pb.wait", "pb.fetch", "pb.dispatch"]
    assert [round(g[1] * 1e6) for g in gaps] == [25, 20, 10]
