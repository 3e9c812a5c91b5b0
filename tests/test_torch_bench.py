"""``python -m rnet_torch.bench`` against rnet's top-level ``bench.py``, on the CPU.

* ``reference_gpu_bound_qps`` (the FLOP-model bounds, from the port's
  config) equals ``bench.reference_gpu_bound_qps`` key for key.
* The JSON line of ``rnet_torch.bench.main`` (``--platform cpu``, original-fp
  shrunk through a temp ``config.json``, K=2 and a short window) has exactly the keys of the dict
  literal in ``bench.main`` (read with ``ast`` from ``bench.py``) plus
  ``device``, finite positive q/s, and ``vs_baseline`` from
  ``BENCH_BASELINE.json`` or -1.0 without it.
* ``measure_train_qps`` / ``measure_infer_qps`` run eagerly on the CPU at
  the shrunk shape (B=4, K=2): finite positive q/s, the state's step
  advanced by exactly the steps taken, and the first step's metrics equal
  to ``rnet_torch.train.steps.train_step`` (the first evaluation's to
  ``eval_step``) on the same batch and weights.
* ``pick_windows`` is rnet's ``_pick_k`` (``rnet/utils/timing.py``) in chunk
  units: the same long window rounded up to whole chunks, the same guard.

The numbers are CPU numbers: they say the arithmetic and the bookkeeping
are right, nothing of the card's speed.
"""

import ast
import json
import math
import os

import pytest
import torch

import bench as rnet_bench
from rnet.utils.timing import _pick_k
from rnet_torch import bench
from rnet_torch.train import steps as tsteps

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, K = 4, 2
SHRUNK = dict(image_size=32, g_layers=[32, 32, 32, 32], f_layers=[32, 32], lstm_hidden=16, lstm_word_emb=8,
              question_max_len=12)


@pytest.fixture(scope="module")
def small_config(tmp_path_factory):
    with open(os.path.join(REPO, "config.json")) as f:
        cfg = json.load(f)["original-fp"]
    cfg.update(SHRUNK)
    path = tmp_path_factory.mktemp("cfg") / "config.json"
    path.write_text(json.dumps({"original-fp": cfg}))
    return str(path)


def _bench_main_keys():
    """The keys of the dict literal that bench.main prints."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    dicts = [n for n in ast.walk(main) if isinstance(n, ast.Dict) and any(
        isinstance(k, ast.Constant) and k.value == "metric" for k in n.keys)]
    assert len(dicts) == 1
    return {k.value for k in dicts[0].keys}


def test_reference_gpu_bound_qps_matches_bench():
    assert bench.reference_gpu_bound_qps() == rnet_bench.reference_gpu_bound_qps()


def test_get_torch_baseline_reads_the_cache(tmp_path):
    with open(os.path.join(REPO, "BENCH_BASELINE.json")) as f:
        want = json.load(f)["torch_cpu_oracle_train_qps"]
    assert bench.get_torch_baseline() == want == rnet_bench.get_torch_baseline()
    assert math.isnan(bench.get_torch_baseline(str(tmp_path / "missing.json")))


@pytest.mark.parametrize("baseline", ["cached", "missing"])
def test_json_line_has_bench_keys(small_config, baseline, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("RNET_BENCH_BS", str(B))
    monkeypatch.setattr(bench, "STEPS_PER_CHUNK", K)
    monkeypatch.setattr(bench, "TARGET_S", 0.01)
    if baseline == "missing":
        monkeypatch.setattr(bench, "BASELINE_PATH", str(tmp_path / "missing.json"))
    rc = bench.main(["--platform", "cpu", "--config", small_config])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == _bench_main_keys() | {"device"}
    assert line["metric"] == "clevr_fp_train_questions_per_sec_per_chip" and line["unit"] == "questions/s"
    assert line["backend"] == "cpu" and line["device"] == "cpu" and line["batch_size"] == B
    for key in ("value", "infer_qps", "xla_impl_train_qps", "vs_v100_fp32_flop_bound"):
        assert math.isfinite(line[key]) and line[key] >= 0, key
    assert line["value"] > 0 and line["infer_qps"] > 0 and line["xla_impl_train_qps"] > 0
    if baseline == "missing":
        assert line["vs_baseline"] == -1.0
    else:
        assert abs(line["vs_baseline"] - line["value"] / bench.get_torch_baseline()) <= 0.01


@pytest.mark.parametrize("rl_impl", ["auto", "pallas"])
def test_measure_train_qps_steps_and_first_loss(small_config, rl_impl):
    """``pallas`` on the CPU: the kernels' plain versions; ``auto``: ``xla``."""
    m = bench.measure_train_qps(rl_impl, B, "cpu", config_path=small_config, k=K, target_s=0.01)
    assert math.isfinite(m.qps) and m.qps > 0 and m.step_s > 0
    assert m.k == K and m.windows[0] < m.windows[1]
    assert m.calls == 1 + sum(bench.PROBES) + bench.REPEATS * sum(m.windows)
    assert m.state.step == m.steps == m.calls * K
    assert m.pool_mb is None and tuple(m.first.shape) == (K, 3)
    state, batch = bench.bench_setup(rl_impl, B, "cpu", small_config)
    first = tsteps.train_step(state, batch)
    assert torch.equal(m.first[0], torch.stack([first["loss"], first["accuracy"], first["grad_norm"]]))
    second = tsteps.train_step(state, batch)
    assert torch.equal(m.first[1, 0], second["loss"])


def test_measure_infer_qps_matches_eval_step(small_config):
    m = bench.measure_infer_qps("auto", B, "cpu", config_path=small_config, k=K, target_s=0.01)
    assert math.isfinite(m.qps) and m.qps > 0
    assert m.state.step == 0 and m.steps == m.calls * K
    state, batch = bench.bench_setup("auto", B, "cpu", small_config)
    want = tsteps.eval_step(state, batch)
    for k in range(K):
        assert torch.equal(m.first["pred"][k], want["pred"])
        assert torch.equal(m.first["nll_sum"][k], want["nll_sum"])


@pytest.mark.parametrize("ta, tb", [(0.05, 0.2), (0.2, 0.05), (0.01, 0.011), (1e-4, 6e-4), (3.0, 18.0),
                                    (0.5, 0.5)])
def test_pick_windows_is_rnets_pick_k_in_chunks(ta, tb):
    """At K=16 the probe windows are rnet's 16 and 96 steps: the long window
    is ``_pick_k``'s rounded up to whole chunks, the short one a fifth of it;
    a poisoned difference (tb <= ta) falls back to the same upper bound."""
    assert tuple(K_ * 16 for K_ in bench.PROBES) == (16, 96)
    n1, n2 = bench.pick_windows(ta, tb, 16)
    _, k2 = _pick_k(ta, tb, bench.TARGET_S)
    assert (n2 - 1) * 16 < k2 <= n2 * 16
    assert n1 == max(n2 // 5, 1) and n1 < n2


@pytest.mark.parametrize("k", [1, 2, 4])
def test_pick_windows_counts_steps_at_any_chunk(k):
    """The same per-step rate gives the same long window in steps, whatever K."""
    per_step = 2e-3
    n1, n2 = bench.pick_windows(bench.PROBES[0] * k * per_step, bench.PROBES[1] * k * per_step, k)
    _, k2 = _pick_k(16 * per_step, 96 * per_step, bench.TARGET_S)
    assert (n2 - 1) * k < k2 <= n2 * k and n1 == max(n2 // 5, 1)
