"""Whole runs of tiny cells on the CPU: the result line's keys, the traced
run's reduction, every fault a cell can have turning ``correct`` false,
and the controls reading further from the reference than the program.
The look for a chip is skipped (``run.run_cell``); everything after it runs
as on the card, with the port's plain CPU versions of its kernels."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import core, run

CELLS = ["ofp.train.b512", "wfp.eval-int8.b512", "ofp.serve.poisson", "ofp.eval.b512"]
SEED = 2**31 + 77


def _run(tiny, cell, trace=False, seconds=0.6):
    root, bench = tiny
    c = core.resolve_cell(cell, bench, root)
    return run.run_cell(c, SEED, seconds, trace, "cpu", time.time())


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny, cell):
    line = _run(tiny, cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    c = core.resolve_cell(cell, tiny[1], tiny[0])
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line["checks"]) == list(k for k in c.limits if not k.startswith("_"))
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_result_line(tiny, cell):
    line = _run(tiny, cell, trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"]) and line["device"]["window_s"] > 0
    c = core.resolve_cell(cell, tiny[1], tiny[0])
    assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}


def _fault_train_state_unchanged(monkeypatch):
    from rnet_torch.train import steps

    def update(state, batch, image_cache):  # forward and backward, but no optimizer step
        loss, acc, grads = steps.loss_and_grads(state.model, batch, state.generator, image_cache)
        return torch.stack([loss, acc, steps.global_norm(grads)])

    monkeypatch.setattr(steps, "_update", update)


def _fault_train_half_batch(monkeypatch):
    from rnet_torch.train import steps

    gather = steps._gather
    monkeypatch.setattr(steps, "_gather", lambda data, idx: gather(data, idx[: idx.shape[0] // 2]))


def _fault_eval_answer_altered(monkeypatch):
    from rnet_torch.train import steps

    eval_step = steps.eval_step

    def altered(state, batch, image_cache=None):
        out = eval_step(state, batch, image_cache)
        out["pred"] = (out["pred"] + 1) % state.model.cfg.n_answers
        return out

    monkeypatch.setattr(steps, "eval_step", altered)


def _fault_serve_answer_altered(monkeypatch):
    from rnet_torch.serve import InferenceServer

    predict = InferenceServer._predict

    def altered(self, inputs, question):
        pred, logp = predict(self, inputs, question)
        return (pred + 1) % self.cfg.n_answers, logp

    monkeypatch.setattr(InferenceServer, "_predict", altered)


FAULTS = [
    ("ofp.train.b512", _fault_train_state_unchanged, "change_gap"),
    ("ofp.train.b512", _fault_train_half_batch, "loss1_gap"),
    ("ofp.eval.b512", _fault_eval_answer_altered, "pred_gap"),
    ("wfp.eval-int8.b512", _fault_eval_answer_altered, "pred_gap"),
    ("ofp.serve.poisson", _fault_serve_answer_altered, "pred_gap"),
]


@pytest.mark.parametrize("cell,fault,number", FAULTS, ids=[f"{c}-{f.__name__[7:]}" for c, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault, number):
    fault(monkeypatch)
    line = _run(tiny, cell)
    assert line["correct"] is False
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]


CONTROLS = [
    ("ofp.train.b512", "fp8", ("loss1_gap", "moment_gap")),
    ("ofp.train.b512", "half_batch", ("loss1_gap", "moment_gap")),
    ("ofp.eval.b512", "fp8", ("nll_gap",)),
    ("wfp.eval-int8.b512", "fp8_int4", ("nll_gap",)),
    ("ofp.serve.poisson", "fp8", ("logp_gap",)),
]


@pytest.mark.parametrize("cell,control,numbers", CONTROLS, ids=[f"{c}-{k}" for c, k, _ in CONTROLS])
def test_controls_read_further_than_the_program(tiny, cell, control, numbers):
    """At a tiny size the cells' limits do not apply; the control still reads
    at least three times what the program reads, on one of its numbers."""
    root, bench = tiny
    c = core.resolve_cell(cell, bench, root)
    entry = core.load_entry(c.traffic["entry"])
    got = entry.calibrate(core.Run(c, SEED, 0.6, False, torch.device("cpu"), time.time()), [control])
    assert any(got[control][k] >= 3 * max(got["program"][k], 1e-7) for k in numbers), got


def test_a_run_loads_no_jax_and_no_rnet(tiny):
    """In a fresh process: a whole tiny run, then its modules' top-level
    names compared whole against jax, jaxlib, flax and rnet."""
    root, _ = tiny
    code = (
        "import sys, json, time; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2]);"
        "import conftest, rnet_torch.config as pc; from portbench import core, run;"
        "bench = conftest.build_tiny_root(sys.argv[3]); pc.DEFAULT_CONFIG_PATH = sys.argv[3] + '/port_config.json';"
        "c = core.resolve_cell('ofp.eval.b512', bench, sys.argv[3]);"
        "line = run.run_cell(c, 5, 0.3, False, 'cpu', time.time());"
        "print(json.dumps({'correct': line['correct'], 'bad': core.forbidden_modules(),"
        " 'port': 'rnet_torch' in sys.modules}))"
    )
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code, core.REPO, os.path.dirname(__file__), root + "-sub"],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": [], "port": True}


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "ofp.eval.b512", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True, timeout=300, cwd=core.REPO,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


CHIP_CONTROLS = [  # (cell, control or fault, seeds of three on which it breaks a limit: PERF.md)
    ("ofp.train.b512", "fp8", 3), ("ofp.train.b512", "half_batch", 3), ("wfp.eval-int8.b512", "fp8_int4", 3),
    ("ofp.serve.poisson", "fp8", 3), ("ofp.eval.b512", "fp8", 3),
]


@pytest.mark.chip
@pytest.mark.parametrize("cell,control,fails", CHIP_CONTROLS, ids=[f"{c}-{k}" for c, k, _ in CHIP_CONTROLS])
def test_control_fails_the_cell_at_its_own_size(cell, control, fails):
    """On the card, at the cell's size, on three seeds: the program's
    readings hold every limit and the control's break one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = core.resolve_cell(cell, core.with_later(core.load_benchmark()))
    entry = core.load_entry(c.traffic["entry"])
    broke = 0
    for seed in (SEED, SEED + 1, SEED + 2):
        got = entry.calibrate(core.Run(c, seed, 5.0, False, torch.device("cuda"), time.time()), [control])
        assert all(ch.ok for ch in core.checks_from(got["program"], c.limits)), (seed, got)
        broke += not all(ch.ok for ch in core.checks_from(got[control], c.limits))
    assert broke >= fails
