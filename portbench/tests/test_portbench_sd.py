"""The state-description training cell, ``osd.train.b640``, at a tiny size on
the CPU: its files found by name, whole runs (untraced and traced), the
route check, a broken timed path turning ``correct`` false, and the
controls reading further from the reference than the program."""

from __future__ import annotations

import copy
import json
import os
import time

import pytest
import torch

from portbench import core, run

from conftest import build_tiny_root

CELL = "osd.train.b640"
SEED = 2**31 + 91
TINY_SD = dict(max_objects=12, object_dim=18, lstm_word_emb=8, lstm_hidden=16, question_max_len=12, g_layers=[32] * 4,
               f_layers=[32, 64])


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture()
def tiny_sd(tmp_path, monkeypatch):
    """(root, bench): the SD cell on a tiny configuration the port reads."""
    import rnet_torch.config as port_config

    root = str(tmp_path / "root")
    bench = build_tiny_root(root)
    cfgs = json.load(open(os.path.join(root, "port_config.json")))
    cfgs["tiny-sd"] = dict(cfgs["original-sd"], **TINY_SD)
    _write(os.path.join(root, "port_config.json"), cfgs)
    c = json.load(open(os.path.join(core.ROOT, "configs", "original-sd.json")))
    c["name"] = c["port_config"] = "tiny-sd"
    c["widths"].update(TINY_SD)
    c["data"]["train"] = {"scenes": 40, "questions": 250}
    c["data"]["question_words"] = {"mean": 6, "sd": 2, "min": 2, "max": 12}
    _write(os.path.join(root, "configs", "tiny-sd.json"), c)
    w = next(x for x in bench["workloads"] if x["name"] == CELL)
    t = json.load(open(os.path.join(core.ROOT, "traffic", f"{w['traffic']}.json")))
    t.update(batch_size=16, log_interval=2, trace_after_chunks=1, trace_chunks=2, reference_block=4)
    _write(os.path.join(root, "traffic", f"{w['traffic']}.json"), t)
    w["config"] = "tiny-sd"
    monkeypatch.setattr(port_config, "DEFAULT_CONFIG_PATH", os.path.join(root, "port_config.json"))
    return root, bench


def _run(tiny_sd, trace=False):
    root, bench = tiny_sd
    return run.run_cell(core.resolve_cell(CELL, bench, root), SEED, 0.5, trace, "cpu", time.time())


def test_cell_files_found_by_name():
    bench = core.load_benchmark()
    c = core.resolve_cell(CELL, bench)
    assert c.config["name"] == "original-sd" and c.traffic["entry"] == "train_sd" and c.chips == 1
    assert [m["name"] for m in c.end_to_end] == ["train_qps", "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["idle_share.train", "idle_share.between_chunks.train",
                                                  "mfu.train.sd", "device_ms.g.train.sd"]
    assert list(c.limits) == ["loss1_gap", "gnorm1_gap", "moment_gap", "change_gap"]
    for name, lim in c.limits.items():
        assert lim["lower"] <= lim["limit"] <= lim["upper"], name


def test_the_port_states_the_configuration_widths():
    from portbench import port

    cell = core.resolve_cell(CELL)
    cfg = port.model_config(cell)
    assert cfg.state_description and cfg.n_objects == 12 and cfg.obj_feat_dim == 18
    assert port.vocab_size() == cell.config["vocab_size"]


def test_result_line(tiny_sd):
    line = _run(tiny_sd)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_qps", "setup_s"}
    json.dumps(line, allow_nan=False)


def test_traced_result_line(tiny_sd):
    line = _run(tiny_sd, trace=True)
    assert line["correct"] is True
    assert {"mfu.train.sd", "device_ms.g.train.sd"} <= set(line["metrics"])  # no device intervals on the CPU
    assert set(line["metrics"]) <= {"idle_share.train", "idle_share.between_chunks.train", "mfu.train.sd",
                                    "device_ms.g.train.sd"}
    assert line["metrics"]["mfu.train.sd"]["value"] > 0


def test_split_lays_out_scenes_as_the_dataset_does():
    entry = core.load_entry("train_sd")
    c = core.resolve_cell(CELL)
    w = dict(c.config["widths"], question_max_len=12)
    d = copy.deepcopy(c.config["data"])
    d["train"] = {"scenes": 50, "questions": 300}
    split = entry.split_on_device(d, w, 90, SEED, torch.device("cpu"))
    objs, n = split["objects"], split["n_objects"].long()
    assert objs.shape == (300, 12, 18) and objs.dtype == torch.float32
    assert int(n.min()) >= 3 and int(n.max()) <= 10
    real = torch.arange(12)[None, :] < n[:, None]
    assert bool((objs[~real] == 0).all())
    xyz, hot = objs[real][:, :3], objs[real][:, 3:]
    assert float(xyz.abs().max()) <= 1.0
    for a, b in ((0, 8), (8, 11), (11, 13), (13, 15)):  # colour, shape, material, size: one-hots
        assert bool((hot[:, a:b].sum(-1) == 1).all())
    again = entry.split_on_device(d, w, 90, SEED, torch.device("cpu"))
    assert all(torch.equal(split[k], again[k]) for k in split)


def test_route_check():
    entry = core.load_entry("train_sd")
    zero = {"pairwise_fwd": 0, "pairwise_bwd": 0, "pair_mask": 0}
    assert "30 g_xla" in entry.check_route({**zero, "g_xla": 30}, 30)
    assert "counts no g_xla" in entry.check_route(zero, 30)
    with pytest.raises(RuntimeError):
        entry.check_route({**zero, "g_xla": 29}, 30)
    with pytest.raises(RuntimeError):
        entry.check_route({**zero, "pairwise_fwd": 1, "g_xla": 30}, 30)


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tiny_sd, monkeypatch):
    from rnet_torch.train import steps

    def update(state, batch, image_cache):
        loss, acc, grads = steps.loss_and_grads(state.model, batch, state.generator, image_cache)
        return torch.stack([loss, acc, steps.global_norm(grads)])

    monkeypatch.setattr(steps, "_update", update)
    line = _run(tiny_sd)
    assert line["correct"] is False and line["checks"]["change_gap"]["value"] > line["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("control", ["fp8", "half_batch"])
def test_controls_read_further_than_the_program(tiny_sd, control):
    root, bench = tiny_sd
    c = core.resolve_cell(CELL, bench, root)
    got = core.load_entry("train_sd").calibrate(core.Run(c, SEED, 0.5, False, torch.device("cpu"), time.time()),
                                                [control])
    assert any(got[control][k] >= 3 * max(got["program"][k], 1e-7) for k in ("loss1_gap", "moment_gap")), got
