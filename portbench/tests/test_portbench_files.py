"""BENCHMARK.json against the benchmark's contract, and the harness's
files found by name (CPU, no run)."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module", params=["committed", "with later cells"])
def bench(request):
    """BENCHMARK.json, and with the cells of ``later/`` added: each has to
    meet the contract when it joins."""
    with open(core.BENCHMARK) as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    committed = json.loads(text)
    return committed if request.param == "committed" else core.with_later(committed)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(core.REPO, p)) and not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_names_and_units_use_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in bench["end_to_end"] + bench["per_layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in bench[group]]
        assert len(got) == len(set(got)), group
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(bench["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(core.REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_workloads(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = set()
    four = 0
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert 1 <= len(bench["per_layer"]) <= 128
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reporting, m["name"]
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in bench["workloads"]:  # every cell: setup_s, another end-to-end metric, a per-layer metric
        cell = core.resolve_cell(w["name"], bench)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_run_seconds_fit_a_full_check_of_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", ["ofp.train.b512", "wfp.eval-int8.b512", "ofp.serve.poisson", "ofp.eval.b512"])
def test_cell_files_found_by_name(cell):
    bench = core.with_later(core.load_benchmark())
    c = core.resolve_cell(cell, bench)
    assert c.config["name"] == next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    assert core.load_entry(c.traffic["entry"]).run
    for m in c.per_layer:
        assert callable(core.load_reader(m["name"]))
    checks = core.checks_from({}, c.limits)
    assert checks and all(not ch.ok for ch in checks)  # a reading that is missing fails
    for name, lim in c.limits.items():
        assert lim["lower"] <= lim["limit"] <= lim["upper"], name


def test_a_cell_is_added_by_files_alone(bench, tmp_path):
    """A new configuration, traffic mix, limits file, per-layer metric and
    BENCHMARK.json entry; no file that is there changes."""
    root = tmp_path / "pb"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(core.ROOT, d), root / d)
    cfg = json.load(open(root / "configs" / "original-fp.json"))
    cfg["name"] = "original-fp-b"
    json.dump(cfg, open(root / "configs" / "original-fp-b.json", "w"))
    t = json.load(open(root / "traffic" / "train.b512.json"))
    t["batch_size"] = 64
    json.dump(t, open(root / "traffic" / "train.b64.json", "w"))
    json.dump(json.load(open(root / "limits" / "ofp.train.b512.json")), open(root / "limits" / "ofpb.train.b64.json", "w"))
    (root / "metrics" / "steps.train.py").write_text("def read(ctx):\n    return ctx.counts.get('steps')\n")
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "ofpb.train.b64", "config": "original-fp-b", "traffic": "train.b64", "chips": 1,
                             "why": "a test cell"})
    new["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher", "source": "program_counter",
                             "layer": "model step", "moves": "train_qps", "workloads": ["ofpb.train.b64"]})
    for m in new["end_to_end"]:
        if m["name"] == "train_qps":
            m["workloads"].append("ofpb.train.b64")
    c = core.resolve_cell("ofpb.train.b64", new, str(root))
    assert c.traffic["batch_size"] == 64 and c.config["name"] == "original-fp-b"
    assert [m["name"] for m in c.per_layer][-1] == "steps.train"
    assert core.load_reader("steps.train", str(root))(type("C", (), {"counts": {"steps": 7}})()) == 7


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"rnet_torch": 1, "rnet_torch.models": 1, "jaxtyping": 1, "rnet": 1, "rnet.models": 1, "jaxlib.xla": 1,
            "flax": 1, "jax": 1}
    assert core.forbidden_modules(mods) == ["flax", "jax", "jaxlib.xla", "rnet", "rnet.models"]
    assert core.forbidden_modules({"rnet_torch": 1, "jaxtyping": 1, "rnetx": 1}) == []
