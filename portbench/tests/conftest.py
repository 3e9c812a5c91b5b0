"""Fixtures of the benchmark's CPU tests: tiny cells built from the
committed ones, found by name from files in a temporary root, with the
port's config.json widened by their tiny configurations."""

from __future__ import annotations

import copy
import json
import os
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import core  # noqa: E402

TINY = {  # name: (image size, g width); 64 px gives 16 objects, which the int8 chain takes at H=128
    "tiny-fp": (32, 32),
    "tiny-int8": (64, 128),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one")


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def build_tiny_root(root: str) -> dict:
    """Write tiny copies of every committed configuration, traffic mix and
    limits file under ``root``; return the BENCHMARK.json, with the cells of
    ``later/`` added, whose cells use them."""
    with open(os.path.join(REPO, "config.json")) as f:
        port_cfgs = json.load(f)
    base = json.load(open(os.path.join(core.ROOT, "configs", "original-fp.json")))
    for name, (img, g) in TINY.items():
        entry = dict(port_cfgs["original-fp"], image_size=img, g_layers=[g] * 4, f_layers=[g, g], lstm_hidden=16,
                     lstm_word_emb=8, question_max_len=12)
        port_cfgs[name] = entry
        c = copy.deepcopy(base)
        c["name"] = c["port_config"] = name
        c["widths"].update(image_size=img, g_layers=[g] * 4, f_layers=[g, g], lstm_hidden=16, lstm_word_emb=8,
                           question_max_len=12)
        c["data"]["train"] = {"images": 64, "questions": 256, "canvas_pad": 4}
        c["data"]["val"] = {"images": 32, "questions": 100, "canvas_pad": 4}
        c["data"]["png"].update(width=48, height=32)
        c["data"]["question_words"] = {"mean": 6, "sd": 2, "min": 2, "max": 12}
        _write(os.path.join(root, "configs", f"{name}.json"), c)
    _write(os.path.join(root, "port_config.json"), port_cfgs)
    for name in os.listdir(os.path.join(core.ROOT, "traffic")):
        t = json.load(open(os.path.join(core.ROOT, "traffic", name)))
        t.update(reference_block=4)
        if t["entry"] == "train":  # on the CPU the fused augment's plain version, as the card runs the kernel
            t.update(augment_impl="pallas", batch_size=16, log_interval=2, trace_after_chunks=1, trace_chunks=2)
        elif t["entry"] == "eval":
            t.update(batch_size=16, log_interval=2, sample_batches=3, nll_batches=5, trace_epoch=0)
        else:
            t.update(rate_per_s=40.0, pool_images=4, sample_requests=16, trace_at_s=0.2, trace_s=0.3, drain_s=5.0)
        _write(os.path.join(root, "traffic", name), t)
    bench = core.with_later(core.load_benchmark())
    for w in bench["workloads"]:
        w["config"] = "tiny-int8" if "int8" in w["traffic"] else "tiny-fp"
        limits = json.load(open(os.path.join(core.ROOT, "limits", f"{w['name']}.json")))
        if "pred_gap" in limits:  # tiny random weights give flat logits: an answer moved by one reads 0.15-2.6 nats
            limits["pred_gap"]["limit"] = 0.05
        _write(os.path.join(root, "limits", f"{w['name']}.json"), limits)
    return bench


@pytest.fixture()
def tiny(tmp_path, monkeypatch):
    """(root, bench): tiny cells on the CPU; the port reads their configs."""
    import rnet_torch.config as port_config

    root = str(tmp_path / "root")
    bench = build_tiny_root(root)
    monkeypatch.setattr(port_config, "DEFAULT_CONFIG_PATH", os.path.join(root, "port_config.json"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return root, bench
