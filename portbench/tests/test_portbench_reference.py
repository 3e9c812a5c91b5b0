"""The plain reference against the port's CPU path at a tiny size, with the
same weights and draws (CPU). The reference imports nothing of the port."""

from __future__ import annotations

import ast
import os

import pytest
import torch

from portbench import core, data, reference

W = {"state_description": False, "image_size": 32, "conv_channels": [24, 24, 24, 24], "conv_kernel": 3,
     "conv_stride": 2, "lstm_word_emb": 8, "lstm_hidden": 16, "question_max_len": 12, "lstm_mask_pads": True,
     "g_layers": [32, 32, 32, 32], "question_injection_position": 0, "f_layers": [32, 32], "n_answers": 28,
     "dropout": 0.5, "pair_dropout": 0.0, "pair_pool": "sum", "object_mask": False}
VOCAB = 90


def _port_model(rl_impl: str, dtype: str = "float32"):
    from rnet_torch.config import ModelConfig
    from rnet_torch.models import RN

    keys = {k: (tuple(v) if isinstance(v, list) else v) for k, v in W.items()}
    cfg = ModelConfig(name="tiny", rl_impl=rl_impl, compute_dtype=dtype, device_augment=True,
                      augment_impl="pallas", **keys)
    return RN(cfg, VOCAB)


def _weights(seed: int):
    return reference.draw_weights(W, VOCAB, torch.Generator().manual_seed(seed), "cpu")


def _inputs(seed: int, B: int = 6, canvas: int = 40):
    g = torch.Generator().manual_seed(seed)
    cache = data.image_cache(10, canvas, g, "cpu")
    q = data.questions(B, W["question_max_len"], VOCAB, {"mean": 6, "sd": 2, "min": 2, "max": 12}, g, "cpu")
    return cache, q, data.answers(B, 28, g, "cpu"), data.image_index(B, 10, g, "cpu")


def test_reference_imports_nothing_of_the_port():
    with open(os.path.join(core.ROOT, "reference.py")) as f:
        tree = ast.parse(f.read())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert {m.split(".")[0] for m in mods if m} <= {"__future__", "contextlib", "dataclasses", "math", "typing", "torch"}


def test_layout_is_the_port_models():
    from portbench import port

    model = _port_model("xla")
    port.put_weights(model, _weights(0))  # raises on any difference of names or shapes


@pytest.mark.parametrize("rl_impl", ["naive", "xla"])
def test_eval_log_probs_agree_with_the_port(rl_impl):
    from portbench import port

    p = _weights(1)
    model = _port_model(rl_impl).eval()
    port.put_weights(model, p)
    cache, q, _, idx = _inputs(2)
    imgs = cache[idx.long()]
    with torch.no_grad():
        want = model(imgs, q)
    got = reference.eval_log_probs(p, W, imgs, q, reference.FLOAT32, block=4)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_train_steps_agree_with_the_port():
    from portbench import port
    from rnet_torch.train import steps

    p0 = _weights(3)
    model = _port_model("xla")
    port.put_weights(model, p0)
    state = steps.create_train_state(model, steps.make_optimizer(1e-3, 50.0), seed=11)
    cache, _, _, _ = _inputs(4)
    g = torch.Generator().manual_seed(5)
    n = 24
    d = {"question": data.questions(n, 12, VOCAB, {"mean": 6, "sd": 2, "min": 2, "max": 12}, g, "cpu"),
         "answer": data.answers(n, 28, g, "cpu"), "image_idx": data.image_index(n, 10, g, "cpu")}
    rows = [torch.arange(k * 6, k * 6 + 6, dtype=torch.int32) for k in range(3)]
    losses = []
    for r in rows:
        batch = {k: v[r.long()] for k, v in d.items()}
        losses.append(float(steps.train_step(state, batch, cache)["loss"]))
    ref = reference.train_steps(p0, W, cache, d, rows, 11, {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "lr": 1e-3,
                                                            "clip_norm": 50.0}, block=4)
    assert ref["loss"] == pytest.approx(losses, rel=1e-5)
    live = dict(model.named_parameters())
    norms = {k: float(g.norm()) for k, g in ref["grad1"].items()}
    med = sorted(norms.values())[len(norms) // 2]
    moved = [k for k in norms if norms[k] >= 1e-3 * med]  # conv biases: zero gradient under BatchNorm
    assert len(moved) == len(norms) - len(W["conv_channels"])
    for name in moved:
        assert torch.allclose(ref["params"][name], live[name].detach(), atol=2e-6, rtol=1e-4), name


def test_controls_read_further_from_the_reference_than_bf16():
    p = _weights(6)
    cache, q, _, idx = _inputs(7, B=8)
    imgs = cache[idx.long()]
    ref = reference.eval_log_probs(p, W, imgs, q, reference.FLOAT32, block=4)
    err = {name: float((reference.eval_log_probs(p, W, imgs, q, reference.PRECISIONS[name], block=4) - ref).abs().max())
           for name in ("bf16", "fp8")}
    assert 0 < err["bf16"] * 3 < err["fp8"]
