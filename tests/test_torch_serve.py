"""rnet_torch.serve vs rnet.serve on the synthetic fixture, on the CPU.

rnet's InferenceServer initialises small models and exports them with
``rnet.train.checkpoint.export_weights``; the port's server loads that pkl
(``device="cpu"``) and must give the same answers and log-probs for the same
scene and PNG requests. Also: per-request error isolation, the bucket
ladder, chunking vs padding, the stdin micro-batcher and the CLI round trip.
"""

import io
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from rnet.config import load_config as jax_load_config
from rnet.serve import InferenceServer as JaxServer
from rnet.train.checkpoint import export_weights
from rnet.train.loop import make_injected_optimizer
from rnet.train.steps import create_train_state
from rnet_torch import serve as tserve
from rnet_torch.config import load_config
from rnet_torch.data.vocab import Dictionaries

torch.set_num_threads(1)

SD_KW = dict(g_layers=(64, 64), f_layers=(64,), lstm_hidden=32, lstm_word_emb=16, dropout=0.0, question_max_len=24)
FP_KW = dict(g_layers=(32, 32), f_layers=(32,), lstm_hidden=16, lstm_word_emb=8, dropout=0.0, question_max_len=24)
OVER = {"compute_dtype": "float32", "rl_impl": "xla"}


def _cfgs(name, kw, dicts):
    return (
        jax_load_config(name, overrides=OVER).replace(n_answers=dicts.n_answers, **kw),
        load_config(name, overrides=OVER).replace(n_answers=dicts.n_answers, **kw),
    )


def _exported(name, kw, dicts, path, seed, max_batch):
    """(rnet server with weights, port config) after exporting its weights."""
    jcfg, tcfg = _cfgs(name, kw, dicts)
    jserver = JaxServer(jcfg, dicts, max_batch=max_batch)
    state = create_train_state(
        jserver.model, jcfg, make_injected_optimizer(1e-3, clip_norm=50.0),
        jax.random.key(seed), jserver._dummy_batch(),
    )
    export_weights(state, path, dicts=dicts)
    jserver.params, jserver.batch_stats = state.params, state.batch_stats
    return jserver, tcfg


@pytest.fixture(scope="module")
def sd_pair(dicts, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tserve") / "sd_weights.pkl")
    jserver, tcfg = _exported("original-sd", SD_KW, dicts, path, seed=11, max_batch=8)
    server = tserve.InferenceServer(tcfg, dicts, max_batch=8, device="cpu")
    server.load(path)
    server.warmup()
    return jserver, server, path


@pytest.fixture(scope="module")
def fp_pair(dicts, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tserve") / "fp_weights.pkl")
    jserver, tcfg = _exported("original-fp", FP_KW, dicts, path, seed=5, max_batch=2)
    server = tserve.InferenceServer(tcfg, dicts, max_batch=2, device="cpu")
    server.load(path)
    return jserver, server


def _val_questions(fixture_dir, k):
    with open(os.path.join(fixture_dir, "questions", "CLEVR_val_questions.json")) as f:
        return json.load(f)["questions"][:k]


def _sd_requests(fixture_dir, k=5):
    with open(os.path.join(fixture_dir, "scenes", "CLEVR_val_scenes.json")) as f:
        scenes = {s["image_index"]: s for s in json.load(f)["scenes"]}
    return [
        {"objects": scenes[q["image_index"]]["objects"], "question": q["question"]}
        for q in _val_questions(fixture_dir, k)
    ]


def _fp_requests(fixture_dir, k=3):
    return [
        {"image": os.path.join(fixture_dir, "images", "val", q["image_filename"]), "question": q["question"]}
        for q in _val_questions(fixture_dir, k)
    ]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["answer"] == w["answer"]
        assert g["batch"] == w["batch"] and g["bucket"] == w["bucket"]
        np.testing.assert_allclose(g["log_prob"], w["log_prob"], rtol=1e-4, atol=1e-4)
        assert g["log_prob"] <= 0.0 and g["latency_ms"] > 0


def test_sd_answers_match_rnet(fixture_dir, sd_pair):
    jserver, server, _ = sd_pair
    reqs = _sd_requests(fixture_dir, k=5)
    _assert_same(server.answer(reqs), jserver.answer(reqs))


def test_fp_answers_match_rnet(fixture_dir, fp_pair):
    """PNG requests through the eval transform, chunked 2+1 at max_batch=2."""
    jserver, server = fp_pair
    reqs = _fp_requests(fixture_dir, k=3)
    _assert_same(server.answer(reqs), jserver.answer(reqs))


def test_serve_samples_is_answer_after_encode(fixture_dir, sd_pair):
    _, server, _ = sd_pair
    reqs = _sd_requests(fixture_dir, k=4)
    by_samples = server.serve_samples([server.encode(r) for r in reqs])
    by_answer = server.answer(reqs)
    assert [r["answer"] for r in by_samples] == [r["answer"] for r in by_answer]
    assert [r["log_prob"] for r in by_samples] == [r["log_prob"] for r in by_answer]


def test_error_isolation_sd(fixture_dir, sd_pair):
    _, server, _ = sd_pair
    reqs = _sd_requests(fixture_dir, k=2)
    batch = [
        reqs[0],
        {"objects": reqs[0]["objects"], "question": 123},
        {"objects": reqs[0]["objects"], "question": reqs[0]["question"] + " zorpulated"},
        "not a json object",
        {"question": reqs[0]["question"]},
        {"objects": [{"color": "red"}], "question": reqs[0]["question"]},
        reqs[1],
    ]
    got = server.answer(batch)
    alone = server.answer(reqs)
    assert len(got) == len(batch)
    assert got[0]["answer"] == alone[0]["answer"] and got[6]["answer"] == alone[1]["answer"]
    assert "question" in got[1]["error"]
    assert "out-of-vocabulary" in got[2]["error"] and "zorpulated" in got[2]["error"]
    assert "JSON object" in got[3]["error"]
    assert "objects" in got[4]["error"]
    assert "bad scene objects" in got[5]["error"]
    assert server.answer(reqs[:1])[0]["answer"] == alone[0]["answer"]


def test_error_isolation_fp(fixture_dir, fp_pair):
    _, server = fp_pair
    req = _fp_requests(fixture_dir, k=1)[0]
    got = server.answer(
        [{"image": "/nonexistent/nope.png", "question": req["question"]}, {"question": req["question"]}, req]
    )
    assert "not found" in got[0]["error"]
    assert "image" in got[1]["error"]
    assert got[2]["answer"] == server.answer([req])[0]["answer"]


def test_oov_drop_policy(fixture_dir, dicts, sd_pair):
    _, server, path = sd_pair
    d2 = Dictionaries(dicts.word_to_idx, dicts.answer_to_idx, oov="drop")
    drop = tserve.InferenceServer(server.cfg, d2, max_batch=8, device="cpu")
    drop.load(path)
    req = _sd_requests(fixture_dir, k=1)[0]
    clean, spiked, all_oov = drop.answer(
        [req, dict(req, question="zorpulated " + req["question"]), dict(req, question="zorpulated quuxed")]
    )
    assert spiked["answer"] == clean["answer"]
    assert "no in-vocabulary words" in all_oov["error"]


def test_bucket_ladder(fixture_dir, dicts, sd_pair):
    """B=1 routes to bucket 1, B=5 to bucket 8; a single-bucket server answers
    the same (routing never changes answers)."""
    _, server, path = sd_pair
    assert server.buckets == (1, 8)
    reqs = _sd_requests(fixture_dir, k=5)
    one = server.answer(reqs[:1])
    assert one[0]["bucket"] == 1 and one[0]["batch"] == 1
    five = server.answer(reqs)
    assert all(r["bucket"] == 8 and r["batch"] == 5 for r in five)
    single = tserve.InferenceServer(server.cfg, dicts, max_batch=8, buckets=[8], device="cpu")
    single.load(path)
    assert single.buckets == (8,)
    assert [r["answer"] for r in single.answer(reqs)] == [r["answer"] for r in five]
    assert single.answer(reqs[:1])[0]["answer"] == one[0]["answer"]
    assert tserve.InferenceServer(server.cfg, dicts, max_batch=64, buckets=[4, 100], device="cpu").buckets == (4, 64)


def test_padding_and_chunking_consistent(fixture_dir, dicts, sd_pair):
    """3 requests padded to bucket 8 == the same 3 chunked 2+1 at max_batch=2."""
    _, server, path = sd_pair
    reqs = _sd_requests(fixture_dir, k=3)
    chunked = tserve.InferenceServer(server.cfg, dicts, max_batch=2, device="cpu")
    chunked.load(path)
    padded_res, chunked_res = server.answer(reqs), chunked.answer(reqs)
    assert [r["answer"] for r in padded_res] == [r["answer"] for r in chunked_res]
    assert [r["batch"] for r in chunked_res] == [2, 2, 1]
    np.testing.assert_allclose(
        [r["log_prob"] for r in padded_res], [r["log_prob"] for r in chunked_res], rtol=1e-5, atol=1e-5
    )


def test_port_export_loads_in_rnet(fixture_dir, dicts, sd_pair, tmp_path):
    """The reverse direction: a pkl written by rnet_torch.checkpoint loads in
    rnet's server (import_weights) and answers the same."""
    from rnet_torch.checkpoint import export_weights as port_export

    jserver, server, _ = sd_pair
    path = str(tmp_path / "port.pkl")
    port_export(server.model, path, dicts=dicts)
    back = JaxServer(jserver.cfg, dicts, max_batch=8)
    back.load(path)
    reqs = _sd_requests(fixture_dir, k=5)
    _assert_same(server.answer(reqs), back.answer(reqs))


def test_requires_weights(dicts, sd_pair):
    _, server, _ = sd_pair
    fresh = tserve.InferenceServer(server.cfg, dicts, max_batch=2, device="cpu")
    with pytest.raises(RuntimeError, match="load"):
        fresh.answer([{"objects": [], "question": "what?"}])


def test_load_refuses_orbax_dir_and_wrong_skeleton(dicts, sd_pair, tmp_path):
    _, server, path = sd_pair
    with pytest.raises(NotImplementedError, match="orbax"):
        server.load(str(tmp_path))
    wider = tserve.InferenceServer(server.cfg.replace(g_layers=(64, 96)), dicts, device="cpu")
    with pytest.raises(ValueError, match="relational.g1_kernel"):
        wider.load(path)


def test_int8_impl_raises(fixture_dir, dicts, sd_pair):
    """An int8 server of original-sd (n=12, a shape the int8 kernel does not
    take) answers through the fp core with rnet's loud "NOT int8" warning,
    the answers of the fp server."""
    _, server, path = sd_pair
    s8 = tserve.InferenceServer(server.cfg.replace(rl_impl="pallas_int8"), dicts, device="cpu")
    s8.load(path)
    reqs = _sd_requests(fixture_dir, k=5)
    with pytest.warns(UserWarning, match="NOT int8"):
        got = s8.answer(reqs)
    _assert_same(got, server.answer(reqs))


def test_int8_server_matches_rnet(fixture_dir, dicts, tmp_path, monkeypatch):
    """An int8 server of original-fp shrunk to a shape the int8 kernel takes
    (32x32 images, a 4x4 grid of objects, g of 4 x 128) answers PNG requests
    through the plain int8 core, once per served batch and with no warning,
    as rnet's int8 server does with its kernel in interpret mode (off a TPU
    rnet would fall back to fp)."""
    from rnet.kernels import pairwise as rpw
    from rnet_torch.kernels import pairwise as tpw

    orig = rpw.pairwise_core_int8
    monkeypatch.setattr(rpw, "pairwise_core_int8",
                        lambda *a, inject, interpret=False: orig(*a, inject=inject, interpret=True))
    calls = []
    real = tpw.pairwise_core_int8_reference
    monkeypatch.setattr(tpw, "pairwise_core_int8_reference", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kw = dict(FP_KW, image_size=32, conv_channels=(24, 24, 24), g_layers=(128,) * 4, f_layers=(32, 32))
    path = str(tmp_path / "fp_int8.pkl")
    jserver, tcfg = _exported("original-fp", kw, dicts, path, seed=9, max_batch=4)
    j8 = JaxServer(jserver.cfg.replace(rl_impl="pallas_int8"), dicts, max_batch=4)
    j8.params, j8.batch_stats = jserver.params, jserver.batch_stats
    s8 = tserve.InferenceServer(tcfg.replace(rl_impl="pallas_int8"), dicts, max_batch=4, device="cpu")
    s8.load(path)
    reqs = _fp_requests(fixture_dir, k=5)  # chunked 4 + 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = s8.answer(reqs)
    assert len(calls) == 2
    _assert_same(got, j8.answer(reqs))


def _cli_config(tmp_path, cfg):
    p = str(tmp_path / "config.json")
    with open(p, "w") as f:
        json.dump(
            {
                "original-sd": {
                    "state_description": True, "max_objects": cfg.max_objects,
                    "object_dim": cfg.object_dim, "lstm_word_emb": 16, "lstm_hidden": 32,
                    "g_layers": [64, 64], "question_injection_position": 0, "f_layers": [64],
                    "dropout": 0.0, "pair_dropout": 0.0, "question_max_len": 24,
                }
            },
            f,
        )
    return p


def test_cli_stdin_round_trip(fixture_dir, dicts, sd_pair, tmp_path, monkeypatch, capsys):
    """python -m rnet_torch.serve: JSON lines in, one JSON line out per
    request (bad lines isolated), dictionaries carried by the pkl, stdout
    nothing but JSON; answers equal the in-process server's."""
    _, server, path = sd_pair
    reqs = _sd_requests(fixture_dir, k=3)
    lines = [
        json.dumps(reqs[0]), '{"this is not json', json.dumps(reqs[1]),
        json.dumps(dict(reqs[2], question="zorpulated nonsense words")), json.dumps(reqs[2]),
    ]
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(line + "\n" for line in lines)))
    rc = tserve.main(
        ["--model", "original-sd", "--config", _cli_config(tmp_path, server.cfg), "--checkpoint", path,
         "--batch-size", "4", "--precision", "float32", "--rl-impl", "xla", "--platform", "cpu"]
    )
    assert rc == 0
    captured = capsys.readouterr()
    out_lines = [line for line in captured.out.splitlines() if line.strip()]
    assert len(out_lines) == 5 and all(line.startswith("{") for line in out_lines)
    assert "dictionaries: carried by checkpoint" in captured.err
    results = [json.loads(line) for line in out_lines]
    assert "malformed JSON" in results[1]["error"]
    assert "out-of-vocabulary" in results[3]["error"]
    want = server.answer(reqs)
    assert [results[i]["answer"] for i in (0, 2, 4)] == [w["answer"] for w in want]


def test_cli_default_platform_needs_cuda(dicts, sd_pair, tmp_path, monkeypatch):
    """Without --platform cpu the CLI asks for CUDA and raises without it."""
    _, server, path = sd_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--model", "original-sd", "--config", _cli_config(tmp_path, server.cfg), "--checkpoint", path])


# ---- stdin micro-batching ----


def test_iter_microbatches_fd_burst_groups(monkeypatch):
    r, w = os.pipe()
    os.write(w, b'{"a":1}\n{"a":2}\n\n{"a":3}\n{"a":4}\n{"a":5}\n{"a":6')
    os.close(w)
    monkeypatch.setattr("sys.stdin", os.fdopen(r, "r"))
    batches = list(tserve.iter_microbatches(4))
    assert [len(b) for b in batches] == [4, 2]
    assert batches[0] == ['{"a":1}', '{"a":2}', '{"a":3}', '{"a":4}']
    assert batches[1] == ['{"a":5}', '{"a":6']  # trailing line without newline


def test_iter_microbatches_fd_interactive(monkeypatch):
    r, w = os.pipe()
    monkeypatch.setattr("sys.stdin", os.fdopen(r, "r"))
    gen = tserve.iter_microbatches(4)
    os.write(w, b"one\n")
    assert next(gen) == ["one"]  # a single request is served immediately
    os.write(w, b"two\nthree\n")
    assert next(gen) == ["two", "three"]  # buffered lines serve together
    os.close(w)
    assert list(gen) == []


def test_iter_microbatches_non_fd_fallback(monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO("a\n\nb\nc\n"))
    batches = list(tserve.iter_microbatches(2))
    assert [[line.strip() for line in b] for b in batches] == [["a", "b"], ["c"]]
