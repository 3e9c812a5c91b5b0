"""``python -m rnet_torch.evaluate`` on the CPU (``--platform cpu``), on the
synthetic fixture: the same weights pkl evaluated by rnet's ``test.main``
and by the port (accuracy equal, NLL within 1e-4, the same report rows), a
port checkpoint given by its epoch number, ``--split train`` under the eval
transform, and ``--rl-impl pallas_int8``: the clip-fraction line, the loud
"NOT int8" fallback of both packages at n=12, and the plain int8 path on a
shrunk original-fp.
"""

import argparse
import csv
import json
import os
import sys
import warnings

import jax
import pytest
import torch

from rnet.config import load_config as jax_load_config
from rnet.serve import InferenceServer as JaxServer
from rnet.train.checkpoint import export_weights
from rnet.train.loop import make_injected_optimizer
from rnet.train.steps import create_train_state
from rnet_torch import cli as tcli
from rnet_torch.checkpoint import export_weights as port_export
from rnet_torch.config import DEFAULT_CONFIG_PATH, load_config
from rnet_torch.data.vocab import Dictionaries
from rnet_torch.evaluate import main
from rnet_torch.kernels import pairwise as tpw
from rnet_torch.models import RN
from rnet_torch.ocdbt import CheckpointFormatError

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import test as rnet_test_cli  # noqa: E402  (rnet's eval CLI, the top-level test.py)

torch.set_num_threads(1)

PORT = ["--platform", "cpu", "--num-workers", "2", "--log-interval", "100"]
SD = dict(lstm_word_emb=16, lstm_hidden=32, g_layers=[64, 64], f_layers=[64], dropout=0.0)
FP_INT8 = dict(image_size=32, conv_channels=[24, 24, 24], g_layers=[128] * 4, f_layers=[32, 32],
               lstm_hidden=24, lstm_word_emb=8, dropout=0.0)


def _rows(results, split):
    with open(os.path.join(results, f"{split}_accuracy.csv")) as f:
        return {r[0]: float(r[1]) for r in csv.reader(f) if r[0] != "metric"}


@pytest.fixture(scope="module")
def small_config(tmp_path_factory):
    """config.json with original-sd and original-fp shrunk (original-fp to
    a 4x4 grid, n=16, and g widths of 128: a shape the int8 kernel takes)."""
    with open(DEFAULT_CONFIG_PATH) as f:
        full = json.load(f)
    out = {"original-sd": {**full["original-sd"], **SD}, "original-fp": {**full["original-fp"], **FP_INT8}}
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    with open(path, "w") as f:
        json.dump(out, f)
    return path


@pytest.fixture(scope="module")
def rnet_pkl(dicts, small_config, tmp_path_factory):
    """Seeded original-sd weights exported by rnet, with its dictionaries."""
    cfg = jax_load_config("original-sd", small_config, {"compute_dtype": "float32"}).replace(
        n_answers=dicts.n_answers)
    server = JaxServer(cfg, dicts, max_batch=4)
    state = create_train_state(server.model, cfg, make_injected_optimizer(1e-3, clip_norm=50.0),
                               jax.random.key(3), server._dummy_batch())
    path = str(tmp_path_factory.mktemp("pkl") / "sd.pkl")
    export_weights(state, path, dicts=dicts)
    return path


def _argv(fixture_dir, small_config, tmp, model, checkpoint, *extra):
    return ["--clevr-dir", fixture_dir, "--model", model, "--config", small_config, "--precision", "float32",
            "--checkpoint", str(checkpoint), "--checkpoint-dir", str(tmp / "ck"), "--batch-size", "16",
            "--test-results-dir", str(tmp / "res"), *extra]


def test_evaluate_matches_rnet_test_cli(fixture_dir, small_config, rnet_pkl, tmp_path):
    """The same pkl through rnet's test.py and the port: equal accuracy and
    per-family / per-answer rows, mean NLL within 1e-4 (fp32 sums in another
    order)."""
    assert rnet_test_cli.main(_argv(fixture_dir, small_config, tmp_path / "r", "original-sd", rnet_pkl)) == 0
    assert main(_argv(fixture_dir, small_config, tmp_path / "p", "original-sd", rnet_pkl, *PORT)) == 0
    want, got = _rows(tmp_path / "r" / "res", "val"), _rows(tmp_path / "p" / "res", "val")
    assert set(got) == set(want) and any(k.startswith("category_") for k in got)
    assert abs(got.pop("mean_nll") - want.pop("mean_nll")) <= 1e-4
    assert got == want
    assert os.path.exists(tmp_path / "p" / "res" / "val_confusion.csv")


def test_evaluate_port_checkpoint_by_epoch(fixture_dir, small_config, tmp_path, capsys):
    """A checkpoint of ``python -m rnet_torch.train`` given by its epoch
    number evaluates to the accuracy and NLL its own epoch eval recorded."""
    from rnet_torch.train.__main__ import main as train_main

    ck, res = str(tmp_path / "ck"), str(tmp_path / "train_res")
    assert train_main(["--clevr-dir", fixture_dir, "--model", "original-sd", "--config", small_config,
                       "--precision", "float32", "--epochs", "1", "--batch-size", "16", "--lr", "1e-3",
                       "--checkpoint-dir", ck, "--test-results-dir", res, *PORT]) == 0
    with open(os.path.join(res, "history.json")) as f:
        (h,) = json.load(f)
    assert main(_argv(fixture_dir, small_config, tmp_path, "original-sd", 1, *PORT)) == 0
    rows = _rows(tmp_path / "res", "val")
    assert rows["overall_accuracy"] == pytest.approx(h["val_acc"], abs=1e-6)
    assert rows["mean_nll"] == pytest.approx(h["val_nll"], abs=1e-5)
    assert "overall accuracy:" in capsys.readouterr().out
    os.makedirs(os.path.join(ck, "original-sd_epoch_007"))  # a directory, as rnet's epochs, but no checkpoint
    with pytest.raises(CheckpointFormatError, match="_METADATA"):
        main(_argv(fixture_dir, small_config, tmp_path, "original-sd", 7, *PORT))


@pytest.mark.parametrize("pipeline", ["pil", "cached"])
def test_evaluate_split_train_uses_eval_transform(fixture_dir, small_config, tmp_path, monkeypatch, pipeline):
    """--split train builds only the train split, with the deterministic eval
    transform on each pipeline, and reports under the split's tag."""
    built = {}
    real = tcli.build_datasets

    def spy(*a, **kw):
        built.update(real(*a, **kw))
        return built

    monkeypatch.setattr(tcli, "build_datasets", spy)
    cfg = load_config("original-fp", small_config, {"compute_dtype": "float32"})
    with open(os.path.join(fixture_dir, "questions", "CLEVR_train_questions.json")) as f:
        qs = json.load(f)["questions"]
    from rnet_torch.data.vocab import build_dictionaries

    dicts = build_dictionaries(fixture_dir)
    pkl = str(tmp_path / "fp.pkl")
    port_export(RN(cfg.replace(n_answers=dicts.n_answers), dicts.vocab_size), pkl, dicts=dicts)
    assert main(_argv(fixture_dir, small_config, tmp_path, "original-fp", pkl, "--split", "train",
                      "--data-pipeline", pipeline, *PORT)) == 0
    (ds,) = built.values()
    assert list(built) == ["train"] and len(ds) == len(qs)
    assert (ds.transform.train if pipeline == "pil" else ds.train) is False
    assert _rows(tmp_path / "res", "train")["overall_accuracy"] >= 0.0


def test_evaluate_int8_falls_back_loudly_at_n12_in_both(fixture_dir, small_config, rnet_pkl, tmp_path, capsys):
    """original-sd (n=12) under --rl-impl pallas_int8: both packages print
    the clip-fraction line, warn "NOT int8" and evaluate in fp, to the same
    accuracy."""
    flag = ["--rl-impl", "pallas_int8"]
    with pytest.warns(UserWarning, match="NOT int8"):
        assert rnet_test_cli.main(_argv(fixture_dir, small_config, tmp_path / "r", "original-sd", rnet_pkl,
                                        *flag)) == 0
    out_r = capsys.readouterr().out
    with pytest.warns(UserWarning, match="NOT int8"):
        assert main(_argv(fixture_dir, small_config, tmp_path / "p", "original-sd", rnet_pkl, *flag, *PORT)) == 0
    out_p = capsys.readouterr().out
    for out in (out_r, out_p):
        assert "int8 calibration clip fractions per layer: [" in out
    want, got = _rows(tmp_path / "r" / "res", "val"), _rows(tmp_path / "p" / "res", "val")
    assert got["overall_accuracy"] == want["overall_accuracy"]
    assert abs(got["mean_nll"] - want["mean_nll"]) <= 1e-4


def test_evaluate_int8_runs_the_int8_path(fixture_dir, small_config, dicts, tmp_path, capsys, monkeypatch):
    """A shrunk original-fp (n=16, H=128) under --rl-impl pallas_int8 runs the
    plain int8 version on every eval batch, with no warning; the clip line
    comes first, then the overall line."""
    calls = []
    real = tpw.pairwise_core_int8_reference

    def counting(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(tpw, "pairwise_core_int8_reference", counting)
    cfg = load_config("original-fp", small_config, {"compute_dtype": "float32"}).replace(n_answers=dicts.n_answers)
    pkl = str(tmp_path / "fp.pkl")
    port_export(RN(cfg, dicts.vocab_size, generator=torch.Generator().manual_seed(4)), pkl,
                dicts=Dictionaries(dicts.word_to_idx, dicts.answer_to_idx))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert main(_argv(fixture_dir, small_config, tmp_path, "original-fp", pkl, "--rl-impl", "pallas_int8",
                          *PORT)) == 0
    assert not [w for w in caught if "int8" in str(w.message) or "inference-only" in str(w.message)]
    out = capsys.readouterr().out
    assert out.index("int8 calibration clip fractions per layer: [") < out.index("overall accuracy:")
    n_val = len(tcli.build_datasets(argparse.Namespace(clevr_dir=fixture_dir, data_pipeline="pil"), cfg,
                                    dicts, splits=("val",))["val"])
    assert sum(calls) == -(-n_val // 16) * 16  # every eval batch in int8 (the clip report runs none)
    assert 0.0 <= _rows(tmp_path / "res", "val")["overall_accuracy"] <= 1.0
