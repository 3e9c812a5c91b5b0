"""``python -m rnet_torch.train`` on the CPU (``--platform cpu``), on the
synthetic fixture, in the manner of tests/test_cli.py: two epochs with
checkpoints, ``history.json`` and per-family reports, ``--resume latest``,
a shrunk original-fp given through ``--config`` on each data pipeline, the
supervised child (``--auto-restart``, a real ``python -m`` process), and
the flags that are refused.
"""

import json
import os

import pytest
import torch

from rnet_torch.train.__main__ import main

torch.set_num_threads(1)

COMMON = ["--platform", "cpu", "--precision", "float32", "--log-interval", "100", "--num-workers", "2"]


def _history(results):
    with open(os.path.join(results, "history.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def trained_sd(fixture_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    ckpt, results = str(root / "model"), str(root / "results")
    rc = main(["--clevr-dir", fixture_dir, "--model", "original-sd", "--epochs", "2", "--batch-size", "16",
               "--lr", "1e-3", "--lr-step", "0", "--checkpoint-dir", ckpt, "--test-results-dir", results, *COMMON])
    assert rc == 0
    return ckpt, results


def test_train_cli_trains_checkpoints_and_reports(trained_sd):
    ckpt, results = trained_sd
    names = sorted(os.listdir(ckpt))
    assert names == ["original-sd_dictionaries.json", "original-sd_epoch_001", "original-sd_epoch_002"]
    hist = _history(results)
    assert [h["epoch"] for h in hist] == [1, 2] and "val_acc" in hist[-1] and "val_nll" in hist[-1]
    with open(os.path.join(results, "val_epoch002_accuracy.csv")) as f:
        keys = {line.split(",")[0] for line in f}
    assert {"overall_accuracy", "mean_nll"} <= keys
    assert any(k.startswith("category_") for k in keys) and any(k.startswith("answer_") for k in keys)
    assert os.path.exists(os.path.join(results, "val_epoch002_confusion.csv"))


def test_train_cli_resumes_latest(trained_sd, fixture_dir, tmp_path):
    ckpt, _ = trained_sd
    results = str(tmp_path / "results")
    rc = main(["--clevr-dir", fixture_dir, "--model", "original-sd", "--epochs", "3", "--batch-size", "16",
               "--checkpoint-dir", ckpt, "--test-results-dir", results, "--resume", "latest", *COMMON])
    assert rc == 0
    assert [h["epoch"] for h in _history(results)] == [3]  # continued, not restarted


@pytest.fixture(scope="module")
def small_fp_config(tmp_path_factory):
    from rnet_torch.config import DEFAULT_CONFIG_PATH

    with open(DEFAULT_CONFIG_PATH) as f:
        fp = json.load(f)["original-fp"]
    fp.update(image_size=32, g_layers=[48, 48, 48, 48], f_layers=[32, 32], lstm_hidden=24, lstm_word_emb=8,
              question_max_len=24)
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    with open(path, "w") as f:
        json.dump({"original-fp": fp}, f)
    return path


@pytest.mark.parametrize("pipeline", [["device"], ["cached"], ["pil"], ["device", "--no-device-augment"]])
def test_train_cli_fp_pipelines(fixture_dir, small_fp_config, tmp_path, pipeline):
    """original-fp (shrunk through --config) trains on each data pipeline,
    with the device augmentation on by default for cached and device."""
    results = str(tmp_path / "results")
    rc = main(["--clevr-dir", fixture_dir, "--model", "original-fp", "--config", small_fp_config,
               "--epochs", "1", "--batch-size", "32", "--data-pipeline", *pipeline,
               "--checkpoint-dir", str(tmp_path / "model"), "--test-results-dir", results, *COMMON])
    assert rc == 0
    (h,) = _history(results)
    assert h["train_loss"] == h["train_loss"] and 0.0 <= h["val_acc"] <= 1.0  # finite, evaluated
    assert os.path.exists(tmp_path / "model" / "original-fp_epoch_001")


def test_train_cli_supervised_child(fixture_dir, tmp_path, monkeypatch):
    """--auto-restart runs the same command as a child ``python -m
    rnet_torch.train`` with the watchdog armed; a healthy run ends in one
    child with exit 0."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child beside the other test workers
    ckpt = str(tmp_path / "model")
    rc = main(["--clevr-dir", fixture_dir, "--model", "original-sd", "--epochs", "1", "--batch-size", "16",
               "--checkpoint-dir", ckpt, "--stall-timeout", "600", "--auto-restart", "2", *COMMON])
    assert rc == 0
    assert "original-sd_epoch_001" in os.listdir(ckpt)


def test_train_cli_refuses_what_is_not_ported(fixture_dir, tmp_path, monkeypatch):
    base = ["--clevr-dir", fixture_dir, "--model", "original-sd", "--epochs", "1",
            "--checkpoint-dir", str(tmp_path / "m")]
    # one process: a two-rank mesh names both numbers and the launch, and
    # --multihost wants torchrun's environment (tests/test_torch_parallel.py
    # runs both under torchrun)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=r"needs 2 processes, the run has 1.*--nproc-per-node 2"):
        main(base + ["--mesh", "data:2", "--platform", "cpu"])
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        main(base + ["--multihost", "--platform", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(base)  # the default platform is the card
