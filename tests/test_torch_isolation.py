"""rnet_torch stands alone: no JAX, no flax, nothing of rnet.

In a fresh interpreter every module of the port is imported and sys.modules
is checked; a weights pkl exported by rnet is read with jax and flax blocked;
and the entry point asks for CUDA by default and raises without it.
"""

import os
import subprocess
import sys

import jax
import pytest
import torch

from rnet.config import load_config as jax_load_config
from rnet.serve import InferenceServer as JaxServer
from rnet.train.checkpoint import export_weights
from rnet.train.loop import make_injected_optimizer
from rnet.train.steps import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )


def test_port_imports_no_jax_and_no_rnet():
    code = r"""
import importlib, pkgutil, sys
import rnet_torch
names = ["rnet_torch"] + [m.name for m in pkgutil.walk_packages(rnet_torch.__path__, "rnet_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "rnet", "serve", "train", "PIL"))
print(len(names), bad)
assert not bad, bad
want = {"rnet_torch.kernels.augment", "rnet_torch.data.augment", "rnet_torch.data.cache",
        "rnet_torch.data.categories", "rnet_torch.data.pipeline", "rnet_torch.eval.metrics",
        "rnet_torch.train.checkpoint", "rnet_torch.train.loop", "rnet_torch.train.__main__",
        "rnet_torch.utils.watchdog", "rnet_torch.utils.profiling", "rnet_torch.evaluate", "rnet_torch.extract",
        "rnet_torch.parallel.mesh"}
assert want <= set(names), sorted(want - set(names))
assert len(names) >= 30, names
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_exported_pkl_loads_with_jax_blocked(dicts, tmp_path):
    cfg = jax_load_config("original-sd", overrides={"compute_dtype": "float32"}).replace(
        g_layers=(32, 32), f_layers=(16,), lstm_hidden=8, lstm_word_emb=4, n_answers=dicts.n_answers
    )
    jserver = JaxServer(cfg, dicts, max_batch=2)
    state = create_train_state(
        jserver.model, cfg, make_injected_optimizer(1e-3, clip_norm=50.0), jax.random.key(0), jserver._dummy_batch()
    )
    path = str(tmp_path / "w.pkl")
    export_weights(state, path, dicts=dicts)
    code = rf"""
import sys
for m in ("jax", "jaxlib", "flax", "optax", "orbax", "rnet"):
    sys.modules[m] = None  # any import of them now raises
from rnet_torch.checkpoint import load_exported_dicts, load_weights
from rnet_torch.config import load_config
from rnet_torch.data.vocab import Dictionaries
from rnet_torch.models import RN
w2i, a2i = load_exported_dicts({path!r})
cfg = load_config("original-sd", overrides={{"compute_dtype": "float32"}}).replace(
    g_layers=(32, 32), f_layers=(16,), lstm_hidden=8, lstm_word_emb=4, n_answers=len(a2i))
model = RN(cfg, Dictionaries(w2i, a2i).vocab_size)
load_weights(model, {path!r})
print("loaded", sum(p.numel() for p in model.parameters()))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "loaded" in proc.stdout


def test_default_device_is_cuda_and_raises_without_it(dicts, monkeypatch):
    from rnet_torch.config import load_config
    from rnet_torch.serve import InferenceServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config("original-sd").replace(n_answers=dicts.n_answers)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceServer(cfg, dicts)
    assert InferenceServer(cfg, dicts, device="cpu").device.type == "cpu"
