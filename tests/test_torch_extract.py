"""g-prefix feature extraction of the port against rnet's, on the CPU.

``RelationalLayer.g_prefix_features`` and ``RN.extract`` against rnet's at
injection positions 1, 2 and 3 (fp32 within 1e-5 of the largest feature;
bf16 within the looser bound stated below), the ValueError of both at
position 0, features that no question can change, and ``python -m
rnet_torch.extract --platform cpu`` against rnet's ``extract.main`` on the
conftest fixture with the same weights pkl: shrunk ``ir-fp`` (PNGs) and
``ir-sd`` (scenes) give the same file names in the same order and features
within 1e-4, with an odd batch size (a ragged last batch), the same ``.h5``,
and exit code 2 for ``original-sd``. Weights cross through the weights-only
pkl (``export_weights`` / ``load_weights``) or ``rnet_torch.convert``.
"""

import json
import os
import pickle
import sys
import types

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnet.config import load_config as jax_load_config
from rnet.models import RN as JaxRN
from rnet.models.relational import RelationalLayer as JaxRelational
from rnet.train.checkpoint import export_weights
from rnet_torch import convert
from rnet_torch.cli import config_from_args, load_dicts
from rnet_torch.config import DEFAULT_CONFIG_PATH, load_config
from rnet_torch.data.clevr import scene_to_objects
from rnet_torch.extract import main, parse_args
from rnet_torch.models import RN
from rnet_torch.models.relational import RelationalLayer
from rnet_torch.ocdbt import CheckpointFormatError
from rnet_torch.train.__main__ import main as train_main
from rnet_torch.train.checkpoint import CheckpointManager

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import extract as rnet_extract_cli  # noqa: E402  (rnet's extraction CLI, the top-level extract.py)

torch.set_num_threads(1)

V = 40
PORT = ["--platform", "cpu", "--num-workers", "2"]
G4 = (48, 48, 48, 48)
# The shrunk models of the CLI tests (ir-* keep rnet's injection position 2)
SHRUNK = {
    "ir-fp": dict(image_size=32, conv_channels=[24, 24, 24], g_layers=[48] * 4, f_layers=[32, 32],
                  lstm_hidden=24, lstm_word_emb=8, dropout=0.0),
    "ir-sd": dict(g_layers=[64] * 4, f_layers=[32], lstm_hidden=24, lstm_word_emb=8, dropout=0.0),
    "original-sd": dict(g_layers=[64] * 4, f_layers=[32], lstm_hidden=24, lstm_word_emb=8, dropout=0.0),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _with_bn_stats(variables, seed):
    """Non-trivial BatchNorm running statistics, so that eval mode shows."""
    rs = np.random.RandomState(seed)
    for name, st in variables.get("batch_stats", {}).get("conv", {}).items():
        c = st["mean"].shape[0]
        st["mean"] = rs.uniform(-0.5, 0.5, c).astype(np.float32)
        st["var"] = rs.uniform(0.5, 1.5, c).astype(np.float32)
    return variables


def _close(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0 and err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# The layer and the model
# ---------------------------------------------------------------------------


def _relational(inject, dtype):
    kw = dict(obj_dim=7, q_dim=12, g_layers=G4, f_layers=(24,), n_answers=9, question_injection_position=inject)
    jm = JaxRelational(dropout=0.0, dtype=jnp.dtype(dtype), **kw)
    return jm, RelationalLayer(dtype=getattr(torch, dtype), **kw)


# bf16: both packages round after every op at the same points (here the
# features come out bitwise equal); a matmul that sums its products in
# another order may move an activation by one bf16 ulp, which can move the
# bf16 pair sum by one ulp, 2^-8 of its value: bound 2^-7 of the largest.
@pytest.mark.parametrize("dtype, rel", [("float32", 1e-5), ("bfloat16", 2.0**-7)])
@pytest.mark.parametrize("inject", [1, 2, 3])
def test_g_prefix_features_matches_rnet(inject, dtype, rel):
    rs = np.random.RandomState(inject)
    x = rs.randn(3, 9, 7).astype(np.float32)
    q = rs.randn(3, 12).astype(np.float32)
    jm, tm = _relational(inject, dtype)
    variables = _np_tree(jm.init(jax.random.key(inject), jnp.asarray(x), jnp.asarray(q)))
    want = jm.apply(variables, jnp.asarray(x), method=JaxRelational.g_prefix_features)
    tm.load_state_dict(convert.flax_to_state_dict(variables))
    with torch.no_grad():
        got = tm.g_prefix_features(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, G4[inject - 1])
    _close(got.numpy(), want, rel)


def test_g_prefix_features_refuses_inject_zero():
    """Both packages raise at injection position 0: the question joins at
    the first layer, so no g layer is question-independent."""
    x = np.zeros((1, 4, 7), np.float32)
    jm, tm = _relational(0, "float32")
    variables = _np_tree(jm.init(jax.random.key(0), jnp.asarray(x), jnp.zeros((1, 12))))
    with pytest.raises(ValueError, match="question_injection_position >= 1"):
        jm.apply(variables, jnp.asarray(x), method=JaxRelational.g_prefix_features)
    with pytest.raises(ValueError, match="question_injection_position >= 1"):
        tm.g_prefix_features(torch.from_numpy(x))


def _rn_pair(name, inject):
    over = {"compute_dtype": "float32", "question_injection_position": inject}
    if name.endswith("-fp"):
        kw = dict(image_size=32, g_layers=G4, f_layers=(32, 32), lstm_hidden=24, lstm_word_emb=8, dropout=0.0)
    else:
        kw = dict(g_layers=G4, f_layers=(32,), lstm_hidden=24, lstm_word_emb=8, dropout=0.0, max_objects=6)
    return jax_load_config(name, overrides=over).replace(**kw), load_config(name, overrides=over).replace(**kw)


def _rn_inputs(cfg, rs, B, canvas):
    if cfg.state_description:
        x = rs.randn(B, cfg.max_objects, cfg.object_dim).astype(np.float32)
        x[:, 4:] = 0.0  # pad objects take part as zero vectors
        return x
    return rs.randint(0, 256, size=(B, canvas, canvas, 3)).astype(np.uint8)


@pytest.mark.parametrize("inject", [1, 2, 3])
@pytest.mark.parametrize("name, canvas", [("ir-fp", 32), ("ir-fp", 40), ("ir-sd", None)])
def test_rn_extract_matches_rnet(name, canvas, inject):
    """RN.extract on the same weights (BatchNorm running statistics not the
    identity): from pixels at the model's size and on a larger canvas (a
    centre crop in both), and from state descriptions; within 1e-5 of the
    largest feature."""
    jcfg, tcfg = _rn_pair(name, inject)
    rs = np.random.RandomState(10 + inject)
    x = _rn_inputs(tcfg, rs, 3, canvas)
    tokens = rs.randint(1, V, size=(3, 12)).astype(np.int32)
    jm = JaxRN(cfg=jcfg, vocab_size=V)
    init_x = x if tcfg.state_description else x[:, :32, :32]
    variables = _with_bn_stats(_np_tree(jm.init(jax.random.key(inject), jnp.asarray(init_x), jnp.asarray(tokens))), 3)
    want = jm.apply(variables, jnp.asarray(x), method=JaxRN.extract)
    port = RN(tcfg, V)
    port.load_state_dict(convert.flax_to_state_dict(variables))
    port.train()  # extract runs in eval mode whatever the module's mode, and restores it
    got = port.extract(torch.from_numpy(x))
    assert port.training and not got.requires_grad
    assert tuple(got.shape) == (3, G4[inject - 1])
    _close(got.numpy(), want, 1e-5)


def test_rn_extract_ignores_the_question():
    """The features of an ir model depend on no question weight: changing
    the LSTM and the question rows of W_p (p = 2) leaves them bitwise equal,
    while the model's answers move."""
    _, tcfg = _rn_pair("ir-sd", 2)
    rs = np.random.RandomState(5)
    x = torch.from_numpy(_rn_inputs(tcfg, rs, 4, None))
    tokens = torch.from_numpy(rs.randint(1, V, size=(4, 12)).astype(np.int32))
    port = RN(tcfg, V, generator=torch.Generator().manual_seed(1)).eval()
    before = port.extract(x)
    with torch.no_grad():
        answers = port(x, tokens)
        for p in port.text.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(2)))
        port.relational.g2_kernel[G4[1]:].mul_(-3.0)  # the question's rows of layer 2
        moved = port(x, tokens)
    assert torch.equal(port.extract(x), before)
    assert not torch.allclose(moved, answers)


# ---------------------------------------------------------------------------
# python -m rnet_torch.extract against rnet's extract.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_config(tmp_path_factory):
    """config.json with ir-fp, ir-sd and original-sd shrunk."""
    with open(DEFAULT_CONFIG_PATH) as f:
        full = json.load(f)
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    with open(path, "w") as f:
        json.dump({name: {**full[name], **kw} for name, kw in SHRUNK.items()}, f)
    return path


def _rnet_pkl(name, small_config, dicts, path):
    """Seeded weights of `name` exported by rnet, with its dictionaries."""
    cfg = jax_load_config(name, small_config, {"compute_dtype": "float32"}).replace(n_answers=dicts.n_answers)
    if cfg.state_description:
        x = jnp.zeros((1, cfg.max_objects, cfg.object_dim))
    else:
        x = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.uint8)
    model = JaxRN(cfg=cfg, vocab_size=dicts.vocab_size)
    variables = _with_bn_stats(_np_tree(model.init(jax.random.key(4), x, jnp.ones((1, 12), jnp.int32))), 6)
    state = types.SimpleNamespace(params=variables["params"], batch_stats=variables.get("batch_stats", {}))
    export_weights(state, str(path), dicts=dicts)
    return str(path)


def _argv(fixture_dir, small_config, out, name, checkpoint, *extra):
    return ["--clevr-dir", fixture_dir, "--model", name, "--config", small_config, "--precision", "float32",
            "--checkpoint", str(checkpoint), "--checkpoint-dir", str(out / "ck"), "--batch-size", "3",
            "--features-dirs", str(out / "feat"), *extra]


def _read(out, name):
    base = os.path.join(out, "feat", f"{name}_val_gfeatures")
    with open(base + ".pkl", "rb") as f:
        pkl = pickle.load(f)
    with h5py.File(base + ".h5", "r") as f:
        h5 = {"features": f["features"][()], "filenames": [s.decode() for s in f["filenames"][()]]}
    return pkl, h5


@pytest.mark.parametrize("name", ["ir-fp", "ir-sd"])
def test_extract_cli_matches_rnet(name, fixture_dir, small_config, dicts, tmp_path):
    """The same pkl through rnet's extract.py and the port: the same file
    names in the same order (sorted PNGs; the scenes' order), one row per
    image although the batch size (3) leaves a ragged last batch, features
    within 1e-4 (fp32 sums in another order), and an .h5 holding the pkl's
    contents."""
    pkl = _rnet_pkl(name, small_config, dicts, tmp_path / f"{name}.pkl")
    assert rnet_extract_cli.main(_argv(fixture_dir, small_config, tmp_path / "r", name, pkl)) == 0
    assert main(_argv(fixture_dir, small_config, tmp_path / "p", name, pkl, *PORT)) == 0
    (want, want_h5), (got, got_h5) = _read(tmp_path / "r", name), _read(tmp_path / "p", name)
    if name == "ir-fp":
        names = sorted(f for f in os.listdir(os.path.join(fixture_dir, "images", "val")) if f.endswith(".png"))
    else:
        with open(os.path.join(fixture_dir, "scenes", "CLEVR_val_scenes.json")) as f:
            names = [s["image_filename"] for s in json.load(f)["scenes"]]
    assert len(names) % 3 != 0  # the last batch is ragged
    assert got["filenames"] == want["filenames"] == names == got_h5["filenames"]
    assert got["features"].shape == want["features"].shape == (len(names), SHRUNK[name]["g_layers"][1])
    np.testing.assert_allclose(got["features"], want["features"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got_h5["features"], got["features"])


def test_extract_cli_refuses_inject_zero(fixture_dir, small_config, dicts, tmp_path, capsys):
    """original-sd injects the question at layer 0: both CLIs exit 2 with
    the same message and write nothing."""
    pkl = _rnet_pkl("original-sd", small_config, dicts, tmp_path / "sd.pkl")
    assert rnet_extract_cli.main(_argv(fixture_dir, small_config, tmp_path / "r", "original-sd", pkl)) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert main(_argv(fixture_dir, small_config, tmp_path / "p", "original-sd", pkl, *PORT)) == 2
    assert capsys.readouterr().err.strip().splitlines()[-1] == want
    assert "needs an 'ir' model" in want and not os.path.exists(tmp_path / "p" / "feat")


def test_extract_cli_port_checkpoint_by_epoch(fixture_dir, small_config, tmp_path):
    """A checkpoint of ``python -m rnet_torch.train`` given by its epoch
    number extracts what RN.extract gives on the same weights; a directory
    of that name that is no orbax checkpoint raises and says why."""
    ck = str(tmp_path / "ck")
    assert train_main(["--clevr-dir", fixture_dir, "--model", "ir-sd", "--config", small_config,
                       "--precision", "float32", "--epochs", "1", "--batch-size", "16", "--lr", "1e-3",
                       "--checkpoint-dir", ck, "--test-results-dir", str(tmp_path / "res"), *PORT]) == 0
    argv = _argv(fixture_dir, small_config, tmp_path, "ir-sd", 1, *PORT)
    assert main(argv) == 0
    got, _ = _read(tmp_path, "ir-sd")
    args = parse_args(argv)
    dicts = load_dicts(args, checkpoint="1", checkpoint_dir=ck)
    cfg = config_from_args(args, dicts)
    model = RN(cfg, dicts.vocab_size)
    CheckpointManager(ck, "ir-sd").restore_weights(model, 1)
    with open(os.path.join(fixture_dir, "scenes", "CLEVR_val_scenes.json")) as f:
        scenes = json.load(f)["scenes"]
    objs = np.stack([scene_to_objects(s["objects"], cfg.max_objects, cfg.object_dim) for s in scenes])
    np.testing.assert_allclose(got["features"], model.extract(torch.from_numpy(objs)).numpy(), rtol=1e-6, atol=1e-6)
    os.makedirs(os.path.join(ck, "ir-sd_epoch_007"))  # a directory, as rnet's epochs, but no checkpoint
    with pytest.raises(CheckpointFormatError, match="_METADATA"):
        main(_argv(fixture_dir, small_config, tmp_path, "ir-sd", 7, *PORT))


def test_extract_cli_needs_a_card_unless_asked_for_the_cpu(fixture_dir, small_config, dicts, tmp_path, monkeypatch):
    """Without --platform cpu the CLI runs on CUDA; with no card it raises
    and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pkl = _rnet_pkl("ir-sd", small_config, dicts, tmp_path / "sd.pkl")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(_argv(fixture_dir, small_config, tmp_path, "ir-sd", pkl))


def test_extractor_captures_one_graph_per_batch_shape_and_dtype():
    """``python -m rnet_torch.extract`` on CUDA runs each batch as one replay
    of the graph captured at the first batch of its (shape, dtype); a
    ragged last batch is its own key. The bookkeeping through
    test_torch_graphs.py's fake capture backend (no card here); without
    graphs, as on the CPU, the same function runs eagerly."""
    from rnet_torch.extract import Extractor
    from rnet_torch.train.graphs import StepGraphs, shape_key
    from test_torch_graphs import FakeBackend

    cfg = load_config("ir-sd", overrides={"compute_dtype": "float32"}).replace(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in SHRUNK["ir-sd"].items()})
    model = RN(cfg, V, generator=torch.Generator().manual_seed(3))
    rs = np.random.RandomState(0)
    full, ragged = (torch.from_numpy(rs.randn(n, cfg.max_objects, cfg.object_dim).astype(np.float32)) for n in (5, 3))
    backend = FakeBackend()
    graphs = StepGraphs("cpu", backend=backend)
    extract = Extractor(model, graphs)
    with torch.no_grad():
        want = model.extract(full)
    assert torch.equal(extract(full), want) and torch.equal(Extractor(model)(full), want)
    for x in (full + 1, ragged, full + 2, ragged.double()):
        extract(x)
    keys = [("extract", shape_key({"x": x})) for x in (full, ragged, ragged.double())]
    assert list(graphs.captured) == keys
    assert [graphs.captured[k].graph["replays"] for k in keys] == [3, 1, 1]
    assert backend.events.count("warmup") == 3
