"""rnet's orbax epoch directories read by the port (``rnet_torch.ocdbt``),
on the CPU, against orbax, tensorstore and rnet themselves.

* Directories written by rnet's own ``CheckpointManager`` (a from-pixels
  and a state-description config, shrunk; two epochs each, after Adam
  steps; and a tree with a bfloat16 leaf, 0-d leaves, an array far above
  the inline-value limit, nested sequences and empty containers): the
  port's tree equals ``ocp.StandardCheckpointer().restore(path)`` leaf for
  leaf, bit for bit, with the same containers.
* The OCDBT layer against tensorstore: a store with interior B-tree nodes
  (small ``max_decoded_node_bytes``), and a manifest whose latest version
  lives in version-tree nodes, not inline (the version tensorstore reads
  as that generation).
* Resume: rnet's ``Trainer.resume(dir)`` and the port's, each followed by
  one train step on the same batch (dropout, pair dropout, augmentation
  off), agree within tests/test_torch_train.py's one-step tolerances on
  the metrics, parameters, BatchNorm statistics and Adam moments; Adam's
  count and the step continue from the checkpoint's.
* The entry points: ``python -m rnet_torch.evaluate``, ``python -m
  rnet_torch.extract`` and ``InferenceServer.load`` on an rnet epoch (by
  path and by epoch number) give what they give on the pkl that rnet's
  ``export_weights`` writes from the same state; a wrong ``--model``
  raises naming the leaves; what the reader does not know raises.
* The committed full-width fixture (``tests/torch_fixtures/``, written by
  ``tests/torch_fixture_writer.py``) reads back to its recorded digests.
"""

import hashlib
import json
import os
import shutil
import sys
import types
from functools import partial

import google_crc32c
import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard

from rnet.config import load_config as jax_load_config
from rnet.data.clevr import ClevrDataset as JaxClevr
from rnet.data.clevr import ClevrDatasetStateDescription as JaxClevrSD
from rnet.models import RN as JaxRN
from rnet.train import steps as jsteps
from rnet.train.checkpoint import CheckpointManager as JaxCheckpointManager
from rnet.train.checkpoint import export_weights
from rnet.train.loop import Trainer as JaxTrainer
from rnet.train.loop import make_injected_optimizer
from rnet.train.schedules import DoublingSchedule as JaxSchedule
from rnet_torch import convert, ocdbt
from rnet_torch.checkpoint import load_weights
from rnet_torch.config import DEFAULT_CONFIG_PATH, load_config
from rnet_torch.data.clevr import ClevrDataset, ClevrDatasetStateDescription
from rnet_torch.data.vocab import build_dictionaries
from rnet_torch.evaluate import main as eval_main
from rnet_torch.extract import main as extract_main
from rnet_torch.models import RN
from rnet_torch.serve import InferenceServer
from rnet_torch.train import steps as tsteps
from rnet_torch.train.checkpoint import CheckpointManager, rnet_seed
from rnet_torch.train.loop import Trainer
from rnet_torch.train.schedules import DoublingSchedule
from test_torch_train import _assert_moments_close, _assert_trees_close, _assert_updates_close, _conv_bias_keys, _flat

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_fixtures")
LR = 1e-3  # test_torch_train.py's step tolerances are set at this LR
BS = 8  # rnet's Trainer puts all 8 virtual CPU devices on the data axis
PORT = ["--platform", "cpu", "--num-workers", "2", "--log-interval", "100"]
# question_max_len 16: rnet's LSTM unrolls over it, and its compile time with it
SHRUNK = {
    "original-fp": dict(image_size=32, g_layers=[48] * 4, f_layers=[32, 32], lstm_hidden=24, lstm_word_emb=8,
                        dropout=0.0, device_augment=False, question_max_len=16),
    "original-sd": dict(g_layers=[48] * 3, f_layers=[32], lstm_hidden=24, lstm_word_emb=8, dropout=0.0,
                        question_max_len=16),
    "ir-sd": dict(g_layers=[64] * 4, f_layers=[32], lstm_hidden=24, lstm_word_emb=8, dropout=0.0,
                  question_max_len=16),
}


@pytest.fixture(scope="module")
def small_config(tmp_path_factory):
    with open(DEFAULT_CONFIG_PATH) as f:
        full = json.load(f)
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    with open(path, "w") as f:
        json.dump({name: {**full[name], **kw} for name, kw in SHRUNK.items()}, f)
    return path


def _batch(cfg, vocab, seed=0, n=BS):
    rs = np.random.RandomState(seed)
    b = {"question": rs.randint(1, vocab, size=(n, cfg.question_max_len)).astype(np.int32),
         "answer": rs.randint(0, cfg.n_answers, size=n).astype(np.int32)}
    b["question"][:, :6] = 0  # leading pads (inverted questions)
    if cfg.state_description:
        b["objects"] = rs.randn(n, cfg.max_objects, cfg.object_dim).astype(np.float32)
    else:
        b["image"] = rs.randint(0, 256, size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.uint8)
    return b


@pytest.fixture(scope="module")
def rnet_runs(tmp_path_factory, small_config, dicts):
    """Per model: (checkpoint dir, its state after epoch 2, the jax config).
    Each run is rnet's injected-LR optimizer (the Trainer's), epochs 1 and
    2 saved by rnet's CheckpointManager after one Adam step each (ir-sd,
    which only extraction reads, at its initial state)."""
    out = {}
    for name in SHRUNK:
        cfg = jax_load_config(name, small_config, {"compute_dtype": "float32"}).replace(n_answers=dicts.n_answers)
        model = JaxRN(cfg=cfg, vocab_size=dicts.vocab_size)
        opt = make_injected_optimizer(LR, 50.0)
        jb = {k: jnp.asarray(v) for k, v in _batch(cfg, dicts.vocab_size, seed=1).items()}
        state = jsteps.create_train_state(model, cfg, opt, jax.random.key(11), jb)
        step = jax.jit(partial(jsteps.train_step, model=model, cfg=cfg, optimizer=opt))
        directory = str(tmp_path_factory.mktemp(f"rnet_{name}"))
        mgr = JaxCheckpointManager(directory, name, dicts=dicts)
        for epoch in (1, 2):
            if name != "ir-sd":
                state, _ = step(state, jb)
            mgr.save(state, epoch)
        out[name] = (directory, jax.tree.map(np.asarray, state), cfg)
    return out


def _assert_same_tree(got, want, where="tree"):
    """Equal containers and leaves, bit for bit (bfloat16 by its bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (where, got.keys(), want.keys())
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (where, type(got), type(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{where}[{i}]")
    elif want is None:
        assert got is None, where
    else:
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
            assert tuple(got.shape) == w.shape and got.view(torch.int16).numpy().tobytes() == w.tobytes(), where
        else:
            assert isinstance(got, np.ndarray) and got.dtype == w.dtype and got.shape == w.shape, where
            assert got.tobytes() == w.tobytes(), where


def _orbax(path):
    return ocp.StandardCheckpointer().restore(path)


@pytest.mark.parametrize("name", list(SHRUNK))
@pytest.mark.parametrize("epoch", [1, 2])
def test_restore_equals_orbax(rnet_runs, name, epoch):
    directory = rnet_runs[name][0]
    path = os.path.join(directory, f"{name}_epoch_{epoch:03d}")
    _assert_same_tree(ocdbt.restore(path), _orbax(path))
    if epoch == 2:  # the last epoch is the state the run ended with
        _assert_same_tree(ocdbt.restore(path)["params"], rnet_runs[name][1].params)


def test_restore_equals_orbax_on_every_leaf_kind(dicts, tmp_path):
    """bfloat16, 0-d, unsigned, int8, bool and fp16 leaves, a 240 KB array
    (far above the 1,024-byte inline limit: an indirect value), sequences
    holding dicts, None and empty containers; written by rnet's manager."""
    rs = np.random.RandomState(0)
    tree = {
        "a": {"bf16": jnp.asarray(rs.standard_normal(50), jnp.bfloat16), "scalar": jnp.int32(7),
              "big": jnp.asarray(rs.standard_normal((300, 200)).astype(np.float32)),
              "u32": jnp.arange(5, dtype=jnp.uint32), "f16": jnp.ones(3, jnp.float16),
              "flags": jnp.array([True, False]), "i8": jnp.arange(-3, 3, dtype=jnp.int8),
              "f32_0d": jnp.float32(1.5)},
        "seq": [jnp.zeros(2), {"x": jnp.ones(3)}, None, {}],
        "t": (jnp.float32(-2.0),),
    }
    path = JaxCheckpointManager(str(tmp_path), "misc", dicts=dicts).save(tree, 1)
    kv = ocdbt.read_kvstore(path)
    assert len(kv["a.big/0.0"]) > 1024  # stored outside the node
    got = ocdbt.restore(path)
    _assert_same_tree(got, _orbax(path))
    assert got["a"]["scalar"].shape == () and got["a"]["bf16"].dtype == torch.bfloat16


def _tensorstore(path, **spec):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/", **spec}).result()


def test_ocdbt_interior_nodes_match_tensorstore(tmp_path):
    """A store of 3 commits x 60 keys with nodes capped at 600 decoded bytes
    (a B-tree of height 2 and more, with subtree prefixes), values inline
    and indirect (> 40 bytes)."""
    kv = _tensorstore(tmp_path, config={"max_decoded_node_bytes": 600, "max_inline_value_bytes": 40})
    for g in range(3):
        with ts.Transaction() as txn:
            for i in range(60):
                kv.with_transaction(txn)[f"key/{g:02d}/{i:04d}"] = (b"v%d-%d" % (g, i)) * (1 + i % 25)
    got = ocdbt.read_kvstore(str(tmp_path))
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    assert got == want and len(got) == 180
    m = open(tmp_path / "manifest.ocdbt", "rb").read()
    assert max(int(v[1]) for v in _inline_versions(m)) >= 2  # the root's height


def _manifest_parts(raw):
    """(body, start and end of its inline version entries) of a manifest."""
    body = zstandard.ZstdDecompressor().decompressobj().decompress(raw[14:-4]) if raw[13] == 1 else raw[14:-4]
    r = ocdbt._Reader(body, "manifest")
    r.take(16)
    r.varint(), r.varint(), r.varint(), r.byte()
    if r.varint() == 1:
        r.take(4)
    files = ocdbt._data_files(r)
    start = r.pos
    versions = ocdbt._version_leaves(r, files)
    return body, start, r.pos, versions


def _inline_versions(raw):
    return _manifest_parts(raw)[3]


def test_latest_version_from_version_tree_nodes(tmp_path):
    """tensorstore keeps the newest versions inline and older ones in
    version-tree nodes. With the inline entries removed from the manifest
    (re-encoded uncompressed, its CRC-32C recomputed), the latest version is
    the newest one in the nodes: the reader must reach it through them and
    read what tensorstore reads at that generation."""
    src = tmp_path / "src"
    kv = _tensorstore(src, config={"version_tree_arity_log2": 1})
    for g in range(8):
        kv[f"k{g}"] = b"x" * (g + 1)
    raw = open(src / "manifest.ocdbt", "rb").read()
    body, start, end, inline = _manifest_parts(raw)
    newest_in_nodes = min(v[0] for v in inline) - 1
    old = _tensorstore(src, version=newest_in_nodes)
    want = {k.decode(): old.read(k).result().value for k in old.list().result()}
    dst = tmp_path / "dst"
    shutil.copytree(src, dst)
    new_body = body[:start] + b"\x00" + body[end:]
    head = (0x0CDB3A2A).to_bytes(4, "big") + (14 + len(new_body) + 4).to_bytes(8, "little") + b"\x00\x00"
    blob = head + new_body
    with open(dst / "manifest.ocdbt", "wb") as f:
        f.write(blob + google_crc32c.value(blob).to_bytes(4, "little"))
    assert ocdbt.read_kvstore(str(dst)) == want and len(want) == newest_in_nodes - 1


def test_resume_matches_rnet_trainer(fixture_dir, dicts, rnet_runs, tmp_path):
    """rnet's Trainer.resume and the port's on rnet's epoch 2, then one step
    on the same batch: test_torch_train.py's one-step tolerances."""
    for name in ("original-fp", "original-sd"):
        directory, _, jcfg = rnet_runs[name]
        path = os.path.join(directory, f"{name}_epoch_002")
        tcfg = load_config(name, overrides={"compute_dtype": "float32"}).replace(
            **{k: tuple(v) if isinstance(v, list) else v for k, v in SHRUNK[name].items()}, n_answers=dicts.n_answers)
        pdicts = build_dictionaries(fixture_dir)
        if jcfg.state_description:
            kw = dict(max_objects=jcfg.max_objects, object_dim=jcfg.object_dim)
            jds, tds = (JaxClevrSD(fixture_dir, "val", dicts, **kw), ClevrDatasetStateDescription(fixture_dir, "val", pdicts, **kw))
        else:
            jds, tds = (JaxClevr(fixture_dir, "val", dicts, image_size=32), ClevrDataset(fixture_dir, "val", pdicts, image_size=32))
        sched = dict(lr=JaxSchedule(LR, 1.0, 0), bs=JaxSchedule(BS, 1.0, 0))
        jtr = JaxTrainer(jcfg, dicts.vocab_size, jds, jds, dicts, checkpoint_dir=str(tmp_path / f"j_{name}"),
                         log_fn=lambda *a: None, seed=7, **sched)
        tr = Trainer(tcfg, pdicts.vocab_size, tds, tds, pdicts, lr=DoublingSchedule(LR, 1.0, 0),
                     bs=DoublingSchedule(BS, 1.0, 0), checkpoint_dir=str(tmp_path / f"p_{name}"),
                     log_fn=lambda *a: None, seed=7, device="cpu")
        assert jtr.resume(path) == tr.resume(path) == 2
        restored = ocdbt.restore(path)
        assert tr.state.step == 2 and tr.state.generator.initial_seed() == rnet_seed(restored["rng"])
        p0 = _flat(jax.tree.map(np.asarray, jtr.state.params))
        batch = _batch(jcfg, dicts.vocab_size, seed=5)
        jstate, jm = jtr.jit_train(jtr.state, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = tsteps.train_step(tr.state, batch)
        for m in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(tm[m]), float(jm[m]), rtol=1e-5, atol=1e-7, err_msg=(name, m))
        assert tr.state.step == int(jstate.step) == 3
        got = convert.state_dict_to_flax(tr.state.model.state_dict())
        adam = convert.adam_state_to_flax(tr.state.model, tr.state.adam)
        jadam = jstate.opt_state[1].inner_state[0]
        assert int(adam["count"]) == int(jadam.count) == 3
        biases = _conv_bias_keys(jstate.params)
        _assert_updates_close(p0, jstate.params, got["params"], 1, skip=biases)
        _assert_moments_close(jadam.mu, adam["mu"], "mu", skip=biases)
        _assert_moments_close(jadam.nu, adam["nu"], "nu", skip=biases)
        fw, fg = _flat(jstate.params), _flat(got["params"])
        for k in biases:  # removed by the train-mode BatchNorm: Adam's bound
            assert np.abs(fw[k] - fg[k]).max() <= 2 * LR * 1.001, k
        if biases:
            _assert_trees_close(jstate.batch_stats, got["batch_stats"], 1e-5, LR, "batch_stats")


def _export(rnet_runs, name, dicts, path):
    state = rnet_runs[name][1]
    export_weights(types.SimpleNamespace(params=state.params, batch_stats=state.batch_stats), str(path), dicts=dicts)
    return str(path)


def test_evaluate_reads_an_rnet_epoch_as_its_pkl(fixture_dir, small_config, dicts, rnet_runs, tmp_path):
    directory = rnet_runs["original-sd"][0]
    pkl = _export(rnet_runs, "original-sd", dicts, tmp_path / "w.pkl")
    reports = {}
    for tag, ck, ck_dir in (("path", os.path.join(directory, "original-sd_epoch_002"), "unused"),
                            ("epoch", "2", directory), ("pkl", pkl, "unused")):
        res = str(tmp_path / tag)
        assert eval_main(["--clevr-dir", fixture_dir, "--model", "original-sd", "--config", small_config,
                          "--precision", "float32", "--checkpoint", ck, "--checkpoint-dir",
                          os.path.join(str(tmp_path), ck_dir), "--batch-size", "16", "--test-results-dir", res,
                          *PORT]) == 0
        with open(os.path.join(res, "val_accuracy.csv")) as f, open(os.path.join(res, "val_confusion.csv")) as g:
            reports[tag] = (f.read(), g.read())
    assert reports["path"] == reports["epoch"] == reports["pkl"]


def test_extract_reads_an_rnet_epoch_as_its_pkl(fixture_dir, small_config, dicts, rnet_runs, tmp_path):
    directory = rnet_runs["ir-sd"][0]
    pkl = _export(rnet_runs, "ir-sd", dicts, tmp_path / "w.pkl")
    feats = {}
    for tag, ck in (("epoch", "2"), ("pkl", pkl)):
        out = str(tmp_path / tag)
        assert extract_main(["--clevr-dir", fixture_dir, "--model", "ir-sd", "--config", small_config,
                             "--precision", "float32", "--checkpoint", ck, "--checkpoint-dir", directory,
                             "--features-dirs", out, "--batch-size", "7", *PORT]) == 0
        with open(os.path.join(out, "ir-sd_val_gfeatures.pkl"), "rb") as f:
            feats[tag] = __import__("pickle").load(f)
    assert feats["epoch"]["filenames"] == feats["pkl"]["filenames"]
    np.testing.assert_array_equal(feats["epoch"]["features"], feats["pkl"]["features"])


def test_server_loads_an_rnet_epoch_as_its_pkl(fixture_dir, small_config, dicts, rnet_runs, tmp_path):
    directory = rnet_runs["original-sd"][0]
    pdicts = build_dictionaries(fixture_dir)
    cfg = load_config("original-sd", small_config, {"compute_dtype": "float32"}).replace(n_answers=dicts.n_answers)
    with open(os.path.join(fixture_dir, "scenes", "CLEVR_val_scenes.json")) as f:
        scenes = {s["image_index"]: s for s in json.load(f)["scenes"]}
    with open(os.path.join(fixture_dir, "questions", "CLEVR_val_questions.json")) as f:
        qs = json.load(f)["questions"][:9]
    reqs = [{"objects": scenes[q["image_index"]]["objects"], "question": q["question"]} for q in qs]
    answers = {}
    for tag, ck, ck_dir in (("path", os.path.join(directory, "original-sd_epoch_002"), None), ("epoch", "2", directory),
                            ("pkl", _export(rnet_runs, "original-sd", dicts, tmp_path / "w.pkl"), None)):
        server = InferenceServer(cfg, pdicts, max_batch=4, device="cpu")
        server.load(ck, ck_dir)
        answers[tag] = [(r["answer"], r["log_prob"]) for r in server.answer(reqs)]
    assert answers["path"] == answers["epoch"] == answers["pkl"] and len(answers["pkl"]) == len(reqs)


def test_wrong_model_raises_naming_the_leaves(small_config, dicts, rnet_runs):
    path = os.path.join(rnet_runs["original-sd"][0], "original-sd_epoch_002")
    wide = load_config("original-sd", small_config, {"compute_dtype": "float32"}).replace(
        g_layers=(64,) * 3, n_answers=dicts.n_answers)
    model = RN(wide, dicts.vocab_size)
    with pytest.raises(ValueError, match=r"relational.g0_kernel: checkpoint \(\d+, 48\) vs model \(\d+, 64\)"):
        load_weights(model, path)
    with pytest.raises(ValueError, match="relational.g2_bias"):
        CheckpointManager(os.path.dirname(path), "original-sd").restore_weights(model, 2)
    state = tsteps.create_train_state(model, tsteps.make_optimizer(LR))
    with pytest.raises(ValueError, match="wrong --model"):
        CheckpointManager(os.path.dirname(path), "original-sd").restore(state, path)


def test_unknown_formats_raise(rnet_runs, tmp_path):
    """zarr3, an unknown OCDBT format version and compression, an unknown
    zarr dtype and compressor, a data file path out of the directory."""
    src = os.path.join(rnet_runs["original-sd"][0], "original-sd_epoch_001")
    bad = str(tmp_path / "zarr3")
    shutil.copytree(src, bad)
    with open(os.path.join(bad, "_METADATA")) as f:
        meta = json.load(f)
    with open(os.path.join(bad, "_METADATA"), "w") as f:
        json.dump({**meta, "use_zarr3": True}, f)
    with pytest.raises(ocdbt.CheckpointFormatError, match="zarr3"):
        ocdbt.restore(bad)

    raw = open(os.path.join(src, "manifest.ocdbt"), "rb").read()
    for byte, value, match in ((12, 1, "format version 1"), (13, 2, "compression 2")):
        blob = bytearray(raw[:-4])
        blob[byte] = value
        blob = bytes(blob) + google_crc32c.value(bytes(blob)).to_bytes(4, "little")
        with pytest.raises(ocdbt.CheckpointFormatError, match=match):
            ocdbt._blob(blob, ocdbt.MANIFEST_MAGIC, "manifest.ocdbt")
    with pytest.raises(ocdbt.CheckpointFormatError, match="CRC-32C"):
        ocdbt._blob(raw[:-1] + bytes([raw[-1] ^ 1]), ocdbt.MANIFEST_MAGIC, "manifest.ocdbt")

    zarray = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4", "compressor": None, "fill_value": None,
              "order": "C", "filters": None}
    for change, match in (({"dtype": ">f4"}, "zarr dtype"), ({"dtype": "|O"}, "zarr dtype"),
                          ({"compressor": {"id": "blosc"}}, "compressor 'blosc'"), ({"order": "F"}, "order")):
        with pytest.raises(ocdbt.CheckpointFormatError, match=match):
            ocdbt.read_array({"x/.zarray": json.dumps({**zarray, **change}).encode(), "x/0": b"\0" * 8}, "x")
    with pytest.raises(ocdbt.CheckpointFormatError, match="no fill value"):
        ocdbt.read_array({"x/.zarray": json.dumps(zarray).encode()}, "x")
    filled = ocdbt.read_array({"x/.zarray": json.dumps({**zarray, "shape": [3], "fill_value": "NaN"}).encode(),
                               "x/0": np.float32([1, 2]).tobytes()}, "x")  # chunk 1 missing: the fill value
    assert filled[:2].tolist() == [1.0, 2.0] and np.isnan(filled[2])

    r = ocdbt._Reader(b"\x01\x02" + b"../d/x", "node")
    with pytest.raises(ocdbt.CheckpointFormatError, match="leaves the checkpoint directory"):
        ocdbt._data_files(r)


def test_committed_fixture_reads_back_to_its_digests(tmp_path):
    """The full-width original-fp fixture (written once by
    tests/torch_fixture_writer.py with rnet's CheckpointManager after two
    Adam steps): every leaf's sha256, dtype and shape as recorded, the
    kernels' moments not zero, the full-width port model loads it, and the
    dictionaries are those of chip_smoke.py's synthetic directory."""
    with open(os.path.join(FIXTURE, "digests.json")) as f:
        rec = json.load(f)
    tree = ocdbt.restore(os.path.join(FIXTURE, rec["epoch"]))
    leaves = {}

    def walk(node, where):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, where + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, where + (str(i),))
        elif node is not None:
            leaves[".".join(where)] = node

    walk(tree, ())
    assert sorted(leaves) == sorted(rec["leaves"])
    for k, want in rec["leaves"].items():
        got = leaves[k]
        assert [str(got.dtype), list(got.shape)] == [want["dtype"], want["shape"]], k
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], k
    params = [k for k in leaves if k.startswith("params.")]
    moments = {k: v for k, v in leaves.items() if ".mu." in k or ".nu." in k}
    assert len(moments) == 2 * len(params)
    assert all(np.abs(v).max() > 0 for k, v in moments.items() if k.endswith("kernel"))
    assert int(tree["step"]) == rec["steps"] == 2
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.write_synthetic_questions(np, str(tmp_path), rec["synthetic_seed"])
    d = build_dictionaries(str(tmp_path), use_cache=False)
    with open(os.path.join(FIXTURE, f"{rec['model']}_dictionaries.json")) as f:
        carried = json.load(f)
    assert carried == {"word_to_idx": d.word_to_idx, "answer_to_idx": d.answer_to_idx}
    model = RN(load_config(rec["model"]).replace(n_answers=d.n_answers), d.vocab_size)  # full width
    load_weights(model, os.path.join(FIXTURE, rec["epoch"]))
    assert sum(p.numel() for p in model.parameters()) == sum(leaves[k].size for k in params)
