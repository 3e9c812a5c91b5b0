"""The port's multi-GPU path on the CPU over gloo, held to rnet's sharded functions.

``rnet_torch/parallel/mesh.py`` (the mesh, the collectives),
``pairwise_core_sharded`` (the g_theta core per shard), global-batch
BatchNorm, the data-averaged train step, the sharded ``BatchIterator`` and
the Trainer and entry points under a mesh. Each multi-process case starts
one ``tests/torch_parallel_worker.py`` per rank (file-based init under
``tmp_path``, no TCP port; one thread a rank; a timeout of its own so that
a hang fails the test), and every launch runs several tasks:

* the sharded core (forward and the six gradients) under data:2, pairs:2
  and data:2,pairs:2, against rnet's ``pairwise_core_sharded`` in interpret
  mode on a mesh of the same shape of the conftest's virtual CPU devices,
  within 1e-5 of max|rnet|; the int8 island under pairs:2 against rnet's
  with ``interpret=True``, and the per-shard calibration; the per-shard
  Philox masks under pair dropout, exactly the port's own reference at
  ``seed + shard_id * 1_000_003`` (rnet refuses pair dropout off a TPU);
* one train step under data:2, pairs:2 and data:2,pairs:2 (the kernel path's
  plain version, the ``xla`` and ``naive`` splits) against ``rnet.train.steps.train_step``
  on the same weights and global batch, at tests/test_torch_train.py's
  tolerances, BatchNorm statistics included;
* two-epoch Trainer runs (data:2 and pairs:2 on host batches, data:2 on
  device-resident data) against the one-process port run: train loss, val
  accuracy and NLL within rel 2e-4 (tests/test_multihost.py's bound) and the
  parameters bit for bit equal on the ranks;
* ``python -m torch.distributed.run`` of ``rnet_torch.train`` and
  ``rnet_torch.evaluate`` with ``--mesh``.

The four-process Trainer run is marked slow, as rnet's multi-process runs are.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnet.kernels import pairwise as rpw
from rnet.parallel import mesh as rmesh
from rnet_torch.data.pipeline import BatchIterator
from rnet_torch.kernels import augment as taug
from rnet_torch.kernels import pairwise as tpw
from rnet_torch.models.relational import dropout, pair_dropout
from rnet_torch.parallel import mesh as pmesh
from test_torch_train import (
    LR, V, _adam_of, _assert_moments_close, _assert_trees_close, _assert_updates_close, _conv_bias_keys, _flat,
    _states,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
TIMEOUT = 300  # seconds for one launch of the ranks
GRADS = ("du", "dv", "ds", "dqa", "dws", "dbs")
CORE = dict(B=4, n=16, H=128, L=3, inject=2)  # inject at the last layer: dqa is not zero
SEED = 0x5EED_0001
KEEP = 0.75
STEP_IMPLS = ("pallas", "xla", "naive")


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _launch(out, world: int, tasks, timeout: int = TIMEOUT):
    """Run ``tasks`` on ``world`` worker ranks; [{task name: result}] per rank."""
    os.makedirs(out, exist_ok=True)
    job = {"init": f"file://{out}/pg", "world": world, "out": str(out), "tasks": tasks}
    path = os.path.join(out, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    procs = [
        subprocess.Popen([sys.executable, WORKER, path, str(r)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}/{world} failed:\n{log[-4000:]}"
    results = []
    for r in range(world):
        mine = {}
        for t in tasks:
            with open(os.path.join(out, f"{t['name']}.{r}.pkl"), "rb") as f:
                mine[t["name"]] = pickle.load(f)
        results.append(mine)
    return results


def _core_inputs():
    rs = np.random.RandomState(3)
    B, n, H, L = CORE["B"], CORE["n"], CORE["H"], CORE["L"]
    return {
        "u": (rs.randn(B, n, H) * 0.3).astype(np.float32), "v": (rs.randn(B, n, H) * 0.3).astype(np.float32),
        "s": (rs.randn(B, H) * 0.1).astype(np.float32), "qa": (rs.randn(B, H) * 0.1).astype(np.float32),
        "ws": (rs.randn(L - 1, H, H) / np.sqrt(H)).astype(np.float32),
        "bs": (rs.randn(L - 1, H) * 0.05).astype(np.float32), "r": rs.randn(B, H).astype(np.float32),
    }


@pytest.fixture(scope="module")
def step_setup(tmp_path_factory):
    """rnet's state and one jitted step of shrunk original-fp (dropout
    off), the weights as a state dict file and the global batch (B=4)."""
    root = str(tmp_path_factory.mktemp("step"))
    jstate, jstep, tstate, batch, jb = _states("original-fp")
    weights, batch_path = os.path.join(root, "w.pt"), os.path.join(root, "batch.npz")
    torch.save(tstate.model.state_dict(), weights)
    np.savez(batch_path, **batch)
    cfg = {k: getattr(tstate.model.cfg, k) for k in ("image_size", "g_layers", "f_layers", "lstm_hidden",
                                                     "lstm_word_emb", "dropout")}
    task = {"kind": "step", "name": "step", "model": "original-fp", "cfg": cfg, "weights": weights,
            "batch": batch_path, "vocab": V, "lr": LR, "impls": list(STEP_IMPLS)}
    return (jstate, jstep, jb), task


@pytest.fixture(scope="module")
def core_inputs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("core") / "in.npz")
    data = _core_inputs()
    np.savez(path, **data)
    return path, data


def _tasks(core_path, step_task, specs, n):
    return [
        {"kind": "mesh", "name": "mesh", "specs": specs, "n": n},
        {"kind": "core", "name": "core", "specs": specs, "inputs": core_path, "inject": CORE["inject"], "seed": SEED},
        dict(step_task, specs=specs),
    ]


@pytest.fixture(scope="module")
def two_ranks(core_inputs, step_setup, noise_clevr, tmp_path_factory):
    """One launch of two ranks: data:2 and pairs:2, the Trainer runs, then
    the train CLI with a mesh of three."""
    ref, step_task = step_setup
    root = tmp_path_factory.mktemp("two")
    bad_mesh = [*_cli_args(noise_clevr, _small_config(root)), "--mesh", "data:3", "--epochs", "1",
                "--checkpoint-dir", str(root / "bad")]
    tasks = (_tasks(core_inputs[0], step_task, ["data:2", "pairs:2"], CORE["n"])
             + _trainer_task(noise_clevr, TRAINER_RUNS) + [{"kind": "cli", "name": "bad_mesh", "argv": bad_mesh}])
    return _launch(str(root), 2, tasks), ref


@pytest.fixture(scope="module")
def four_ranks(core_inputs, step_setup, tmp_path_factory):
    """One launch of four ranks: data:2,pairs:2."""
    ref, step_task = step_setup
    root = str(tmp_path_factory.mktemp("four"))
    return _launch(root, 4, _tasks(core_inputs[0], step_task, ["data:2,pairs:2"], CORE["n"])), ref


def _ranks(request, spec):
    return request.getfixturevalue("four_ranks" if spec == "data:2,pairs:2" else "two_ranks")


# ---- the mesh ----


def test_make_mesh_without_a_process_group():
    """One process: no mesh for no spec or a spec of one; a bigger spec
    raises naming both numbers and the launch (rnet's make_mesh raises on a
    spec that does not fit its devices, tests/test_sharding.py:24-31)."""
    assert pmesh.make_mesh(None, "cpu") is None
    assert pmesh.make_mesh("data:1", "cpu") is None
    assert pmesh.make_mesh("data:1,pairs:1", "cpu") is None
    with pytest.raises(ValueError, match=r"needs 8 processes, the run has 1.*--nproc-per-node 8"):
        pmesh.make_mesh("data:4,pairs:2", "cpu")
    assert pmesh.parse_spec("data:4,pairs:2") == (("data", "pairs"), (4, 2))
    for bad in ("model:2", "data:2,data:2", "data:0", "data:x"):
        with pytest.raises(ValueError, match="mesh spec"):
            pmesh.parse_spec(bad)


def test_axis_groups_are_row_major():
    """"data:4,pairs:2": rank r has data r // 2 and pairs r % 2, as rnet's
    device reshape lays them out."""
    assert pmesh.axis_groups((4, 2), 0) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert pmesh.axis_groups((4, 2), 1) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert pmesh.axis_groups((3,), 0) == [[0, 1, 2]]


@pytest.mark.parametrize("spec", ["data:2", "pairs:2", "data:2,pairs:2"])
def test_mesh_coordinates(request, spec):
    ranks, _ = _ranks(request, spec)
    jm = rmesh.make_mesh(spec, devices=jax.devices()[: len(ranks)])
    for r, res in enumerate(ranks):
        got = res["mesh"][spec]
        coords = np.argwhere(np.vectorize(lambda d: d.id)(jm.devices) == jax.devices()[r].id)[0]
        # the spec's axes as rnet lays them out, then the axis it leaves out at size 1
        assert got["coords"] == tuple(int(c) for c in coords) + (0,) * (2 - len(coords)), (spec, r)
        d, p = got["data"][0], got["pairs"][0]
        assert got["shard_id"] == d + p * got["data"][1]
        ni = CORE["n"] // got["pairs"][1]
        assert got["pair_rows"] == (p * ni, (p + 1) * ni)


# ---- the sharded core ----


def _rnet_core(spec, data, **kw):
    """rnet's shard_map island in interpret mode, with the gradients of
    sum(out * r) (tests/test_sharding.py:46-95)."""
    n_dev = int(np.prod([int(p.split(":")[1]) for p in spec.split(",")]))
    mesh = rmesh.make_mesh(spec, devices=jax.devices()[:n_dev])
    args = [jnp.asarray(data[k]) for k in ("u", "v", "s", "qa", "ws", "bs")]
    r = jnp.asarray(data["r"])

    def loss(*a):
        return (rpw.pairwise_core_sharded(*a, inject=CORE["inject"], mesh=mesh, interpret=True, **kw) * r).sum()

    out = jax.jit(lambda *a: rpw.pairwise_core_sharded(*a, inject=CORE["inject"], mesh=mesh, interpret=True, **kw))(
        *args)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*args)
    return {"out": np.asarray(out), **{k: np.asarray(g) for k, g in zip(GRADS, grads)}}


def _by_data(ranks, spec, key, part="core"):
    """The ranks' results of ``key`` joined over ``data`` (batch-sized
    tensors) or summed over it (dws, dbs: the step's reduction), each data
    index read from its pairs member 0; the pairs members must agree bit
    for bit (replicated gradients)."""
    by = {}
    for res in ranks:
        m = res["mesh"][spec]
        by.setdefault(m["data"][0], []).append(res["core"][spec][part][key])
    for d, parts in by.items():
        for other in parts[1:]:
            np.testing.assert_array_equal(other, parts[0], err_msg=f"{spec} {key}: pairs members differ")
    firsts = [by[d][0] for d in sorted(by)]
    return sum(firsts) if key in ("dws", "dbs") else np.concatenate(firsts)


@pytest.mark.parametrize("spec", ["data:2", "pairs:2", "data:2,pairs:2"])
def test_sharded_core_matches_rnet(request, core_inputs, spec):
    """Forward and all six gradients within 1e-5 of max|rnet| (fp32)."""
    ranks, _ = _ranks(request, spec)
    want = _rnet_core(spec, core_inputs[1])
    for key in ("out", *GRADS):
        got = _by_data(ranks, spec, key)
        assert got.shape == want[key].shape, key
        err = np.abs(got - want[key]).max()
        assert err <= 1e-5 * np.abs(want[key]).max(), (spec, key, err)


@pytest.mark.parametrize("spec", ["pairs:2", "data:2,pairs:2"])
def test_sharded_int8_matches_rnet(request, core_inputs, spec):
    """The int8 island: each shard calibrates on its own rows (the scales
    of its shard equal rnet's ``_activation_scales`` there) and the pooled
    partials are summed over pairs; within 1e-5 of max|rnet|."""
    ranks, _ = _ranks(request, spec)
    data = core_inputs[1]
    n_dev = len(ranks)
    mesh = rmesh.make_mesh(spec, devices=jax.devices()[:n_dev])
    args = [jnp.asarray(data[k]) for k in ("u", "v", "s", "qa", "ws", "bs")]
    want = np.asarray(jax.jit(lambda *a: rpw.pairwise_core_sharded(
        *a, inject=CORE["inject"], mesh=mesh, interpret=True, int8=True))(*args))
    by = {}
    for res in ranks:
        m = res["mesh"][spec]
        (d, D), (p, P) = m["data"], m["pairs"]
        B, n = CORE["B"] // D, CORE["n"] // P
        rows = slice(d * B, (d + 1) * B)
        local = [data[k][rows] for k in ("u", "v", "s", "qa")]
        local[0] = local[0][:, p * n:(p + 1) * n]
        scales = np.asarray(rpw._activation_scales(*map(jnp.asarray, local), jnp.asarray(data["ws"]),
                                                   jnp.asarray(data["bs"]), CORE["inject"]))
        np.testing.assert_allclose(res["core"][spec]["scales"], scales, rtol=1e-6, err_msg=(spec, d, p))
        by.setdefault(d, res["core"][spec]["int8"])
        np.testing.assert_array_equal(res["core"][spec]["int8"], by[d])  # pairs members agree
    got = np.concatenate([by[d] for d in sorted(by)])
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("spec", ["data:2", "pairs:2", "data:2,pairs:2"])
def test_pair_dropout_masks_per_shard(request, core_inputs, spec):
    """Pair dropout: shard (d, p) draws the port's Philox mask at seed +
    shard_id * 1_000_003 (shard_id = d + p * D), bit for bit: its output
    and dv equal the sum over its pairs members of the plain core on their
    rows at their seeds; every shard's mask differs."""
    ranks, _ = _ranks(request, spec)
    data = core_inputs[1]
    seeds = set()
    for res in ranks:
        m = res["mesh"][spec]
        (d, D), (P,) = m["data"], (m["pairs"][1],)
        B, n = CORE["B"] // D, CORE["n"] // P
        rows = slice(d * B, (d + 1) * B)
        v, s, qa, r = (torch.from_numpy(data[k][rows]) for k in ("v", "s", "qa", "r"))
        ws, bs = torch.from_numpy(data["ws"]), torch.from_numpy(data["bs"])
        out, dv = 0, 0
        for p in range(P):
            u = torch.from_numpy(data["u"][rows, p * n:(p + 1) * n].copy())
            seed = torch.tensor([SEED + (d + p * D) * pmesh.SHARD_SEED_STRIDE], dtype=torch.int64)
            seeds.add(int(seed))
            out = out + tpw.pairwise_core_reference(u, v, s, qa, ws, bs, CORE["inject"], KEEP, seed)
            dv = dv + tpw.pairwise_core_bwd_reference(u, v, s, qa, ws, bs, r, CORE["inject"], KEEP, seed)[1]
        got = res["core"][spec]["dropout"]
        assert res["core"][spec]["shard_id"] == d + m["pairs"][0] * D
        np.testing.assert_array_equal(got["out"], out.numpy(), err_msg=spec)
        np.testing.assert_array_equal(got["dv"], dv.numpy(), err_msg=spec)
    masks = [tpw.pair_mask_reference(torch.tensor([s]), 2, 8, 16, KEEP) for s in sorted(seeds)]
    assert len(masks) == len(ranks) and all(not torch.equal(a, b) for a, b in zip(masks, masks[1:]))


# ---- the train step ----


@pytest.mark.parametrize("spec", ["data:2", "pairs:2", "data:2,pairs:2"])
@pytest.mark.parametrize("impl", STEP_IMPLS)
def test_train_step_matches_rnet(request, spec, impl):
    """One step of shrunk original-fp on the rank's rows of the global
    batch (B=4): global-batch BatchNorm moments, the pairs split of the
    kernel path (its plain version), of ``xla`` or of ``naive`` (the split
    pair tensor), the gradient average
    over data; against rnet's step on the whole batch, at
    tests/test_torch_train.py's tolerances, BatchNorm running statistics
    included, and every rank's state bit for bit equal."""
    ranks, (jstate, jstep, jb) = _ranks(request, spec)
    p0 = _flat(jstate.params)
    jstate, jmetrics = jstep(jstate, jb)
    key = f"{spec}/{impl}"
    got = ranks[0]["step"][key]
    for res in ranks[1:]:
        for k, v in res["step"][key]["state"].items():
            np.testing.assert_array_equal(v, got["state"][k], err_msg=f"{key} {k}: replicas differ")
        assert res["step"][key]["metrics"] == got["metrics"]
    for m in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][m], float(jmetrics[m]), rtol=1e-5, atol=1e-7, err_msg=m)
    biases = _conv_bias_keys(jstate.params)
    jadam = _adam_of(jstate.opt_state)
    _assert_updates_close(p0, jstate.params, got["flax"]["params"], 1, skip=biases)
    _assert_moments_close(jadam.mu, got["adam"]["mu"], "mu", skip=biases)
    _assert_moments_close(jadam.nu, got["adam"]["nu"], "nu", skip=biases)
    fw, fg = _flat(jstate.params), _flat(got["flax"]["params"])
    for k in biases:
        assert np.abs(fw[k] - fg[k]).max() <= 2 * LR * 1.001, k
    _assert_trees_close(jstate.batch_stats, got["flax"]["batch_stats"], 1e-5, LR, "batch_stats")


# ---- draws at the global batch ----


def _fake_mesh(data: int, pairs: int, d: int, p: int) -> pmesh.Mesh:
    """A rank's place without process groups: enough for the draws."""
    return pmesh.Mesh(("data", "pairs"), (data, pairs), d * pairs + p, (d, p), (None, None), torch.device("cpu"),
                      "gloo")


def test_draws_are_the_global_batch_rows():
    """Every draw under a mesh is the one-process draw at the global batch,
    this rank's data rows of it: dropout, pair dropout (and its pairs
    shard's i-rows), the augment kernel's angles and offsets, the model's
    crop offsets and rotation angles. Pairs members draw the same."""
    from rnet_torch.data.augment import random_crop_batch, random_rotate_batch

    B, D, F, n = 3, 2, 5, 4
    y_all = torch.ones(B * D, F)
    a_all = torch.ones(B * D, n * n, 2)
    canvas = torch.arange(B * D * 10 * 10 * 3, dtype=torch.float32).reshape(B * D, 10, 10, 3)
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    want_drop = dropout(y_all, 0.5, gen())
    want_pair = pair_dropout(a_all, 0.5, gen())
    want_rot = random_rotate_batch(canvas, gen())
    want_crop = random_crop_batch(canvas, gen(), 6, groups=2)
    cache = torch.randint(0, 256, (9, 16, 16, 3), generator=gen(), dtype=torch.uint8)
    idx = torch.arange(B * D, dtype=torch.int32) % 9
    want_aug = taug.gather_augment(cache, idx, gen(), 8, torch.float32)
    for d in range(D):
        rows = slice(d * B, (d + 1) * B)
        for p in range(2):
            m = _fake_mesh(D, 2, d, p)
            torch.testing.assert_close(dropout(y_all[rows], 0.5, gen(), m), want_drop[rows], rtol=0, atol=0)
            prow = m.pair_rows(n)
            a = a_all[rows].reshape(B, n, n, 2)[:, prow].reshape(B, -1, 2)
            torch.testing.assert_close(pair_dropout(a, 0.5, gen(), m, n),
                                       want_pair[rows].reshape(B, n, n, 2)[:, prow].reshape(B, -1, 2), rtol=0, atol=0)
            torch.testing.assert_close(random_rotate_batch(canvas[rows], gen(), mesh=m), want_rot[rows], rtol=0, atol=0)
            torch.testing.assert_close(random_crop_batch(canvas[rows], gen(), 6, groups=2, mesh=m), want_crop[rows],
                                       rtol=0, atol=0)
            torch.testing.assert_close(taug.gather_augment(cache, idx[rows], gen(), 8, torch.float32, mesh=m),
                                       want_aug[rows], rtol=0, atol=0)


# ---- the data pipeline ----


@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_iterator_shards_as_rnet(fixture_dir, dicts, drop_last):
    """``shard=(rank, world)``: rnet's order (one global shuffle, then
    every world-th sample), the same number of batches on every shard
    (floored on the smallest, or ceiled on the largest and padded), and
    every sample on exactly one shard per epoch."""
    from rnet.data.clevr import ClevrDatasetStateDescription as JaxSD
    from rnet.data.pipeline import BatchIterator as JaxIterator
    from rnet_torch.data.clevr import ClevrDatasetStateDescription
    from rnet_torch.data.vocab import build_dictionaries

    jds = JaxSD(fixture_dir, "val", dicts)
    tds = ClevrDatasetStateDescription(fixture_dir, "val", build_dictionaries(fixture_dir))
    seen = []
    for rank in range(3):
        kw = dict(shuffle=True, seed=5, epoch=2, drop_last=drop_last, num_threads=1, shard=(rank, 3))
        want = list(JaxIterator(jds, 4, **kw))
        got = list(BatchIterator(tds, 4, **kw))
        assert len(got) == len(want) == len(BatchIterator(tds, 4, **dict(kw, shard=(0, 3))))
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        if not drop_last:
            seen += [i for b in got for i, ok in zip(b["index"], b["valid"]) if ok]
    if not drop_last:
        assert sorted(seen) == list(range(len(tds)))


# ---- the Trainer ----

TRAINER_CFG = dict(image_size=32, g_layers=[48] * 4, f_layers=[32, 32], lstm_hidden=24, lstm_word_emb=8,
                   question_max_len=24, dropout=0.0, device_augment=False, rl_impl="pallas")
TRAINER_BS = 8
# train.py's default LR, as tests/test_torch_loop.py takes: Adam's first
# steps move each weight by about lr * sign(g), so a rounding-level gap
# (the all-reduced sums, BatchNorm's combined moments) flips the sign of
# gradients near zero and grows step by step; at 1e-3 the device-pipeline
# run's val NLL ended 2.08e-4 from one process's after 34 steps.
TRAINER_LR = 1e-4
TRAINER_RUNS = [
    {"name": "data2_host", "spec": "data:2", "device_data": False},
    {"name": "pairs2_host", "spec": "pairs:2", "device_data": False},
    {"name": "data2_device", "spec": "data:2", "device_data": True},
]


@pytest.fixture(scope="module")
def noise_clevr(fixture_dir, tmp_path_factory):
    """The fixture's questions with decoded caches of seeded noise (see
    tests/test_torch_loop.py's ``noise_dir``: no PNG is decoded, and every
    rank reads the same files)."""
    root = tmp_path_factory.mktemp("clevr_noise_parallel")
    for sub in ("images", "questions", "scenes"):
        if os.path.exists(os.path.join(fixture_dir, sub)):
            os.symlink(os.path.join(fixture_dir, sub), root / sub)
    os.makedirs(root / "rnet_cache")
    rs = np.random.RandomState(1)
    for split in ("train", "val"):
        files = sorted(f for f in os.listdir(os.path.join(fixture_dir, "images", split)) if f.endswith(".png"))
        arr = np.lib.format.open_memmap(str(root / "rnet_cache" / f"{split}_32p8.u8"), mode="w+", dtype=np.uint8,
                                        shape=(len(files), 48, 48, 3))
        arr[:] = rs.randint(0, 256, arr.shape, dtype=np.uint8)
        arr.flush()
        del arr
        with open(root / "rnet_cache" / f"{split}_32p8.json", "w") as f:
            json.dump({"files": files, "image_size": 32, "pad": 8, "n": len(files)}, f)
    return str(root)


def _one_process(clevr, run, tmp, epochs=2):
    from rnet_torch.config import load_config
    from rnet_torch.data.cache import CachedClevrDataset
    from rnet_torch.data.vocab import build_dictionaries
    from rnet_torch.train.loop import Trainer
    from rnet_torch.train.schedules import DoublingSchedule

    dicts = build_dictionaries(clevr)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in TRAINER_CFG.items()}
    cfg = load_config("original-fp", overrides={"compute_dtype": "float32"}).replace(n_answers=dicts.n_answers, **kw)
    ds_kw = dict(image_size=32, question_max_len=24, serve_padded=True, serve_indices=True)
    tr = Trainer(
        cfg, dicts.vocab_size, CachedClevrDataset(clevr, "train", dicts, train_transform=True, **ds_kw),
        CachedClevrDataset(clevr, "val", dicts, train_transform=False, **ds_kw), dicts,
        lr=DoublingSchedule(base=TRAINER_LR, gamma=1.0, step=0),
        bs=DoublingSchedule(base=TRAINER_BS, gamma=1.0, step=0),
        checkpoint_dir=str(tmp / f"one_{run['name']}"), log_interval=2, log_fn=lambda *a: None, seed=7,
        device_data=run["device_data"], device="cpu", num_threads=1,
    )
    return tr.fit(epochs)


def _trainer_task(clevr, runs):
    return [{"kind": "trainer", "name": "trainer", "model": "original-fp", "cfg": TRAINER_CFG, "clevr_dir": clevr,
             "bs": TRAINER_BS, "lr": TRAINER_LR, "epochs": 2, "runs": runs}]


METRICS = ("epoch", "batch_size", "lr", "train_loss", "train_acc", "val_acc", "val_nll")


def _assert_runs_match(ranks, name, single):
    runs = [r["trainer"][name] for r in ranks]
    for other in runs[1:]:
        for k, v in other["state"].items():
            np.testing.assert_array_equal(v, runs[0]["state"][k], err_msg=f"{name} {k}: replicas differ")
        for mine, first in zip(other["history"], runs[0]["history"]):  # the times aside
            assert {k: mine[k] for k in METRICS} == {k: first[k] for k in METRICS}
    assert [h["epoch"] for h in runs[0]["history"]] == [1, 2]
    for got, want in zip(runs[0]["history"], single):
        assert got["batch_size"] == want["batch_size"] == TRAINER_BS
        for key in ("train_loss", "val_acc", "val_nll"):
            assert got[key] == pytest.approx(want[key], rel=2e-4, abs=2e-4), (name, key)
    assert runs[0]["ckpts"] == ["original-fp_dictionaries.json", "original-fp_epoch_001", "original-fp_epoch_002"]


@pytest.mark.parametrize("run", TRAINER_RUNS, ids=[r["name"] for r in TRAINER_RUNS])
def test_two_process_trainer_matches_one_process(two_ranks, noise_clevr, tmp_path, run):
    """Two epochs on two ranks (the sharded BatchIterator, or each rank's
    data columns of the device pipeline's index chunks; eval gathered over
    data) against one process at the same global batch: the same samples
    in every global batch, so the metrics agree to rounding."""
    _assert_runs_match(two_ranks[0], run["name"], _one_process(noise_clevr, run, tmp_path))


@pytest.mark.slow
def test_four_process_trainer_matches_one_process(noise_clevr, tmp_path):
    """data:2,pairs:2 on four ranks, host batches and device-resident data."""
    runs = [{"name": "d2p2_host", "spec": "data:2,pairs:2", "device_data": False},
            {"name": "d2p2_device", "spec": "data:2,pairs:2", "device_data": True}]
    ranks = _launch(str(tmp_path / "four"), 4, _trainer_task(noise_clevr, runs), timeout=600)
    for run in runs:
        _assert_runs_match(ranks, run["name"], _one_process(noise_clevr, run, tmp_path))


# ---- the entry points ----


def _torchrun(args, n: int = 2, timeout: int = TIMEOUT):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(n), *args]
    return subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True, timeout=timeout)


def _small_config(tmp):
    from rnet_torch.config import DEFAULT_CONFIG_PATH

    with open(DEFAULT_CONFIG_PATH) as f:
        cfg = json.load(f)["original-fp"]
    cfg.update({k: v for k, v in TRAINER_CFG.items() if k not in ("device_augment", "rl_impl")})
    path = str(tmp / "config.json")
    with open(path, "w") as f:
        json.dump({"original-fp": cfg}, f)
    return path


def _cli_args(clevr, config):
    return ["--platform", "cpu", "--clevr-dir", clevr, "--model", "original-fp", "--config", config,
            "--data-pipeline", "cached", "--no-device-augment", "--precision", "float32", "--batch-size", "8",
            "--num-workers", "1"]


def test_entry_points_under_torchrun(noise_clevr, tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    rnet_torch.train --platform cpu --mesh data:2``: one epoch, rank 0
    alone prints and writes the checkpoint and history.json;
    ``rnet_torch.evaluate --mesh data:2`` on that checkpoint gives the
    one-process accuracy."""
    from rnet_torch import evaluate

    common = _cli_args(noise_clevr, _small_config(tmp_path))
    ck, res = str(tmp_path / "ck"), str(tmp_path / "res")
    proc = _torchrun(["-m", "rnet_torch.train", *common, "--mesh", "data:2", "--multihost", "--epochs", "1",
                      "--checkpoint-dir", ck, "--test-results-dir", res])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("done: epoch 1") == 1 and proc.stdout.count("model: original-fp") == 1
    assert sorted(os.listdir(ck)) == ["original-fp_dictionaries.json", "original-fp_epoch_001"]
    with open(os.path.join(res, "history.json")) as f:
        assert [h["epoch"] for h in json.load(f)] == [1]

    ev = _torchrun(["-m", "rnet_torch.evaluate", *common, "--mesh", "data:2", "--checkpoint", "1",
                    "--checkpoint-dir", ck, "--test-results-dir", str(tmp_path / "ev2")])
    assert ev.returncode == 0, ev.stdout[-3000:] + ev.stderr[-3000:]
    two = [line for line in ev.stdout.splitlines() if line.startswith("overall accuracy")]
    assert len(two) == 1
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert evaluate.main([*common, "--checkpoint", "1", "--checkpoint-dir", ck,
                              "--test-results-dir", str(tmp_path / "ev1")]) == 0
    one = [line for line in buf.getvalue().splitlines() if line.startswith("overall accuracy")]
    acc = [float(line.split()[2]) for line in (one[0], two[0])]
    nll = [float(line.split()[-1]) for line in (one[0], two[0])]
    assert acc[0] == acc[1] and nll[0] == pytest.approx(nll[1], rel=1e-4)


def test_train_cli_refuses_a_mesh_of_another_size(two_ranks):
    """``rnet_torch.train --mesh data:3`` on two ranks raises on every rank,
    naming both numbers and the launch to use (before any collective)."""
    for r in two_ranks[0]:
        assert "mesh spec 'data:3' needs 3 processes, the run has 2" in r["bad_mesh"]["raised"]
        assert "--nproc-per-node 3" in r["bad_mesh"]["raised"]


@pytest.mark.parametrize("module", ["serve", "extract"])
def test_serve_and_extract_take_no_mesh(module):
    """As rnet's: they run on one device and refuse --mesh."""
    import importlib

    mod = importlib.import_module(f"rnet_torch.{module}")
    argv = ["--platform", "cpu", "--checkpoint", "w.pkl", "--mesh", "data:2"]
    if module == "extract":
        argv += ["--clevr-dir", "x"]
    with pytest.raises(SystemExit, match="--mesh"):
        mod.main(argv)

