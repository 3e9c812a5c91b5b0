"""The port's compiled dispatch on the CPU: rnet_torch.train.steps'
``make_chunked_steps`` and ``make_jitted_steps`` and
rnet_torch.train.graphs' ``StepGraphs``.

* The chunked train step over a (K=3, B) index block on device-resident
  data (per-question tensors and a padded uint8 image cache) against
  rnet's ``make_chunked_steps(...)[0]`` on JAX's CPU, from the same weights
  (rnet's init carried over with ``rnet_torch.convert``); dropout, pair
  dropout and augmentation off. The eval chunk against rnet's
  ``eval_chunk``, unpacked with ``rnet.train.steps.unpack_eval_chunk``. An
  LR change between chunks against rnet's injected LR. These are the
  functions a CUDA graph captures on the card: on the CPU they run eagerly.
* ``StepGraphs`` through a fake capture backend (no card here): the
  launch counters' increments during a capture are added at every replay,
  the warm-up's and capture's own increments are taken back, the state
  comes back from its rollback, and a capture error propagates.
* On the CPU nothing is captured: a Trainer and a server have no graphs,
  and an epoch never reaches ``torch.cuda.CUDAGraph``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnet.config import load_config as jax_load_config
from rnet.models import RN as JaxRN
from rnet.train import steps as jsteps
from rnet.train.loop import set_learning_rate as jax_set_learning_rate
from rnet_torch import convert
from rnet_torch.config import load_config
from rnet_torch.models import RN
from rnet_torch.train import graphs as tgraphs
from rnet_torch.train import steps as tsteps

torch.set_num_threads(1)

V = 40
B = 4
K = 3
LR = 1e-3
IMG, CANVAS = 32, 48  # the shrunk model's input and the padded cache canvas
SHRUNK = dict(image_size=IMG, g_layers=(48,) * 4, f_layers=(32, 32), lstm_hidden=24, lstm_word_emb=8,
              question_max_len=12, dropout=0.0, pair_dropout=0.0, device_augment=False)


def _data(seed=0, n_images=6, n_questions=2 * K * B):
    """Per-question arrays and a padded uint8 image cache, seeded numpy."""
    rs = np.random.RandomState(seed)
    cache = rs.randint(0, 256, size=(n_images, CANVAS, CANVAS, 3)).astype(np.uint8)
    q = rs.randint(1, V, size=(n_questions, 12)).astype(np.int32)
    q[:, :4] = 0  # leading pads (inverted questions)
    data = {
        "image_idx": rs.randint(0, n_images, size=n_questions).astype(np.int32),
        "question": q,
        "answer": rs.randint(0, 28, size=n_questions).astype(np.int32),
    }
    return data, cache


def _setup(n_chunks=1):
    """(rnet chunk fns, rnet state, port state, numpy data, cache, idx blocks)."""
    over = {"compute_dtype": "float32"}
    jcfg = jax_load_config("original-fp", overrides=over).replace(**SHRUNK)
    tcfg = load_config("original-fp", overrides=over).replace(**SHRUNK)
    data, cache = _data()
    order = np.random.RandomState(1).permutation(len(data["answer"]))
    idx = [order[c * K * B : (c + 1) * K * B].reshape(K, B).astype(np.int32) for c in range(n_chunks)]
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jcache = jnp.asarray(cache)
    opt = jsteps.make_optimizer(LR, 50.0, 0.0, inject_lr=True)  # the Trainer's optimizer
    jm = JaxRN(cfg=jcfg, vocab_size=V)
    sample = {k: v[idx[0][0]] for k, v in jdata.items()}
    jstate = jsteps.create_train_state(jm, jcfg, opt, jax.random.key(0), sample, image_cache=jcache)
    model = RN(tcfg, V)
    model.load_state_dict(convert.flax_to_state_dict(
        jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})))
    tstate = tsteps.create_train_state(model, tsteps.make_optimizer(LR))
    jchunks = jsteps.make_chunked_steps(jm, jcfg, opt, donate=False)
    return jchunks, jstate, tstate, data, cache, idx, jdata, jcache


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_params_close(p0, jparams, tmodel, steps):
    """Each leaf's update w_t - w_0 within tests/test_torch_train.py's
    tolerances (relative norm, fp32 on the CPU): 2e-3 after three steps or
    more (Adam's first steps move each weight by about lr * sign(g), so a
    rounding gap near g = 0 flips a sign); 1e-2 for the conv stem, whose
    train-mode BatchNorm backward cancels large terms. The conv biases,
    which BatchNorm removes (exact gradient 0), are held to Adam's bound of
    lr a step."""
    got = _flat(convert.state_dict_to_flax(tmodel.state_dict())["params"])
    want = _flat(jparams)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k.startswith("['conv']['conv") and k.endswith("['bias']"):
            assert np.abs(got[k] - w).max() <= 2 * LR * steps * 1.001, k
            continue
        tol = 1e-2 if k.startswith("['conv']") else 2e-3
        rel = _rel(got[k] - p0[k], w - p0[k])
        assert rel <= tol, f"update of {k} after {steps} steps: relative gap {rel} (tolerance {tol})"


def test_train_chunk_matches_rnet_make_chunked_steps():
    """One (K=3, B=4) chunk: the (K, 3) per-step loss, accuracy and
    grad_norm within 1e-5 relative (fp32, sums in other orders; as
    tests/test_torch_train.py), the step count, and the parameters after K
    steps within _assert_params_close's tolerances."""
    (jtrain, _), jstate, tstate, data, cache, idx, jdata, jcache = _setup()
    p0 = _flat(jstate.params)
    jstate, jms = jtrain(jstate, jnp.asarray(idx[0]), jdata, jcache)
    train_chunk, _ = tsteps.make_chunked_steps(tstate)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    ms = train_chunk(torch.from_numpy(idx[0]), tdata, torch.from_numpy(cache))
    assert ms.shape == (K, 3) and tstate.step == int(jstate.step) == K
    np.testing.assert_allclose(ms.numpy(), np.asarray(jms), rtol=1e-5, atol=1e-7)
    _assert_params_close(p0, jstate.params, tstate.model, K)


def test_eval_chunk_matches_rnet_eval_chunk():
    """A (K, B) eval chunk with a partial valid mask after one train chunk:
    predictions, labels and the valid mask equal rnet's (unpacked with
    unpack_eval_chunk), the index passed through, and the chunk's NLL sum
    within 1e-5 relative (fp32 on the CPU)."""
    (jtrain, jeval), jstate, tstate, data, cache, idx, jdata, jcache = _setup()
    jstate, _ = jtrain(jstate, jnp.asarray(idx[0]), jdata, jcache)
    train_chunk, eval_chunk = tsteps.make_chunked_steps(tstate)
    tdata, tcache = {k: torch.from_numpy(v) for k, v in data.items()}, torch.from_numpy(cache)
    train_chunk(torch.from_numpy(idx[0]), tdata, tcache)
    eidx = np.arange(K * B, dtype=np.int32).reshape(K, B)
    valid = np.ones((K, B), bool)
    valid[-1, 2:] = False
    pred, label, vld, nll = jsteps.unpack_eval_chunk(
        np.asarray(jeval(jstate, jnp.asarray(eidx), jnp.asarray(valid), jdata, jcache)))
    out = eval_chunk(torch.from_numpy(eidx), torch.from_numpy(valid), tdata, tcache)
    assert sorted(out) == sorted(tsteps.EVAL_KEYS) and out["nll_sum"].shape == (K,)
    np.testing.assert_array_equal(out["pred"].numpy(), pred)
    np.testing.assert_array_equal(out["label"].numpy(), label)
    np.testing.assert_array_equal(out["valid"].numpy(), vld)
    np.testing.assert_array_equal(out["index"].numpy(), eidx)
    np.testing.assert_allclose(float(out["nll_sum"].sum()), nll, rtol=1e-5)
    assert not tstate.model.training


def test_lr_change_between_chunks_matches_rnet_injection():
    """Two chunks with the LR changed between them, through an LR tensor that
    ``set_learning_rate`` fills in place (the card's capturable Adam reads
    its LR from a device tensor; here a CPU tensor stands in for it), against
    rnet's injected LR: the second chunk's metrics within 1e-5 and the
    parameters after 2K steps within _assert_params_close's tolerances."""
    (jtrain, _), jstate, tstate, data, cache, idx, jdata, jcache = _setup(n_chunks=2)
    lr_t = torch.tensor(LR)
    for group in tstate.adam.param_groups:
        group["lr"] = lr_t
    p0 = _flat(jstate.params)
    train_chunk, _ = tsteps.make_chunked_steps(tstate)
    tdata, tcache = {k: torch.from_numpy(v) for k, v in data.items()}, torch.from_numpy(cache)
    jstate, _ = jtrain(jstate, jnp.asarray(idx[0]), jdata, jcache)
    train_chunk(torch.from_numpy(idx[0]), tdata, tcache)
    jstate = jax_set_learning_rate(jstate, 3e-3)
    tsteps.set_learning_rate(tstate, 3e-3)
    assert all(g["lr"] is lr_t for g in tstate.adam.param_groups) and float(lr_t) == pytest.approx(3e-3)
    jstate, jms = jtrain(jstate, jnp.asarray(idx[1]), jdata, jcache)
    ms = train_chunk(torch.from_numpy(idx[1]), tdata, tcache)
    np.testing.assert_allclose(ms.numpy(), np.asarray(jms), rtol=1e-5, atol=1e-7)
    _assert_params_close(p0, jstate.params, tstate.model, 2 * K)


def test_load_adam_state_keeps_the_lr_tensor():
    """A resume fills the live LR tensor with the saved LR instead of putting
    the saved object in its place (a captured step reads the live one)."""
    *_, tstate, data, cache, idx, _, _ = _setup()
    saved = {k: v for k, v in tstate.adam.state_dict().items()}
    saved["param_groups"] = [dict(g, lr=torch.tensor(5e-4)) for g in saved["param_groups"]]
    lr_t = torch.tensor(LR)
    for group in tstate.adam.param_groups:
        group["lr"] = lr_t
    tsteps.load_adam_state(tstate.adam, saved)
    assert all(g["lr"] is lr_t for g in tstate.adam.param_groups) and float(lr_t) == pytest.approx(5e-4)


def test_jitted_steps_equal_the_plain_steps():
    """make_jitted_steps without graphs runs train_step / eval_step: the
    same metrics and parameters, bit for bit, from the same state."""
    *_, tstate, data, cache, idx, _, _ = _setup()
    twin = tsteps.create_train_state(RN(tstate.model.cfg, V), tsteps.make_optimizer(LR))
    twin.model.load_state_dict(tstate.model.state_dict())
    batch = {k: torch.from_numpy(v[idx[0][0]]) for k, v in data.items()}
    tcache = torch.from_numpy(cache)
    jitted_train, jitted_eval = tsteps.make_jitted_steps(tstate)
    for _ in range(2):
        a = jitted_train(batch, tcache)
        b = tsteps.train_step(twin, batch, tcache)
        assert all(torch.equal(a[k], b[k]) for k in ("loss", "accuracy", "grad_norm"))
    assert tstate.step == twin.step == 2
    for k, v in tstate.model.state_dict().items():
        assert torch.equal(v, twin.model.state_dict()[k]), k
    ea, eb = jitted_eval(batch, tcache), tsteps.eval_step(twin, batch, tcache)
    assert sorted(ea) == sorted(eb) and all(torch.equal(ea[k], eb[k]) for k in ea)


# ---------------------------------------------------------------------------
# StepGraphs through a fake capture
# ---------------------------------------------------------------------------


class FakeBackend:
    """Stands in for CUDA graphs on the CPU: ``capture`` records what ran in
    it (the step function runs once, as under a real capture, but its work
    is kept by nobody) and ``replay`` counts replays. ``fail`` makes the
    capture raise as a failed stream capture does."""

    def __init__(self, fail=False):
        self.fail = fail
        self.events = []

    def new_pool(self):
        return "pool"

    @contextlib.contextmanager
    def warmup(self):
        self.events.append("warmup")
        yield

    def new_graph(self):
        return {"replays": 0}

    @contextlib.contextmanager
    def capture(self, graph, pool, generators):
        self.events.append(("capture", pool, len(generators)))
        yield
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")

    def replay(self, graph):
        graph["replays"] += 1

    def reserved_bytes(self):
        return 0


class Rollback:
    def __init__(self, box):
        self.box = box
        self.restored = []

    def snapshot(self):
        return dict(self.box)

    def restore(self, snap):
        self.restored.append(dict(self.box))
        self.box.clear()
        self.box.update(snap)


def _step_fn(box, counter):
    """A 'step': launches two kernels, changes the state, doubles its input."""

    def fn(x):
        counter["fwd"] += 1
        counter["bwd"] += 1
        box["steps"] += 1
        return {"y": x["a"] * 2}

    return fn


def test_step_graphs_add_the_capture_launches_at_every_replay():
    """Counters start at what they were before the capture; each replay
    adds what the capture counted (one launch of each kernel), none of the
    warm-up's; the function runs only for the warm-up and the capture; the
    rollback puts the state back; inputs go through the static buffers."""
    counter, other = {"fwd": 5, "bwd": 0, "idle": 0}, {"aug": 0}
    box = {"steps": 0}
    rollback = Rollback(box)
    backend = FakeBackend()
    g = tgraphs.StepGraphs("cpu", rollback=rollback, counters=(counter, other), backend=backend,
                           generators=(torch.Generator(),))
    fn = _step_fn(box, counter)
    out = g.run("k", fn, {"a": torch.tensor([1.0, 2.0])})
    assert box["steps"] == 0 and rollback.restored == [{"steps": 2}]  # one warm-up run, one capture
    assert backend.events == ["warmup", ("capture", "pool", 1)]
    assert counter == {"fwd": 6, "bwd": 1, "idle": 0} and other == {"aug": 0}
    (c,) = g.captured.values()
    assert c.deltas == [{"fwd": 1, "bwd": 1}, {}] and c.graph["replays"] == 1
    torch.testing.assert_close(out["y"], torch.tensor([2.0, 4.0]))
    out["y"].zero_()  # a copy: the graph's own output is untouched
    assert c.outputs["y"].tolist() == [2.0, 4.0]
    for _ in range(3):
        g.run("k", fn, {"a": torch.tensor([7.0, 8.0])})
    assert counter == {"fwd": 9, "bwd": 4, "idle": 0} and c.graph["replays"] == 4
    assert c.inputs["a"].tolist() == [7.0, 8.0] and box["steps"] == 0  # replays run no Python
    g.run("k2", fn, {"a": torch.zeros(3)})  # a new key: a second capture in the same pool
    assert len(g.captured) == 2 and backend.events[-1] == ("capture", "pool", 1)
    g.clear()
    assert not g.captured


def test_step_graphs_capture_error_propagates():
    """A failed capture raises its own error, leaves no graph behind, and
    puts the counters and the state back."""
    counter, box = {"fwd": 3, "bwd": 0}, {"steps": 0}
    g = tgraphs.StepGraphs("cpu", rollback=Rollback(box), counters=(counter,), backend=FakeBackend(fail=True))
    with pytest.raises(RuntimeError, match="stream is capturing"):
        g.run("k", _step_fn(box, counter), {"a": torch.ones(2)})
    assert not g.captured and counter == {"fwd": 3, "bwd": 0} and box == {"steps": 0}


def test_state_rollback_restores_in_place():
    """StateRollback puts back the parameters, buffers, Adam state (zeros
    where there was none), generator and step, into the same tensors."""
    *_, tstate, data, cache, idx, _, _ = _setup()
    batch = {k: torch.from_numpy(v[idx[0][0]]) for k, v in data.items()}
    tcache = torch.from_numpy(cache)
    rb = tsteps.StateRollback(tstate)
    snap = rb.snapshot()
    ptrs = {k: v.data_ptr() for k, v in tstate.model.state_dict().items()}
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    draw = torch.rand(3, generator=tstate.generator)
    tstate.generator.set_state(snap[2])
    tsteps.train_step(tstate, batch, tcache)
    adam_ptrs = {id(p): {k: v.data_ptr() for k, v in s.items()} for p, s in tstate.adam.state.items()}
    rb.restore(snap)
    assert tstate.step == 0
    for k, v in tstate.model.state_dict().items():
        assert v.data_ptr() == ptrs[k] and torch.equal(v, before[k]), k
    for p, s in tstate.adam.state.items():
        assert {k: v.data_ptr() for k, v in s.items()} == adam_ptrs[id(p)]
        assert all(not v.any() for v in s.values())
    assert torch.equal(torch.rand(3, generator=tstate.generator), draw)


# ---------------------------------------------------------------------------
# On the CPU nothing is captured
# ---------------------------------------------------------------------------


def test_nothing_is_captured_on_the_cpu(monkeypatch, tmp_path):
    """A Trainer and a server asked for the CPU have no graphs whatever
    ``cuda_graphs`` says, and a device-pipeline epoch and its eval never
    reach torch.cuda.CUDAGraph."""
    from rnet_torch.data.vocab import Dictionaries
    from rnet_torch.serve import InferenceServer
    from rnet_torch.train.loop import Trainer
    from rnet_torch.train.schedules import DoublingSchedule

    def refuse(*a, **kw):
        raise AssertionError("a CUDA graph was made on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    data, cache = _data(n_questions=2 * B)

    class Split:
        serve_indices = True
        images = cache

        def __len__(self):
            return len(data["answer"])

        def device_arrays(self):
            return data

        def question_categories(self):
            return None

    dicts = Dictionaries({f"w{i}": i for i in range(1, V)}, {f"a{i}": i for i in range(28)})
    cfg = load_config("original-fp", overrides={"compute_dtype": "float32"}).replace(**SHRUNK)
    split = Split()
    tr = Trainer(cfg, V, split, split, dicts, lr=DoublingSchedule(LR), bs=DoublingSchedule(B), device="cpu",
                 device_data=True, invert=False, log_fn=lambda *a: None, cuda_graphs=True,
                 checkpoint_dir=str(tmp_path))
    assert tr.graphs is None
    stats = tr.train_epoch(1)
    ev = tr.eval_epoch(1)
    assert np.isfinite(stats["train_loss"]) and tr.state.step == 2 and 0.0 <= ev["val_acc"] <= 1.0
    server = InferenceServer(cfg, dicts, max_batch=2, device="cpu", cuda_graphs=True)
    assert server.graphs is None
