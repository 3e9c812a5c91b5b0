"""rnet_torch.train vs rnet.train on the CPU: train/eval steps, Adam state,
schedules and the train-mode model pieces (BatchNorm, dropout).

Weights come from rnet's ``create_train_state`` and are carried into the port
with ``rnet_torch.convert``; batches are seeded numpy arrays handed to both.
Dropout and pair dropout are off wherever the two packages are compared
(their random streams cannot match); the port's dropout is checked by its
statistics instead.
"""

import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rnet.config import load_config as jax_load_config
from rnet.models import RN as JaxRN
from rnet.models.conv import ConvInputModel as JaxConv
from rnet.train import steps as jsteps
from rnet.train.loop import set_learning_rate as jax_set_learning_rate
from rnet.train.schedules import DoublingSchedule as JaxDoublingSchedule
from rnet_torch import convert
from rnet_torch.config import load_config
from rnet_torch.models import RN
from rnet_torch.models.conv import ConvInputModel
from rnet_torch.models.relational import RelationalLayer, dropout, pair_dropout
from rnet_torch.train import steps as tsteps
from rnet_torch.train.schedules import DoublingSchedule

torch.set_num_threads(1)

V = 40
B = 4
LR = 1e-3


def _shrunk(name, **extra):
    """Shrunk configs as in tests/test_torch_models.py, dropout off."""
    over = {"compute_dtype": "float32"}
    if name.endswith("-fp"):
        kw = dict(image_size=32, g_layers=(48,) * 4, f_layers=(32, 32), lstm_hidden=24,
                  lstm_word_emb=8, dropout=0.0)
    else:
        kw = dict(g_layers=(48,) * 3, f_layers=(32,), lstm_hidden=24, lstm_word_emb=8,
                  dropout=0.0, max_objects=6)
    kw.update(extra)
    return jax_load_config(name, overrides=over).replace(**kw), load_config(name, overrides=over).replace(**kw)


def _batch(cfg, seed=0, n=B):
    rs = np.random.RandomState(seed)
    batch = {
        "question": rs.randint(1, V, size=(n, 12)).astype(np.int32),
        "answer": rs.randint(0, cfg.n_answers, size=n).astype(np.int32),
    }
    batch["question"][:, :4] = 0  # leading pads (inverted questions)
    if cfg.state_description:
        batch["objects"] = rs.randn(n, cfg.max_objects, cfg.object_dim).astype(np.float32)
    else:
        batch["image"] = rs.randint(0, 256, size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.uint8)
    return batch


def _adam_of(opt_state):
    leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return next(s for s in leaves if isinstance(s, optax.ScaleByAdamState))


def _states(name, lr=LR, clip_norm=50.0, weight_decay=0.0, **extra):
    """(rnet state, its jitted train_step, port state, batch) from one init."""
    jcfg, tcfg = _shrunk(name, **extra)
    batch = _batch(tcfg)
    jm = JaxRN(cfg=jcfg, vocab_size=V)
    opt = jsteps.make_optimizer(lr, clip_norm, weight_decay)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = jsteps.create_train_state(jm, jcfg, opt, jax.random.key(0), jb)
    model = RN(tcfg, V)
    model.load_state_dict(
        convert.flax_to_state_dict(jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    )
    tstate = tsteps.create_train_state(model, tsteps.make_optimizer(lr, clip_norm, weight_decay))
    jstep = jax.jit(partial(jsteps.train_step, model=jm, cfg=jcfg, optimizer=opt))
    return jstate, jstep, tstate, batch, jb


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(want, got, rtol, atol, what, skip=()):
    """Per leaf: max|want - got| <= atol + rtol * max|want|."""
    fw, fg = _flat(want), _flat(got)
    assert sorted(fw) == sorted(fg), what
    for k, w in fw.items():
        if any(s in k for s in skip):
            continue
        err = np.abs(w - fg[k]).max()
        assert err <= atol + rtol * np.abs(w).max(), f"{what}{k}: max err {err} (max|want| {np.abs(w).max()})"


def _conv_bias_keys(tree):
    """Keys of the conv layers' biases: ['conv']['conv{i}']['bias']."""
    return [k for k in _flat(tree) if re.fullmatch(r"\['conv'\]\['conv\d+'\]\['bias'\]", k)]


def _rel(got, want):
    """||got - want|| / ||want||, with 0 / 0 = 0."""
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# Tolerances of the train-step comparison, fp32 on the CPU, lr 1e-3. Each
# is a per-leaf relative norm, ||port - rnet|| / ||rnet||; for parameters it
# is taken of the update w_t - w_0, so that a missing or wrong step shows as
# O(1) whatever the size of the weights.
# * metrics: the two frameworks sum in different orders; rtol 1e-5.
# * Adam moments (mu ~ gradient, nu ~ gradient^2): 1e-4 (measured <= 4e-5).
#   The conv and BN leaves (['conv']...) get 1e-2 (measured <= 2.3e-3 after
#   three steps): the train-mode BatchNorm backward cancels large terms
#   (g - mean(g) - x^ mean(g x^)), and flax computes the batch variance as
#   E[x^2] - E[x]^2 where torch does not.
# * updates: Adam's first step is lr * g / (|g| + eps), about lr * sign(g),
#   so an element whose gradient is below the frameworks' rounding gap may
#   flip sign and move by 2 lr: the update's gap exceeds the moments'. 1e-4
#   after one step (measured <= 2.7e-5), 2e-3 after three (measured <= 6.6e-4,
#   ir-fp's g2 kernel, after the conv stem's gap has reached every
#   activation); 1e-2 for the conv and BN leaves (measured <= 2.8e-3).
# * the conv biases feed a train-mode BatchNorm, which removes them: their
#   exact gradient is 0 and the computed one is rounding noise, so Adam's
#   normalised step there has no defined direction. They are held to Adam's
#   bound instead (|step| <= lr each) and their moments to noise level; the
#   running means, which the biases shift, to atol lr * steps.
def _assert_updates_close(p0, jparams, tparams, steps, skip=()):
    fw, fg = _flat(jparams), _flat(tparams)
    assert sorted(fw) == sorted(fg)
    for k, w in fw.items():
        if k in skip:
            continue
        tol = 1e-2 if k.startswith("['conv']") else (1e-4 if steps == 1 else 2e-3)
        rel = _rel(fg[k] - p0[k], w - p0[k])
        assert rel <= tol, f"update of {k} after {steps} steps: relative gap {rel} (tolerance {tol})"


def _assert_moments_close(want, got, what, skip):
    fw, fg = _flat(want), _flat(got)
    assert sorted(fw) == sorted(fg), what
    for k, w in fw.items():
        if k in skip:
            continue
        tol = 1e-2 if k.startswith("['conv']") else 1e-4
        rel = _rel(fg[k], w)
        assert rel <= tol, f"{what}{k}: relative gap {rel} (tolerance {tol})"


def _compare(p0, jstate, jmetrics, tstate, tmetrics, steps):
    for m in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(tmetrics[m]), float(jmetrics[m]), rtol=1e-5, atol=1e-7, err_msg=m)
    assert tstate.step == int(jstate.step) == steps
    got = convert.state_dict_to_flax(tstate.model.state_dict())
    adam = convert.adam_state_to_flax(tstate.model, tstate.adam)
    jadam = _adam_of(jstate.opt_state)
    biases = _conv_bias_keys(jstate.params)
    _assert_updates_close(p0, jstate.params, got["params"], steps, skip=biases)
    _assert_moments_close(jadam.mu, adam["mu"], "mu", skip=biases)
    _assert_moments_close(jadam.nu, adam["nu"], "nu", skip=biases)
    assert int(adam["count"]) == int(jadam.count) == steps
    if biases:
        fw, fg = _flat(jstate.params), _flat(got["params"])
        mu_w, mu_g = _flat(jadam.mu), _flat(adam["mu"])
        for k in biases:
            assert np.abs(fw[k] - fg[k]).max() <= 2 * LR * steps * 1.001, k
            assert np.abs(mu_w[k]).max() < 1e-6 and np.abs(mu_g[k]).max() < 1e-6, k
        _assert_trees_close(jstate.batch_stats, got["batch_stats"], 1e-5, LR * steps, "batch_stats")
    else:
        assert not got["batch_stats"]


TRAIN_CASES = [
    ("original-fp", dict(rl_impl="xla")),
    ("original-fp", dict(rl_impl="pallas")),
    ("ir-fp", dict()),
    ("original-sd", dict()),
    ("original-fp", dict(clip_norm=0.05)),  # clipping active: grad_norm ~1.3
    ("original-sd", dict(weight_decay=1e-2)),
]


@pytest.mark.parametrize("name, kw", TRAIN_CASES, ids=[f"{n}-{'-'.join(map(str, k.values())) or 'default'}" for n, k in TRAIN_CASES])
def test_train_steps_match_jax(name, kw):
    """One and three train steps from the same weights and batch match
    rnet.train.steps.train_step in parameters, BatchNorm running statistics,
    Adam mu/nu/count and the three metrics."""
    jstate, jstep, tstate, batch, jb = _states(name, **kw)
    p0 = _flat(jstate.params)
    for steps in (1, 2, 3):
        jstate, jmetrics = jstep(jstate, jb)
        tmetrics = tsteps.train_step(tstate, batch)
        if steps in (1, 3):
            _compare(p0, jstate, jmetrics, tstate, tmetrics, steps)
    if kw.get("clip_norm"):
        assert float(tmetrics["grad_norm"]) > kw["clip_norm"]  # the clip was active


def test_eval_step_matches_jax():
    """eval_step under a partial valid mask, with trained BatchNorm statistics."""
    jstate, jstep, tstate, batch, jb = _states("original-fp")
    jstate, _ = jstep(jstate, jb)
    tsteps.train_step(tstate, batch)
    eb = _batch(load_config("original-fp").replace(image_size=32), seed=3, n=5)
    eb["valid"] = np.array([True, True, False, True, False])
    eb["index"] = np.arange(10, 15, dtype=np.int32)
    jm = JaxRN(cfg=_shrunk("original-fp")[0], vocab_size=V)
    want = jsteps.eval_step(jstate, {k: jnp.asarray(v) for k, v in eb.items()}, model=jm, cfg=jm.cfg)
    got = tsteps.eval_step(tstate, eb)
    assert sorted(got) == sorted(want)
    for k in ("pred", "label", "correct", "valid", "index"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(float(got["nll_sum"]), float(want["nll_sum"]), rtol=1e-5)
    assert not tstate.model.training


def test_eval_step_without_valid_counts_every_sample():
    _, _, tstate, batch, _ = _states("original-sd")
    out = tsteps.eval_step(tstate, batch)
    assert out["valid"].all() and "index" not in out
    assert out["correct"].sum() == (out["pred"] == out["label"]).sum()


def test_set_learning_rate_takes_effect_without_rebuild():
    """LR 0 leaves the parameters as they are; the next step at a new LR
    moves them, through the same Adam object (rnet: loop.set_learning_rate)."""
    _, _, tstate, batch, _ = _states("original-sd")
    adam = tstate.adam
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    tsteps.set_learning_rate(tstate, 0.0)
    tsteps.train_step(tstate, batch)
    for k, v in tstate.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    tsteps.set_learning_rate(tstate, 1e-3)
    tsteps.train_step(tstate, batch)
    assert tstate.adam is adam and adam.param_groups[0]["lr"] == 1e-3
    moved = max((v - before[k]).abs().max().item() for k, v in tstate.model.state_dict().items())
    assert moved > 1e-4


def test_set_learning_rate_matches_jax_injection():
    """The port's LR change and rnet's injected-hyperparameter change give
    the same second step."""
    jcfg, tcfg = _shrunk("original-sd")
    batch = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxRN(cfg=jcfg, vocab_size=V)
    opt = jsteps.make_optimizer(LR, 50.0, 0.0, inject_lr=True)
    jstate = jsteps.create_train_state(jm, jcfg, opt, jax.random.key(0), jb)
    model = RN(tcfg, V)
    model.load_state_dict(convert.flax_to_state_dict(jax.tree.map(np.asarray, {"params": jstate.params})))
    tstate = tsteps.create_train_state(model, tsteps.make_optimizer(LR))
    jstep = jax.jit(partial(jsteps.train_step, model=jm, cfg=jcfg, optimizer=opt))
    p0 = _flat(jstate.params)
    jstate, _ = jstep(jstate, jb)
    tsteps.train_step(tstate, batch)
    jstate = jax_set_learning_rate(jstate, 3e-3)
    tsteps.set_learning_rate(tstate, 3e-3)
    jstate, _ = jstep(jstate, jb)
    tsteps.train_step(tstate, batch)
    got = convert.state_dict_to_flax(model.state_dict())
    _assert_updates_close(p0, jstate.params, got["params"], steps=2)


def test_clip_follows_optax():
    """Unchanged below the norm; g / norm * max_norm at or above it (no +1e-6)."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    norm = tsteps.global_norm(g)
    assert float(norm) == 13.0
    want = optax.clip_by_global_norm(13.5).update([jnp.asarray(t) for t in g], None)[0]
    tsteps.clip_by_global_norm_(g, norm, 13.5)
    for a, b in zip(g, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = optax.clip_by_global_norm(6.5).update([jnp.asarray(t) for t in g], None)[0]
    tsteps.clip_by_global_norm_(g, norm, 6.5)
    for a, b in zip(g, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
    np.testing.assert_allclose(float(tsteps.global_norm(g)), 6.5, rtol=1e-7)


def test_doubling_schedule_matches_rnet():
    s = DoublingSchedule(base=1e-4, gamma=2.0, step=2, max=4e-4)
    assert s.value(1) == pytest.approx(1e-4)
    assert s.value(3) == pytest.approx(2e-4)
    assert s.value(50) == pytest.approx(4e-4)  # capped
    b = DoublingSchedule(base=32, gamma=2.0, step=1, max=128)
    assert [b.int_value(e) for e in (1, 2, 3, 4)] == [32, 64, 128, 128]
    for kw in (dict(base=1e-4, gamma=2.0, step=2, max=4e-4), dict(base=32, gamma=2.0, step=1, max=128),
               dict(base=5e-4, gamma=1.0, step=0), dict(base=7, gamma=3.0, step=3)):
        mine, ref = DoublingSchedule(**kw), JaxDoublingSchedule(**kw)
        for e in range(0, 12):
            assert mine.value(e) == ref.value(e) and mine.int_value(e) == ref.int_value(e), (kw, e)


@pytest.mark.parametrize("name", ["original-fp", "original-sd"])
def test_adam_state_round_trip_is_exact(name):
    """optax ScaleByAdamState (mu, nu, count) -> torch Adam -> back is exact,
    and the port's optimizer steps on from the loaded moments."""
    jstate, jstep, tstate, batch, jb = _states(name)
    jstate, _ = jstep(jstate, jb)
    jstate, _ = jstep(jstate, jb)
    ja = _adam_of(jstate.opt_state)
    src = jax.tree.map(np.asarray, {"mu": ja.mu, "nu": ja.nu, "count": ja.count})
    convert.flax_to_adam_state(tstate.model, tstate.adam, src)
    back = convert.adam_state_to_flax(tstate.model, tstate.adam)
    assert back["count"].dtype == np.int32 and int(back["count"]) == 2
    for tag in ("mu", "nu"):
        fa, fb = _flat(src[tag]), _flat(back[tag])
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    tsteps.train_step(tstate, batch)
    assert int(convert.adam_state_to_flax(tstate.model, tstate.adam)["count"]) == 3


def test_adam_state_of_a_fresh_optimizer_is_zero():
    _, _, tstate, _, _ = _states("original-sd")
    st = convert.adam_state_to_flax(tstate.model, tstate.adam)
    assert int(st["count"]) == 0
    assert all(not v.any() for v in _flat(st["mu"]).values())


# ---------------------------------------------------------------------------
# Train-mode pieces of the model
# ---------------------------------------------------------------------------


def test_batchnorm_train_mode_matches_flax():
    """Batch statistics with gradient, and the running buffers updated with
    the biased variance (flax's momentum 0.9), over two steps."""
    rs = np.random.RandomState(1)
    x = rs.rand(3, 16, 16, 3).astype(np.float32)
    m = JaxConv(channels=(8, 8), dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, m.init(jax.random.key(1), jnp.asarray(x), train=False))
    port = ConvInputModel(channels=(8, 8), dtype=torch.float32)
    sd = convert.flax_to_state_dict(
        {"params": {"conv": variables["params"]}, "batch_stats": {"conv": variables["batch_stats"]}}
    )
    port.load_state_dict({k.removeprefix("conv."): v for k, v in sd.items()})
    port.train()
    stats = variables["batch_stats"]
    for step in range(2):
        xs = x * (1.0 + step)
        want, upd = m.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(xs),
                            train=True, mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, upd["batch_stats"])
        got = port(torch.from_numpy(xs))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        for i in range(2):
            bn = getattr(port, f"bn{i}")
            np.testing.assert_allclose(bn.mean.numpy(), stats[f"bn{i}"]["mean"], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(bn.var.numpy(), stats[f"bn{i}"]["var"], rtol=1e-5, atol=1e-6)
    # the stored variance is the biased one: nn.BatchNorm2d's unbiased would differ
    y = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), port.conv0.weight, port.conv0.bias,
                                   stride=2, padding=1)
    assert not torch.allclose(y.var(dim=(0, 2, 3), unbiased=False), y.var(dim=(0, 2, 3), unbiased=True))


def test_dropout_statistics():
    """f_phi dropout: drop rate within binomial bounds, kept units scaled by
    exactly 1/keep, reproducible from the generator's seed."""
    y = torch.rand(64, 1024) + 0.5
    gen = torch.Generator().manual_seed(3)
    out = dropout(y, 0.3, gen)
    dropped = (out == 0).float().mean().item()
    n = y.numel()
    assert abs(dropped - 0.3) < 5 * (0.3 * 0.7 / n) ** 0.5
    kept = out != 0
    torch.testing.assert_close(out[kept], y[kept] / 0.7, rtol=0, atol=0)
    again = dropout(y, 0.3, torch.Generator().manual_seed(3))
    other = dropout(y, 0.3, torch.Generator().manual_seed(4))
    assert torch.equal(out, again) and not torch.equal(out, other)


def test_pair_dropout_statistics():
    """Whole pairs dropped (every channel of a pair together), at the rate
    asked within binomial bounds, kept pairs scaled by 1/keep."""
    a = torch.rand(8, 256, 16) + 0.5
    out = pair_dropout(a, 0.25, torch.Generator().manual_seed(5))
    pair_dropped = (out == 0).all(dim=-1)
    assert torch.equal(pair_dropped, (out == 0).any(dim=-1))
    rate = pair_dropped.float().mean().item()
    assert abs(rate - 0.25) < 5 * (0.25 * 0.75 / pair_dropped.numel()) ** 0.5
    torch.testing.assert_close(out[~pair_dropped], a[~pair_dropped] / 0.75, rtol=1e-6, atol=0)


def test_relational_train_forward_uses_the_generator():
    """Train mode on the xla path: output from (pair dropout, f dropout)
    drawn in that order from the generator; eval mode ignores both; a
    missing generator raises."""
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(3, 5, 7).astype(np.float32))
    q = torch.from_numpy(rs.randn(3, 12).astype(np.float32))
    layer = RelationalLayer(obj_dim=7, q_dim=12, g_layers=(32, 32), f_layers=(24,), n_answers=9,
                            dropout=0.4, pair_dropout=0.3, impl="xla", dtype=torch.float32)
    layer.train()
    got = layer(x, q, generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    a = pair_dropout(layer._g_xla(x, q), 0.3, gen)
    y = torch.relu(a.sum(dim=1) @ layer.f0_kernel + layer.f0_bias)
    y = dropout(y, 0.4, gen) @ layer.f1_kernel + layer.f1_bias
    torch.testing.assert_close(got, torch.log_softmax(y, dim=-1))
    with pytest.raises(ValueError, match="Generator"):
        layer(x, q)
    layer.eval()
    torch.testing.assert_close(layer(x, q), layer(x, q, generator=torch.Generator().manual_seed(1)))


def test_kernel_impl_train_forward_draws_a_pair_seed():
    """impl='pallas' in train mode with pair dropout: the pooled sum drops the
    pairs of the Philox mask for a seed drawn from the generator."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(2, 8, 7).astype(np.float32))
    q = torch.from_numpy(rs.randn(2, 12).astype(np.float32))
    kw = dict(obj_dim=7, q_dim=12, g_layers=(128, 128), f_layers=(24,), n_answers=9, dropout=0.0,
              dtype=torch.float32)
    kern = RelationalLayer(pair_dropout=0.5, impl="pallas", **kw).train()
    ref = RelationalLayer(pair_dropout=0.0, impl="pallas", **kw).eval()
    ref.load_state_dict(kern.state_dict())
    a = kern(x, q, generator=torch.Generator().manual_seed(2))
    b = kern(x, q, generator=torch.Generator().manual_seed(2))
    c = kern(x, q, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c) and not torch.allclose(a, ref(x, q))


def test_training_on_fp_with_train_forward_runs_and_learns():
    """A few port train steps on a fixed batch lower the loss (dropout on)."""
    _, tcfg = _shrunk("original-fp", dropout=0.2, pair_dropout=0.1)
    model = RN(tcfg, V)
    state = tsteps.create_train_state(model, tsteps.make_optimizer(3e-3), seed=1)
    batch = _batch(tcfg)
    losses = [float(tsteps.train_step(state, batch)["loss"]) for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert model.conv.bn0.var.ne(1.0).all()  # running statistics moved
