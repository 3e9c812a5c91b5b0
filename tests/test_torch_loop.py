"""rnet_torch.train.loop.Trainer vs rnet.train.loop.Trainer on the CPU, and
the port's checkpoint manager.

* One epoch of a shrunk original-fp on the device pipeline (device-resident
  cache and per-question data, per-step index gathers), augmentation and
  dropout off, on the fixture's questions with noise images (see
  ``noise_dir``), from the same weights (rnet ``export_weights`` -> port
  ``load_weights``): the same batches in the same order, so the epoch's
  train loss, the val accuracy and NLL, and the parameters agree within the
  tolerances of tests/test_torch_train.py.
* With augmentation on (the model-side path on the CPU, and the fused
  kernel's plain version under ``augment_impl="pallas"``): finite losses,
  and inputs that are not the centre crop.
* Resume: two epochs equal one epoch, a resume into a new Trainer and one
  more epoch, bit for bit (dropout and augmentation on, so the generator's
  state must come back too).
* CheckpointManager: keep-N, latest_epoch, the dictionaries sidecar.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from rnet.config import load_config as jax_load_config
from rnet.data.cache import CachedClevrDataset as JaxCached
from rnet.train.checkpoint import export_weights as jax_export_weights
from rnet.train.loop import Trainer as JaxTrainer
from rnet.train.schedules import DoublingSchedule as JaxSchedule
from rnet_torch import convert
from rnet_torch.checkpoint import load_weights, run_dicts_path
from rnet_torch.config import load_config
from rnet_torch.data.cache import CachedClevrDataset
from rnet_torch.data.vocab import Dictionaries, build_dictionaries
from rnet_torch.kernels import augment as tker
from rnet_torch.train import steps as tsteps
from rnet_torch.train.checkpoint import CheckpointManager
from rnet_torch.train.loop import Trainer
from rnet_torch.train.schedules import DoublingSchedule

torch.set_num_threads(1)

BS = 8  # rnet's Trainer puts all 8 virtual CPU devices on the data axis
# The parity epoch takes 3 steps, as tests/test_torch_train.py's longest
# comparison: Adam's first steps move each weight by about lr * sign(g), so
# a rounding-level gap flips the sign of gradients near zero and the two
# runs drift apart step by step (at lr 1e-3 and batch 8 the losses agree to
# 1e-4 for 5 steps, the updates of some leaves by only 10-50 % after 17).
PARITY_BS = 40
LR = 1e-4  # train.py's default
SHRUNK = dict(image_size=32, g_layers=(48,) * 4, f_layers=(32, 32), lstm_hidden=24, lstm_word_emb=8,
              question_max_len=24)


@pytest.fixture(scope="module")
def port_dicts(fixture_dir):
    return build_dictionaries(fixture_dir)


@pytest.fixture(scope="module")
def noise_dir(fixture_dir, tmp_path_factory):
    """The fixture's questions with image caches of seeded uniform noise.

    The fixture's images are flat grey backgrounds with a few sprites: the
    conv stem's BatchNorm then normalises channels whose variance is a
    small part of their mean square, and its backward cancels most of its
    input gradient, so rounding-level gaps between the packages (flax's
    batch variance is E[x^2] - E[x]^2, 1.7e-5 relative error there against
    4.7e-8 for torch's) reach the conv and BN gradients at 2-5 % after one
    step. On noise the three-step epoch agrees within test_torch_train.py's
    tolerances (measured <= 5.2e-4 on the updates, conv0's kernel); the
    loop, its data order and its batches are what this comparison is
    about."""
    root = tmp_path_factory.mktemp("clevr_noise")
    for sub in ("images", "questions"):
        os.symlink(os.path.join(fixture_dir, sub), root / sub)
    os.makedirs(root / "rnet_cache")
    rs = np.random.RandomState(0)
    for split in ("train", "val"):
        files = sorted(f for f in os.listdir(os.path.join(fixture_dir, "images", split)) if f.endswith(".png"))
        arr, meta = (str(root / "rnet_cache" / f"{split}_32p8{ext}") for ext in (".u8", ".json"))
        mm = np.lib.format.open_memmap(arr, mode="w+", dtype=np.uint8, shape=(len(files), 48, 48, 3))
        mm[:] = rs.randint(0, 256, mm.shape, dtype=np.uint8)
        mm.flush()
        del mm
        with open(meta, "w") as f:
            json.dump({"files": files, "image_size": 32, "pad": 8, "n": len(files)}, f)
    return str(root)


def _cfg(n_answers, **kw):
    over = {"compute_dtype": "float32"}
    extra = dict(SHRUNK, n_answers=n_answers, dropout=0.0, device_augment=False)
    extra.update(kw)
    return load_config("original-fp", overrides=over).replace(**extra)


def _datasets(cls, fixture_dir, dicts, **kw):
    ds_kw = dict(image_size=32, question_max_len=24, serve_padded=True, serve_indices=True, **kw)
    return (cls(fixture_dir, "train", dicts, train_transform=True, **ds_kw),
            cls(fixture_dir, "val", dicts, train_transform=False, **ds_kw))


def _trainer(fixture_dir, dicts, ckpt, cfg, device_data=True, bs=BS, **kw):
    train_ds, val_ds = _datasets(CachedClevrDataset, fixture_dir, dicts)
    return Trainer(
        cfg, dicts.vocab_size, train_ds, val_ds, dicts,
        lr=DoublingSchedule(base=LR, gamma=1.0, step=0), bs=DoublingSchedule(base=bs, gamma=1.0, step=0),
        checkpoint_dir=str(ckpt), log_interval=100, log_fn=lambda *a: None, seed=7,
        device_data=device_data, device="cpu", **kw,
    )


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_trainer_epoch_matches_rnet(noise_dir, dicts, port_dicts, tmp_path):
    jcfg = jax_load_config("original-fp", overrides={"compute_dtype": "float32"}).replace(
        n_answers=dicts.n_answers, dropout=0.0, device_augment=False, **SHRUNK
    )
    jtrain, jval = _datasets(JaxCached, noise_dir, dicts)
    jtr = JaxTrainer(
        jcfg, dicts.vocab_size, jtrain, jval, dicts,
        lr=JaxSchedule(base=LR, gamma=1.0, step=0), bs=JaxSchedule(base=PARITY_BS, gamma=1.0, step=0),
        checkpoint_dir=str(tmp_path / "jax"), log_interval=100, log_fn=lambda *a: None, seed=7,
        device_data=True,
    )
    path = str(tmp_path / "w0.pkl")
    jax_export_weights(jtr.state, path)
    tr = _trainer(noise_dir, port_dicts, tmp_path / "port", _cfg(dicts.n_answers), bs=PARITY_BS)
    load_weights(tr.state.model, path)
    assert tr.train_data is not None and tuple(tr.train_cache.shape[1:]) == (48, 48, 3)
    p0 = jax.tree.map(np.copy, convert.state_dict_to_flax(tr.state.model.state_dict())["params"])

    want, got = jtr.train_epoch(1), tr.train_epoch(1)
    assert got["batch_size"] == want["batch_size"] == PARITY_BS
    steps = len(jtrain) // PARITY_BS
    assert tr.state.step == int(jtr.state.step) == steps == 3
    # the epoch mean of the per-step losses: the same batches, fp32 sums in
    # another order (and over 8 devices in rnet)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    assert tr.train_cache.shape[0] == len(np.asarray(jtrain.images))
    np.testing.assert_allclose(got["train_acc"], want["train_acc"], atol=1e-6)
    # parameters: the update w - w0 per leaf within test_torch_train.py's
    # tolerances (2e-3 relative norm after three steps, 1e-2 in the conv
    # stem); the conv biases feed a train-mode BatchNorm, which removes
    # them (their gradient is rounding noise): held to Adam's bound
    wp = jax.tree.map(np.asarray, jtr.state.params)
    gp = convert.state_dict_to_flax(tr.state.model.state_dict())["params"]
    for name in gp["relational"]:
        w, g, w0 = wp["relational"][name], gp["relational"][name], p0["relational"][name]
        assert _rel(g - w0, w - w0) <= 2e-3, name
    for layer in gp["conv"]:
        for leaf in gp["conv"][layer]:
            w, g, w0 = wp["conv"][layer][leaf], gp["conv"][layer][leaf], p0["conv"][layer][leaf]
            if layer.startswith("conv") and leaf == "bias":
                assert np.abs(g - w).max() <= 2 * LR * steps * 1.001, layer
            else:
                assert _rel(g - w0, w - w0) <= 1e-2, (layer, leaf)

    want, got = jtr.eval_epoch(1), tr.eval_epoch(1)
    assert got["_accumulator"].n == want["_accumulator"].n == len(jval)
    assert got["val_acc"] == pytest.approx(want["val_acc"], abs=1e-9)
    np.testing.assert_allclose(got["val_nll"], want["val_nll"], rtol=1e-4)
    assert got["_accumulator"].per_category_accuracy() == want["_accumulator"].per_category_accuracy()


def test_augmented_training_runs_and_changes_inputs(fixture_dir, port_dicts, tmp_path):
    """device_augment on, the CPU's default route (the model crops and
    rotates in its forward) and the fused kernel's plain version
    (augment_impl="pallas"): finite losses, and the images the conv stem
    sees in a train step are not the centre crop."""
    cfg = _cfg(port_dicts.n_answers, device_augment=True)
    off = _trainer(fixture_dir, port_dicts, tmp_path / "off", _cfg(port_dicts.n_answers)).train_epoch(1)
    for impl in ("auto", "pallas"):
        tr = _trainer(fixture_dir, port_dicts, tmp_path / impl, cfg.replace(augment_impl=impl))
        tker.reset_launches()
        stats = tr.train_epoch(1)
        assert np.isfinite(stats["train_loss"]) and stats["train_loss"] != off["train_loss"], impl
        assert tker.launches["augment"] == 0  # the plain version on the CPU
        seen = []
        hook = tr.state.model.conv.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach()))
        batch = {k: v[:BS] for k, v in tr.train_data.items()}
        tsteps.train_step(tr.state, batch, tr.train_cache)
        hook.remove()
        center = tr.train_cache[batch["image_idx"].long()][:, 8:40, 8:40].float() / 255.0
        (x,) = seen
        assert x.shape == center.shape and (x.float() - center).abs().max() > 0.05, impl


def _params(trainer):
    return {k: v.clone() for k, v in trainer.state.model.state_dict().items()}


def test_resume_is_bitwise(fixture_dir, port_dicts, tmp_path):
    """fit(2) == fit(1) + resume(1) in a new Trainer + fit(2), bit for bit,
    with dropout and augmentation drawing from the generator."""
    cfg = _cfg(port_dicts.n_answers, device_augment=True, dropout=0.3)
    a = _trainer(fixture_dir, port_dicts, tmp_path / "a", cfg)
    ha = a.fit(2)
    b = _trainer(fixture_dir, port_dicts, tmp_path / "b", cfg)
    b.fit(1)
    assert b.ckpt.latest_epoch() == 1
    c = _trainer(fixture_dir, port_dicts, tmp_path / "b", cfg)
    assert c.resume(c.ckpt.latest_epoch()) == 1 and c.state.step == b.state.step
    hc = c.fit(2)
    assert [h["epoch"] for h in hc] == [2]
    assert hc[-1]["train_loss"] == ha[-1]["train_loss"] and hc[-1]["val_nll"] == ha[-1]["val_nll"]
    pa, pc = _params(a), _params(c)
    for k in pa:
        assert torch.equal(pa[k], pc[k]), k
    sa, sc = a.state.adam.state_dict()["state"], c.state.adam.state_dict()["state"]
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sc[i][k]), (i, k)
    # restore_weights: parameters and BatchNorm buffers only
    d = _trainer(fixture_dir, port_dicts, tmp_path / "b", cfg)
    assert d.restore_weights(str(tmp_path / "b" / "original-fp_epoch_002")) == 2
    for k, v in _params(d).items():
        assert torch.equal(v, pc[k]), k
    assert d.state.step == 0


def test_checkpoint_manager_keep_latest_and_sidecar(fixture_dir, port_dicts, tmp_path):
    tr = _trainer(fixture_dir, port_dicts, tmp_path / "unused", _cfg(port_dicts.n_answers), device_data=False)
    keep = CheckpointManager(str(tmp_path / "gc"), "m", keep=2, dicts=port_dicts)
    assert keep.latest_epoch() is None
    for e in (1, 2, 3, 5):
        keep.save(tr.state, e)
    assert sorted(p.name for p in (tmp_path / "gc").iterdir()) == ["m_dictionaries.json", "m_epoch_003", "m_epoch_005"]
    assert keep.latest_epoch() == 5
    every = CheckpointManager(str(tmp_path / "all"), "m")
    for e in (1, 2, 3):
        every.save(tr.state, e)
    assert every.latest_epoch() == 3 and len(list((tmp_path / "all").iterdir())) == 3
    # the sidecar in rnet's format, and a run with other dictionaries refused
    import json

    with open(run_dicts_path(str(tmp_path / "gc"), "m")) as f:
        assert json.load(f)["answer_to_idx"] == dict(port_dicts.answer_to_idx)
    other = Dictionaries(dict(port_dicts.word_to_idx), {a: i for i, a in enumerate(reversed(list(port_dicts.answer_to_idx)))})
    with pytest.raises(ValueError, match="differ"):
        CheckpointManager(str(tmp_path / "gc"), "m", dicts=other)
    CheckpointManager(str(tmp_path / "gc"), "m", dicts=port_dicts)  # the same dictionaries pass
    wrong = _trainer(fixture_dir, port_dicts, tmp_path / "w", _cfg(port_dicts.n_answers, g_layers=(64,) * 4),
                     device_data=False)
    with pytest.raises(ValueError, match="relational.g0_kernel"):
        keep.restore(wrong.state, 5)
