"""rnet's round-3 campaign fixture (``--n-train 70000 --n-val 15000 --style
v2 --seed 1``) as the port regenerates it, and rnet's epoch-119 original-fp
(``results/campaign_r3/original-fp_epoch119_weights.pkl``, no dictionaries
carried) in both packages, on the CPU.

* ``tests/torch_fixtures/clevr_v2_seed1_70k/`` (written once by
  ``tests/torch_fixture_v2_70k_writer.py`` with rnet's generator) holds
  the counts, the digests and the dictionaries of that fixture.
* The port's ``_draw_split`` of the 70,000 train scenes (no rendering)
  gives rnet's train questions JSON to the byte (its sha256), and the
  port's ``build_dictionaries`` of it the committed dictionaries, in order.
* The epoch-119 weights load into the port's ``RN`` and rnet's with those
  dictionaries, and on the first 16 questions of the committed 600-image v2
  seed-1 val split (the same generator, ``tests/torch_fixtures/
  clevr_v2_seed1_val/``) give the same log-probs, element by element within
  1e-4 plus 1e-5 of their magnitude (trained logits put wrong answers up to
  1,548 nats down, where fp32's resolution is 1.2e-4; near 0 the bound is
  1e-4), the same predictions, and every answer right. The writer scored
  the whole split on the CPU: 7,484 of 7,484 right in both packages.
* In int8 (``rl_impl`` "pallas_int8"), the same weights give the same
  log-probs in the port (its plain int8 chain) as in rnet (its int8 kernel
  in interpret mode; off a TPU rnet would fall back to fp) on the first 8
  val questions, within 1e-5 plus 1e-5 of their magnitude: on an H100 the
  port's int8 scores 0.997048 where bf16 scores 0.999775 (chip_smoke phase
  17), the loss rnet's int8 chain has at H=256 (RESULTS.md:503-505).
* The writer's readings of eval batches 0 and 45 at B=512
  (``int8_batches.json``): rnet's int8 (its kernel in interpret mode) loses
  questions of batch 45 that its bf16 answers right, and with fp32 compute
  the port's plain int8 chain gives its prediction on every question of
  both batches. Phase 17 holds the card's int8 to rnet's there.
"""

import json
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rnet.config import load_config as jax_load_config
from rnet.kernels import pairwise as rpw
from rnet.models import RN as JaxRN
from rnet_torch.checkpoint import load_weights
from rnet_torch.config import load_config
from rnet_torch.data import synth
from rnet_torch.data.cache import CachedClevrDataset
from rnet_torch.data.vocab import Dictionaries, build_dictionaries, invert_questions
from rnet_torch.models import RN

torch.set_num_threads(1)

FIRST = 16


def _committed():
    with open(os.path.join(chip_smoke.CAMPAIGN_FIXTURE, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(chip_smoke.CAMPAIGN_FIXTURE, "dictionaries.json")) as f:
        dicts = json.load(f)
    return digests, Dictionaries(dicts["word_to_idx"], dicts["answer_to_idx"])


def test_committed_fixture_records_rnets_campaign():
    digests, dicts = _committed()
    assert digests["source"].endswith("--n-train 70000 --n-val 15000 --style v2 --seed 1")
    assert (digests["train_questions"], digests["val_questions"]) == (870_780, 186_681)  # RESULTS.md
    assert (digests["train_images"], digests["val_images"]) == (70_000, 15_000)
    assert digests["cache_shape"] == [15_000, 144, 144, 3]
    assert chip_smoke.CAMPAIGN_SYNTH == (70_000, 15_000, "v2", 1)
    assert dicts.n_answers == 28 and sorted(dicts.answer_to_idx.values()) == list(range(28))
    assert sorted(dicts.word_to_idx.values()) == list(range(1, len(dicts.word_to_idx) + 1))
    scores = digests["epoch119_on_clevr_v2_seed1_val"]
    assert scores["rnet"]["accuracy"] == scores["port"]["accuracy"] == 1.0


def test_port_draws_rnets_train_split(tmp_path):
    digests, want = _committed()
    n_train, _, style, seed = chip_smoke.CAMPAIGN_SYNTH
    scenes, questions = synth._draw_split(random.Random(seed), "train", n_train, style)
    assert len(scenes) == n_train and len(questions) == digests["train_questions"]
    synth._write_split(str(tmp_path), "train", [], questions)
    del scenes, questions
    path = tmp_path / "questions" / "CLEVR_train_questions.json"
    assert chip_smoke.sha256_of(str(path)) == digests["files"]["CLEVR_train_questions.json"]["sha256"]
    got = build_dictionaries(str(tmp_path), use_cache=False)
    assert list(got.word_to_idx.items()) == list(want.word_to_idx.items())
    assert list(got.answer_to_idx.items()) == list(want.answer_to_idx.items())


@pytest.fixture(scope="module")
def val600(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clevr_val600"))
    chip_smoke.expand_val_fixture(root)
    return root


def _both_packages(val600, n, rl_impl):
    """The first `n` val questions through the port's RN and rnet's, both
    loaded from the epoch-119 pkl, fp32, at `rl_impl`; (port, rnet, labels)."""
    _, dicts = _committed()
    ds = CachedClevrDataset(val600, "val", dicts, image_size=128, question_max_len=48, train_transform=False)
    batch = ds.get_batch(np.arange(n))
    images, tokens = batch["image"], invert_questions(batch["question"])
    over = {"compute_dtype": "float32", "rl_impl": rl_impl}
    port = RN(load_config("original-fp", overrides=over).replace(n_answers=dicts.n_answers), dicts.vocab_size)
    load_weights(port, chip_smoke.CAMPAIGN_PKL)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(images), torch.from_numpy(tokens)).numpy()

    with open(chip_smoke.CAMPAIGN_PKL, "rb") as f:
        flat = pickle.load(f)
    assert sorted(flat) == ["batch_stats", "params"]  # a round-3 export: no dictionaries
    jcfg = jax_load_config("original-fp", overrides=over).replace(n_answers=dicts.n_answers)
    variables = {"params": flat["params"], "batch_stats": flat["batch_stats"]}
    want = np.asarray(JaxRN(cfg=jcfg, vocab_size=dicts.vocab_size).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images), jnp.asarray(tokens), train=False))
    assert got.shape == want.shape == (n, dicts.n_answers)
    return got, want, batch["answer"]


def test_epoch119_matches_rnet_on_val_questions(val600):
    got, want, labels = _both_packages(val600, FIRST, "xla")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert (got.argmax(-1) == labels).all()


def test_epoch119_int8_matches_rnets_int8(val600, monkeypatch):
    orig = rpw.pairwise_core_int8
    monkeypatch.setattr(rpw, "pairwise_core_int8",
                        lambda *a, inject, interpret=False: orig(*a, inject=inject, interpret=True))
    got, want, labels = _both_packages(val600, 8, "pallas_int8")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert (got.argmax(-1) == labels).all()


def test_committed_int8_batches_hold_rnets_int8():
    with open(chip_smoke.CAMPAIGN_INT8) as f:
        rec = json.load(f)
    assert rec["batch_size"] == chip_smoke.TRAIN_B == 512
    assert sorted(rec["batches"]) == ["0", "45"]
    digits = rec["answer_digits"]
    arms = ("rnet_bf16", "rnet_int8", "port_int8", "rnet_int8_f32", "port_int8_f32")
    for k, row in rec["batches"].items():
        assert (row["questions"], row["first_question"]) == (512, int(k) * 512)
        pred = {arm: np.array([digits.index(c) for c in row[arm]["predictions"]]) for arm in arms}
        assert all(len(p) == 512 for p in pred.values())
        # rnet's bf16 answers every question right: each arm's right answers are its agreements with it
        assert row["rnet_bf16"]["right"] == 512
        for arm in arms[1:]:
            assert row[arm]["right"] == int((pred[arm] == pred["rnet_bf16"]).sum())
        assert row["rnet_int8_equal_to_rnet_bf16"] == row["rnet_int8"]["right"]
        # fp32 compute: the port's int8 is rnet's question for question
        assert (pred["port_int8_f32"] == pred["rnet_int8_f32"]).all()
        assert row["port_int8_f32"]["mean_nll"] == pytest.approx(row["rnet_int8_f32"]["mean_nll"], rel=1e-6)
        # bf16 compute: the stems differ, the bound phase 17 holds the card to still holds the port's CPU chain
        assert row["port_int8_equal_to_rnet_int8"] == int((pred["port_int8"] == pred["rnet_int8"]).sum())
        assert row["port_int8_equal_to_rnet_int8"] >= chip_smoke.CAMPAIGN_INT8_RNET_AGREE * 512
        assert abs(row["port_int8"]["right"] - row["rnet_int8"]["right"]) <= chip_smoke.CAMPAIGN_INT8_RNET_RIGHT
    # rnet's own int8 loses on batch 45 what the card's does (0.997048 overall on the H100)
    assert rec["batches"]["45"]["rnet_int8"]["right"] < 500 and rec["batches"]["0"]["rnet_int8"]["right"] == 512
