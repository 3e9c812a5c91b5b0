"""The committed val split of the v2 seed-1 fixture
(``tests/torch_fixtures/clevr_v2_seed1_val/``, written by
``tests/torch_fixture_val_writer.py``) and rnet's trained wide-fp weights
on it, on the CPU.

* ``chip_smoke.expand_val_fixture`` writes the questions and the decoded
  cache back into a CLEVR directory with the recorded digests: 7,484
  questions over 600 images, a (600, 144, 144, 3) uint8 cache, and a
  corrupted file is refused.
* The port's ``RN`` loaded from ``results/int8_eval_r4/
  wide-fp_epoch091_weights_dicts.pkl`` (fp32, ``xla``) and rnet's ``RN`` on
  the same weights give log-probs within 1e-4 on the first 16 val
  questions, fed from the port's cache as ``rnet_torch.evaluate
  --data-pipeline device`` feeds them (centre crop, inverted questions,
  the carried dictionaries). Wide-fp costs ~8.6 GFLOP a question, so 16.
  Chip_smoke phase 15 scores the whole split on the card.
"""

import json
import lzma
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rnet.config import load_config as jax_load_config
from rnet.models import RN as JaxRN
from rnet_torch.checkpoint import load_exported_dicts, load_weights
from rnet_torch.config import load_config
from rnet_torch.data.cache import CachedClevrDataset
from rnet_torch.data.vocab import Dictionaries, invert_questions
from rnet_torch.models import RN

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKL = os.path.join(REPO, "results", "int8_eval_r4", "wide-fp_epoch091_weights_dicts.pkl")
N_QUESTIONS, N_IMAGES, CANVAS = 7484, 600, 144
FIRST = 16


@pytest.fixture(scope="module")
def clevr_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clevr_val"))
    chip_smoke.expand_val_fixture(root)
    return root


def test_expanded_fixture_matches_its_digests(clevr_dir):
    with open(os.path.join(chip_smoke.VAL_FIXTURE, "digests.json")) as f:
        digests = json.load(f)
    for name, sub in chip_smoke.VAL_FIXTURE_FILES.items():
        assert os.path.getsize(os.path.join(clevr_dir, sub, name)) == digests["files"][name]["bytes"]
    with open(os.path.join(clevr_dir, "questions", "CLEVR_val_questions.json")) as f:
        questions = json.load(f)["questions"]
    assert len(questions) == N_QUESTIONS == digests["questions"]
    cache = np.load(os.path.join(clevr_dir, "rnet_cache", "val_128p8.u8"), mmap_mode="r")
    assert cache.shape == (N_IMAGES, CANVAS, CANVAS, 3) and cache.dtype == np.uint8
    with open(os.path.join(clevr_dir, "rnet_cache", "val_128p8.json")) as f:
        meta = json.load(f)
    assert meta["n"] == N_IMAGES and (meta["image_size"], meta["pad"]) == (128, 8)
    assert {q["image_filename"] for q in questions} <= set(meta["files"])


def test_a_corrupted_fixture_is_refused(tmp_path, monkeypatch):
    bad = tmp_path / "fixture"
    shutil.copytree(chip_smoke.VAL_FIXTURE, bad)
    with lzma.open(bad / "CLEVR_val_questions.json.xz") as f:
        data = bytearray(f.read())
    data[100] ^= 1
    with lzma.open(bad / "CLEVR_val_questions.json.xz", "wb") as f:
        f.write(bytes(data))
    monkeypatch.setattr(chip_smoke, "VAL_FIXTURE", str(bad))
    with pytest.raises(ValueError, match="sha256"):
        chip_smoke.expand_val_fixture(str(tmp_path / "clevr"))


def test_trained_wide_fp_matches_rnet_on_val_questions(clevr_dir):
    w2i, a2i = load_exported_dicts(PKL)
    dicts = Dictionaries(w2i, a2i)
    ds = CachedClevrDataset(clevr_dir, "val", dicts, image_size=128, question_max_len=48, train_transform=False)
    batch = ds.get_batch(np.arange(FIRST))
    images, tokens = batch["image"], invert_questions(batch["question"])
    over = {"compute_dtype": "float32", "rl_impl": "xla"}
    cfg = load_config("wide-fp", overrides=over).replace(n_answers=dicts.n_answers)
    port = RN(cfg, dicts.vocab_size)
    load_weights(port, PKL)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(images), torch.from_numpy(tokens)).numpy()

    with open(PKL, "rb") as f:
        flat = pickle.load(f)
    jcfg = jax_load_config("wide-fp", overrides=over).replace(n_answers=dicts.n_answers)
    variables = {"params": flat["params"], "batch_stats": flat["batch_stats"]}
    want = np.asarray(JaxRN(cfg=jcfg, vocab_size=dicts.vocab_size).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images), jnp.asarray(tokens), train=False))
    assert got.shape == want.shape == (FIRST, dicts.n_answers)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    # trained weights and the carried dictionaries: most answers right (14 of
    # 16 here), where permuted answer ids would give chance (1/28)
    assert (got.argmax(-1) == batch["answer"]).sum() > FIRST // 2


class _Captured(Exception):
    pass


def test_trained_wide_fp_int8_scales_undershoot_a_serving_batch(clevr_dir, monkeypatch):
    """The open fault of ROADMAP §3 (found by chip_smoke phase 15): served in
    int8 at bucket 8 (questions 1-8 of the val split, one served batch),
    rnet's trained wide-fp gives answers that differ from ``evaluate``'s at
    B=512 on 2 of those 8 questions, because the int8 scales come from a
    subsample of each call's batch (<= 4 strided samples x 16 strided
    objects a side: at n=64 grid columns 0 and 4 only) and every row of this
    batch exceeds them. The port's scales are rnet's ``_activation_scales``
    on the same inputs (1e-6), and the batch's own fp32 activations exceed
    the last quantization point's scale at least twofold in every row (3.9-
    7.6x on the card). A repair changes rnet's int8 semantics; when one
    lands, the last assertion turns."""
    from rnet.kernels import pairwise as rpw
    from rnet_torch.kernels import pairwise as tpw

    w2i, a2i = load_exported_dicts(PKL)
    dicts = Dictionaries(w2i, a2i)
    ds = CachedClevrDataset(clevr_dir, "val", dicts, image_size=128, question_max_len=48, train_transform=False)
    batch = ds.get_batch(np.arange(1, 9))
    cfg = load_config("wide-fp", overrides={"rl_impl": "pallas_int8"}).replace(n_answers=dicts.n_answers)
    port = RN(cfg, dicts.vocab_size)
    load_weights(port, PKL)
    seen = []

    def capture(u, v, s, qa, ws, bs, *, inject):
        seen.append((u, v, s, qa, ws, bs, inject))
        raise _Captured

    monkeypatch.setattr(tpw, "pairwise_core_int8", capture)
    with torch.no_grad(), pytest.raises(_Captured):
        port.eval()(torch.from_numpy(batch["image"]), torch.from_numpy(invert_questions(batch["question"])))
    u, v, s, qa, ws, bs, inject = seen[0]
    assert u.dtype == torch.bfloat16 and tuple(u.shape) == (8, 64, 512)
    got = tpw.activation_scales(u, v, s, qa, ws, bs, inject).numpy()
    want = np.asarray(rpw._activation_scales(*(jnp.asarray(t.float().numpy()) for t in (u, v, s, qa, ws, bs)),
                                             inject))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    acts = tpw._subsample_acts(u.float(), v.float(), s.float(), qa.float(), ws, bs, inject)
    ratios = torch.stack([torch.stack([a[r].amax() for a in acts]) for r in range(8)]) / torch.from_numpy(got)
    assert (ratios[:, -1] > 2.0).all(), ratios
