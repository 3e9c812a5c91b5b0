"""rnet_torch's data layer vs rnet's on the synthetic CLEVR fixture.

The decoded image cache (read across packages, and built byte-identically),
``get_batch`` in every serving mode, ``BatchIterator`` batch for batch
(shuffle, per-batch and per-item rngs, eval padding with ``valid`` and
``index``), the PIL train transform, the question categories, the
``EvalAccumulator`` reports and the state-description reader.
"""

import os
import random

import numpy as np
import pytest
import torch

from rnet.data.cache import CachedClevrDataset as JaxCached
from rnet.data.cache import build_image_cache as jax_build_cache
from rnet.data.categories import QUESTION_CATEGORIES as JAX_CATEGORIES
from rnet.data.categories import category_ids as jax_category_ids
from rnet.data.clevr import ClevrDataset as JaxClevr
from rnet.data.clevr import ClevrDatasetStateDescription as JaxSD
from rnet.data.pipeline import BatchIterator as JaxIterator
from rnet.eval.metrics import EvalAccumulator as JaxAccumulator
from rnet_torch.data.cache import CachedClevrDataset, _cache_paths, build_image_cache
from rnet_torch.data.categories import QUESTION_CATEGORIES, category_ids
from rnet_torch.data.clevr import ClevrDataset, ClevrDatasetStateDescription
from rnet_torch.data.pipeline import BatchIterator, prefetch_to_device
from rnet_torch.data.vocab import build_dictionaries
from rnet_torch.eval.metrics import EvalAccumulator

SIZE = 32  # cache canvases of 48 = 32 + 2 * 8


@pytest.fixture(scope="module")
def port_dicts(fixture_dir):
    return build_dictionaries(fixture_dir)


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cache_is_shared_and_built_byte_identically(fixture_dir, dicts, port_dicts, tmp_path):
    """The port reads the cache rnet built, and a cache the port builds in a
    fresh directory has the same bytes and meta."""
    jpath = jax_build_cache(fixture_dir, "val", image_size=SIZE, pad=8)
    ds = CachedClevrDataset(fixture_dir, "val", port_dicts, image_size=SIZE, train_transform=False)
    np.testing.assert_array_equal(np.asarray(ds.images), np.load(jpath))
    fresh = tmp_path / "clevr"
    fresh.mkdir()
    for sub in ("images", "questions"):
        os.symlink(os.path.join(fixture_dir, sub), fresh / sub)
    path = build_image_cache(str(fresh), "val", image_size=SIZE, pad=8)
    assert path == _cache_paths(str(fresh), "val", SIZE, 8)[0]
    assert os.path.basename(path) == os.path.basename(jpath)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    with open(_cache_paths(str(fresh), "val", SIZE, 8)[1]) as f, open(jpath[:-3] + ".json") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("mode", ["indices", "padded", "train_crop", "eval"])
def test_get_batch_matches_rnet(fixture_dir, dicts, port_dicts, mode):
    kw = {
        "indices": dict(serve_indices=True, serve_padded=True, train_transform=True),
        "padded": dict(serve_padded=True, train_transform=True),
        "train_crop": dict(train_transform=True),
        "eval": dict(train_transform=False),
    }[mode]
    jds = JaxCached(fixture_dir, "train", dicts, image_size=SIZE, **kw)
    tds = CachedClevrDataset(fixture_dir, "train", port_dicts, image_size=SIZE, **kw)
    idxs = [5, 0, 5, len(tds) - 1, 17]
    _assert_batches_equal(jds.get_batch(idxs, random.Random(3)), tds.get_batch(idxs, random.Random(3)))
    _assert_batches_equal(jds.__getitem__(2, random.Random(4)), tds.__getitem__(2, random.Random(4)))
    if mode == "indices":
        _assert_batches_equal(jds.device_arrays(), tds.device_arrays())
    else:
        assert tds.device_arrays() is None


@pytest.mark.parametrize("shuffle, drop_last, bs", [(True, True, 8), (False, False, 24), (True, False, 16)])
def test_batch_iterator_matches_rnet_vectorized(fixture_dir, dicts, port_dicts, shuffle, drop_last, bs):
    jds = JaxCached(fixture_dir, "train", dicts, image_size=SIZE, train_transform=True)
    tds = CachedClevrDataset(fixture_dir, "train", port_dicts, image_size=SIZE, train_transform=True)
    kw = dict(shuffle=shuffle, seed=7, epoch=3, drop_last=drop_last, invert=True, num_threads=2)
    jb, tb = list(JaxIterator(jds, bs, **kw)), list(BatchIterator(tds, bs, **kw))
    assert len(jb) == len(tb) == len(BatchIterator(tds, bs, **kw)) > 0
    for a, b in zip(jb, tb):
        _assert_batches_equal(a, b)
    if not drop_last:  # the padded final batch: valid mask and dataset indices
        assert not tb[-1]["valid"].all() or len(tds) % bs == 0
        assert "index" in tb[-1]


def test_batch_iterator_matches_rnet_per_item_with_pil_transform(fixture_dir, dicts, port_dicts):
    """Per-item datasets: PNG decode, pad, crop and PIL rotation from the
    per-item rng — the same pixels in both packages."""
    jds = JaxClevr(fixture_dir, "train", dicts, image_size=SIZE, train_transform=True)
    tds = ClevrDataset(fixture_dir, "train", port_dicts, image_size=SIZE, train_transform=True)
    kw = dict(shuffle=True, seed=1, epoch=2, drop_last=True, num_threads=2)
    for a, b in zip(list(JaxIterator(jds, 8, **kw))[:2], list(BatchIterator(tds, 8, **kw))[:2]):
        _assert_batches_equal(a, b)
    ev = ClevrDataset(fixture_dir, "val", port_dicts, image_size=SIZE)
    jev = JaxClevr(fixture_dir, "val", dicts, image_size=SIZE)
    _assert_batches_equal(jev[3], ev[3])


def test_prefetch_to_cpu_keeps_every_batch(fixture_dir, port_dicts):
    tds = ClevrDatasetStateDescription(fixture_dir, "val", port_dicts)
    batches = list(BatchIterator(tds, 8, drop_last=False))
    got = list(prefetch_to_device(iter(batches), "cpu"))
    assert len(got) == len(batches)
    for a, b in zip(batches, got):
        for k in a:
            assert isinstance(b[k], torch.Tensor)
            np.testing.assert_array_equal(a[k], b[k].numpy())


def test_state_description_reader_matches_rnet(fixture_dir, dicts, port_dicts):
    for split in ("train", "val"):
        jds = JaxSD(fixture_dir, split, dicts, max_objects=10)
        tds = ClevrDatasetStateDescription(fixture_dir, split, port_dicts, max_objects=10)
        assert len(jds) == len(tds)
        _assert_batches_equal(jds.device_arrays(), tds.device_arrays())
        _assert_batches_equal(jds.get_batch([3, 1, 3]), tds.get_batch([3, 1, 3]))
        _assert_batches_equal(jds[2], tds[2])
        np.testing.assert_array_equal(jds.question_categories(), tds.question_categories())


def test_categories_match_rnet(fixture_dir, port_dicts):
    assert QUESTION_CATEGORIES == JAX_CATEGORIES
    tds = ClevrDatasetStateDescription(fixture_dir, "train", port_dicts)
    qs = list(tds.questions) + [
        {"question": "Are there more cubes than spheres?"},
        {"question": "Is the cube the same color as the sphere?"},
        {"question": "What number of things are the same size as the cube?"},
        {"question": "Does the scene contain a cube?"},
        {"question": "Which thing is made of metal?"},
        {"question": "Say something."},
        {"question": "x", "program": [{"type": "equal_integer"}]},
    ]
    got = category_ids(qs)
    np.testing.assert_array_equal(got, jax_category_ids(qs))
    assert len(set(got.tolist())) == len(QUESTION_CATEGORIES)  # every family, "other" included


def test_eval_accumulator_reports_match_rnet(fixture_dir, dicts, port_dicts, tmp_path):
    tds = ClevrDatasetStateDescription(fixture_dir, "val", port_dicts)
    cats = tds.question_categories()
    rs = np.random.RandomState(0)
    n = len(tds)
    mine, ref = EvalAccumulator(port_dicts, categories=cats), JaxAccumulator(dicts, categories=cats)
    for lo in range(0, n, 8):
        idx = np.arange(lo, lo + 8) % n
        pred = rs.randint(0, port_dicts.n_answers, 8)
        label = np.where(rs.rand(8) < 0.5, pred, tds._answers[idx])
        valid = np.arange(lo, lo + 8) < n
        for acc in (mine, ref):
            acc.update(pred, label, valid, nll_sum=1.5, qidx=idx)
    assert mine.accuracy == ref.accuracy and mine.mean_nll == ref.mean_nll and mine.n == ref.n == n
    assert mine.per_answer_accuracy() == ref.per_answer_accuracy()
    assert mine.per_category_accuracy() == ref.per_category_accuracy() != {}
    np.testing.assert_equal(mine.per_class_accuracy(), ref.per_class_accuracy())
    mine.dump(str(tmp_path / "port"), tag="val")
    ref.dump(str(tmp_path / "rnet"), tag="val")
    for name in ("val_accuracy.csv", "val_confusion.csv"):
        with open(tmp_path / "port" / name) as f, open(tmp_path / "rnet" / name) as g:
            assert f.read() == g.read(), name
