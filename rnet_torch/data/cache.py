"""Decoded-image cache: decode the CLEVR PNGs of a split once, serve batches
as array slices.

Port of ``rnet/data/cache.py``. ``build_image_cache`` decodes and resizes
every image of a split (bilinear, as the eval transform does), pads it by
``pad`` edge-replicated pixels and writes one (N, S + 2p, S + 2p, 3) uint8
``.npy`` memmap and its ``.json`` meta under ``<clevr>/rnet_cache/``, with
rnet's file names (``<split>_<S>p<pad>.u8``), so a cache built by either
package is read by the other. ``CachedClevrDataset`` serves from it:
per item (host crop), as vectorized batches (``get_batch``; padded canvases
with ``serve_padded``, for the on-device crop), or as image indices only
(``serve_indices``: the device pipeline, whose Trainer keeps the whole split
on the card). PIL is imported only inside ``build_image_cache``.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from .clevr import _QuestionCategoriesMixin
from .vocab import Dictionaries


def _cache_paths(clevr_dir: str, split: str, size: int, pad: int):
    d = os.path.join(clevr_dir, "rnet_cache")
    base = f"{split}_{size}p{pad}"
    return os.path.join(d, base + ".u8"), os.path.join(d, base + ".json")


def build_image_cache(
    clevr_dir: str, split: str, image_size: int = 128, pad: int = 8, threads: int = 16
) -> str:
    """Decode every PNG of a split into a packed (N, S+2p, S+2p, 3) memmap."""
    from PIL import Image

    arr_path, meta_path = _cache_paths(clevr_dir, split, image_size, pad)
    if os.path.exists(arr_path) and os.path.exists(meta_path):
        return arr_path
    img_dir = os.path.join(clevr_dir, "images", split)
    files = sorted(f for f in os.listdir(img_dir) if f.endswith(".png"))
    S = image_size + 2 * pad
    os.makedirs(os.path.dirname(arr_path), exist_ok=True)
    mm = np.lib.format.open_memmap(arr_path + ".tmp", mode="w+", dtype=np.uint8, shape=(len(files), S, S, 3))

    def decode(i):
        with Image.open(os.path.join(img_dir, files[i])) as im:
            a = np.asarray(im.convert("RGB").resize((image_size, image_size), Image.BILINEAR), dtype=np.uint8)
        mm[i] = np.pad(a, ((pad, pad), (pad, pad), (0, 0)), mode="edge")

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(decode, range(len(files))))
    mm.flush()
    del mm
    os.replace(arr_path + ".tmp", arr_path)
    with open(meta_path, "w") as f:
        json.dump({"files": files, "image_size": image_size, "pad": pad, "n": len(files)}, f)
    return arr_path


class CachedClevrDataset(_QuestionCategoriesMixin):
    """From-pixels CLEVR served from the decoded cache.

    * per item (``__getitem__``): the padded canvas cropped on the host
      (train jitter from the rng, else the centre: a plain resize);
    * vectorized (``get_batch``, which ``BatchIterator`` prefers): tokens and
      answers are packed at init and a batch is two gathers; with
      ``serve_padded`` the canvases ship padded and the crop runs on the
      device, with the rotation;
    * ``serve_indices``: batches carry ``image_idx`` instead of pixels, and
      ``device_arrays`` hands the per-question arrays to the Trainer.
    """

    def __init__(
        self,
        clevr_dir: str,
        split: str,
        dictionaries: Dictionaries,
        image_size: int = 128,
        question_max_len: int = 48,
        train_transform: Optional[bool] = None,
        pad: int = 8,
        serve_padded: bool = False,
        serve_indices: bool = False,
    ):
        self.dicts = dictionaries
        self.max_len = question_max_len
        self.size = image_size
        self.pad = pad
        self.train = train_transform if train_transform is not None else (split == "train")
        self.serve_padded = serve_padded
        self.serve_indices = serve_indices
        arr_path, meta_path = _cache_paths(clevr_dir, split, image_size, pad)
        if not os.path.exists(arr_path):
            build_image_cache(clevr_dir, split, image_size, pad)
        self.images = np.load(arr_path, mmap_mode="r")
        with open(meta_path) as f:
            meta = json.load(f)
        self.file_to_idx = {f: i for i, f in enumerate(meta["files"])}
        with open(os.path.join(clevr_dir, "questions", f"CLEVR_{split}_questions.json")) as f:
            self.questions = json.load(f)["questions"]
        self._tokens = np.stack([self.dicts.encode_question(q["question"], self.max_len) for q in self.questions])
        self._answers = np.asarray(
            [self.dicts.encode_answer(str(q["answer"]).lower()) for q in self.questions], dtype=np.int32
        )
        self._img_idx = np.asarray([self.file_to_idx[q["image_filename"]] for q in self.questions], dtype=np.int32)

    def __len__(self) -> int:
        return len(self.questions)

    def device_arrays(self):
        """Per-question arrays for the device-resident pipeline (+ .images)."""
        if not self.serve_indices:
            return None
        return {"question": self._tokens, "answer": self._answers, "image_idx": self._img_idx}

    def get_batch(self, idxs, rng=None):
        """Vectorized batch assembly: two gathers and, unless the canvases
        ship padded, host crops (random with ``rng`` in training)."""
        idxs = np.asarray(idxs, dtype=np.int32)
        if self.serve_indices:
            return {
                "image_idx": self._img_idx[idxs],
                "question": self._tokens[idxs],
                "answer": self._answers[idxs],
            }
        imgs = self.images[self._img_idx[idxs]]  # (B, S+2p, S+2p, 3), one gather
        p, S = self.pad, self.size
        if not self.serve_padded:
            out = np.empty((len(idxs), S, S, 3), np.uint8)
            for k in range(len(idxs)):
                if self.train and rng is not None:
                    x0, y0 = rng.randint(0, 2 * p), rng.randint(0, 2 * p)
                else:
                    x0 = y0 = p
                out[k] = imgs[k, y0 : y0 + S, x0 : x0 + S]
            imgs = out
        return {
            "image": np.ascontiguousarray(imgs),
            "question": self._tokens[idxs],
            "answer": self._answers[idxs],
        }

    def __getitem__(self, i: int, rng=None):
        b = self.get_batch([i], rng)
        return {k: v[0] for k, v in b.items()}
