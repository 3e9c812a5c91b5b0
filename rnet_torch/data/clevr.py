"""CLEVR dataset readers and the host-side image transforms.

Port of ``rnet/data/clevr.py``:
  * ``ImageTransform`` — resize to (S, S) and, for training, pad 8 (edge),
    random crop and a random PIL rotation of up to ±2.8 degrees, to uint8
    HWC (the model normalizes on the device);
  * ``ClevrDataset`` — from-pixels: PNG decode per item;
  * ``ClevrDatasetStateDescription`` — objects from the scenes JSON as fixed
    vectors (``scene_to_objects``), pre-vectorized at init;
  * ``ClevrImageDataset`` — the images of a split alone, eval transform
    (the extraction CLI);
  * ``_QuestionCategoriesMixin`` — per-question family ids for the eval
    reports.
PIL is imported inside the functions that decode, so the package imports
without Pillow. Draws of the train transform come from the ``random.Random``
the caller passes (``BatchIterator``'s per-item rng), as in rnet.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from .categories import category_ids
from .vocab import CLEVR_COLORS, CLEVR_MATERIALS, CLEVR_SHAPES, CLEVR_SIZES, Dictionaries


class _QuestionCategoriesMixin:
    """Lazy per-question category ids (reference test.py family reporting)."""

    def question_categories(self) -> np.ndarray:
        cached = getattr(self, "_qcat", None)
        if cached is None:
            cached = self._qcat = category_ids(self.questions)
        return cached


class ImageTransform:
    """Resize(S) [+ Pad(8) + RandomCrop(S) + RandomRotation(±max_rot_deg)] -> uint8 HWC."""

    def __init__(self, image_size: int, train: bool = False, pad: int = 8, max_rot_deg: float = 2.8):
        self.size = image_size
        self.train = train
        self.pad = pad
        self.max_rot = max_rot_deg

    def __call__(self, img, rng: Optional[random.Random] = None) -> np.ndarray:
        from PIL import Image

        img = img.convert("RGB").resize((self.size, self.size), Image.BILINEAR)
        if not self.train:
            return np.asarray(img, dtype=np.uint8)
        rng = rng or random
        p = self.pad
        arr = np.pad(np.asarray(img, dtype=np.uint8), ((p, p), (p, p), (0, 0)), mode="edge")
        x0 = rng.randint(0, 2 * p)
        y0 = rng.randint(0, 2 * p)
        arr = arr[y0 : y0 + self.size, x0 : x0 + self.size]
        if self.max_rot > 0:  # rotation last, as in the reference chain
            angle = rng.uniform(-self.max_rot, self.max_rot)
            arr = np.asarray(Image.fromarray(arr).rotate(angle, resample=Image.BILINEAR), dtype=np.uint8)
        return arr


class ClevrDataset(_QuestionCategoriesMixin):
    """From-pixels CLEVR: (image uint8 HWC, question ids, answer idx)."""

    def __init__(
        self,
        clevr_dir: str,
        split: str,
        dictionaries: Dictionaries,
        image_size: int = 128,
        question_max_len: int = 48,
        train_transform: Optional[bool] = None,
        max_rot_deg: float = 2.8,
    ):
        self.dicts = dictionaries
        self.max_len = question_max_len
        with open(os.path.join(clevr_dir, "questions", f"CLEVR_{split}_questions.json")) as f:
            self.questions = json.load(f)["questions"]
        is_train = train_transform if train_transform is not None else (split == "train")
        self.transform = ImageTransform(image_size, train=is_train, max_rot_deg=max_rot_deg)
        self.img_dir = os.path.join(clevr_dir, "images", split)

    def __len__(self) -> int:
        return len(self.questions)

    def __getitem__(self, i: int, rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        from PIL import Image

        q = self.questions[i]
        with Image.open(os.path.join(self.img_dir, q["image_filename"])) as im:
            image = self.transform(im, rng)
        return {
            "image": image,  # (S, S, 3) uint8
            "question": self.dicts.encode_question(q["question"], self.max_len),
            "answer": np.int32(self.dicts.encode_answer(str(q["answer"]).lower())),
        }


class ClevrImageDataset:
    """Images only, in sorted file-name order, with the eval transform and
    each item's ``index`` (the extraction CLI)."""

    def __init__(self, clevr_dir: str, split: str, image_size: int = 128):
        self.img_dir = os.path.join(clevr_dir, "images", split)
        self.files = sorted(f for f in os.listdir(self.img_dir) if f.endswith(".png"))
        self.transform = ImageTransform(image_size, train=False)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int, rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        from PIL import Image

        with Image.open(os.path.join(self.img_dir, self.files[i])) as im:
            return {"image": self.transform(im), "index": np.int32(i)}


def scene_to_objects(objects: List[Dict], max_objects: int, object_dim: int = 18) -> np.ndarray:
    """Scene JSON objects -> (max_objects, 18) float32, zero-padded.

    Layout: [x,y,z]/3 ++ onehot color(8) ++ onehot shape(3) ++ onehot
    material(2) ++ onehot size(2).
    """
    out = np.zeros((max_objects, object_dim), dtype=np.float32)
    for k, o in enumerate(objects[:max_objects]):
        v = [c / 3.0 for c in o["3d_coords"]]
        v += [1.0 if o["color"] == c else 0.0 for c in CLEVR_COLORS]
        v += [1.0 if o["shape"] == s else 0.0 for s in CLEVR_SHAPES]
        v += [1.0 if o["material"] == m else 0.0 for m in CLEVR_MATERIALS]
        v += [1.0 if o["size"] == s else 0.0 for s in CLEVR_SIZES]
        out[k] = np.asarray(v, dtype=np.float32)
    return out


class ClevrDatasetStateDescription(_QuestionCategoriesMixin):
    """State-description CLEVR: (objects (N, 18), n_objects, question, answer).

    Pad objects are zero vectors that take part in pairs, as in the
    reference; n_objects is carried for the optional model-side mask.
    """

    def __init__(
        self,
        clevr_dir: str,
        split: str,
        dictionaries: Dictionaries,
        max_objects: int = 12,
        object_dim: int = 18,
        question_max_len: int = 48,
    ):
        self.dicts = dictionaries
        self.max_len = question_max_len
        self.max_objects = max_objects
        self.object_dim = object_dim
        with open(os.path.join(clevr_dir, "questions", f"CLEVR_{split}_questions.json")) as f:
            self.questions = json.load(f)["questions"]
        with open(os.path.join(clevr_dir, "scenes", f"CLEVR_{split}_scenes.json")) as f:
            scenes = json.load(f)["scenes"]
        obj_by_image = {s["image_index"]: scene_to_objects(s["objects"], max_objects, object_dim) for s in scenes}
        n_by_image = {s["image_index"]: min(len(s["objects"]), max_objects) for s in scenes}
        self._objects = np.stack([obj_by_image[q["image_index"]] for q in self.questions])
        self._n_objects = np.asarray([n_by_image[q["image_index"]] for q in self.questions], dtype=np.int32)
        self._tokens = np.stack([dictionaries.encode_question(q["question"], question_max_len) for q in self.questions])
        self._answers = np.asarray(
            [dictionaries.encode_answer(str(q["answer"]).lower()) for q in self.questions], dtype=np.int32
        )

    def __len__(self) -> int:
        return len(self.questions)

    def get_batch(self, idxs, rng=None) -> Dict[str, np.ndarray]:
        idxs = np.asarray(idxs, dtype=np.int32)
        return {
            "objects": self._objects[idxs],
            "n_objects": self._n_objects[idxs],
            "question": self._tokens[idxs],
            "answer": self._answers[idxs],
        }

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """Per-question arrays for the device-resident pipeline."""
        return {
            "objects": self._objects,
            "n_objects": self._n_objects,
            "question": self._tokens,
            "answer": self._answers,
        }

    def __getitem__(self, i: int, rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        return {
            "objects": self._objects[i],
            "n_objects": np.int32(self._n_objects[i]),
            "question": self._tokens[i],
            "answer": np.int32(self._answers[i]),
        }
