"""Request-side CLEVR encoders: the eval image transform and scene vectors.

Port of ``rnet/data/clevr.py`` (``ImageTransform`` at eval, lines 48-82, and
``scene_to_objects``, lines 126-142). The train-time jitter and the dataset
readers come with the training slice. PIL is imported inside the function
that decodes, so the package imports without Pillow.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .vocab import CLEVR_COLORS, CLEVR_MATERIALS, CLEVR_SHAPES, CLEVR_SIZES


class ImageTransform:
    """Eval transform: RGB -> bilinear resize to (S, S) -> uint8 HWC.

    Output stays uint8; the model normalizes to [0, 1] on the device.
    """

    def __init__(self, image_size: int):
        self.size = image_size

    def __call__(self, img) -> np.ndarray:
        from PIL import Image

        img = img.convert("RGB").resize((self.size, self.size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


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
