"""The benchmark's inputs, all drawn from ``--seed``: the harness's own
generators, frozen here so that a change to the port cannot move them.

* ``stream_seed``: one 63-bit seed per named stream of a run;
* ``dictionary``: the harness's 89 question words (ids 1-89, 0 pads: the
  90-word vocabulary ``bench.py`` uses) and CLEVR's 28 answers;
* ``image_cache``, ``questions``, ``answers``, ``image_index``,
  ``families``: a CLEVR split on the device, as the port's device pipeline
  holds it (padded uint8 canvases; questions with the pads first, as
  ``--invert-questions`` lays them out);
* ``png_pool``, ``question_strings``, ``arrival_times``: what a serving
  client sends.

A seed changes the values and the order, never the sizes: every seed gives
the same amount of work.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_WORDS = (
    "the a an is are there what how many of other things objects object thing that same size color shape "
    "material as to left right front behind in on and or either both any number greater less than more fewer "
    "equal does do have has it its made big small large tiny metal metallic rubber matte shiny cube cubes block "
    "blocks sphere spheres ball balls cylinder cylinders gray red blue green brown purple cyan yellow visible "
    "anything else side another which kind cubical round shaped colored cylindrical spherical closest"
).split()
WORDS = tuple(dict.fromkeys(w for w in _WORDS if w.isidentifier()))
ANSWERS = (
    *(str(i) for i in range(11)), "no", "yes",
    "blue", "brown", "cyan", "gray", "green", "purple", "red", "yellow",
    "cube", "cylinder", "sphere", "metal", "rubber", "large", "small",
)


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the named stream of run ``seed`` (any integer)."""
    words = [ord(ch) for ch in stream]
    state = np.random.SeedSequence([int(seed) % 2**64, *words]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def device_generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def host_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def dictionary() -> Tuple[Dict[str, int], Dict[str, int]]:
    """(word -> id from 1, answer -> id from 0)."""
    if len(WORDS) != 89 or len(ANSWERS) != 28:
        raise AssertionError(f"the harness's dictionary has {len(WORDS)} words and {len(ANSWERS)} answers")
    return {w: i + 1 for i, w in enumerate(WORDS)}, {a: i for i, a in enumerate(ANSWERS)}


def image_cache(n: int, canvas: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, canvas, canvas, 3) uint8 canvases, uniform bytes, in one call."""
    return torch.randint(0, 256, (n, canvas, canvas, 3), generator=gen, device=device, dtype=torch.uint8)


def question_lengths(n: int, spec: Dict, gen: torch.Generator, device) -> torch.Tensor:
    """(n,) int64 word counts: a normal of ``spec``'s mean and sd, rounded and
    clipped to [min, max]."""
    z = torch.randn(n, generator=gen, device=device)
    return (z * spec["sd"] + spec["mean"]).round().clamp(spec["min"], spec["max"]).long()


def questions(n: int, max_len: int, vocab: int, spec: Dict, gen: torch.Generator, device) -> torch.Tensor:
    """(n, max_len) int32 token ids in [1, vocab), each row's pads (0) first
    and its words last, in two draws."""
    lengths = question_lengths(n, spec, gen, device)
    tokens = torch.randint(1, vocab, (n, max_len), generator=gen, device=device, dtype=torch.int32)
    pos = torch.arange(max_len, device=device)
    return torch.where(pos[None, :] >= max_len - lengths[:, None], tokens, 0).to(torch.int32)


def answers(n: int, n_answers: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, n_answers, (n,), generator=gen, device=device, dtype=torch.int32)


def image_index(n: int, n_images: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, n_images, (n,), generator=gen, device=device, dtype=torch.int32)


def families(n: int, n_families: int, rng: np.random.Generator) -> np.ndarray:
    """(n,) int32 question-family ids (the eval report's per-family table)."""
    return rng.integers(0, n_families, n, dtype=np.int32)


def split_on_device(split: Dict, w: Dict, vocab: int, spec: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """One split of a configuration's ``data``: ``cache`` (images, canvas,
    canvas, 3) uint8 and the per-question ``question``, ``answer`` and
    ``image_idx`` the port's device pipeline keeps."""
    gen = device_generator(seed, "split", device)
    canvas = w["image_size"] + 2 * split["canvas_pad"]
    nq = split["questions"]
    return {
        "cache": image_cache(split["images"], canvas, gen, device),
        "question": questions(nq, w["question_max_len"], vocab, spec, gen, device),
        "answer": answers(nq, w["n_answers"], gen, device),
        "image_idx": image_index(nq, split["images"], gen, device),
    }


def question_strings(n: int, spec: Dict, rng: np.random.Generator) -> List[str]:
    """``n`` questions of the harness's words, lengths as ``question_lengths``."""
    lengths = np.clip(np.round(rng.normal(spec["mean"], spec["sd"], n)), spec["min"], spec["max"]).astype(int)
    return [" ".join(WORDS[i] for i in rng.integers(0, len(WORDS), k)) + "?" for k in lengths]


_RGB = np.array(  # CLEVR's eight colours, as rnet_torch.data.synth draws them
    [(87, 87, 87), (173, 35, 35), (42, 75, 215), (29, 105, 20), (129, 74, 25), (129, 38, 192), (41, 208, 208),
     (255, 238, 51)], np.float32)


def scene_image(width: int, height: int, noise_sd: float, rng: np.random.Generator) -> np.ndarray:
    """(height, width, 4) uint8 RGBA of a rendered-looking scene: a lit floor,
    3-10 shaded objects, and the renderer's noise (``noise_sd``), so that it
    compresses as a rendered image does rather than as a flat drawing."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.repeat((110.0 + 50.0 * y / height - 12.0 * ((x / width - 0.5) ** 2))[..., None], 3, axis=2)
    for _ in range(int(rng.integers(3, 11))):
        cx, cy = rng.uniform(0.1, 0.9) * width, rng.uniform(0.3, 0.9) * height
        r = rng.uniform(14.0, 42.0)
        sphere = rng.random() < 0.5
        colour = _RGB[rng.integers(0, len(_RGB))]
        box = (slice(max(0, int(cy - r)), min(height, int(cy + r) + 1)), slice(max(0, int(cx - r)), min(width, int(cx + r) + 1)))
        bx, by = x[box] - cx, y[box] - cy
        inside = (bx**2 + by**2 <= r * r) if sphere else (np.abs(bx) <= r) & (np.abs(by) <= r)
        light = 1.15 - 0.5 * np.sqrt((bx + 0.4 * r) ** 2 + (by + 0.4 * r) ** 2) / (1.6 * r)
        img[box] = np.where(inside[..., None], colour * light[..., None], img[box])
    img = img + rng.normal(0.0, noise_sd, img.shape)
    rgba = np.empty((height, width, 4), np.uint8)
    rgba[..., :3] = np.clip(np.round(img), 0, 255)
    rgba[..., 3] = 255
    return rgba


def png_pool(directory: str, n: int, spec: Dict, rng: np.random.Generator, threads: int = 4) -> List[str]:
    """Write ``n`` distinct scene PNGs of ``spec`` (width, height, noise_sd,
    compress_level) into ``directory``, each from its own stream of ``rng``,
    in ``threads`` threads; their paths."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    seeds = rng.integers(0, 2**63, n)

    def write(k: int) -> str:
        path = os.path.join(directory, f"scene_{k:03d}.png")
        img = scene_image(spec["width"], spec["height"], spec["noise_sd"], np.random.default_rng(int(seeds[k])))
        Image.fromarray(img, "RGBA").save(path, compress_level=spec["compress_level"])
        return path

    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(write, range(n)))


def arrival_times(rate: float, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Open-loop arrivals (seconds from the window's start) at ``rate``/s:
    round(rate * seconds) exponential gaps taken at fixed quantiles, so that
    every seed sends the same set of gaps, in its own order; the last
    request is due just before ``seconds``."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q) / rate)
    t = np.cumsum(gaps)
    return t * (seconds * (1.0 - 0.5 / n) / t[-1])


def sample_rows(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """``k`` distinct sorted indices of ``range(n)`` (all when k >= n)."""
    return np.arange(n) if k >= n else np.sort(rng.choice(n, size=k, replace=False))


def chunks(n: int, size: int) -> Sequence[slice]:
    return [slice(a, min(a + size, n)) for a in range(0, n, size)]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by linear interpolation between closest ranks."""
    v = np.sort(np.asarray(values, np.float64))
    if not len(v):
        return math.nan
    return float(np.percentile(v, q))
