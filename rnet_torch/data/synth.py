"""Synthetic CLEVR-shaped fixture generator: ``python -m rnet_torch.data.synth``.

Port of ``rnet/data/synth.py`` (an own copy: the port imports nothing of
``rnet``). It writes a miniature dataset with the real CLEVR directory
schema (SURVEY.md section 4 item 4):

    <root>/images/{train,val}/CLEVR_{split}_{idx:06d}.png
    <root>/questions/CLEVR_{split}_questions.json
    <root>/scenes/CLEVR_{split}_scenes.json

Scenes are rendered as flat 2-D sprites (color/shape/size/material are all
visually encoded), and questions are template-generated WITH correct answers
computed from the scene, so models can genuinely learn/overfit on fixtures.

The random stream is Python's ``random.Random(seed)``, drawn in rnet's
order, so the same arguments give the same files as rnet's generator: every
JSON byte for byte, every PNG pixel for pixel (and byte for byte under the
same Pillow and zlib). Word and answer ids are first-seen over the train
questions, so a model trained on an rnet fixture keeps its answer head's
ids on the fixture regenerated here.

``generate`` draws a split's scenes and questions (``_draw_split``; the
train split's answer-completion pass included) and then renders each scene
(``_render_scene``); rendering draws nothing from the stream, so a split can
be drawn without writing its PNGs, and its PNGs written in any order or in
several processes (``_render_split``). Pillow is imported only where a scene
is rendered.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Tuple

from .vocab import (
    CLEVR_COLORS,
    CLEVR_MATERIALS,
    CLEVR_SHAPES,
    CLEVR_SIZES,
)

_RGB = {
    "gray": (87, 87, 87),
    "red": (173, 35, 35),
    "blue": (42, 75, 215),
    "green": (29, 105, 20),
    "brown": (129, 74, 25),
    "purple": (129, 38, 192),
    "cyan": (41, 208, 208),
    "yellow": (255, 238, 51),
}


def _draw_object(draw, obj: Dict, W: int, H: int, style: str = "v1") -> None:
    cx = (obj["3d_coords"][0] / 3.0 * 0.4 + 0.5) * W
    cy = (obj["3d_coords"][1] / 3.0 * 0.4 + 0.5) * H
    if style == "v3":  # perspective-projected radius (size-distance confound)
        r = obj["r_frac"] * min(W, H)
        width = max(1, round(0.22 * r))
    elif style == "v2":  # bigger sprites: every attribute visible at 8x8-grid scale
        r = (0.075 if obj["size"] == "small" else 0.13) * min(W, H)
        width = max(2, round(0.030 * min(W, H)))
    else:
        r = (0.055 if obj["size"] == "small" else 0.10) * min(W, H)
        width = 2
    color = _RGB[obj["color"]]
    # "metal" renders with a white specular outline; "rubber" is matte.
    outline = (255, 255, 255) if obj["material"] == "metal" else None
    box = (cx - r, cy - r, cx + r, cy + r)
    if obj["shape"] == "sphere":
        draw.ellipse(box, fill=color, outline=outline, width=width)
    elif obj["shape"] == "cube":
        draw.rectangle(box, fill=color, outline=outline, width=width)
    else:  # cylinder -> vertical capsule-ish rectangle with rounded top
        draw.rounded_rectangle(
            (cx - 0.7 * r, cy - r, cx + 0.7 * r, cy + r),
            radius=int(0.5 * r),
            fill=color,
            outline=outline,
            width=width,
        )


def _random_scene(rng: random.Random, n_min: int = 3, n_max: int = 6) -> List[Dict]:
    n = rng.randint(n_min, n_max)
    objs = []
    taken: List[Tuple[float, float]] = []
    for _ in range(n):
        for _attempt in range(50):
            x, y = rng.uniform(-2.8, 2.8), rng.uniform(-2.8, 2.8)
            if all((x - tx) ** 2 + (y - ty) ** 2 > 1.2 for tx, ty in taken):
                break
        taken.append((x, y))
        objs.append(
            {
                "color": rng.choice(CLEVR_COLORS),
                "shape": rng.choice(CLEVR_SHAPES),
                "material": rng.choice(CLEVR_MATERIALS),
                "size": rng.choice(CLEVR_SIZES),
                "rotation": rng.uniform(0, 360),
                "3d_coords": [x, y, 0.35],
                "pixel_coords": [0, 0, 0],
            }
        )
    return objs


def _make_questions(rng: random.Random, objs: List[Dict]) -> List[Tuple[str, str, str]]:
    """Template (question, answer, final_program_function) computed from the scene.

    Covers all five CLEVR question families (count / exist / compare-numbers /
    query-attribute / compare-attribute) so per-category eval reporting has
    every row populated; the final program function is emitted into the
    questions JSON like real CLEVR (``rnet_torch.data.categories`` classifies
    by it).
    """
    qs: List[Tuple[str, str, str]] = []

    color = rng.choice(CLEVR_COLORS)
    count = sum(o["color"] == color for o in objs)
    qs.append((f"How many {color} things are there?", str(count), "count"))

    shape = rng.choice(CLEVR_SHAPES)
    exist = any(o["shape"] == shape for o in objs)
    qs.append((f"Is there a {shape} in the scene?", "yes" if exist else "no", "exist"))

    # query-attribute on a uniquely-colored object, when one exists
    for o in objs:
        if sum(p["color"] == o["color"] for p in objs) == 1:
            attr = rng.choice(["shape", "material", "size"])
            qs.append((f"What {attr} is the {o['color']} thing?", o[attr], f"query_{attr}"))
            break

    c1, c2 = rng.sample(list(CLEVR_COLORS), 2)
    n1 = sum(o["color"] == c1 for o in objs)
    n2 = sum(o["color"] == c2 for o in objs)
    qs.append(
        (
            f"Are there more {c1} things than {c2} things?",
            "yes" if n1 > n2 else "no",
            "greater_than",
        )
    )

    # query color of a uniquely-shaped object
    for o in objs:
        if sum(p["shape"] == o["shape"] for p in objs) == 1:
            qs.append((f"What color is the {o['shape']}?", o["color"], "query_color"))
            break

    # compare-attribute between two uniquely-colored objects
    uniq = [o for o in objs if sum(p["color"] == o["color"] for p in objs) == 1]
    if len(uniq) >= 2:
        a, b = rng.sample(uniq, 2)
        attr = rng.choice(["shape", "material", "size"])
        qs.append(
            (
                f"Is the {a['color']} thing the same {attr} as the {b['color']} thing?",
                "yes" if a[attr] == b[attr] else "no",
                f"equal_{attr}",
            )
        )
    return qs


def _random_scene_v2(rng: random.Random, n_min: int = 2, n_max: int = 5) -> List[Dict]:
    """Fixture-v2 scenes: fewer, larger, well-separated sprites.

    Spacing is size-aware (no occlusion) and positions stay >=0.18 of the
    canvas from every edge, so the train-time 16 px crop jitter + rotation
    can never clip an object (clipped edge objects were count/exist label
    noise in v1).
    """
    n = rng.randint(n_min, n_max)
    objs: List[Dict] = []
    taken: List[Tuple[float, float, float]] = []  # (x, y, radius in scene units)
    for _ in range(n):
        size = rng.choice(CLEVR_SIZES)
        r_units = (0.075 if size == "small" else 0.13) / (0.4 / 3.0)
        lim = 2.55 - r_units  # keep the whole sprite crop/rotation-safe
        placed = False
        for _attempt in range(300):
            x, y = rng.uniform(-lim, lim), rng.uniform(-lim, lim)
            if all(
                (x - tx) ** 2 + (y - ty) ** 2 > (1.1 * (r_units + tr)) ** 2
                for tx, ty, tr in taken
            ):
                placed = True
                break
        if not placed:  # never emit overlapping sprites (v1 label noise)
            continue
        taken.append((x, y, r_units))
        objs.append(
            {
                "color": rng.choice(CLEVR_COLORS),
                "shape": rng.choice(CLEVR_SHAPES),
                "material": rng.choice(CLEVR_MATERIALS),
                "size": size,
                "rotation": rng.uniform(0, 360),
                "3d_coords": [x, y, 0.35],
                "pixel_coords": [0, 0, 0],
            }
        )
    if len(objs) < 2:  # placement starved (rare): resample the scene
        return _random_scene_v2(rng, n_min, n_max)
    return objs


def _make_questions_v2(rng: random.Random, objs: List[Dict]) -> List[Tuple[str, str, str]]:
    """Fixture-v2 question mix: ~12 questions/image across all five families,
    each answerable from pixels at sprite scale, with comparison operands
    biased toward attributes actually present (so yes/no isn't one-sided)."""
    qs: List[Tuple[str, str, str]] = []
    colors_present = [o["color"] for o in objs]
    shapes_present = [o["shape"] for o in objs]

    def pick(pool, present):
        # half the time pick an attribute value that is in the scene
        return rng.choice(present) if present and rng.random() < 0.5 else rng.choice(pool)

    # --- count ---
    c = pick(CLEVR_COLORS, colors_present)
    qs.append((f"How many {c} things are there?", str(sum(o["color"] == c for o in objs)), "count"))
    s = pick(CLEVR_SHAPES, shapes_present)
    qs.append((f"How many {s}s are there?", str(sum(o["shape"] == s for o in objs)), "count"))
    qs.append(("How many things are there?", str(len(objs)), "count"))

    # --- exist ---
    s = pick(CLEVR_SHAPES, shapes_present)
    qs.append((f"Is there a {s} in the scene?", "yes" if any(o["shape"] == s for o in objs) else "no", "exist"))
    c = pick(CLEVR_COLORS, colors_present)
    qs.append((f"Is there a {c} thing in the scene?", "yes" if c in colors_present else "no", "exist"))
    o0 = rng.choice(objs)
    c, s = (o0["color"], o0["shape"]) if rng.random() < 0.5 else (
        rng.choice(CLEVR_COLORS), rng.choice(CLEVR_SHAPES)
    )
    hit = any(o["color"] == c and o["shape"] == s for o in objs)
    qs.append((f"Is there a {c} {s} in the scene?", "yes" if hit else "no", "exist"))

    # --- compare-numbers ---
    c1 = pick(CLEVR_COLORS, colors_present)
    c2 = pick(CLEVR_COLORS, [cc for cc in colors_present if cc != c1])
    if c1 != c2:
        n1 = sum(o["color"] == c1 for o in objs)
        n2 = sum(o["color"] == c2 for o in objs)
        qs.append((f"Are there more {c1} things than {c2} things?", "yes" if n1 > n2 else "no", "greater_than"))
        qs.append((
            f"Are there the same number of {c1} things and {c2} things?",
            "yes" if n1 == n2 else "no", "equal_integer",
        ))
    s1 = pick(CLEVR_SHAPES, shapes_present)
    s2 = pick(CLEVR_SHAPES, [ss for ss in shapes_present if ss != s1])
    if s1 != s2:
        m1 = sum(o["shape"] == s1 for o in objs)
        m2 = sum(o["shape"] == s2 for o in objs)
        qs.append((f"Are there fewer {s1}s than {s2}s?", "yes" if m1 < m2 else "no", "less_than"))

    # --- query-attribute (on uniquely-identified objects) ---
    uniq_color = [o for o in objs if colors_present.count(o["color"]) == 1]
    rng.shuffle(uniq_color)
    for o in uniq_color[:2]:
        attr = rng.choice(["shape", "material", "size"])
        qs.append((f"What {attr} is the {o['color']} thing?", o[attr], f"query_{attr}"))
    uniq_shape = [o for o in objs if shapes_present.count(o["shape"]) == 1]
    if uniq_shape:
        o = rng.choice(uniq_shape)
        qs.append((f"What color is the {o['shape']}?", o["color"], "query_color"))

    # --- compare-attribute ---
    if len(uniq_color) >= 2:
        for a, b in [uniq_color[:2], uniq_color[-2:]][: 2 if len(uniq_color) > 2 else 1]:
            attr = rng.choice(["shape", "material", "size"])
            qs.append((
                f"Is the {a['color']} thing the same {attr} as the {b['color']} thing?",
                "yes" if a[attr] == b[attr] else "no", f"equal_{attr}",
            ))
    return qs


def _random_scene_v3(
    rng: random.Random, n_min: int = 4, n_max: int = 10, sep: float = 0.55,
    _depth: int = 0
) -> List[Dict]:
    """Fixture-v3 "CLEVR-hard" scenes: fixture-v2 saturates near 100 %, so
    accuracy comparisons lose their power on it.

    Three difficulty sources v2 deliberately removed, tuned to land
    original-fp in the reference's real-CLEVR regime (~85-95%):
      * crowding: 4-10 objects (v2: 2-5) at v1 sprite scale;
      * partial occlusion: placement only guarantees a visible crescent
        (center distance >= max(0.55*(ri+rj), 0.9*max(ri, rj))) instead of
        v2's full separation — attributes of a half-hidden object must be
        read from the visible sliver;
      * size-distance confound: apparent radius = size_base * (0.75 +
        0.5*depth) with depth following y (painter's order: larger y is
        drawn later, i.e. nearer) — a far 'large' projects like a near
        'small', so size questions need the position *relation*, not a
        local pixel cue.
    Labels stay exact: answers are computed from scene truth, every sprite
    keeps a crop/rotation-safe margin, and the crescent rule bounds how
    much of any object occlusion can hide.
    """
    n = rng.randint(n_min, n_max)
    objs: List[Dict] = []
    taken: List[Tuple[float, float, float]] = []  # (x, y, r in scene units)
    for _ in range(n):
        size = rng.choice(CLEVR_SIZES)
        placed = False
        for _attempt in range(400):
            x, y = rng.uniform(-2.2, 2.2), rng.uniform(-2.2, 2.2)
            depth = (y + 2.8) / 5.6  # 0 = back (top row), 1 = front (bottom)
            scale = 0.75 + 0.5 * depth
            r_frac = (0.055 if size == "small" else 0.10) * scale
            r_units = r_frac * 7.5  # canvas fraction -> scene units (0.4/3)
            lim = (0.40 - r_frac) * 7.5  # 16px crop jitter + rotation safe
            if abs(x) > lim or abs(y) > lim:
                continue
            if all(
                (x - tx) ** 2 + (y - ty) ** 2
                >= max(sep * (r_units + tr), 0.9 * max(r_units, tr)) ** 2
                for tx, ty, tr in taken
            ):
                placed = True
                break
        if not placed:  # crowded placement starved: drop this object
            continue
        taken.append((x, y, r_units))
        objs.append(
            {
                "color": rng.choice(CLEVR_COLORS),
                "shape": rng.choice(CLEVR_SHAPES),
                "material": rng.choice(CLEVR_MATERIALS),
                "size": size,
                "rotation": rng.uniform(0, 360),
                "3d_coords": [x, y, 0.35],
                "pixel_coords": [0, 0, 0],
                "r_frac": r_frac,
            }
        )
    if len(objs) < 3 and _depth < 20:  # starved scene: resample
        return _random_scene_v3(rng, n_min, n_max, sep, _depth + 1)
    return objs


def _make_questions_v3(rng: random.Random, objs: List[Dict]) -> List[Tuple[str, str, str]]:
    """Fixture-v3 question mix (~14/image): v2's five families PLUS the
    spatial-relational templates real CLEVR leans on (left/right/behind/
    front counts, closest-object queries) and size questions under the
    perspective confound. Anchors are uniquely-colored objects so every
    reference is unambiguous; answers are computed from scene truth."""
    qs: List[Tuple[str, str, str]] = []
    colors_present = [o["color"] for o in objs]
    shapes_present = [o["shape"] for o in objs]

    def pick(pool, present):
        return rng.choice(present) if present and rng.random() < 0.5 else rng.choice(pool)

    # --- count ---
    c = pick(CLEVR_COLORS, colors_present)
    qs.append((f"How many {c} things are there?", str(sum(o["color"] == c for o in objs)), "count"))
    s = pick(CLEVR_SHAPES, shapes_present)
    qs.append((f"How many {s}s are there?", str(sum(o["shape"] == s for o in objs)), "count"))
    qs.append(("How many things are there?", str(len(objs)), "count"))
    m = rng.choice(CLEVR_MATERIALS)
    qs.append((f"How many {m} things are there?", str(sum(o["material"] == m for o in objs)), "count"))

    # unique-color anchors for every relational reference
    uniq = [o for o in objs if colors_present.count(o["color"]) == 1]
    rng.shuffle(uniq)

    # --- spatial-relational count (left/right = x, behind/front = y) ---
    if uniq:
        a = uniq[0]
        rel, axis, sign = rng.choice(
            [("left of", 0, -1), ("right of", 0, +1),
             ("behind", 1, -1), ("in front of", 1, +1)]
        )
        cnt = sum(
            sign * (o["3d_coords"][axis] - a["3d_coords"][axis]) > 0
            for o in objs
            if o is not a
        )
        qs.append(
            (f"How many things are {rel} the {a['color']} thing?", str(cnt), "count")
        )

    # --- exist (incl. conjunctions) ---
    s = pick(CLEVR_SHAPES, shapes_present)
    qs.append((f"Is there a {s} in the scene?", "yes" if any(o["shape"] == s for o in objs) else "no", "exist"))
    o0 = rng.choice(objs)
    c2, s2 = (o0["color"], o0["shape"]) if rng.random() < 0.5 else (
        rng.choice(CLEVR_COLORS), rng.choice(CLEVR_SHAPES)
    )
    hit = any(o["color"] == c2 and o["shape"] == s2 for o in objs)
    qs.append((f"Is there a {c2} {s2} in the scene?", "yes" if hit else "no", "exist"))
    sz, mt = rng.choice(CLEVR_SIZES), rng.choice(CLEVR_MATERIALS)
    hit = any(o["size"] == sz and o["material"] == mt for o in objs)
    qs.append((f"Is there a {sz} {mt} thing in the scene?", "yes" if hit else "no", "exist"))

    # --- compare-numbers ---
    c1 = pick(CLEVR_COLORS, colors_present)
    c2 = pick(CLEVR_COLORS, [cc for cc in colors_present if cc != c1])
    if c1 != c2:
        n1 = sum(o["color"] == c1 for o in objs)
        n2 = sum(o["color"] == c2 for o in objs)
        qs.append((f"Are there more {c1} things than {c2} things?", "yes" if n1 > n2 else "no", "greater_than"))
        qs.append((
            f"Are there the same number of {c1} things and {c2} things?",
            "yes" if n1 == n2 else "no", "equal_integer",
        ))
    s1 = pick(CLEVR_SHAPES, shapes_present)
    s2 = pick(CLEVR_SHAPES, [ss for ss in shapes_present if ss != s1])
    if s1 != s2:
        m1 = sum(o["shape"] == s1 for o in objs)
        m2 = sum(o["shape"] == s2 for o in objs)
        qs.append((f"Are there fewer {s1}s than {s2}s?", "yes" if m1 < m2 else "no", "less_than"))

    # --- query-attribute (anchored; size is confounded by perspective) ---
    for o in uniq[:2]:
        attr = rng.choice(["shape", "material", "size"])
        qs.append((f"What {attr} is the {o['color']} thing?", o[attr], f"query_{attr}"))
    uniq_shape = [o for o in objs if shapes_present.count(o["shape"]) == 1]
    if uniq_shape:
        o = rng.choice(uniq_shape)
        qs.append((f"What color is the {o['shape']}?", o["color"], "query_color"))

    # --- relational query: nearest neighbor of an anchor ---
    if uniq and len(objs) >= 2:
        a = uniq[-1]
        others = [o for o in objs if o is not a]
        near = min(
            others,
            key=lambda o: (o["3d_coords"][0] - a["3d_coords"][0]) ** 2
            + (o["3d_coords"][1] - a["3d_coords"][1]) ** 2,
        )
        attr = rng.choice(["color", "shape"])
        qs.append(
            (f"What {attr} is the thing closest to the {a['color']} thing?",
             near[attr], f"query_{attr}")
        )

    # --- compare-attribute (size compare crosses the perspective confound) ---
    if len(uniq) >= 2:
        a, b = uniq[0], uniq[1]
        attr = rng.choice(["shape", "material"])
        qs.append((
            f"Is the {a['color']} thing the same {attr} as the {b['color']} thing?",
            "yes" if a[attr] == b[attr] else "no", f"equal_{attr}",
        ))
        c3, d3 = rng.sample(uniq, 2)
        qs.append((
            f"Is the {c3['color']} thing the same size as the {d3['color']} thing?",
            "yes" if c3["size"] == d3["size"] else "no", "equal_size",
        ))
    return qs


def _image_hw(style: str, image_hw: Tuple[int, int] = (120, 160)) -> Tuple[int, int]:
    """(H, W) of a style's PNGs: v2 and v3 are square (128 unless asked)."""
    if style in ("v2", "v3"):
        H = W = max(image_hw) if image_hw != (120, 160) else 128
        return H, W
    return image_hw


def _draw_split(
    rng: random.Random,
    split: str,
    n_images: int,
    style: str = "v1",
    v3_objects: Tuple[int, int] = (4, 10),
    v3_min_sep: float = 0.55,
) -> Tuple[List[Dict], List[Dict]]:
    """Draw one split's scenes and questions from `rng`, in ``generate``'s
    order (a scene, then its questions, image by image); for the train split
    the answer-completion pass follows. Renders nothing. Returns (scenes,
    questions), the records of the split's two JSON files."""
    make_qs = {
        "v3": _make_questions_v3,
        "v2": _make_questions_v2,
    }.get(style, _make_questions)
    scenes, questions = [], []
    for idx in range(n_images):
        if style == "v3":
            objs = _random_scene_v3(rng, v3_objects[0], v3_objects[1], v3_min_sep)
        elif style == "v2":
            objs = _random_scene_v2(rng)
        else:
            objs = _random_scene(rng)
        fname = f"CLEVR_{split}_{idx:06d}.png"
        scenes.append(
            {
                "split": split,
                "image_index": idx,
                "image_filename": fname,
                "objects": objs,
                "directions": {},
            }
        )
        for q, a, fn in make_qs(rng, objs):
            questions.append(
                {
                    "split": split,
                    "image_index": idx,
                    "image_filename": fname,
                    "question": q,
                    "answer": a,
                    "question_index": len(questions),
                    "question_family_index": 0,
                    "program": [{"function": fn, "inputs": [], "value_inputs": []}],
                }
            )

    if split == "train":
        # Real CLEVR train covers the full 28-answer universe; guarantee the
        # same here so val never hits an unseen answer (dictionaries are
        # built from train only, as in the reference).
        present = {q["answer"] for q in questions}
        templates = {
            **{n: (f"How many things are there exactly {n}?", "count")
               for n in map(str, range(11))},
            **{b: (f"Is there anything at all {b}?", "exist") for b in ("yes", "no")},
            **{c: (f"What color is the thing that is {c}?", "query_color")
               for c in CLEVR_COLORS},
            **{s: (f"What shape is the thing that is a {s}?", "query_shape")
               for s in CLEVR_SHAPES},
            **{m: (f"What material is the thing made of {m}?", "query_material")
               for m in CLEVR_MATERIALS},
            **{s: (f"What size is the thing that is {s}?", "query_size")
               for s in CLEVR_SIZES},
        }
        for ans, (qtext, fn) in templates.items():
            if ans not in present:
                questions.append(
                    {
                        "split": split,
                        "image_index": 0,
                        "image_filename": f"CLEVR_{split}_000000.png",
                        "question": qtext,
                        "answer": ans,
                        "question_index": len(questions),
                        "question_family_index": 999,
                        "program": [{"function": fn, "inputs": [], "value_inputs": []}],
                    }
                )
    return scenes, questions


def _render_scene(objs: List[Dict], path: str, H: int, W: int, style: str = "v1") -> None:
    """Render one scene's objects back to front (painter's order by y) and
    write the PNG at `path`; v2 and v3 draw at 2x and downsample with LANCZOS
    (crisp edges). Draws nothing from the random stream."""
    from PIL import Image, ImageDraw

    if style in ("v2", "v3"):  # 2x supersample -> LANCZOS: crisp edges
        img = Image.new("RGB", (2 * W, 2 * H), (210, 210, 210))
        _draw = ImageDraw.Draw(img)
        for o in sorted(objs, key=lambda o: o["3d_coords"][1]):
            _draw_object(_draw, o, 2 * W, 2 * H, style=style)
        img = img.resize((W, H), Image.LANCZOS)
    else:
        img = Image.new("RGB", (W, H), (210, 210, 210))
        _draw = ImageDraw.Draw(img)
        # painter's order: back-to-front by y
        for o in sorted(objs, key=lambda o: o["3d_coords"][1]):
            _draw_object(_draw, o, W, H)
    # compress_level=1: pixel-identical PNGs, ~6x faster encode — at
    # reference scale (70k images) default-level zlib dominates gen time
    img.save(path, compress_level=1)


def _render_split(
    root: str, split: str, scenes: List[Dict], H: int, W: int, style: str = "v1", workers: int = 1
) -> None:
    """Write the PNG of every scene of a split under ``<root>/images/<split>/``;
    with ``workers`` > 1 in that many processes (the files are the same)."""
    img_dir = os.path.join(root, "images", split)
    os.makedirs(img_dir, exist_ok=True)
    objs = [sc["objects"] for sc in scenes]
    paths = [os.path.join(img_dir, sc["image_filename"]) for sc in scenes]
    if workers <= 1:
        for o, path in zip(objs, paths):
            _render_scene(o, path, H, W, style)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from itertools import repeat

    # spawned, not forked: the caller may hold CUDA and threads
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        list(pool.map(_render_scene, objs, paths, repeat(H), repeat(W), repeat(style), chunksize=64))


def _write_split(root: str, split: str, scenes: List[Dict], questions: List[Dict]) -> None:
    """The split's questions and scenes JSON, the bytes rnet's ``json.dump``
    writes (one ``write`` of ``json.dumps``: the same encoder, not a write
    per token)."""
    for kind, records in (("questions", questions), ("scenes", scenes)):
        os.makedirs(os.path.join(root, kind), exist_ok=True)
        with open(os.path.join(root, kind, f"CLEVR_{split}_{kind}.json"), "w") as f:
            f.write(json.dumps({"info": {"split": split, "synthetic": True}, kind: records}))


def generate(
    root: str,
    n_train: int = 32,
    n_val: int = 8,
    image_hw: Tuple[int, int] = (120, 160),
    seed: int = 0,
    style: str = "v1",
    v3_objects: Tuple[int, int] = (4, 10),
    v3_min_sep: float = 0.55,
    workers: int = 1,
) -> str:
    """Write a miniature CLEVR-schema dataset under ``root``. Returns root.

    style="v2" (from-pixels accuracy demo): square 2x-supersampled render,
    larger well-separated sprites that survive the 8x8 conv grid,
    crop/rotation-safe margins, and ~12 balanced questions per image across
    all five CLEVR families.

    style="v3" ("CLEVR-hard"): crowded scenes (4-10 objects at v1 sprite
    scale), partial occlusion, a size-distance perspective confound, and
    spatial-relational question templates — tuned so original-fp lands in
    the reference's real-CLEVR accuracy regime instead of saturating.

    ``workers`` > 1 renders the PNGs in that many processes: rendering draws
    nothing from the random stream, so the files are the same.
    """
    rng = random.Random(seed)
    H, W = _image_hw(style, image_hw)
    for split, n_images in (("train", n_train), ("val", n_val)):
        scenes, questions = _draw_split(rng, split, n_images, style, v3_objects, v3_min_sep)
        _render_split(root, split, scenes, H, W, style, workers)
        _write_split(root, split, scenes, questions)
    return root


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Generate a synthetic CLEVR-schema fixture")
    p.add_argument("root")
    p.add_argument("--n-train", type=int, default=32)
    p.add_argument("--n-val", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--style", choices=("v1", "v2", "v3"), default="v1")
    p.add_argument(
        "--v3-objects", type=int, nargs=2, default=(4, 10), metavar=("MIN", "MAX"),
        help="v3 scene crowding range (difficulty knob; default 4 10)",
    )
    p.add_argument(
        "--v3-min-sep", type=float, default=0.55,
        help="v3 occlusion knob: min center distance as a fraction of the "
        "radius sum (0.55 = heavy partial occlusion, >=1.0 = fully separated)",
    )
    a = p.parse_args(argv)
    generate(
        a.root, a.n_train, a.n_val, seed=a.seed, style=a.style,
        v3_objects=tuple(a.v3_objects), v3_min_sep=a.v3_min_sep,
    )
    print(f"wrote synthetic CLEVR fixture to {a.root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
