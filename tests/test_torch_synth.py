"""The port's fixture generator (``rnet_torch.data.synth``) against rnet's
(``rnet.data.synth``), on the CPU at tiny sizes.

* ``generate`` of each package into its own directory, for v1, v2, v3 and
  v3 with its knobs: the same file list, every JSON file byte for byte,
  every PNG's pixels and bytes equal (the same Pillow and zlib here).
* ``python -m rnet_torch.data.synth`` and ``python -m rnet.data.synth`` on
  the same arguments write the same tree and print the same line.
* The split drawn without rendering (``_draw_split``), val after an
  unrendered train, gives the scenes and questions that ``generate`` wrote;
  ``generate(..., workers=2)`` (the PNGs rendered in worker processes)
  writes the same tree.
"""

import filecmp
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from rnet.data import synth as rnet_synth
from rnet_torch.data import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRAIN, N_VAL = 12, 4
STYLES = {
    "v1": {"style": "v1"},
    "v2": {"style": "v2"},
    "v3": {"style": "v3"},
    "v3-knobs": {"style": "v3", "v3_objects": (3, 6), "v3_min_sep": 1.0},
}


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _assert_same_tree(a, b):
    files = _tree(a)
    assert files == _tree(b)
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            with Image.open(pa) as ia, Image.open(pb) as ib:
                assert ia.size == ib.size and ia.mode == ib.mode == "RGB"
                assert np.array_equal(np.asarray(ia), np.asarray(ib)), rel
        assert filecmp.cmp(pa, pb, shallow=False), rel
    return files


@pytest.mark.parametrize("name", sorted(STYLES))
def test_generate_writes_rnets_files(name, tmp_path):
    kw = STYLES[name]
    want, got = str(tmp_path / "rnet"), str(tmp_path / "port")
    assert rnet_synth.generate(want, N_TRAIN, N_VAL, seed=3, **kw) == want
    assert synth.generate(got, N_TRAIN, N_VAL, seed=3, **kw) == got
    files = _assert_same_tree(want, got)
    assert sum(f.endswith(".png") for f in files) == N_TRAIN + N_VAL
    with open(os.path.join(got, "questions", "CLEVR_train_questions.json")) as f:
        answers = {q["answer"] for q in json.load(f)["questions"]}
    assert len(answers) == 28  # the completion pass covers every answer


@pytest.mark.parametrize("args", [["--n-train", "6", "--n-val", "3"],
                                  ["--n-train", "5", "--n-val", "2", "--style", "v3", "--seed", "7",
                                   "--v3-objects", "3", "5", "--v3-min-sep", "0.8"]],
                         ids=["defaults", "v3-knobs"])
def test_cli_writes_rnets_tree(args, tmp_path):
    outs = {}
    for pkg in ("rnet", "rnet_torch"):
        root = str(tmp_path / pkg)
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.data.synth", root, *args], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs[pkg] = proc.stdout.replace(root, "<root>")
    assert outs["rnet"] == outs["rnet_torch"] == "wrote synthetic CLEVR fixture to <root>\n"
    _assert_same_tree(str(tmp_path / "rnet"), str(tmp_path / "rnet_torch"))


@pytest.mark.parametrize("name", ["v1", "v2", "v3-knobs"])
def test_drawn_split_equals_generated_files(name, tmp_path):
    kw = dict(STYLES[name])
    style = kw.pop("style")
    root = str(tmp_path / "gen")
    synth.generate(root, N_TRAIN, N_VAL, seed=11, style=style, **kw)
    rng = random.Random(11)
    train = synth._draw_split(rng, "train", N_TRAIN, style, **kw)
    val = synth._draw_split(rng, "val", N_VAL, style, **kw)
    for split, (scenes, questions) in (("train", train), ("val", val)):
        with open(os.path.join(root, "questions", f"CLEVR_{split}_questions.json")) as f:
            assert json.load(f)["questions"] == questions
        with open(os.path.join(root, "scenes", f"CLEVR_{split}_scenes.json")) as f:
            assert json.load(f)["scenes"] == scenes
    # written as generate writes them, the val JSON is the same bytes
    out = str(tmp_path / "drawn")
    synth._write_split(out, "val", *val)
    for kind in ("questions", "scenes"):
        rel = os.path.join(kind, f"CLEVR_val_{kind}.json")
        assert filecmp.cmp(os.path.join(root, rel), os.path.join(out, rel), shallow=False)
    # rendered in two worker processes, the tree is the same
    two = str(tmp_path / "two")
    synth.generate(two, N_TRAIN, N_VAL, seed=11, style=style, workers=2, **kw)
    _assert_same_tree(root, two)
