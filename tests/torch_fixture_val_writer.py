"""Write ``tests/torch_fixtures/clevr_v2_seed1_val/``: the val split that rnet
scored its trained wide-fp weights on.

    python tests/torch_fixture_val_writer.py

rnet's epoch-91 wide-fp weights (``results/int8_eval_r4/
wide-fp_epoch091_weights_dicts.pkl``, dictionaries carried) were scored on
the val split of the v2 seed-1 synthetic fixture (``results/widefp_r3/
int8_eval/{auto,pallas_int8}/val_accuracy.csv``). This script:

- runs ``python -m rnet.data.synth <tmp> --n-train 4000 --n-val 600
  --style v2 --seed 1`` (the fixture's own command; ~15 s);
- builds the port's decoded cache of the val split,
  ``rnet_torch.data.cache.build_image_cache(<tmp>, "val")``
  (``rnet_cache/val_128p8.u8``, 600 x 144 x 144 x 3 uint8, and its
  ``.json`` meta);
- asserts, for every image, that the cached canvas's centre crop equals
  rnet's PNG eval transform (``rnet.data.clevr.ImageTransform(128,
  train=False)``) of the PNG, so the port's cache path and rnet's PNG path
  feed the model the same pixels;
- writes ``CLEVR_val_questions.json.xz``, ``val_128p8.u8.xz`` and
  ``val_128p8.json`` (as is), and ``digests.json``: the sha256 and size of
  each expanded file, and the counts.

xz (Python's ``lzma``), not zlib: the cache takes 0.24 MB so, against 0.99 MB
through ``np.savez_compressed``, and the questions 0.05 MB against 0.08 MB
through gzip; the repository's committed tree has little room left.
``chip_smoke.expand_val_fixture`` writes the files back into a CLEVR
directory, each checked against its digest (chip_smoke phase 15;
``tests/test_torch_val_fixture.py``). The output is deterministic: a rerun
gives the same digests.
"""

import hashlib
import json
import lzma
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from rnet.data.clevr import ImageTransform  # noqa: E402
from rnet_torch.data.cache import build_image_cache  # noqa: E402

SYNTH = ["--n-train", "4000", "--n-val", "600", "--style", "v2", "--seed", "1"]
IMAGE_SIZE, PAD = 128, 8


def main() -> int:
    out = chip_smoke.VAL_FIXTURE
    tmp = tempfile.mkdtemp(prefix="rnet_val_fixture_")
    try:
        subprocess.run([sys.executable, "-m", "rnet.data.synth", tmp, *SYNTH], cwd=REPO, check=True)
        arr_path = build_image_cache(tmp, "val", IMAGE_SIZE, PAD)
        meta_path = arr_path[: -len(".u8")] + ".json"
        cache = np.load(arr_path, mmap_mode="r")
        shape = list(cache.shape)
        with open(meta_path) as f:
            files = json.load(f)["files"]
        tf = ImageTransform(IMAGE_SIZE, train=False)
        for i, name in enumerate(files):
            with Image.open(os.path.join(tmp, "images", "val", name)) as im:
                want = tf(im)
            if not np.array_equal(cache[i, PAD : PAD + IMAGE_SIZE, PAD : PAD + IMAGE_SIZE], want):
                raise AssertionError(f"the cache's centre crop of {name} differs from rnet's eval transform")
        sources = {
            "CLEVR_val_questions.json": os.path.join(tmp, "questions", "CLEVR_val_questions.json"),
            "val_128p8.u8": arr_path,
            "val_128p8.json": meta_path,
        }
        with open(sources["CLEVR_val_questions.json"]) as f:
            n_questions = len(json.load(f)["questions"])
        os.makedirs(out, exist_ok=True)
        digests = {}
        for name, src in sources.items():
            with open(src, "rb") as f:
                data = f.read()
            digests[name] = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
            if name in chip_smoke.VAL_FIXTURE_XZ:
                with open(os.path.join(out, name + ".xz"), "wb") as f:
                    f.write(lzma.compress(data, preset=9 | lzma.PRESET_EXTREME))
            else:
                shutil.copyfile(src, os.path.join(out, name))
        with open(os.path.join(out, "digests.json"), "w") as f:
            json.dump({"source": "python -m rnet.data.synth <dir> " + " ".join(SYNTH),
                       "questions": n_questions, "cache_shape": shape, "files": digests},
                      f, indent=1, sort_keys=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    size = sum(os.path.getsize(os.path.join(out, n)) for n in os.listdir(out))
    print(f"wrote {out}: {n_questions} questions, cache {shape}, {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
