"""Write ``tests/torch_fixtures/clevr_v2_seed1_70k/``: what rnet's generator
makes of the fixture its flagship original-fp was trained on.

    JAX_PLATFORMS=cpu python tests/torch_fixture_v2_70k_writer.py

rnet's round-3 campaign (``results/campaign_r3/``) trained original-fp for
120 epochs on ``python -m rnet.data.synth <dir> --n-train 70000 --n-val
15000 --style v2 --seed 1`` and scored epoch 119
(``original-fp_epoch119_weights.pkl``, which carries no dictionaries) at
0.999818 on that val split. Its answer head's ids are the first-seen order
of that fixture's train questions, so the port can score it only on the
same fixture, regenerated. The fixture is far too large to commit; this
script writes the few KB that hold a regeneration to rnet's:

- ``dictionaries.json``: ``rnet.data.vocab.build_dictionaries`` of the
  870,780 train questions (words and answers in first-seen order);
- ``digests.json``: the question and image counts; the sha256 and size of
  the four JSON files; the sha256 of the port's decoded val cache
  (``rnet_torch.data.cache.build_image_cache(<dir>, "val")``, 15,000 x 144
  x 144 x 3 uint8, and its ``.json``) built from rnet's PNGs; Pillow's and
  zlib's versions; and rnet's and the port's CPU scores of the epoch-119
  weights on the committed 600-image v2 seed-1 val split
  (``tests/torch_fixtures/clevr_v2_seed1_val/``, the same generator: a check
  that today's rnet config reproduces the round-3 model);
- ``int8_batches.json``: on eval batches 0 and 45 of the val split (B=512,
  ``evaluate``'s order), the predictions, right answers and mean NLL of
  rnet's int8 (its kernel in interpret mode) and bf16, and of the port's
  plain int8 chain, with bf16 compute as ``evaluate`` runs and again with
  fp32 compute (``_int8_batches``).

It runs rnet's own ``generate`` with rendering of the train split skipped
(the 70,000 train PNGs would take ~8 minutes and nothing here reads them):
``rnet.data.synth``'s ``Image`` and ``ImageDraw`` are swapped for recorders
that replay every call on Pillow when the image is saved, unless its path
is under ``images/train/``. Rendering draws nothing from the random stream,
so every file written is the one rnet's CLI writes. ~10 minutes and ~2 GB
on the CPU (~80 s of drawing and val rendering, the cache, ~220 s of scores,
~210 s of int8 batches).
``chip_smoke.py`` phase 17 holds the card's regeneration to these files.
"""

import hashlib
import json
import os
import pickle
import shutil
import sys
import tempfile
import time
import zlib
from contextlib import contextmanager

import numpy as np
import PIL
from PIL import Image, ImageDraw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from rnet.data import synth as rnet_synth  # noqa: E402
from rnet.data.vocab import build_dictionaries  # noqa: E402
from rnet_torch.data.cache import build_image_cache  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_fixtures", "clevr_v2_seed1_70k")
SYNTH = {"n_train": 70_000, "n_val": 15_000, "style": "v2", "seed": 1}
PKL = os.path.join(REPO, "results", "campaign_r3", "original-fp_epoch119_weights.pkl")
IMAGE_SIZE, PAD = 128, 8
SCORE_B = 64
# eval batches of the val split at evaluate's B=512, in its order: the first, and the one where the port's int8
# and bf16 answers differ most on an H100 (chip_smoke.py phase 17)
INT8_BATCHES, EVAL_B = (0, 45), 512
INT8_CHUNK = 16  # samples a call of the pair chain: the batch is calibrated whole, the chain run in chunks
ANSWER_DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"  # a prediction per character (answer ids < 36)


class _Recorder:
    """Stands in for a PIL image and its ImageDraw: records the calls and
    replays them on Pillow at ``save``, except for train-split paths."""

    def __init__(self, mode, size, color):
        self.new, self.ops, self.resized = (mode, size, color), [], None

    def __getattr__(self, name):  # ellipse, rectangle, rounded_rectangle
        return lambda *a, **k: self.ops.append((name, a, k))

    def resize(self, size, resample):
        self.resized = (size, resample)
        return self

    def save(self, path, **kw):
        if f"{os.sep}images{os.sep}train{os.sep}" in path:
            return
        img = Image.new(*self.new)
        draw = ImageDraw.Draw(img)
        for name, a, k in self.ops:
            getattr(draw, name)(*a, **k)
        if self.resized is not None:
            img = img.resize(*self.resized)
        img.save(path, **kw)


class _ImageModule:
    LANCZOS = Image.LANCZOS

    @staticmethod
    def new(mode, size, color):
        return _Recorder(mode, size, color)


class _DrawModule:
    @staticmethod
    def Draw(img):
        return img


@contextmanager
def _train_unrendered():
    saved = rnet_synth.Image, rnet_synth.ImageDraw
    rnet_synth.Image, rnet_synth.ImageDraw = _ImageModule, _DrawModule
    try:
        yield
    finally:
        rnet_synth.Image, rnet_synth.ImageDraw = saved


def _file_digest(path):
    with open(path, "rb") as f:
        data = f.read()
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}


def _check_recorder(tmp):
    """The recorders change nothing rnet writes: a small v2 run through them
    equals rnet's plain run on every val file and every JSON file."""
    a, b = os.path.join(tmp, "plain"), os.path.join(tmp, "recorded")
    rnet_synth.generate(a, 20, 6, style="v2", seed=1)
    with _train_unrendered():
        rnet_synth.generate(b, 20, 6, style="v2", seed=1)
    for sub in ("questions", "scenes", os.path.join("images", "val")):
        for name in sorted(os.listdir(os.path.join(a, sub))):
            if _file_digest(os.path.join(a, sub, name)) != _file_digest(os.path.join(b, sub, name)):
                raise AssertionError(f"the recorders change {sub}/{name}")
    if os.listdir(os.path.join(b, "images", "train")):
        raise AssertionError("the recorders wrote train PNGs")


def _scores(dicts):
    """rnet's and the port's fp32 (``xla``) scores of the epoch-119 weights
    on the committed 600-image val split, fed from the port's cache as
    ``python -m rnet_torch.evaluate --data-pipeline device`` feeds them."""
    import jax
    import jax.numpy as jnp
    import torch

    from rnet.config import load_config as jax_load_config
    from rnet.models import RN as JaxRN
    from rnet_torch.checkpoint import load_weights
    from rnet_torch.config import load_config
    from rnet_torch.data.cache import CachedClevrDataset
    from rnet_torch.data.vocab import invert_questions
    from rnet_torch.models import RN

    root = tempfile.mkdtemp(prefix="rnet_val600_")
    try:
        chip_smoke.expand_val_fixture(root)
        ds = CachedClevrDataset(root, "val", dicts, image_size=IMAGE_SIZE, question_max_len=48,
                                train_transform=False)
        over = {"compute_dtype": "float32", "rl_impl": "xla"}
        port = RN(load_config("original-fp", overrides=over).replace(n_answers=dicts.n_answers), dicts.vocab_size)
        load_weights(port, PKL)
        port.eval()
        with open(PKL, "rb") as f:
            flat = pickle.load(f)
        jcfg = jax_load_config("original-fp", overrides=over).replace(n_answers=dicts.n_answers)
        variables = jax.tree.map(jnp.asarray, {"params": flat["params"], "batch_stats": flat["batch_stats"]})
        jmodel = JaxRN(cfg=jcfg, vocab_size=dicts.vocab_size)
        apply = jax.jit(lambda x, q: jmodel.apply(variables, x, q, train=False))
        out = {"rnet": {"right": 0, "nll": 0.0}, "port": {"right": 0, "nll": 0.0}, "same": 0, "max_abs_diff": 0.0}
        n = len(ds)
        for b0 in range(0, n, SCORE_B):
            batch = ds.get_batch(np.arange(b0, min(n, b0 + SCORE_B)))
            images, tokens, labels = batch["image"], invert_questions(batch["question"]), batch["answer"]
            with torch.no_grad():
                got = port(torch.from_numpy(images), torch.from_numpy(tokens)).numpy()
            want = np.asarray(apply(jnp.asarray(images), jnp.asarray(tokens)))
            for tag, lp in (("port", got), ("rnet", want)):
                out[tag]["right"] += int((lp.argmax(-1) == labels).sum())
                out[tag]["nll"] -= float(lp[np.arange(len(labels)), labels].sum())
            out["same"] += int((got.argmax(-1) == want.argmax(-1)).sum())
            out["max_abs_diff"] = max(out["max_abs_diff"], float(np.abs(got - want).max()))
        for tag in ("rnet", "port"):
            out[tag] = {"accuracy": out[tag]["right"] / n, "mean_nll": out[tag]["nll"] / n, "right": out[tag]["right"]}
        out.update(questions=n, predictions_equal=out.pop("same") / n)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _int8_batches(root, dicts):
    """rnet's int8 (``--rl-impl pallas_int8``: its kernel in interpret mode)
    and its bf16 (``xla``) on eval batches ``INT8_BATCHES`` of the val split,
    as ``python -m rnet_torch.evaluate`` batches it (B=512, the eval
    transform, bf16 compute), beside the port's int8 (its plain chain) on
    the same inputs; both packages' int8 again with fp32 compute (suffix
    ``_f32``). int8 calibrates on the whole batch (the strided
    subsample of ``_activation_scales`` / ``activation_scales``), so each
    package's scales are taken from the whole batch and its pair chain then
    runs ``INT8_CHUNK`` samples at a time with them: the chain is per sample,
    so the result is the whole batch's in a few hundred MB. Returns, per
    batch, each arm's predictions (one ``ANSWER_DIGITS`` character per
    question), right answers and mean NLL, and the agreements."""
    import jax
    import jax.numpy as jnp
    import torch

    from rnet.config import load_config as jax_load_config
    from rnet.kernels import pairwise as rpw
    from rnet.models import RN as JaxRN
    from rnet_torch.checkpoint import load_weights
    from rnet_torch.config import load_config
    from rnet_torch.data.cache import CachedClevrDataset
    from rnet_torch.data.vocab import invert_questions
    from rnet_torch.kernels import pairwise as pw
    from rnet_torch.models import RN

    scales, chain = rpw._activation_scales, rpw.pairwise_core_int8

    def rnet_int8(u, v, s, qa, ws, bs, *, inject, interpret=False):
        c = scales(u, v, s, qa, ws, bs, inject)
        rpw._activation_scales = lambda *a, **k: c
        try:
            return jnp.concatenate([rpw._fwd_pallas_int8(u[i:i + INT8_CHUNK], v[i:i + INT8_CHUNK],
                                                         s[i:i + INT8_CHUNK], qa[i:i + INT8_CHUNK], ws, bs,
                                                         inject, True) for i in range(0, u.shape[0], INT8_CHUNK)])
        finally:
            rpw._activation_scales = scales

    port_chain = pw.pairwise_core_int8

    def port_int8(u, v, s, qa, ws, bs, *, inject):
        fu, fv, fs, fqa, w8, m, b_f = pw.quantize_int8(u, v, s, qa, ws, bs, inject)
        return torch.cat([pw.pairwise_core_int8_reference(fu[i:i + INT8_CHUNK], fv[i:i + INT8_CHUNK],
                                                          fs[i:i + INT8_CHUNK], fqa[i:i + INT8_CHUNK], w8, m, b_f,
                                                          inject=inject) for i in range(0, u.shape[0], INT8_CHUNK)])

    ds = CachedClevrDataset(root, "val", dicts, image_size=IMAGE_SIZE, question_max_len=48, train_transform=False)
    with open(PKL, "rb") as f:
        flat = pickle.load(f)
    variables = jax.tree.map(jnp.asarray, {"params": flat["params"], "batch_stats": flat["batch_stats"]})

    def jax_rn(**over):
        cfg = jax_load_config("original-fp", overrides=over).replace(n_answers=dicts.n_answers)
        return JaxRN(cfg=cfg, vocab_size=dicts.vocab_size)

    def port_rn(**over):
        model = RN(load_config("original-fp", overrides=over).replace(n_answers=dicts.n_answers), dicts.vocab_size)
        load_weights(model, PKL)
        return model.eval()

    xla = jax_rn(rl_impl="xla")
    bf16 = jax.jit(lambda x, q: xla.apply(variables, x, q, train=False))
    # (tag suffix, compute dtype): bf16 as evaluate runs it; fp32, where the two packages' stems agree to 1e-6
    dtypes = (("", "bfloat16"), ("_f32", "float32"))
    int8 = {sfx: (jax_rn(rl_impl="pallas_int8", compute_dtype=dt), port_rn(rl_impl="pallas_int8", compute_dtype=dt))
            for sfx, dt in dtypes}

    def arm(lp, labels):
        pred = lp.argmax(-1)
        return {"predictions": "".join(ANSWER_DIGITS[p] for p in pred), "right": int((pred == labels).sum()),
                "mean_nll": float(-lp[np.arange(len(labels)), labels].astype(np.float64).mean())}, pred

    out = {}
    for k in INT8_BATCHES:
        batch = ds.get_batch(np.arange(k * EVAL_B, min(len(ds), (k + 1) * EVAL_B)))
        images, tokens, labels = batch["image"], invert_questions(batch["question"]), batch["answer"]
        row = {"questions": len(labels), "first_question": k * EVAL_B}
        ref = np.concatenate([np.asarray(bf16(jnp.asarray(images[i:i + SCORE_B]), jnp.asarray(tokens[i:i + SCORE_B])),
                                         np.float32) for i in range(0, len(labels), SCORE_B)])
        row["rnet_bf16"], p_bf16 = arm(ref, labels)
        for sfx, _ in dtypes:
            jmodel, port = int8[sfx]
            rpw.pairwise_core_int8, pw.pairwise_core_int8 = rnet_int8, port_int8
            try:
                want = np.asarray(jmodel.apply(variables, jnp.asarray(images), jnp.asarray(tokens), train=False),
                                  np.float32)
                with torch.no_grad():
                    got = port(torch.from_numpy(images), torch.from_numpy(tokens)).float().numpy()
            finally:
                rpw.pairwise_core_int8, pw.pairwise_core_int8 = chain, port_chain
            row[f"rnet_int8{sfx}"], p_int8 = arm(want, labels)
            row[f"port_int8{sfx}"], p_port = arm(got, labels)
            row[f"rnet_int8{sfx}_equal_to_rnet_bf16"] = int((p_int8 == p_bf16).sum())
            row[f"port_int8{sfx}_equal_to_rnet_int8{sfx}"] = int((p_port == p_int8).sum())
            row[f"port_int8{sfx}_max_abs_logp_diff"] = float(np.abs(got - want).max())
        out[str(k)] = row
        print(f"int8 eval batch {k}: {json.dumps(row)}", flush=True)
    return out


def main() -> int:
    tmp = tempfile.mkdtemp(prefix="rnet_v2_70k_")
    try:
        _check_recorder(tmp)
        root = os.path.join(tmp, "clevr")
        t0 = time.perf_counter()
        with _train_unrendered():
            rnet_synth.generate(root, **SYNTH)
        t_gen = time.perf_counter() - t0
        arr_path = build_image_cache(root, "val", IMAGE_SIZE, PAD)
        meta_path = arr_path[: -len(".u8")] + ".json"
        dicts = build_dictionaries(root, use_cache=False)
        counts = {}
        for split in ("train", "val"):
            with open(os.path.join(root, "questions", f"CLEVR_{split}_questions.json")) as f:
                counts[f"{split}_questions"] = len(json.load(f)["questions"])
            counts[f"{split}_images"] = SYNTH[f"n_{split}"]
        files = {f"CLEVR_{split}_{kind}.json": _file_digest(os.path.join(root, kind, f"CLEVR_{split}_{kind}.json"))
                 for split in ("train", "val") for kind in ("questions", "scenes")}
        files["val_128p8.u8"] = _file_digest(arr_path)
        files["val_128p8.json"] = _file_digest(meta_path)
        t0 = time.perf_counter()
        scores = _scores(dicts)
        t_score = time.perf_counter() - t0
        t0 = time.perf_counter()
        int8_batches = _int8_batches(root, dicts)
        t_int8 = time.perf_counter() - t0
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, "dictionaries.json"), "w") as f:
            json.dump({"word_to_idx": dicts.word_to_idx, "answer_to_idx": dicts.answer_to_idx}, f)
        source = (f"python -m rnet.data.synth <dir> --n-train {SYNTH['n_train']} --n-val {SYNTH['n_val']} "
                  f"--style {SYNTH['style']} --seed {SYNTH['seed']}")
        with open(os.path.join(OUT, "digests.json"), "w") as f:
            json.dump({"source": source, **counts, "cache_shape": list(np.load(arr_path, mmap_mode="r").shape),
                       "files": files, "pillow": PIL.__version__, "zlib": zlib.ZLIB_VERSION,
                       "epoch119_on_clevr_v2_seed1_val": scores}, f, indent=1, sort_keys=True)
        with open(os.path.join(OUT, "int8_batches.json"), "w") as f:
            json.dump({"batch_size": EVAL_B, "answer_digits": ANSWER_DIGITS, "batches": int8_batches}, f, indent=1,
                      sort_keys=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"wrote {OUT}: {counts}, generate {t_gen:.1f} s, scores {t_score:.1f} s, int8 batches {t_int8:.1f} s: "
          f"{json.dumps(scores)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
