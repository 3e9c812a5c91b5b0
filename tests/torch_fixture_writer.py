"""Write ``tests/torch_fixtures/``: an rnet epoch directory at full width.

    JAX_PLATFORMS=cpu python tests/torch_fixture_writer.py

``original-fp`` at full width (128x128 images, g_theta 4 x 256, f_phi
256 -> 256 -> 28), saved as epoch 1 by rnet's own ``CheckpointManager``
after two ``train_step``s of rnet's Trainer optimizer, with the
dictionaries of the synthetic CLEVR directory that ``chip_smoke.py``
writes (seed 5, its phase-10 directory), which the manager records in its
sidecar. ``digests.json`` records every leaf of
``ocp.StandardCheckpointer().restore`` (dtype, shape, sha256 of its bytes
in C order), keyed by its tree path joined with ".".

The fixture is committed, and the repository's tree has to stay small
(under 1.2 MiB of room was left), so the state is built to compress, with
every shape and the format as a run's:

- each parameter leaf is its seeded initial values (``jax.random.key(5)``)
  repeated with a period of ``PERIOD`` elements, which zstd stores about
  once (the last f_phi kernel also scaled by ``LOGIT_SCALE``);
- the two steps take, as labels, the model's own predictions on one
  seeded batch of two noise images (dropout off), where every logit margin
  exceeds 104, so the loss and its gradient are exactly zero; the
  optimizer is the Trainer's chain (clip at 50, ``add_decayed_weights``,
  injected Adam) with ``WEIGHT_DECAY`` = 2^-10 and LR 0, so each gradient
  is 2^-10 x the parameter: Adam's moments are nonzero and as periodic
  as the parameters, the count is 2, the parameters stay as built, and
  the BatchNorm statistics move as in training.

``tests/test_torch_orbax.py`` reads the directory back with the port's
reader against the digests and the dictionaries; ``chip_smoke.py`` phase 14
evaluates, serves and resumes training from it on the card (the LR then
comes from the run's schedule). Run this again only to change the fixture:
orbax's files differ from run to run (ids, timestamps), the digests do not.
"""

import hashlib
import json
import os
import shutil
import sys
import tempfile
from functools import partial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402

import chip_smoke  # noqa: E402
from rnet.config import load_config  # noqa: E402
from rnet.data.vocab import build_dictionaries  # noqa: E402
from rnet.models import RN  # noqa: E402
from rnet.train.checkpoint import CheckpointManager  # noqa: E402
from rnet.train.loop import make_injected_optimizer  # noqa: E402
from rnet.train.steps import create_train_state, train_step  # noqa: E402

OUT = os.path.join(REPO, "tests", "torch_fixtures")
MODEL = "original-fp"
SEED = 5  # chip_smoke.py's phase-10 directory: write_synthetic_clevr(np, root, seed=5)
EPOCH = 1
STEPS = 2
B = 2
PERIOD = 257  # elements; prime, so no matrix row repeats another
LOGIT_SCALE = 256.0  # on the last f_phi kernel: margins above 104 at every sample
WEIGHT_DECAY = 2.0**-10


def leaf_digests(tree) -> dict:
    out = {}

    def walk(node, where):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, where + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, where + (str(i),))
        elif node is not None:
            a = np.asarray(node)
            out[".".join(where)] = {"dtype": str(a.dtype), "shape": list(a.shape),
                                    "sha256": hashlib.sha256(a.tobytes()).hexdigest()}

    walk(tree, ())
    return out


def periodic(leaf):
    flat = np.asarray(leaf).ravel()
    return np.resize(flat[:PERIOD], flat.size).reshape(np.shape(leaf))


def main() -> int:
    tmp = tempfile.mkdtemp(prefix="rnet_fixture_")
    try:
        chip_smoke.write_synthetic_questions(np, tmp, SEED)
        dicts = build_dictionaries(tmp, use_cache=False)
    finally:
        shutil.rmtree(tmp)
    cfg = load_config(MODEL).replace(n_answers=dicts.n_answers)
    model = RN(cfg=load_config(MODEL).replace(n_answers=dicts.n_answers, dropout=0.0), vocab_size=dicts.vocab_size)
    opt = make_injected_optimizer(0.0, 50.0, WEIGHT_DECAY)
    rs = np.random.RandomState(SEED)
    batch = {"image": jnp.asarray(rs.randint(0, 256, (B, cfg.image_size, cfg.image_size, 3)).astype(np.uint8)),
             "question": jnp.asarray(rs.randint(1, dicts.vocab_size, (B, cfg.question_max_len)).astype(np.int32)),
             "answer": jnp.zeros((B,), jnp.int32)}
    state = create_train_state(model, cfg, opt, jax.random.key(SEED), batch)
    params = jax.tree.map(periodic, state.params)
    last = f"f{len(cfg.f_layers)}_kernel"
    params["relational"][last] = params["relational"][last] * LOGIT_SCALE
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    logp, _ = model.apply({"params": state.params, "batch_stats": state.batch_stats}, batch["image"],
                          batch["question"], train=True, mutable=["batch_stats"])
    top2 = np.sort(np.asarray(logp), axis=-1)[:, -2:]
    print("logit margins", top2[:, 1] - top2[:, 0])
    assert (top2[:, 1] - top2[:, 0] > 110).all(), "margins too small for an exactly zero loss gradient"
    batch["answer"] = jnp.asarray(np.asarray(logp).argmax(-1).astype(np.int32))
    step = jax.jit(partial(train_step, model=model, cfg=cfg, optimizer=opt))
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        print({k: float(v) for k, v in metrics.items()})
        assert float(metrics["loss"]) == 0.0 and float(metrics["grad_norm"]) == 0.0
    # only this writer's files: the directory holds other fixtures too
    shutil.rmtree(os.path.join(OUT, f"{MODEL}_epoch_{EPOCH:03d}"), ignore_errors=True)
    for name in (f"{MODEL}_dictionaries.json", "digests.json"):
        if os.path.exists(os.path.join(OUT, name)):
            os.remove(os.path.join(OUT, name))
    path = CheckpointManager(OUT, MODEL, dicts=dicts).save(state, EPOCH)
    leaves = leaf_digests(ocp.StandardCheckpointer().restore(path))
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump({"epoch": os.path.basename(path), "model": MODEL, "steps": STEPS, "synthetic_seed": SEED,
                   "leaves": leaves}, f, indent=1, sort_keys=True)
    size = sum(os.path.getsize(os.path.join(r, n)) for r, _, fs in os.walk(path) for n in fs)
    print(f"wrote {path}: {len(leaves)} leaves, {size} bytes in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
