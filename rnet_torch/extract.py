"""Extract g_theta relational image features with the port: ``python -m rnet_torch.extract``.

Port of the top-level ``extract.py``, with the same flags and a
``main(argv)`` that returns the exit code: load an ``ir`` model (the
question joins g_theta at layer p >= 1; p = 0 exits 2), run every image of
``--split`` through the question-independent prefix of g_theta
(``RN.extract``: the eval-mode objects, g layers 0 .. p-1, summed over
pairs) and write one feature row per image, in file-name order, to
``<features-dirs>/<model>_<split>_gfeatures.pkl`` (``features``,
``filenames``) and, where ``h5py`` imports, the same into a ``.h5``.
From-pixels models read the split's PNGs (eval transform); state-description
models take one row per scene of ``scenes/CLEVR_<split>_scenes.json``.
``--checkpoint`` takes a weights-only ``.pkl`` exported by either package,
or one of the port's own epoch checkpoints (a path, or an epoch number
under ``--checkpoint-dir``); rnet's orbax directories raise (ROADMAP.md).
Runs on CUDA unless ``--platform cpu`` is given; without a card it raises.

Example:
    python -m rnet_torch.extract --clevr-dir /data/CLEVR_v1.0 --model ir-fp \\
        --checkpoint 200 --checkpoint-dir model --features-dirs features --split val
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys


def parse_args(argv=None) -> argparse.Namespace:
    from .cli import add_common_args

    p = argparse.ArgumentParser(prog="python -m rnet_torch.extract", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument(
        "--checkpoint", required=True,
        help="the port's epoch checkpoint (path or epoch number) or a weights-only .pkl export",
    )
    p.add_argument("--checkpoint-dir", default="model")
    p.add_argument("--features-dirs", default="features", help="output directory")
    p.add_argument("--split", default="val")
    return p.parse_args(argv)


class _SceneDataset:
    """One item per scene: its object vectors and its index."""

    def __init__(self, objects):
        self.objects = objects

    def __len__(self) -> int:
        return len(self.objects)

    def __getitem__(self, i: int, rng=None):
        import numpy as np

        return {"objects": self.objects[i], "index": np.int32(i)}


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np

    from .checkpoint import load_weights
    from .cli import config_from_args, device_from_args, load_dicts, refuse_mesh
    from .data.clevr import ClevrImageDataset, scene_to_objects
    from .data.pipeline import BatchIterator, prefetch_to_device
    from .models import RN
    from .serve import resolve_device
    from .train.checkpoint import CheckpointManager

    refuse_mesh(args, "extraction")
    dicts = load_dicts(args, checkpoint=args.checkpoint, checkpoint_dir=args.checkpoint_dir)
    cfg = config_from_args(args, dicts)
    if cfg.question_injection_position < 1:
        print(
            f"error: model {cfg.name!r} injects the question at g layer 0; "
            "feature extraction needs an 'ir' model (injection >= 1)",
            file=sys.stderr,
        )
        return 2
    device = resolve_device(device_from_args(args))

    if cfg.state_description:
        # one row per IMAGE: the scenes themselves (the question dataset
        # would repeat each image ~10x)
        with open(os.path.join(args.clevr_dir, "scenes", f"CLEVR_{args.split}_scenes.json")) as f:
            scenes = json.load(f)["scenes"]
        names = [s["image_filename"] for s in scenes]
        ds = _SceneDataset(np.stack([scene_to_objects(s["objects"], cfg.max_objects, cfg.object_dim) for s in scenes]))
        key = "objects"
    else:
        ds = ClevrImageDataset(args.clevr_dir, args.split, image_size=cfg.image_size)
        names = list(ds.files)
        key = "image"

    model = RN(cfg, dicts.vocab_size).to(device)
    ck = str(args.checkpoint)
    if ck.endswith(".pkl"):
        load_weights(model, ck)
    else:
        CheckpointManager(args.checkpoint_dir, cfg.name).restore_weights(model, int(ck) if ck.isdigit() else ck)

    feats, order = [], []
    it = BatchIterator(ds, args.batch_size, drop_last=False, invert=False, num_threads=args.num_workers)
    for batch in prefetch_to_device(iter(it), device):
        out = model.extract(batch[key]).cpu().numpy()
        valid = batch["valid"].cpu().numpy()
        feats.append(out[valid])
        order.extend(batch["index"].cpu().numpy()[valid].tolist())
    features = np.concatenate(feats, axis=0)
    if order != list(range(len(ds))):  # feature rows must align with `names`
        raise RuntimeError("extraction batches arrived out of order")

    os.makedirs(args.features_dirs, exist_ok=True)
    out_pkl = os.path.join(args.features_dirs, f"{cfg.name}_{args.split}_gfeatures.pkl")
    with open(out_pkl, "wb") as f:
        pickle.dump({"features": features, "filenames": names[: len(features)]}, f)
    out_h5 = None
    try:
        import h5py
    except ImportError:
        h5py = None
    if h5py is not None:
        out_h5 = os.path.join(args.features_dirs, f"{cfg.name}_{args.split}_gfeatures.h5")
        with h5py.File(out_h5, "w") as f:
            f.create_dataset("features", data=features)
            f.create_dataset("filenames", data=np.asarray(names[: len(features)], dtype=object),
                             dtype=h5py.string_dtype())
    print(f"extracted {features.shape} features -> {out_pkl}" + (f", {out_h5}" if out_h5 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
