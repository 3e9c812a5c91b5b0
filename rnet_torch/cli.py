"""Shared CLI plumbing of the port's entry points.

Port of ``rnet/cli.py``: ``add_common_args`` with the same flag names (so a
command line carries across), ``config_from_args``, ``build_datasets`` and
``load_dicts`` (dictionaries carried by the checkpoint, messages on stderr
only: serve's stdout is a JSON-lines protocol). ``--platform`` picks the
device: ``default`` is CUDA, ``cpu`` the opt-in; a missing card raises
instead of falling back. Flags of surfaces not ported yet (``--mesh``) raise.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict

from .config import DEFAULT_CONFIG_PATH, ModelConfig, load_config
from .data.clevr import ClevrDataset, ClevrDatasetStateDescription
from .data.vocab import Dictionaries, build_dictionaries


def add_common_args(p: argparse.ArgumentParser, clevr_required: bool = True) -> None:
    p.add_argument("--clevr-dir", required=clevr_required, default=None, help="CLEVR_v1.0 root directory")
    p.add_argument("--model", default="original-fp", help="config.json model name")
    p.add_argument("--config", default=DEFAULT_CONFIG_PATH, help="config.json path")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--num-workers", type=int, default=8, help="decode threads")
    p.add_argument(
        "--invert-questions", dest="invert", action="store_true", default=True,
        help="reverse question token order (default on, as in the reference)",
    )
    p.add_argument("--no-invert-questions", dest="invert", action="store_false")
    p.add_argument(
        "--oov", choices=["error", "unk", "drop"], default="error",
        help="out-of-vocabulary question words: error (default), unk, drop",
    )
    # config overrides
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument(
        "--question-injection", type=int, default=None, dest="question_injection_position",
        help="g layer index where the question is concatenated",
    )
    p.add_argument("--pair-dropout", type=float, default=None, dest="pair_dropout")
    p.add_argument("--pair-pool", choices=["sum", "mean"], default=None, dest="pair_pool")
    p.add_argument("--object-mask", dest="object_mask", action="store_true", default=None)
    p.add_argument(
        "--lstm-pad-drift", dest="lstm_mask_pads", action="store_false", default=None,
        help="run the LSTM over pad steps like the reference",
    )
    p.add_argument("--precision", choices=["bfloat16", "float32"], default=None, dest="compute_dtype")
    p.add_argument(
        "--rl-impl", choices=["auto", "naive", "xla", "pallas", "pallas_int8"], default=None,
        dest="rl_impl",
        help="pairwise-core implementation: auto (default), naive, xla (decomposed "
        "torch), pallas (the CUDA kernel; plain version on the CPU); pallas_int8 "
        "is not ported yet",
    )
    p.add_argument("--mesh", default=None, help="multi-device mesh (not ported yet)")
    p.add_argument(
        "--platform", choices=["default", "cpu"], default="default",
        help="default: run on CUDA (raises without a card); cpu: run on the CPU",
    )
    p.add_argument("--data-pipeline", choices=["pil", "cached", "device"], default="pil")
    p.add_argument("--device-augment", dest="device_augment", action=argparse.BooleanOptionalAction, default=None)
    p.add_argument("--augment-impl", choices=["auto", "pallas", "xla"], default=None, dest="augment_impl")


def device_from_args(args: argparse.Namespace) -> str:
    return "cpu" if getattr(args, "platform", "default") == "cpu" else "cuda"


def config_from_args(args: argparse.Namespace, dicts: Dictionaries) -> ModelConfig:
    if getattr(args, "mesh", None):
        raise SystemExit("--mesh: multi-GPU runs come with a later slice of the port")
    overrides = {
        k: getattr(args, k, None)
        for k in (
            "dropout", "question_injection_position", "pair_dropout", "pair_pool",
            "object_mask", "lstm_mask_pads", "compute_dtype", "rl_impl",
            "device_augment", "augment_impl",
        )
    }
    if getattr(args, "data_pipeline", "pil") in ("cached", "device") and overrides.get("device_augment") is None:
        overrides["device_augment"] = True
    cfg = load_config(args.model, args.config, overrides)
    return cfg.replace(n_answers=dicts.n_answers)


def build_datasets(args: argparse.Namespace, cfg: ModelConfig, dicts: Dictionaries) -> Dict[str, Any]:
    """The train and val datasets for ``--data-pipeline``: per-item PNG
    decode (``pil``), or the decoded cache (``cached``; ``device`` also
    serves image indices for the device-resident Trainer). With
    ``device_augment`` the cached canvases ship padded for the on-device
    crop, and the ``pil`` transform leaves the rotation to the device."""
    out = {}
    pipeline = getattr(args, "data_pipeline", "pil")
    for split in ("train", "val"):
        train_tf = split == "train"
        if cfg.state_description:
            out[split] = ClevrDatasetStateDescription(
                args.clevr_dir, split, dicts, max_objects=cfg.max_objects, object_dim=cfg.object_dim,
                question_max_len=cfg.question_max_len,
            )
        elif pipeline in ("cached", "device"):
            from .data.cache import CachedClevrDataset

            out[split] = CachedClevrDataset(
                args.clevr_dir, split, dicts, image_size=cfg.image_size, question_max_len=cfg.question_max_len,
                train_transform=train_tf, serve_padded=cfg.device_augment, serve_indices=(pipeline == "device"),
            )
        else:
            out[split] = ClevrDataset(
                args.clevr_dir, split, dicts, image_size=cfg.image_size, question_max_len=cfg.question_max_len,
                train_transform=train_tf, max_rot_deg=0.0 if cfg.device_augment else 2.8,
            )
    return out


def load_dicts(args: argparse.Namespace, checkpoint=None, checkpoint_dir=None) -> Dictionaries:
    """Dictionaries carried by the checkpoint (pkl ``dicts`` or the run's
    sidecar JSON), else built from ``--clevr-dir``.

    Word/answer ids follow first-seen data order, so a regenerated data dir
    permutes them; the carried maps keep the answer head's ids."""
    from .checkpoint import load_exported_dicts, load_run_dicts

    oov = getattr(args, "oov", "error")
    if checkpoint is not None:
        carried, src = None, None
        ck = str(checkpoint)
        if ck.endswith(".pkl") and os.path.exists(ck):
            carried, src = load_exported_dicts(ck), ck
        else:
            if os.path.isdir(ck):
                carried = load_run_dicts(os.path.dirname(ck), args.model)
                src = os.path.dirname(ck)
            if carried is None and checkpoint_dir is not None:
                carried = load_run_dicts(checkpoint_dir, args.model)
                src = checkpoint_dir
        if carried is not None:
            w2i, a2i = carried
            print(
                f"dictionaries: carried by checkpoint ({src}; {len(w2i)} words, {len(a2i)} answers)",
                file=sys.stderr,
            )
            return Dictionaries(w2i, a2i, oov=oov)
        print(
            "WARNING: checkpoint carries no dictionaries — word/answer indices "
            "come from --clevr-dir; if this is not the original training data, "
            "accuracy is meaningless (index permutation).",
            file=sys.stderr,
        )
    if getattr(args, "clevr_dir", None) is None:
        raise SystemExit(
            "no dictionaries available: the checkpoint carries none and no "
            "--clevr-dir was given to rebuild them from training data"
        )
    return build_dictionaries(args.clevr_dir, oov=oov)
