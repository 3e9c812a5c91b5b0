"""Evaluate a trained Relation Network with the port: ``python -m rnet_torch.evaluate``.

Port of the top-level ``test.py``, with the same flags and a ``main(argv)``
that returns the exit code: load the checkpoint (the dictionaries it
carries first), run one split (``--split``, default ``val``) with the
deterministic eval transform, print overall, per-question-family and
per-answer-class accuracy, and dump the reports (``<split>_accuracy.csv``,
``<split>_confusion.csv``) into ``--test-results-dir``. ``--checkpoint``
takes a weights-only ``.pkl`` exported by either package, or an epoch
checkpoint of either package (a path, or an epoch number under
``--checkpoint-dir``: the port's file or rnet's orbax directory). Under
``--rl-impl pallas_int8`` the g-chain runs in int8 and the per-layer int8
calibration clip fractions of the first batch are printed first. Runs on
CUDA unless ``--platform cpu`` is given; without a card it raises. Under
torchrun (one process per GPU, ``--mesh`` as ``rnet_torch.train`` takes
it) every rank evaluates its ``data`` share of the split, the outputs are
gathered, and rank 0 prints and writes the reports.

Example:
    python -m rnet_torch.evaluate --clevr-dir /data/CLEVR_v1.0 --model original-fp \\
        --checkpoint 200 --checkpoint-dir model --data-pipeline device --rl-impl pallas_int8
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None) -> argparse.Namespace:
    from .cli import add_common_args

    p = argparse.ArgumentParser(prog="python -m rnet_torch.evaluate", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument(
        "--checkpoint", required=True,
        help="an epoch checkpoint of the port or rnet (path or epoch number) or a weights-only .pkl export",
    )
    p.add_argument("--checkpoint-dir", default="model")
    p.add_argument("--test-results-dir", default="results")
    p.add_argument("--split", default="val")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from .cli import device_from_args
    from .parallel.mesh import distributed_init

    joined = distributed_init(device_from_args(args))
    try:
        return _evaluate(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _evaluate(args) -> int:
    from .checkpoint import load_weights
    from .cli import build_datasets, config_from_args, device_from_args, load_dicts
    from .train.loop import Trainer
    from .train.schedules import DoublingSchedule

    dicts = load_dicts(args, checkpoint=args.checkpoint, checkpoint_dir=args.checkpoint_dir)
    cfg = config_from_args(args, dicts)
    # only the requested split, with the eval transform even for --split train
    ds = build_datasets(args, cfg, dicts, splits=(args.split,), eval_only=True)
    trainer = Trainer(
        cfg, dicts.vocab_size, ds[args.split], ds[args.split], dicts,
        lr=DoublingSchedule(1e-4), bs=DoublingSchedule(args.batch_size, 1.0, 0), seed=args.seed,
        invert=args.invert, num_threads=args.num_workers, checkpoint_dir=args.checkpoint_dir,
        log_interval=args.log_interval, device_data=(args.data_pipeline == "device"),
        device=device_from_args(args), mesh_spec=args.mesh,
    )
    say = print if trainer.primary else (lambda *a, **k: None)
    ck = str(args.checkpoint)
    if ck.endswith(".pkl"):
        load_weights(trainer.state.model, ck)
    else:  # weights only: eval needs no optimizer state
        trainer.restore_weights(int(ck) if ck.isdigit() else ck)

    if cfg.rl_impl == "pallas_int8":
        # calibration-drift receipt: the share of probe activations per layer
        # that would clip at 127 under this batch's int8 scales
        fr = trainer.int8_clip_report(batch_size=min(args.batch_size, 256))
        say("int8 calibration clip fractions per layer: [" + ", ".join(f"{f:.2e}" for f in fr) + "]")
        if float(fr.max()) > 1e-3:
            say(
                "WARNING: clip fraction > 1e-3 — the 1.2x calibration margin "
                "is being exceeded; int8 accuracy may drift on this data"
            )

    stats = trainer.eval_epoch(trainer.epoch, batch_size=args.batch_size)
    acc = stats.pop("_accumulator")
    if not trainer.primary:
        return 0
    paths = acc.dump(args.test_results_dir, tag=args.split)
    print(f"overall accuracy: {acc.accuracy:.4f} | mean NLL: {acc.mean_nll:.4f}")
    cat = acc.per_category_accuracy()
    if cat:  # the reference test.py's table: accuracy per question family
        print("per question category:")
        for c, v in sorted(cat.items()):
            print(f"  {c:18s}: {v:.4f}")
    print("per answer class:")
    for cls, v in sorted(acc.per_class_accuracy().items()):
        print(f"  {cls:10s}: {v:.4f}")
    print(f"reports: {paths}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
