"""Train a Relation Network on CLEVR with the port: ``python -m rnet_torch.train``.

Port of the top-level ``train.py``, with the same flags and a ``main(argv)``
that returns the exit code: config selection, LR and batch-size doubling,
per-epoch eval with reports and a full-state checkpoint, ``--resume``
(a path, an epoch number or ``latest``), ``history.json`` under
``--test-results-dir``, the stall watchdog and ``--auto-restart``
supervision. Runs on CUDA unless ``--platform cpu`` is given; without a card
it raises.

Several GPUs: one process per GPU, launched by torchrun, whose environment
the run joins (NCCL on CUDA, gloo with ``--platform cpu``); ``--mesh``
lays the processes out (default: all on ``data``), ``--multihost`` insists
on that environment. Rank 0 prints, writes checkpoints, reports and
``history.json``.

Examples:
    python -m rnet_torch.train --clevr-dir /data/CLEVR_v1.0 --model original-fp \\
        --data-pipeline device --batch-size 512 --epochs 400 --lr 1e-4 --lr-max 5e-4
    python -m torch.distributed.run --nproc-per-node 8 -m rnet_torch.train \\
        --clevr-dir /data/CLEVR_v1.0 --data-pipeline device --batch-size 512 --mesh data:4,pairs:2
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    from ..cli import add_common_args

    p = argparse.ArgumentParser(prog="python -m rnet_torch.train", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-gamma", type=float, default=2.0)
    p.add_argument("--lr-step", type=int, default=20, help="epochs between LR doublings (0: constant)")
    p.add_argument("--lr-max", type=float, default=5e-4)
    p.add_argument("--bs-gamma", type=float, default=1.0)
    p.add_argument("--bs-step", type=int, default=0, help="epochs between batch-size doublings (0: constant)")
    p.add_argument("--bs-max", type=int, default=None)
    p.add_argument("--clip-norm", type=float, default=50.0)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--resume", default=None, help="checkpoint path, epoch number, or 'latest'")
    p.add_argument("--checkpoint-dir", default="model")
    p.add_argument(
        "--keep-checkpoints", type=int, default=0,
        help="delete all but the newest N checkpoints (0, the default, keeps every epoch)",
    )
    p.add_argument("--test-results-dir", default=None)
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--save-every", type=int, default=1)
    p.add_argument(
        "--multihost", action="store_true",
        help="join the process group of torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, "
        "MASTER_PORT) and fail without it; torchrun's runs join it anyway",
    )
    p.add_argument("--tb-dir", default=None, help="TensorBoard/CSV scalar log dir")
    p.add_argument("--profile-dir", default=None, help="write a torch.profiler trace of one epoch here")
    p.add_argument("--profile-epoch", type=int, default=1)
    p.add_argument(
        "--stall-timeout", type=float, default=0.0,
        help="seconds without training progress before the process hard-exits "
        "for a supervised restart (0: off); pick a value above the longest "
        "legitimate gap (kernel builds, a large cache upload)",
    )
    p.add_argument(
        "--auto-restart", type=int, default=0,
        help="supervise training: relaunch with --resume latest up to N times "
        "whenever the run exits on a detected stall (use with --stall-timeout)",
    )
    return p.parse_args(argv)


def _resume_target(trainer, resume: str, say=print):
    if str(resume) == "latest":
        latest = trainer.ckpt.latest_epoch()
        if latest is None:
            say("no checkpoint found for --resume latest; starting fresh")
        return latest
    return int(resume) if str(resume).isdigit() else resume


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.auto_restart > 0:
        # supervisor: the child does the work; this process watches exit codes
        from ..utils.watchdog import strip_flag, supervise

        child_argv = strip_flag(list(sys.argv[1:]) if argv is None else list(argv), "--auto-restart")
        if args.stall_timeout <= 0:
            print(
                "WARNING: --auto-restart without --stall-timeout: stalls are never "
                "detected; restarts only follow stall exits of a watchdog-enabled child"
            )
        return supervise([sys.executable, "-m", "rnet_torch.train"] + child_argv, max_restarts=args.auto_restart)
    if args.multihost and "WORLD_SIZE" not in os.environ:
        raise SystemExit(
            "--multihost: no process group to join: launch one process per GPU with "
            "python -m torch.distributed.run --nproc-per-node N -m rnet_torch.train ..."
        )
    from ..cli import device_from_args
    from ..parallel.mesh import distributed_init

    joined = distributed_init(device_from_args(args))
    try:
        return _train(args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args) -> int:
    from ..cli import build_datasets, config_from_args, device_from_args, load_dicts
    from ..parallel.mesh import process_rank
    from .loop import Trainer
    from .schedules import DoublingSchedule

    say = print if process_rank() == 0 else (lambda *a, **k: None)
    dicts = load_dicts(args)
    cfg = config_from_args(args, dicts)
    say(f"model: {cfg.name} | vocab {dicts.vocab_size} | answers {dicts.n_answers}")
    say(f"config: {cfg}")
    ds = build_datasets(args, cfg, dicts)

    watchdog = None
    if args.stall_timeout > 0:
        from ..utils.watchdog import Watchdog

        watchdog = Watchdog(args.stall_timeout).start()
        say(f"stall watchdog armed: {args.stall_timeout:.0f}s")
    try:
        trainer = Trainer(
            cfg, dicts.vocab_size, ds["train"], ds["val"], dicts,
            lr=DoublingSchedule(args.lr, args.lr_gamma, args.lr_step, args.lr_max),
            bs=DoublingSchedule(args.batch_size, args.bs_gamma, args.bs_step, args.bs_max),
            clip_norm=args.clip_norm, weight_decay=args.weight_decay, seed=args.seed, invert=args.invert,
            num_threads=args.num_workers, checkpoint_dir=args.checkpoint_dir,
            keep_checkpoints=args.keep_checkpoints, log_interval=args.log_interval, tb_dir=args.tb_dir,
            profile_dir=args.profile_dir, profile_epoch=args.profile_epoch,
            device_data=(args.data_pipeline == "device"), watchdog=watchdog, device=device_from_args(args),
            mesh_spec=args.mesh,
        )
        if args.resume is not None:
            target = _resume_target(trainer, args.resume, say)
            if target is not None:
                epoch = trainer.resume(target)
                say(f"resumed from {args.resume} (epoch {epoch})")
        history = trainer.fit(
            args.epochs, eval_every=args.eval_every, save_every=args.save_every, results_dir=args.test_results_dir
        )
    finally:
        if watchdog is not None:
            watchdog.stop()
    if args.test_results_dir and trainer.primary:
        os.makedirs(args.test_results_dir, exist_ok=True)
        with open(os.path.join(args.test_results_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=2)
    if history:
        last = history[-1]
        say(
            f"done: epoch {last['epoch']} train_loss {last['train_loss']:.4f}"
            + (f" val_acc {last['val_acc']:.4f}" if "val_acc" in last else "")
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
