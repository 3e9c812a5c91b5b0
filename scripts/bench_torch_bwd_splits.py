#!/usr/bin/env python3
"""Time rnet_torch's g_theta backward where the batch is smaller than the
card, and compare two checkouts of the repository on one NVIDIA GPU.

    python3 scripts/bench_torch_bwd_splits.py --tree DIR --out FILE.json
    python3 scripts/bench_torch_bwd_splits.py --compare OLD_DIR --out-dir DIR

The first form imports ``rnet_torch`` from DIR (a checkout of this
repository; the kernels are built there, under ``rnet_torch/_build``) and
times it with this checkout's ``chip_smoke.py`` functions: the backward at
``chip_smoke.BWD_ROWS`` (original-fp at B = 64 and 512, stretch-fp-32 at B
= 8 and 16, bf16 and fp32; ``time_bwd_rows``, CUDA events, with the plain
version and cuBLAS autograd beside each, "OOM" where they do not fit, and
each row's gradients held to the plain version) and stretch-fp-32's
replayed bf16 train step through rl_impl "auto" against "xla" at B = 8 and
16 (``stretch_steps``). It writes one JSON object to FILE. A tree whose
``TilePlan`` has no ``splits`` (the backward before the sample splits) is
read as one CTA a sample.

The second runs OLD_DIR, this checkout, this checkout, OLD_DIR in turn, each
as its own process on the same card, writes each run's JSON under DIR and
prints one JSON object of the four runs with the card's name and power
limit (nvidia-smi). Numbers are comparable only within one such call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py as a module (its functions import
    ``rnet_torch`` by name, so they time whichever tree is first on sys.path)."""
    spec = importlib.util.spec_from_file_location("bench_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_tree(tree: str, out: str) -> int:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_bwd_splits: torch.cuda.is_available() is False: this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smoke = _smoke()
    from rnet_torch.kernels import augment as aug
    from rnet_torch.kernels import build
    from rnet_torch.kernels import pairwise as pw

    if not pw.__file__.startswith(tree):
        raise RuntimeError(f"rnet_torch came from {pw.__file__}, not from {tree}")
    if not hasattr(pw.TilePlan, "splits"):  # a tree before the sample splits: one CTA a sample
        pw.TilePlan.splits = 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build([pw.KERNEL, pw.BWD_KERNEL, pw.F32_LIB, aug.KERNEL])
    result = {"tree": tree, "card": smoke.card_line(), "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "build_s": time.perf_counter() - t0,
              "bwd": smoke.time_bwd_rows(torch, pw, smoke.BWD_ROWS),
              "stretch_steps": smoke.stretch_steps(torch, pw, aug, n_answers=28)}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


def compare(old: str, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for k, (tag, tree) in enumerate((("old", old), ("new", HERE), ("new", HERE), ("old", old))):
        out = os.path.join(out_dir, f"run{k}_{tag}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree, "--out", out]
        t0 = time.perf_counter()
        rc = subprocess.run(cmd).returncode
        print(f"run {k} ({tag}, {tree}): exit {rc} in {time.perf_counter() - t0:.1f} s", flush=True)
        if rc != 0:
            return rc
        with open(out) as f:
            runs.append({"tag": tag, **json.load(f)})
    summary = {"card": runs[0]["card"], "order": [r["tag"] for r in runs], "runs": runs}
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", help="the checkout whose rnet_torch is timed")
    p.add_argument("--out", help="JSON file of one run")
    p.add_argument("--compare", metavar="OLD_DIR", help="run OLD_DIR, this checkout, this checkout, OLD_DIR")
    p.add_argument("--out-dir", default=os.path.join(HERE, "rnet_torch", "_build", "bench_bwd_splits"),
                   help="where --compare writes each run's JSON")
    args = p.parse_args(argv)
    if args.compare:
        return compare(args.compare, args.out_dir)
    if not (args.tree and args.out):
        p.error("--tree and --out, or --compare")
    return run_tree(args.tree, args.out)


if __name__ == "__main__":
    sys.exit(main())
