"""Train original-fp from scratch with the port on rnet's round-3 campaign
fixture and hold its curve to rnet's.

    python3 scripts/train_campaign_r3_torch.py --out-dir <dir>

rnet's campaign (``results/campaign_r3/``, RESULTS.md "Reference-scale
training campaign") trained original-fp on ``python -m rnet.data.synth
<dir> --n-train 70000 --n-val 15000 --style v2 --seed 1`` with
``--batch-size 256 --bs-step 30 --bs-gamma 2 --bs-max 512 --lr 2e-4
--lr-step 25 --lr-max 8e-4 --seed 1 --data-pipeline device`` (device
augmentation on) and logged its val accuracy and NLL each epoch
(``campaign_curve.csv``). This script, on one CUDA GPU:

1. writes that fixture with the port's generator (``rnet_torch.data.synth
   .generate``, the 85,000 PNGs rendered in one process per core;
   rendering draws nothing from the stream, so the files are those of
   ``python -m rnet_torch.data.synth``) into
   ``--work-dir`` and holds its four JSON files to the sha256 that rnet's
   generator gave (``tests/torch_fixtures/clevr_v2_seed1_70k/digests.json``);
2. runs ``python -m rnet_torch.train`` (its ``main``, in this process, so
   that the kernels' launch counters can be read after it) with rnet's
   recipe for ``--epochs`` epochs (12 by default), its output in
   ``<out-dir>/train.log`` and its per-epoch reports in
   ``<out-dir>/results/``;
3. writes ``<out-dir>/curve.csv``: per epoch the port's val accuracy, NLL
   and the five families (from its ``val_epochNNN_accuracy.csv``), its
   train loss, epoch seconds and train q/s (``history.json``), beside
   rnet's row of ``campaign_curve.csv``; and ``<out-dir>/summary.json``
   with the launches of each kernel over the run and the bounds: the best
   val accuracy of the epochs run >= 0.98 and epoch 5 >= 0.85 (rnet:
   0.995029 at epoch 12, 0.92184 at epoch 5). It exits 1 if a bound or a
   digest fails.

The streams differ (JAX's PRNG against Philox), so the curve is held, not
the bits. ~15-20 minutes on an H100; the fixture takes ~6 GB of disk.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import glob
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import sha256_of  # noqa: E402
from rnet_torch.data import synth  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "torch_fixtures", "clevr_v2_seed1_70k", "digests.json")
RNET_CURVE = os.path.join(REPO, "results", "campaign_r3", "campaign_curve.csv")
SYNTH = (70_000, 15_000, "v2", 1)  # n_train, n_val, style, seed
RECIPE = ["--model", "original-fp", "--batch-size", "256", "--bs-step", "30", "--bs-gamma", "2", "--bs-max", "512",
          "--lr", "2e-4", "--lr-step", "25", "--lr-max", "8e-4", "--seed", "1", "--data-pipeline", "device"]
BEST_MIN = 0.98  # best val accuracy of the epochs run
EPOCH5_MIN = 0.85  # val accuracy at epoch 5
FAMILIES = ("compare_attribute", "compare_numbers", "count", "exist", "query_attribute")


def write_fixture(root: str) -> dict:
    """The fixture, as ``python -m rnet_torch.data.synth`` writes it (the
    PNGs rendered in one process per core), its JSON files held to rnet's
    digests. Returns the counts and the digests' verdicts."""
    n_train, n_val, style, seed = SYNTH
    synth.generate(root, n_train, n_val, style=style, seed=seed, workers=os.cpu_count())
    with open(FIXTURE) as f:
        want = json.load(f)
    out = {"sha256_equal": {}}
    for split in ("train", "val"):
        for kind in ("questions", "scenes"):
            name = f"CLEVR_{split}_{kind}.json"
            path = os.path.join(root, kind, name)
            out["sha256_equal"][name] = sha256_of(path) == want["files"][name]["sha256"]
        out[f"{split}_images"] = len(os.listdir(os.path.join(root, "images", split)))
    return out


def read_metrics(path: str) -> dict:
    with open(path) as f:
        return {row["metric"]: float(row["value"]) for row in csv.DictReader(f)}


def curve(res_dir: str) -> list:
    """Per epoch the port's numbers beside rnet's campaign row."""
    with open(RNET_CURVE) as f:
        rnet = {int(r["epoch"]): r for r in csv.DictReader(f)}
    hist = {}
    if os.path.exists(os.path.join(res_dir, "history.json")):
        with open(os.path.join(res_dir, "history.json")) as f:
            hist = {h["epoch"]: h for h in json.load(f)}
    rows = []
    for path in sorted(glob.glob(os.path.join(res_dir, "val_epoch*_accuracy.csv"))):
        epoch = int(os.path.basename(path)[len("val_epoch"):][:3])
        m, r, h = read_metrics(path), rnet[epoch], hist.get(epoch, {})
        row = {"epoch": epoch, "port_val_acc": m["overall_accuracy"], "rnet_val_acc": float(r["overall_accuracy"]),
               "port_val_nll": m["mean_nll"], "rnet_val_nll": float(r["mean_nll"])}
        for fam in FAMILIES:
            row[f"port_{fam}"] = m[f"category_{fam}"]
            row[f"rnet_{fam}"] = float(r[f"category_{fam}"])
        row.update(port_train_loss=h.get("train_loss"), port_epoch_s=h.get("sec"), port_train_qps=h.get("qps"),
                   batch_size=h.get("batch_size"), lr=h.get("lr"))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--work-dir", default=None, help="the fixture and checkpoints (default: a temporary directory)")
    p.add_argument("--epochs", type=int, default=12)
    args = p.parse_args(argv)
    from rnet_torch.kernels import augment as aug
    from rnet_torch.kernels import pairwise as pw
    from rnet_torch.train.__main__ import main as train_main

    os.makedirs(args.out_dir, exist_ok=True)
    work = args.work_dir or tempfile.mkdtemp(prefix="rnet_campaign_r3_")
    summary = {"synth": list(SYNTH), "recipe": RECIPE, "epochs": args.epochs}
    try:
        root = os.path.join(work, "clevr")
        t0 = time.perf_counter()
        summary["fixture"] = write_fixture(root)
        summary["fixture"]["seconds"] = time.perf_counter() - t0
        print(f"fixture: {json.dumps(summary['fixture'])}", flush=True)
        res = os.path.join(args.out_dir, "results")
        train_argv = ["--clevr-dir", root, *RECIPE, "--epochs", str(args.epochs),
                      "--checkpoint-dir", os.path.join(work, "ck"), "--test-results-dir", res]
        pw.reset_launches()
        aug.reset_launches()
        t0 = time.perf_counter()
        with open(os.path.join(args.out_dir, "train.log"), "w", buffering=1) as log, \
                contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
            rc = train_main(train_argv)
        summary.update(train_rc=rc, train_s=time.perf_counter() - t0,
                       launches={k: v for k, v in {**pw.launches, **aug.launches}.items() if v})
        rows = curve(res)
        if rows:
            with open(os.path.join(args.out_dir, "curve.csv"), "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(rows)
        acc = {r["epoch"]: r["port_val_acc"] for r in rows}
        best = max(acc.items(), key=lambda kv: kv[1]) if acc else (None, None)
        summary.update(epochs_run=len(rows), best_epoch=best[0], best_val_acc=best[1], epoch5_val_acc=acc.get(5),
                       bounds={"best_val_acc_min": BEST_MIN, "epoch5_val_acc_min": EPOCH5_MIN})
        problems = [f"{k} differs from rnet's" for k, ok in summary["fixture"]["sha256_equal"].items() if not ok]
        if rc != 0:
            problems.append(f"python -m rnet_torch.train exited {rc}")
        if not (best[1] is not None and best[1] >= BEST_MIN):
            problems.append(f"best val accuracy {best[1]!r} below {BEST_MIN}")
        if not (acc.get(5) is not None and acc[5] >= EPOCH5_MIN):
            problems.append(f"epoch 5 val accuracy {acc.get(5)!r} below {EPOCH5_MIN}")
        summary["problems"] = problems
    finally:
        if args.work_dir is None:
            shutil.rmtree(work, ignore_errors=True)
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 1 if summary.get("problems", ["interrupted"]) else 0


if __name__ == "__main__":
    sys.exit(main())
