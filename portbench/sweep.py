"""The knee of the serving cell: the highest offered rate at which answered
requests keep up with arrivals and the backlog does not grow.

    python3 -m portbench.sweep --workload ofp.serve.poisson --seed <n> \
        --rates 100,150,200 [--seconds 10]

One server is set up; each rate runs the cell's open-loop window for
``--seconds`` and prints one JSON line: requests offered, the share
answered by the window's close, p50 and p95 latency (from when each was
due), how long the backlog took to drain after the close, and the growth
of latency over the window (the median of the last fifth of requests over
that of the first half). A rate keeps up where nearly all is answered by
the close and latency does not grow. The cell's rate is written into its
traffic file; the serving cell is one of ``later/`` (``core.with_later``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from portbench import core  # noqa: E402
from portbench.trace import Tracer  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.sweep", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", default="ofp.serve.poisson")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True, help="comma-separated requests/s")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    cell = core.resolve_cell(args.workload, core.with_later(core.load_benchmark()))
    entry = core.load_entry(cell.traffic["entry"])
    st = entry.prepare(core.Run(cell, args.seed, args.seconds, False, torch.device(args.device), time.time()))
    for rate in (float(r) for r in args.rates.split(",")):
        res = entry.window(st, rate, args.seconds, Tracer(False), stream=f"sweep{rate}")
        lat, n = res["latency_ms"], res["requests"]
        answered = float(np.mean(res["done_at"] <= args.seconds))
        growth = float(np.median(lat[-max(1, n // 5):]) / np.median(lat[: max(1, n // 2)]))
        print(json.dumps({"rate_per_s": rate, "offered": n, "answered_by_close": answered,
                          "p50_ms": res["serve_p50_ms"], "p95_ms": res["p95_ms"], "failed": res["failed"],
                          "drain_s": max(0.0, float(np.nanmax(res["done_at"])) - args.seconds),
                          "latency_growth": growth, "batches": len(st.batches),
                          "batch_mean": float(np.mean(st.batches))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
