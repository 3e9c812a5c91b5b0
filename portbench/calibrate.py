"""Readings for the limits of a cell's checks, on the chip at the cell's size.

    python3 -m portbench.calibrate --workload <cell> --seeds <n,n,...> \
        [--controls fp8,half_batch] [--control-seeds 3] [--seconds 3]

For each seed, one JSON line: the program's readings (what a run compares
against its limits) and, for the first ``--control-seeds`` seeds, each
control's: the reference in a lower precision (``fp8``, ``fp8_int4``)
or with a fault (``half_batch``, training) put in the program's place. A cell's limit lies above the highest program reading and below the
lowest control reading (PERF.md gives both). Set-up is paid once a seed;
the serving cell runs a window of ``--seconds`` at its rate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--controls", default="", help="comma-separated: fp8, fp8_int4, half_batch")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    cell = core.resolve_cell(args.workload)
    entry = core.load_entry(cell.traffic["entry"])
    controls = [c for c in args.controls.split(",") if c]
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        run = core.Run(cell, seed, args.seconds, False, torch.device("cuda"), t0)
        got = entry.calibrate(run, controls if k < args.control_seeds else [])
        print(json.dumps({"workload": cell.name, "seed": seed, "seconds": time.time() - t0, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
