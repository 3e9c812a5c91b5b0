"""Run one cell of the benchmark of ``rnet_torch`` once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for (``BENCHMARK.json``). The cell's entry (``entries/``) sets
up from the seed, warms every shape the window uses, measures for
``--seconds``, then checks what the timed path produced against the plain
reference (``reference.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.

It exits with another code than 0 and prints no result when CUDA is not
available or has fewer devices than the cell asks for (3), when the port
cannot be imported (4), and when a module of JAX or of the JAX package
``rnet`` is loaded once the window has closed (5).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

if __package__ in (None, ""):  # run as a script: make the checkout importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import core  # noqa: E402

T_IMPORT = time.time()


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else the time
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(cell: core.Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Run ``cell`` once on ``device`` and return its result line (the chip
    look is the caller's: the tests run this on the CPU at tiny sizes)."""
    import torch

    from portbench import readers

    entry = core.load_entry(cell.traffic["entry"])
    out = entry.run(core.Run(cell, seed, seconds, trace, torch.device(device), t_start))
    checks = core.checks_from(out.readings, cell.limits)
    dev = torch.device(device)
    info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    per_layer, breakdown = {}, None
    if trace:
        ctx = readers.Context(cell, out.trace, out.counts)
        for m in cell.per_layer:
            v = core.load_reader(m["name"])(ctx)
            if v is not None:
                per_layer[m["name"]] = v
        if out.trace is not None:
            info["busy_s"] = out.trace.busy_s()
            info["window_s"] = out.trace.window_s
            breakdown = {"device_ops": out.trace.top_ops(10), "idle_gaps": out.trace.idle_gaps(10)}
    line = core.result_line(cell, out, checks, info, trace, per_layer, breakdown)
    for c in line["checks"].values():
        c["value"] = _finite(c["value"])
    return line


def main(argv=None) -> int:
    t_start = process_start()
    args = parse_args(argv)
    cell = core.resolve_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 3
    try:
        import rnet_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port cannot be imported: {e}", file=sys.stderr)
        return 4
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    print(f"portbench: {cell.name} seed {args.seed} on {power_limit()}, torch {torch.__version__}", file=sys.stderr)
    found = core.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: neither JAX nor the JAX package may run here", file=sys.stderr)
        return 5
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
