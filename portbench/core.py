"""What every cell shares: finding a cell's files by name, the checks that
decide ``correct``, the result line, and the guard against JAX.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness reads

* ``configs/<config>.json``: the widths, data sizes and source;
* ``traffic/<traffic>.json``: ``entry`` (the module under ``entries/``
  that runs the window) and the mix's parameters;
* ``limits/<cell>.json``: the limit of each number compared, with the
  readings it was set from;
* ``metrics/<metric>.py``: one reader per per-layer metric, ``read(ctx)``
  returning a number or None (nothing to read: the metric is left out);
* ``entries/<entry>.py``: the entry, ``run(run) -> Outcome``.

``later/<cell>.json`` holds a cell that runs and is checked but is not yet
in ``BENCHMARK.json`` (its ``workloads``, ``end_to_end`` and ``per_layer``
entries, in that file's form); ``with_later`` adds them, for the tests and
the sweep.

So a cell, a configuration, a mix or a per-layer metric is added by adding
files and ``BENCHMARK.json`` entries; no file already here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Any, Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
BENCHMARK = os.path.join(REPO, "BENCHMARK.json")

# Top-level module names no run may load, compared whole: the port's own
# name, rnet_torch, begins with that of the JAX package, rnet.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rnet")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: str = BENCHMARK) -> Dict[str, Any]:
    return _load_json(path)


def with_later(bench: Dict[str, Any], root: str = ROOT) -> Dict[str, Any]:
    """A copy of ``bench`` with the entries of every ``later/<cell>.json``
    added."""
    out = json.loads(json.dumps(bench))
    later = os.path.join(root, "later")
    for name in sorted(os.listdir(later)) if os.path.isdir(later) else []:
        part = _load_json(os.path.join(later, name))
        for group in ("workloads", "end_to_end", "per_layer"):
            out[group] += part.get(group, [])
    return out


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(name: str, bench: Optional[Dict[str, Any]] = None, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its files read from ``root``."""
    bench = load_benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {[w['name'] for w in bench['workloads']]}")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_load_json(os.path.join(root, "configs", f"{w['config']}.json")),
        traffic=_load_json(os.path.join(root, "traffic", f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(root, "limits", f"{name}.json")),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def _load_module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def load_entry(entry: str, root: str = ROOT):
    return _load_module(os.path.join(root, "entries", f"{entry}.py"), f"portbench_entry_{entry}")


def load_reader(metric: str, root: str = ROOT) -> Callable[[Any], Optional[float]]:
    mod = _load_module(os.path.join(root, "metrics", f"{metric}.py"), "portbench_metric_" + metric.replace(".", "_"))
    return mod.read


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})


@dataclasses.dataclass
class Check:
    """One number compared: ``value`` must not exceed ``limit`` (NaN fails)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


def checks_from(readings: Dict[str, float], limits: Dict[str, Any]) -> List[Check]:
    """Every reading that the cell's limits file holds a limit for, in its order."""
    return [Check(k, float(readings.get(k, math.nan)), float(v["limit"])) for k, v in limits.items()
            if not k.startswith("_")]


@dataclasses.dataclass
class Outcome:
    """What an entry returns: the end-to-end values it took, the work
    attempted and failed, the readings compared against the cell's limits,
    the memory peak (read before the reference runs) and, in a traced run,
    the trace's reduction (``trace.Slice``) and whatever counts its readers
    need."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    readings: Dict[str, float]
    memory_peak_bytes: int
    trace: Any = None
    counts: Dict[str, Any] = dataclasses.field(default_factory=dict)


def result_line(cell: Cell, out: Outcome, checks: List[Check], device: Dict[str, Any], traced: bool,
                per_layer: Dict[str, float], breakdown: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values = per_layer if traced else {m["name"]: out.metrics[m["name"]] for m in cell.end_to_end}
    line: Dict[str, Any] = {
        "correct": bool(checks) and all(c.ok for c in checks) and out.failed == 0,
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": {k: {"value": float(v), "unit": units[k]} for k, v in values.items()},
        "device": device,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return line


@dataclasses.dataclass
class Run:
    """One run of one cell: its seed, the window's seconds, whether it is
    traced, the device, and the wall-clock time its process started (the
    start of ``setup_s``)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
