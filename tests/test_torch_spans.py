"""The port's spans (``rnet_torch.utils.profiling.span``) on the CPU.

A shrunk original-fp ``Trainer`` over device-resident data, its chunked
steps dispatched through ``StepGraphs`` on a fake capture backend (no card
here: ``capture`` runs the step once, ``replay`` runs nothing), so every
span site runs: the loop's ``rn.train.*``, the eval epoch's ``rn.eval.*``
and the dispatch's ``rn.graph.*``.

* With no profiler running, an epoch enters no ``record_function``,
  creates no CUDA event and records nothing.
* Under a CPU ``torch.profiler``, the operator's trace (``profile_trace``)
  holds the ``rn.*`` ranges, nested as the spans are; the records name the
  same nesting, one ``rn.graph.run`` a chunk with its three children, a
  capture only for a cold key, the eval epoch's edges once each.
* ``profile_trace`` clears the records on entry; ``device=True`` records no
  event without CUDA.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from rnet_torch.config import load_config
from rnet_torch.data.vocab import Dictionaries
from rnet_torch.train import graphs as tgraphs
from rnet_torch.train import steps as tsteps
from rnet_torch.train.loop import Trainer
from rnet_torch.train.schedules import DoublingSchedule
from rnet_torch.utils import profiling

torch.set_num_threads(1)

V = 40
B = 4
K = 2  # the Trainer's log_interval: steps (or eval batches) a chunk
CHUNKS = 3
N = CHUNKS * K * B
IMG, CANVAS = 32, 48
SHRUNK = dict(image_size=IMG, g_layers=(32,) * 4, f_layers=(32, 32), lstm_hidden=16, lstm_word_emb=8,
              question_max_len=12, dropout=0.0, pair_dropout=0.0, device_augment=False)

GRAPH_CHILDREN = ("graph.copy_in", "graph.replay", "graph.copy_out")
NESTED = [(c, "graph.run") for c in GRAPH_CHILDREN] + [("train.fetch_wait", "train.fetch"),
                                                       ("train.log", "train.fetch")]


class FakeBackend:
    """CUDA graphs stood in for on the CPU: the capture runs the function
    once, a replay runs nothing."""

    def new_pool(self):
        return "pool"

    def warmup(self):
        return contextlib.nullcontext()

    def new_graph(self):
        return {"replays": 0}

    def capture(self, graph, pool, generators):
        return contextlib.nullcontext()

    def replay(self, graph):
        graph["replays"] += 1

    def reserved_bytes(self):
        return 0


class Split:
    """A device-data split of seeded noise canvases and questions."""

    serve_indices = True

    def __init__(self):
        rs = np.random.RandomState(0)
        self.images = rs.randint(0, 256, size=(6, CANVAS, CANVAS, 3)).astype(np.uint8)
        self.data = {
            "image_idx": rs.randint(0, 6, size=N).astype(np.int32),
            "question": rs.randint(1, V, size=(N, 12)).astype(np.int32),
            "answer": rs.randint(0, 28, size=N).astype(np.int32),
        }

    def __len__(self):
        return N

    def device_arrays(self):
        return self.data

    def question_categories(self):
        return None


def _trainer(tmp, profile_dir=None, profile_epoch=1) -> Trainer:
    """The shrunk Trainer with its steps dispatched through fake graphs."""
    dicts = Dictionaries({f"w{i}": i for i in range(1, V)}, {f"a{i}": i for i in range(28)})
    cfg = load_config("original-fp", overrides={"compute_dtype": "float32"}).replace(**SHRUNK)
    split = Split()
    tr = Trainer(cfg, V, split, split, dicts, lr=DoublingSchedule(1e-3), bs=DoublingSchedule(B), device="cpu",
                 device_data=True, invert=False, log_fn=lambda *a: None, log_interval=K,
                 checkpoint_dir=str(tmp), profile_dir=profile_dir, profile_epoch=profile_epoch)
    tr.graphs = tgraphs.StepGraphs("cpu", generators=(tr.state.generator,), rollback=tsteps.StateRollback(tr.state),
                                   backend=FakeBackend())
    tr.train_chunk, tr.eval_chunk = tsteps.make_chunked_steps(tr.state, tr.graphs)
    return tr


def _trace_ranges(path):
    """{name: [(start us, end us)]} of the trace's rn.* ranges."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("rn."):
            out.setdefault(e["name"][3:], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Epoch 1 cold and unprofiled, epoch 2 through the operator's trace
    (``profile_dir``); then a cold eval epoch and a warm one, each under
    ``profile_trace``. The records and the trace files of each."""
    tmp = tmp_path_factory.mktemp("spans")
    tr = _trainer(tmp / "ckpt", profile_dir=str(tmp / "train"), profile_epoch=2)
    tr.train_epoch(1)
    profiling.clear()
    tr.train_epoch(2)
    train = profiling.records()
    with profiling.profile_trace(str(tmp / "eval_cold")):
        tr.eval_epoch(1)
    eval_cold = profiling.records()
    with profiling.profile_trace(str(tmp / "eval")):
        tr.eval_epoch(2)
    return {"trainer": tr, "train": train, "eval_cold": eval_cold, "eval": profiling.records(),
            "train_trace": _trace_ranges(tmp / "train" / "trace.json"),
            "eval_trace": _trace_ranges(tmp / "eval" / "trace.json")}


def _names(records):
    return [r.name for r in records]


def test_without_a_profiler_an_epoch_records_nothing(traced, monkeypatch):
    """No profiler: no record_function entered, no CUDA event made, no
    record, over a warm train epoch and a warm eval epoch."""

    def refuse(*a, **kw):
        raise AssertionError("a span did work with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    tr = traced["trainer"]
    profiling.clear()
    before = {k: c.graph["replays"] for k, c in tr.graphs.captured.items()}
    stats = tr.train_epoch(3)
    tr.eval_epoch(3)
    assert np.isfinite(stats["train_loss"]) and profiling.records() == []
    assert sum(c.graph["replays"] for c in tr.graphs.captured.values()) == sum(before.values()) + 2 * CHUNKS


def test_span_without_a_profiler_is_one_shared_noop():
    assert profiling.span("graph.run", device=True) is profiling.span("eval.fetch")
    profiling.clear()
    with profiling.span("x"):
        pass
    assert profiling.records() == []


@pytest.mark.parametrize("child,parent", NESTED, ids=[f"{c}-in-{p}" for c, p in NESTED])
def test_the_operator_trace_nests_the_ranges(traced, child, parent):
    """Each child range of the trace lies inside a range of its parent."""
    ranges = traced["train_trace"]
    assert ranges.get(child), sorted(ranges)
    for a, b in ranges[child]:
        assert any(pa <= a and b <= pb for pa, pb in ranges[parent]), (child, a, b)


@pytest.mark.parametrize("which,name,count", [
    ("train_trace", "train.order", 1), ("train_trace", "graph.run", CHUNKS), ("train_trace", "train.fetch", CHUNKS),
    ("train_trace", "graph.capture", 0), ("eval_trace", "eval.upload", 1), ("eval_trace", "eval.fetch", 1),
    ("eval_trace", "eval.accumulate", 1), ("eval_trace", "graph.run", CHUNKS),
])
def test_the_trace_holds_each_range_as_often_as_it_ran(traced, which, name, count):
    assert len(traced[which].get(name, [])) == count


def test_a_warm_train_loop_records_a_run_a_chunk_with_its_children(traced):
    """Epoch 2 is warm: one rn.graph.run a chunk, each with copy_in, replay
    and copy_out inside it in that order; no capture; the epoch's order and
    one fetch a chunk (wait, then log) at the top."""
    recs = traced["train"]
    runs = [r for r in recs if r.name == "graph.run"]
    assert len(runs) == CHUNKS and "graph.capture" not in _names(recs)
    assert all(r.parent is None and r.events is None for r in runs)
    for run in runs:
        inside = [r for r in recs if run.t0_ns <= r.t0_ns and r.t1_ns <= run.t1_ns and r is not run]
        assert _names(inside) == list(GRAPH_CHILDREN) and all(r.parent == "graph.run" for r in inside)
    top = [r.name for r in recs if r.parent is None]
    assert top == ["train.order"] + ["graph.run"] + ["graph.run", "train.fetch"] * (CHUNKS - 1) + ["train.fetch"]
    fetch = [r for r in recs if r.parent == "train.fetch"]
    assert _names(fetch) == ["train.fetch_wait", "train.log"] * CHUNKS


def test_a_cold_key_records_one_capture(traced):
    """The first eval epoch captures the chunk's graph once, before its
    first dispatch, outside any rn.graph.run."""
    recs = traced["eval_cold"]
    caps = [r for r in recs if r.name == "graph.capture"]
    runs = [r for r in recs if r.name == "graph.run"]
    assert len(caps) == 1 and caps[0].parent is None and len(runs) == CHUNKS
    assert caps[0].t1_ns <= runs[0].t0_ns


@pytest.mark.parametrize("which", ["eval_cold", "eval"])
def test_an_eval_epoch_records_its_edges_once_each(traced, which):
    recs = traced[which]
    top = [r.name for r in recs if r.parent is None and not r.name.startswith("graph.")]
    assert top == ["eval.upload", "eval.fetch", "eval.accumulate"]
    assert all(r.t0_ns <= r.t1_ns for r in recs)


def test_profile_trace_clears_the_records_on_entry(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
    assert "before" in _names(profiling.records())
    with profiling.profile_trace(str(tmp_path)):
        assert profiling.records() == []
        with profiling.span("inside"):
            pass
    assert _names(profiling.records()) == ["inside"]
    assert "inside" in _trace_ranges(tmp_path / "trace.json")


def test_a_device_span_records_no_event_without_cuda(tmp_path):
    with profiling.profile_trace(str(tmp_path)):
        with profiling.span("outer", device=True):
            with profiling.span("inner", device=True):
                pass
    inner, outer = profiling.records()
    assert (inner.name, inner.parent, outer.name, outer.parent) == ("inner", "outer", "outer", None)
    assert inner.events is None and outer.events is None
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns


def test_profile_trace_without_a_logdir_records_nothing():
    profiling.clear()
    with profiling.profile_trace(None):
        with profiling.span("x"):
            pass
    assert profiling.records() == [] and not profiling._OPEN
