"""The readers of the port's own spans (``metrics/`` over ``spans.py``) on
synthetic records and a synthetic traced slice: their values, and None
where there is nothing to read (no trace, no records, a port without the
recorder, spans without device events)."""

from __future__ import annotations

import types

import pytest

from portbench import core, readers, spans
from portbench.trace import Slice
from rnet_torch.utils import profiling

WINDOW_US = 2_000_000.0  # a slice of 2 s


class Event:
    """A CUDA event's stand-in: its device time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


def _span(name, t0_ms, t1_ms, parent=None, device=None):
    ev = None if device is None else (Event(device[0]), Event(device[1]))
    return profiling.Span(name, parent, int(t0_ms * 1e6), int(t1_ms * 1e6), ev)


def _ctx(traced=True):
    sl = Slice(0.0, WINDOW_US, [("k", 0.0, WINDOW_US)], []) if traced else None
    return readers.Context(types.SimpleNamespace(name="cell"), sl, {})


@pytest.fixture
def recorded(monkeypatch):
    """Stand the port's records in for ``recs``."""

    def put(recs):
        monkeypatch.setattr(profiling, "records", lambda: list(recs))

    return put


def _read(metric, ctx):
    return core.load_reader(metric)(ctx)


# three chunks: device ms [0, 280], [281.5, 561.5], [564, 844]; gaps 1.5 + 2.5 ms
TRAIN = [
    _span("graph.run", 0.0, 3.0, device=(0.0, 280.0)),
    _span("graph.replay", 0.5, 2.5, parent="graph.run"),
    _span("graph.run", 279.0, 283.0, device=(281.5, 561.5)),
    _span("graph.replay", 279.5, 282.5, parent="graph.run"),
    _span("train.fetch", 283.0, 561.0),
    _span("graph.run", 562.0, 568.0, device=(564.0, 844.0)),
    _span("graph.replay", 562.5, 566.5, parent="graph.run"),
]
EVAL = [_span("eval.upload", 0.0, 4.0), _span("graph.run", 4.0, 5.0), _span("eval.fetch", 300.0, 302.0),
        _span("eval.accumulate", 302.0, 313.5)]


def test_between_chunks_sums_the_device_gaps_over_the_window(recorded):
    recorded(TRAIN)
    assert _read("idle_share.between_chunks.train", _ctx()) == pytest.approx(100.0 * 4.0e-3 / 2.0)


def test_between_chunks_takes_runs_in_host_order(recorded):
    recorded(list(reversed(TRAIN)))
    assert _read("idle_share.between_chunks.train", _ctx()) == pytest.approx(100.0 * 4.0e-3 / 2.0)


def test_replay_is_the_median_host_ms(recorded):
    recorded(TRAIN)
    assert _read("host_ms.replay.train", _ctx()) == pytest.approx(3.0)


def test_epoch_edges_add_upload_and_accumulate(recorded):
    recorded(EVAL)
    assert _read("host_ms.epoch_edges.eval", _ctx()) == pytest.approx(15.5)
    recorded(EVAL + [_span("eval.upload", 400.0, 402.0), _span("eval.accumulate", 700.0, 707.0)])
    assert _read("host_ms.epoch_edges.eval", _ctx()) == pytest.approx((15.5 + 9.0) / 2)


NONE_CASES = [
    ("idle_share.between_chunks.train", [TRAIN[0]]),  # one run: no gap
    ("idle_share.between_chunks.train", [_span("graph.run", 0, 1), _span("graph.run", 2, 3)]),  # no events (CPU)
    ("host_ms.replay.train", [_span("graph.run", 0, 1)]),
    ("host_ms.epoch_edges.eval", [_span("eval.accumulate", 0, 1)]),
]


@pytest.mark.parametrize("metric,recs", NONE_CASES, ids=[f"{m}-{i}" for i, (m, _) in enumerate(NONE_CASES)])
def test_nothing_to_read_gives_none(recorded, metric, recs):
    recorded(recs)
    assert _read(metric, _ctx()) is None


METRICS = ["idle_share.between_chunks.train", "host_ms.replay.train", "host_ms.epoch_edges.eval"]


@pytest.mark.parametrize("metric", METRICS)
def test_an_untraced_run_gives_none(recorded, metric):
    recorded(TRAIN + EVAL)
    assert _read(metric, _ctx(traced=False)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_a_port_without_the_recorder_gives_none(monkeypatch, metric):
    monkeypatch.delattr(profiling, "records")
    assert spans.records(_ctx()) == []
    assert _read(metric, _ctx()) is None
