"""Serving window: ``InferenceServer.answer`` under open-loop arrivals, as
``python -m rnet_torch.serve`` serves one-question requests.

Set-up draws the weights from the seed, builds the server (its bucket
ladder from the traffic), writes the client's pool of distinct scene PNGs
(the configuration's image size) into ``TMPDIR``, draws every request of
the window (a PNG of the pool and a question string of the harness's
words) and the arrival times at the traffic's fixed rate, and warms the
server: ``warmup()`` captures each bucket's graph, and one call per bucket
on real requests warms the decoder.

The window is an open loop. Each pass of the server loop takes every
request already due, up to ``max_batch``, as ``iter_microbatches`` does,
and hands them to ``answer``; when none is due it sleeps until the next.
A request's latency runs from when it was due to when its answer is back,
so a stall delays the requests behind it. Once the last request of the
window is due, the loop drains what is left, for ``drain_s`` at most; a
request that errors or is not answered by then has failed.
``serve_p50_ms`` is the median over every request of the window, a failed
one counted at the drain's end. The 95th percentile (``serve.p95_ms``)
swings with the host's speed far more than the median does, so it is a
per-layer reading of the traced run, taken over the requests that the
profiler left alone: none served while it records, or after its start or
stop before the backlog that left has cleared.

Compared, once the window has closed: a sample of the served requests
drawn from the seed, decoded and resized by the reference itself from the
same PNG and tokenised from the same string: ``pred_gap``, the widest gap
by which the reference's log-prob of the served answer lies below its best,
and ``logp_gap``, the widest gap between the served log-prob and the
reference's log-prob of the same answer.
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import core, data, port, reference
from portbench.trace import Tracer, now


@dataclasses.dataclass
class State:
    cell: core.Cell
    run: core.Run
    weights: Dict[str, torch.Tensor]
    server: object
    pool: List[str]
    tmp: tempfile.TemporaryDirectory
    requests: List[Dict] = dataclasses.field(default_factory=list)
    results: List[Optional[Dict]] = dataclasses.field(default_factory=list)
    encode_ms: List[float] = dataclasses.field(default_factory=list)
    batches: List[int] = dataclasses.field(default_factory=list)


def prepare(run: core.Run) -> State:
    from rnet_torch.serve import InferenceServer

    cell = run.cell
    t, d = cell.traffic, cell.config["data"]
    cfg = port.model_config(cell)
    server = InferenceServer(cfg, port.dictionaries(), invert=True, max_batch=t["max_batch"], buckets=t["buckets"],
                             device=run.device)
    server.init_weights(0)
    weights = port.weights(cell, run)
    port.put_weights(server.model, weights)
    tmp = tempfile.TemporaryDirectory(prefix="portbench-serve-")
    rng = data.host_rng(run.seed, "pool")
    pool = data.png_pool(tmp.name, t["pool_images"], d["png"], rng)
    st = State(cell, run, weights, server, pool, tmp)
    server.warmup()
    warm = requests_for(st, sum(server.buckets), "warm")
    for b in server.buckets:
        server.answer(warm[:b])
    return st


def requests_for(st: State, n: int, stream: str) -> List[Dict]:
    rng = data.host_rng(st.run.seed, stream)
    qs = data.question_strings(n, st.cell.config["data"]["question_words"], rng)
    img = rng.integers(0, len(st.pool), n)
    return [{"image": st.pool[int(i)], "question": q} for i, q in zip(img, qs)]


def window(st: State, rate: float, seconds: float, tracer: Tracer, stream: str = "requests") -> Dict:
    """Serve the arrivals of ``rate``/s over ``seconds``; latencies in ms
    (a failed request at the drain's end), failures, and the batches."""
    t = st.cell.traffic
    server, max_batch = st.server, t["max_batch"]
    due = data.arrival_times(rate, seconds, data.host_rng(st.run.seed, "arrivals" + stream))
    st.requests = requests_for(st, len(due), stream)
    st.results = [None] * len(due)
    done_at = np.full(len(due), np.nan)
    if tracer.enabled:
        encode = server.encode

        def timed(request):
            t0 = now()
            with tracer.span("encode"):
                out = encode(request)
            st.encode_ms.append((now() - t0) * 1e3)
            return out

        server.encode = timed
    st.batches = []
    trace_at, trace_s = t["trace_at_s"], t["trace_s"]
    clean = np.ones(len(due), bool)  # served with the profiler off and its backlog cleared
    stalls = []  # seconds each start and stop of the profiler held the loop
    t0 = now()
    setup_s = time.time() - st.run.t_start
    i, n = 0, len(due)
    sliced = 0.0
    tainted = False
    while i < n:
        el = now() - t0
        if tracer.enabled and not tracer.active and tracer.slice is None and el >= trace_at:
            tracer.start()
            sliced = now()
            stalls.append(sliced - t0 - el)
            tainted = True
        if tracer.active and now() - sliced >= trace_s:
            s0 = now()
            tracer.stop()
            stalls.append(now() - s0)
            tainted = True
        if el > seconds + t["drain_s"]:
            break
        if due[i] > el:
            tainted = tracer.active  # nothing due: any backlog has cleared
            with tracer.span("wait"):
                time.sleep(max(0.0, min(due[i] - el, 0.002)))
            continue
        j = i
        while j < n and j - i < max_batch and due[j] <= el:
            j += 1
        with tracer.span("answer"):
            res = server.answer(st.requests[i:j])
        end = now() - t0
        st.results[i:j] = res
        done_at[i:j] = end
        clean[i:j] = not tainted
        served = [r for r in res if "error" not in r]
        st.batches.append(served[0]["batch"] if served else 0)
        i = j
    if tracer.active:
        tracer.stop()
    end_all = now() - t0
    failed = np.array([r is None or "error" in r for r in st.results])
    lat = np.where(failed | np.isnan(done_at), end_all, done_at) - due
    return {"serve_p50_ms": data.percentile(lat * 1e3, 50), "p95_ms": data.percentile(lat * 1e3, 95),
            "clean_p95_ms": data.percentile(lat[clean] * 1e3, 95), "clean": int(clean.sum()), "stalls_s": stalls,
            "setup_s": setup_s, "requests": n, "failed": int(failed.sum()), "latency_ms": lat * 1e3,
            "due": due, "done_at": done_at, "seconds": end_all}


def _tokens(question: str, max_len: int) -> np.ndarray:
    """The harness's own tokenisation: words to ids, pads after, reversed
    (``--invert-questions``: pads first)."""
    words, _ = data.dictionary()
    ids = [words[x] for x in question.lower().replace("?", "").split()][:max_len]
    return np.asarray((ids + [0] * (max_len - len(ids)))[::-1], np.int32)


def _decode(path: str, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB").resize((size, size), Image.BILINEAR), dtype=np.uint8)


def readings(st: State, control: Optional[str] = None) -> Dict[str, float]:
    """Compare a seeded sample of the served answers with the reference; or,
    for a ``control``, what would read in their place: the reference in a
    lower precision (a name of ``reference.PRECISIONS``), or ``altered``,
    each served answer moved to the next answer."""
    t, w = st.cell.traffic, st.cell.config["widths"]
    _, answers = data.dictionary()
    ok = [k for k, r in enumerate(st.results) if r is not None and "error" not in r]
    rows = data.sample_rows(len(ok), t["sample_requests"], data.host_rng(st.run.seed, "serve_sample"))
    pick = [ok[k] for k in rows]
    dev = st.run.device
    pred_gap = logp_gap = 0.0
    with reference.exact_float32():
        for s in data.chunks(len(pick), 64):
            ks = pick[s]
            imgs = torch.from_numpy(np.stack([_decode(st.requests[k]["image"], w["image_size"]) for k in ks])).to(dev)
            toks = torch.from_numpy(np.stack([_tokens(st.requests[k]["question"], w["question_max_len"])
                                              for k in ks])).to(dev)
            ref = reference.eval_log_probs(st.weights, w, imgs, toks, reference.FLOAT32, t["reference_block"]).double()
            if control is None or control == "altered":
                a = torch.tensor([answers[st.results[k]["answer"]] for k in ks], device=dev)
                lp = torch.tensor([st.results[k]["log_prob"] for k in ks], device=dev, dtype=torch.float64)
                if control == "altered":
                    a = (a + 1) % len(answers)
            else:
                other = reference.eval_log_probs(st.weights, w, imgs, toks, reference.PRECISIONS[control],
                                                 t["reference_block"]).double()
                a = other.argmax(-1)
                lp = other.gather(1, a[:, None])[:, 0]
            at = ref.gather(1, a[:, None])[:, 0]
            pred_gap = max(pred_gap, float((ref.max(-1).values - at).max()))
            logp_gap = max(logp_gap, float((lp - at).abs().max()))
    return {"pred_gap": pred_gap, "logp_gap": logp_gap}


def release(st: State) -> None:
    server = st.server
    if getattr(server, "graphs", None) is not None:
        server.graphs.clear()
    st.server = None
    del server
    port.free(st.run.device)


def run(r: core.Run) -> core.Outcome:
    tracer = Tracer(r.trace)
    st = prepare(r)
    res = window(st, r.cell.traffic["rate_per_s"], r.seconds, tracer)
    thirds = [data.percentile(part, 95) for part in np.array_split(res["latency_ms"], 3)]
    print(f"serve: {res['requests']} requests at {r.cell.traffic['rate_per_s']}/s, p50 {res['serve_p50_ms']!r} ms, "
          f"p95 {res['p95_ms']!r} ms (by thirds of the window {thirds}), {len(st.batches)} batches, "
          f"last answer at {res['seconds']!r} s; p95 {res['clean_p95_ms']!r} ms over the {res['clean']} requests "
          f"the profiler left alone (its start and stop held the loop {res['stalls_s']} s)", file=sys.stderr)
    peak = port.memory_peak(r.device)
    release(st)
    got = readings(st)
    st.tmp.cleanup()
    counts = {"encode_ms": list(st.encode_ms), "batches": list(st.batches), "p95_ms": res["clean_p95_ms"]}
    return core.Outcome(metrics={"serve_p50_ms": res["serve_p50_ms"], "setup_s": res["setup_s"]},
                        attempted=res["requests"], failed=res["failed"], readings=got, memory_peak_bytes=peak,
                        trace=tracer.slice, counts=counts)


def calibrate(r: core.Run, controls: List[str]) -> Dict[str, Dict[str, float]]:
    """The program's readings after a short window at the cell's rate, and
    each control's (``readings``)."""
    st = prepare(r)
    window(st, r.cell.traffic["rate_per_s"], r.seconds, Tracer(False))
    release(st)
    out = {"program": readings(st)}
    for name in controls:
        out[name] = readings(st, name)
    st.tmp.cleanup()
    return out
