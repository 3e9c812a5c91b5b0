"""Training window: the port's device-data training loop, as ``python -m
rnet_torch.train --data-pipeline device`` runs it.

Set-up draws the configuration's train split on the device (padded uint8
canvases, per-question tokens, answers and image indices: what the port's
``Trainer`` keeps on the card) and the weights from the seed, builds one
``Trainer``, and drives that same object through its first steps by
``train_chunk``, the call its loop dispatches: one chunk of
``log_interval`` steps on rows drawn from the seed (the checked steps; the
call captures the chunk's graph, and what it returns comes from the graph's
first replay), then, where the epoch's step count leaves a shorter last
chunk, one chunk of that length, which captures its graph too. The window
then runs the Trainer's own epoch loop, ``Trainer._train_steps_device``,
over whole epochs (its order, its dispatch of a chunk at a time, its fetch
of the previous chunk's metrics), until the next epoch would end further
past ``seconds`` than stopping now; every step gathers and augments its
batch on the device. ``train_qps`` is every question of every step the
window ran over its wall time, which ends with the loop's last fetch.

What is compared, once the window has closed and the Trainer is freed,
against ``reference.train_steps`` over the same rows, from the same weights
and draws: the checked chunk's first loss and first gradient norm (before
the clip, as the step reports it), and, after the chunk, Adam's first
moment and the parameters' change. Moment and change are taken leaf by
leaf: the gap between the two norms over the larger of the reference's
norm of that leaf and of the median leaf. Leaves whose reference gradient
in the first step is under a thousandth of the median leaf's (the conv
biases, which BatchNorm cancels) move under Adam by round-off alone and
are left out of the change. A graph of several steps keeps no state
between them that the harness could read, so the first step's gradient is
checked by its norm, and leaf by leaf through the moment.
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import core, data, port, reference
from portbench.trace import Tracer, now

ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}


@dataclasses.dataclass
class State:
    cell: core.Cell
    run: core.Run
    split: Dict[str, torch.Tensor]
    weights: Dict[str, torch.Tensor]
    trainer: object
    first_rows: torch.Tensor
    produced: Dict
    ckpt: tempfile.TemporaryDirectory


def prepare(run: core.Run) -> State:
    cell = run.cell
    w, t, d = cell.config["widths"], cell.traffic, cell.config["data"]
    cfg = port.model_config(cell)
    t0 = now()
    split = data.split_on_device(d["train"], w, port.vocab_size(), d["question_words"], run.seed, run.device)
    weights = port.weights(cell, run)
    port.sync(run.device)
    t1 = now()
    ckpt = tempfile.TemporaryDirectory(prefix="portbench-")
    n = d["train"]["questions"]
    tr = port.trainer(cfg, cell, run, port.Split(n), port.Split(n), ckpt.name)
    port.put_weights(tr.state.model, weights)
    tr.train_cache = split["cache"]
    tr.train_data = {k: split[k] for k in ("question", "answer", "image_idx")}
    from rnet_torch.train import steps

    steps.set_learning_rate(tr.state, t["lr"])
    K, B = t["log_interval"], t["batch_size"]
    last = (n // B) % K
    rows = torch.from_numpy(data.host_rng(run.seed, "order").permutation(n)[: (K + last) * B].astype(np.int32)
                            .reshape(K + last, B)).to(run.device)
    st = State(cell, run, split, weights, tr, rows[:K].clone(), {}, ckpt)
    t2 = now()
    st.produced = checked_steps(st)
    t3 = now()
    if last:
        tr.train_chunk(rows[K:], tr.train_data, tr.train_cache).cpu()  # the epoch's last, shorter chunk
    print(f"train: set-up since process start {time.time() - run.t_start:.2f} s, of which data and weights "
          f"{t1 - t0:.2f} s, Trainer {t2 - t1:.2f} s, the checked chunk (captured) {t3 - t2:.2f} s, "
          f"the last chunk's capture {now() - t3:.2f} s", file=sys.stderr)
    return st


def checked_steps(st: State) -> Dict:
    """The first chunk, by the loop's own call and feed: each step's loss
    and gradient norm, and Adam's first moment and the parameters after it."""
    tr, names = st.trainer, reference.parameter_names(st.cell.config["widths"], port.vocab_size())
    params = dict(tr.state.model.named_parameters())
    ms = tr.train_chunk(st.first_rows, tr.train_data, tr.train_cache).cpu().double().numpy()
    state = tr.state.adam.state  # a leaf Adam never stepped has no moment: it got nothing
    moment = {n: state.get(params[n], {}).get("exp_avg", torch.zeros_like(params[n])).detach().clone() for n in names}
    after = {n: params[n].detach().clone() for n in names}
    return {"loss": ms[:, 0].tolist(), "grad_norm": ms[:, 2].tolist(), "moment": moment, "params": after}


def _traced(st: State, tracer: Tracer) -> None:
    """Profile the loop's chunks ``trace_after_chunks`` .. + ``trace_chunks``
    of the first epoch, its dispatches and fetches marked as host spans:
    the Trainer's two methods are wrapped on this instance alone."""
    tr, t = st.trainer, st.cell.traffic
    chunk, drain = tr.train_chunk, tr._drain
    at, span = t["trace_after_chunks"], t["trace_chunks"]
    calls = [0]

    def train_chunk(*args):
        k = calls[0]
        calls[0] += 1
        if k == at:
            tracer.start()
        elif k == at + span:
            tracer.stop()
        with tracer.span("dispatch"):
            return chunk(*args)

    def fetch(*args):
        with tracer.span("fetch"):
            return drain(*args)

    tr.train_chunk, tr._drain = train_chunk, fetch


def window(st: State, tracer: Tracer) -> Dict:
    """Whole epochs of the Trainer's loop, for about ``seconds``."""
    tr, t, run = st.trainer, st.cell.traffic, st.run
    B = t["batch_size"]
    if tracer.enabled:
        _traced(st, tracer)
    port.sync(run.device)
    t0 = now()
    setup_s = time.time() - run.t_start
    print(f"train: set-up {setup_s:.2f} s", file=sys.stderr)
    done = failed = epochs = 0
    while True:
        epochs += 1
        ms = tr._train_steps_device(epochs, B, t["lr"])
        done += ms.shape[0]
        failed += int((~np.isfinite(ms[:, 0])).sum())
        seconds = now() - t0
        if seconds + seconds / epochs / 2 >= run.seconds:
            break
    port.sync(run.device)
    seconds = now() - t0
    print(f"train: {epochs} epoch(s), {done} steps in {seconds:.2f} s", file=sys.stderr)
    traced = t["trace_chunks"] * t["log_interval"] if tracer.slice is not None else 0
    return {"train_qps": done * B / seconds, "setup_s": setup_s, "steps": done, "failed": failed,
            "traced_steps": traced}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], names: List[str]) -> float:
    pn = {n: float(prog[n].double().norm()) for n in names}
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = float(np.median([rn[n] for n in names]))
    return max(abs(pn[n] - rn[n]) / max(rn[n], med) for n in names)


def readings(produced: Dict, ref: Dict, p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """loss1_gap and gnorm1_gap (the relative gaps of the first step's loss
    and gradient norm), loss_gap (the largest of the chunk's loss gaps),
    moment_gap and change_gap (the worst leaf, as the module says)."""
    names = list(ref["grad1"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(produced["loss"], ref["loss"])]
    gn = {n: float(ref["grad1"][n].double().norm()) for n in names}
    med = float(np.median(list(gn.values())))
    moved = [n for n in names if gn[n] >= 1e-3 * med]
    d_prog = {n: produced["params"][n] - p0[n] for n in moved}
    d_ref = {n: ref["params"][n] - p0[n] for n in moved}
    g1, r1 = produced["grad_norm"][0], ref["grad_norm"][0]
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps), "gnorm1_gap": abs(g1 - r1) / r1,
            "moment_gap": _leaf_gaps(produced["moment"], ref["moment"], names),
            "change_gap": _leaf_gaps(d_prog, d_ref, moved)}


def reference_run(st: State, precision: reference.Precision = reference.FLOAT32, half_batch: bool = False) -> Dict:
    t = st.cell.traffic
    opt = dict(ADAM, lr=t["lr"], clip_norm=t["clip_norm"])
    data_ = {k: st.split[k] for k in ("question", "answer", "image_idx")}
    rows = list(st.first_rows)
    with reference.exact_float32():
        return reference.train_steps(st.weights, st.cell.config["widths"], st.split["cache"], data_, rows,
                                     data.stream_seed(st.run.seed, "train_state"), opt, precision, half_batch,
                                     t.get("reference_block", 32))


def release(st: State) -> None:
    """Free the Trainer (its graphs, Adam state and pools); keep the inputs."""
    tr = st.trainer
    if getattr(tr, "graphs", None) is not None:
        tr.graphs.clear()
    st.trainer = None
    del tr
    port.free(st.run.device)
    st.ckpt.cleanup()


def run(r: core.Run) -> core.Outcome:
    tracer = Tracer(r.trace)
    st = prepare(r)
    res = window(st, tracer)
    peak = port.memory_peak(r.device)
    release(st)
    ref = reference_run(st)
    got = readings(st.produced, ref, st.weights)
    counts = {"steps": res["traced_steps"], "batch_size": r.cell.traffic["batch_size"]}
    return core.Outcome(metrics={"train_qps": res["train_qps"], "setup_s": res["setup_s"]},
                        attempted=res["steps"], failed=res["failed"], readings=got, memory_peak_bytes=peak,
                        trace=tracer.slice, counts=counts)


def calibrate(r: core.Run, controls: List[str]) -> Dict[str, Dict[str, float]]:
    """The program's readings on this seed, and each control's: the
    reference in a lower precision (``fp8``) or with a fault
    (``half_batch``) put in the program's place."""
    st = prepare(r)
    release(st)
    ref = reference_run(st)
    out = {"program": readings(st.produced, ref, st.weights)}
    for name in controls:
        if name == "half_batch":
            other = reference_run(st, reference.FLOAT32, half_batch=True)
        else:
            other = reference_run(st, reference.PRECISIONS[name])
        out[name] = readings(other, ref, st.weights)
    return out
