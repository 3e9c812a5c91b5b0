"""Evaluation window: ``Trainer.eval_epoch`` over the device-resident val
split, as ``python -m rnet_torch.evaluate`` and every epoch of training run
it, again and again.

Set-up draws the configuration's val split on the device and the weights
from the seed, builds the port's ``Trainer`` (its model in the traffic's
implementation: ``auto`` in bf16, or ``pallas_int8``), hands it the split,
and runs one epoch, which captures the chunk graphs (a chunk of
``log_interval`` batches and the epoch's shorter last one). The window runs
whole epochs until ``seconds`` have passed; ``eval_qps`` is the valid
questions of every epoch over the wall time to the end of the last one,
each epoch's fetch and ``EvalAccumulator`` update included.

The harness keeps what the window's last epoch produced: each chunk's
outputs, as ``eval_chunk`` returned them to ``eval_epoch``. Once the window
has closed and the Trainer is freed, batches drawn from the seed go through
``reference.eval_log_probs``, and

* ``pred_gap``: over the ``sample_batches`` first of them, in fp32, the
  widest gap by which the reference's log-prob of the program's answer
  lies below the reference's best;
* ``nll_gap``: over all ``nll_batches``, with the reference in the
  precision the traffic states (``reference_precision``: bf16, or bf16
  with g_theta's int8 chain), the root mean square of the relative gaps
  between a batch's NLL sum and the reference's. In the same precision
  both sides round the same weights alike, so what is left is the rounding
  of activations, which pooling over batches averages; an fp32 reference
  would leave each seed's own bias from rounding the weights, which no
  pooling removes;
* ``passthrough``: labels, indices and the valid mask that differ from
  the split's (exact), with the questions every epoch's accumulator missed.
"""

from __future__ import annotations

import dataclasses
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
    split: Dict[str, torch.Tensor]
    weights: Dict[str, torch.Tensor]
    trainer: object
    taps: List[Dict[str, torch.Tensor]]
    missed: int
    ckpt: tempfile.TemporaryDirectory


def prepare(run: core.Run) -> State:
    cell = run.cell
    w, d = cell.config["widths"], cell.config["data"]
    cfg = port.model_config(cell)
    split = data.split_on_device(d["val"], w, port.vocab_size(), d["question_words"], run.seed, run.device)
    weights = port.weights(cell, run)
    n = d["val"]["questions"]
    fams = data.families(n, port.n_families(), data.host_rng(run.seed, "families"))
    ckpt = tempfile.TemporaryDirectory(prefix="portbench-")
    val = port.Split(n, fams)
    tr = port.trainer(cfg, cell, run, val, val, ckpt.name)
    port.put_weights(tr.state.model, weights)
    tr.val_cache = split["cache"]
    tr.val_data = {k: split[k] for k in ("question", "answer", "image_idx")}
    st = State(cell, run, split, weights, tr, [], 0, ckpt)
    chunk = tr.eval_chunk

    def tapped(idx_chunk, valid_chunk, data_, image_cache=None):
        out = chunk(idx_chunk, valid_chunk, data_, image_cache)
        st.taps.append(out)
        return out

    tr.eval_chunk = tapped
    return st


def _epoch(st: State, epoch: int, tracer: Tracer) -> int:
    """One ``eval_epoch``; the valid questions it counted."""
    st.taps.clear()
    with tracer.span("eval_epoch"):
        res = st.trainer.eval_epoch(epoch, batch_size=st.cell.traffic["batch_size"])
    n = res["_accumulator"].n
    st.missed += st.cell.config["data"]["val"]["questions"] - n
    return n


def window(st: State, tracer: Tracer) -> Dict:
    run, t = st.run, st.cell.traffic
    _epoch(st, 0, tracer)  # captures the chunk graphs
    st.missed = 0
    port.sync(run.device)
    t0 = now()
    setup_s = time.time() - run.t_start
    questions, epochs, traced = 0, 0, 0
    while now() - t0 < run.seconds or (tracer.enabled and tracer.slice is None):
        trace_this = epochs == t["trace_epoch"]
        if trace_this:
            tracer.start()
        n = _epoch(st, epochs + 1, tracer)
        if trace_this:
            tracer.stop()
            traced = n
        questions += n
        epochs += 1
    port.sync(run.device)
    seconds = now() - t0
    return {"eval_qps": questions / seconds, "setup_s": setup_s, "questions": questions, "epochs": epochs,
            "traced_questions": traced}


def readings(st: State, control: Optional[str] = None) -> Dict[str, float]:
    """Compare the last epoch's outputs with the reference on the sampled
    batches; or, for a ``control``, what would read in their place: the
    reference in a lower precision (a name of ``reference.PRECISIONS``), or
    ``altered``, the program's answers each moved to the next answer."""
    t, w = st.cell.traffic, st.cell.config["widths"]
    B = t["batch_size"]
    n = st.cell.config["data"]["val"]["questions"]
    nb = -(-n // B)
    pred = torch.cat([o["pred"].reshape(-1) for o in st.taps]).cpu()
    label = torch.cat([o["label"].reshape(-1) for o in st.taps]).cpu()
    valid = torch.cat([o["valid"].reshape(-1) for o in st.taps]).cpu()
    index = torch.cat([o["index"].reshape(-1) for o in st.taps]).cpu()
    nll = torch.cat([o["nll_sum"].reshape(-1) for o in st.taps]).double().cpu()
    want_idx = torch.zeros(nb * B, dtype=torch.long)
    want_idx[:n] = torch.arange(n)
    want_valid = torch.arange(nb * B) < n
    want_label = st.split["answer"].long().cpu()[want_idx]
    bad = int((index.long() != want_idx).sum() + (valid.bool() != want_valid).sum()
              + ((label.long() != want_label) & want_valid).sum())
    rng = data.host_rng(st.run.seed, "eval_sample")
    rows = rng.permutation(nb)[: max(t["nll_batches"], t["sample_batches"])]
    same = reference.PRECISIONS[t["reference_precision"]]
    pred_gap, gaps = 0.0, []
    with reference.exact_float32():
        for k, b in enumerate(rows):
            sl = slice(b * B, min((b + 1) * B, n))
            idx = torch.arange(sl.start, sl.stop, device=st.split["cache"].device)
            imgs = st.split["cache"][st.split["image_idx"][idx].long()]
            toks = st.split["question"][idx]
            labels = st.split["answer"][idx].long()

            def log_probs(R):
                return reference.eval_log_probs(st.weights, w, imgs, toks, R, t["reference_block"]).double()

            if control is None or control == "altered":
                p, s = pred[sl].to(imgs.device), float(nll[b])
                if control == "altered":
                    p = (p + 1) % w["n_answers"]
            else:
                other = log_probs(reference.PRECISIONS[control])
                p, s = other.argmax(-1), float(-other.gather(1, labels[:, None]).sum())
            if k < t["sample_batches"]:
                ref = log_probs(reference.FLOAT32)
                gap = ref.max(-1).values - ref.gather(1, p.long()[:, None])[:, 0]
                pred_gap = max(pred_gap, float(gap.max()))
            if k < t["nll_batches"]:
                s_ref = float(-log_probs(same).gather(1, labels[:, None]).sum())
                gaps.append((s - s_ref) / s_ref)
    nll_gap = float(np.sqrt(np.mean(np.square(gaps))))
    return {"pred_gap": pred_gap, "nll_gap": nll_gap, "passthrough": float(bad + st.missed)}


def release(st: State) -> None:
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
    got = readings(st)
    counts = {"questions": res["traced_questions"], "batch_size": r.cell.traffic["batch_size"]}
    return core.Outcome(metrics={"eval_qps": res["eval_qps"], "setup_s": res["setup_s"]},
                        attempted=res["questions"] + st.missed, failed=st.missed, readings=got,
                        memory_peak_bytes=peak, trace=tracer.slice, counts=counts)


def calibrate(r: core.Run, controls: List[str]) -> Dict[str, Dict[str, float]]:
    """The program's readings after one epoch on this seed, and each
    control's (``readings``)."""
    st = prepare(r)
    _epoch(st, 1, Tracer(False))
    release(st)
    out = {"program": readings(st)}
    for name in controls:
        out[name] = readings(st, name)
    return out
