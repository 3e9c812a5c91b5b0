"""Training window of a state-description model: the port's device-data
training loop, as ``python -m rnet_torch.train --model original-sd
--data-pipeline device`` runs it.

Set-up draws the configuration's train split on the device from the seed,
laid out as the port's ``ClevrDatasetStateDescription.device_arrays`` lays
it out: per question its scene's objects (n, 12, 18) fp32, zero-padded,
the count of real ones, its tokens (pads first, as ``--invert-questions``
leaves them) and its answer. Each of the split's scenes has 3-10 objects,
each object its 3-D position uniform in [-3, 3] (over 3, as
``scene_to_objects`` stores it) and uniform one-hots of colour, shape,
material and size; each question names a scene uniformly. The weights come
from ``reference_sd.draw_weights``. There is no image cache and no
augmentation.

The rest is the from-pixels training entry's (``entries/train.py``), on
that entry's own functions: one ``Trainer``, driven through its first
steps by ``train_chunk`` (the checked chunk of ``log_interval`` steps,
captured; then the epoch's shorter last chunk), then the Trainer's own
epoch loop, ``Trainer._train_steps_device``, over whole epochs for about
``seconds``; ``train_qps`` is every question of every step the window ran
over its wall time. What is compared, once the window has closed and the
Trainer is freed, against ``reference_sd.train_steps`` over the same rows,
from the same weights and dropout draws: ``loss1_gap``, ``gnorm1_gap``,
``moment_gap`` and ``change_gap``, as that entry reads them. The reference
runs in the traffic's ``reference_precision``: bf16, its operands rounded
where the port computes in bf16 (g_theta alone here), as the eval cells
compare. Against fp32 the program's first loss kept each seed's bias from
rounding g_theta's weights and activations, as large as an fp8 g_theta's
on some seeds: the LSTM and f_phi run in fp32 in both, so g_theta's
precision moves these numbers little.

The route: the window's g_theta calls must all take the plain ``xla``
route (12 objects), so the port's launch counters after the window must
read one ``g_xla`` a step and no launch of a pairwise kernel; a run that
reads otherwise raises. A port that has no ``g_xla`` counter is held to
the kernels' counts alone.
"""

from __future__ import annotations

import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import core, data, port, reference, reference_sd
from portbench.trace import Tracer, now

_train = core.load_entry("train")  # the from-pixels entry: its State, window, readings and release
State = _train.State

XLA_ROUTE = "g_xla"


def scene_objects(n_scenes: int, w: Dict, spec: Dict, gen: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_scenes, max_objects, object_dim) fp32 objects and (n_scenes,)
    int32 counts: each scene's real objects (a count uniform in [min, max])
    first, as ``scene_to_objects`` lays them out, then zero rows."""
    n, dim = w["max_objects"], w["object_dim"]
    if dim != 3 + 8 + 3 + 2 + 2:
        raise ValueError(f"a CLEVR object has 18 numbers; the configuration states {dim}")
    counts = torch.randint(spec["min"], spec["max"] + 1, (n_scenes, 1), generator=gen, device=device)
    real = torch.arange(n, device=device)[None, :] < counts
    xyz = torch.rand((n_scenes, n, 3), generator=gen, device=device) * 2.0 - 1.0  # [-3, 3] over 3
    parts = [xyz]
    for k in (8, 3, 2, 2):  # colour, shape, material, size
        pick = torch.randint(0, k, (n_scenes, n), generator=gen, device=device)
        parts.append(torch.nn.functional.one_hot(pick, k).float())
    objs = torch.cat(parts, dim=-1)
    return objs * real[..., None], counts[:, 0].to(torch.int32)


def split_on_device(d: Dict, w: Dict, vocab: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The train split as the port's device pipeline holds it: ``objects``,
    ``n_objects``, ``question``, ``answer`` per question."""
    gen = data.device_generator(seed, "split", device)
    sp = d["train"]
    objs, counts = scene_objects(sp["scenes"], w, d["objects_per_scene"], gen, device)
    nq = sp["questions"]
    scene = data.image_index(nq, sp["scenes"], gen, device).long()
    return {
        "objects": objs[scene],
        "n_objects": counts[scene],
        "question": data.questions(nq, w["question_max_len"], vocab, d["question_words"], gen, device),
        "answer": data.answers(nq, w["n_answers"], gen, device),
    }


def prepare(run: core.Run) -> State:
    cell = run.cell
    w, t, d = cell.config["widths"], cell.traffic, cell.config["data"]
    cfg = port.model_config(cell)
    t0 = now()
    split = split_on_device(d, w, port.vocab_size(), run.seed, run.device)
    weights = reference_sd.draw_weights(w, port.vocab_size(), data.device_generator(run.seed, "weights", run.device),
                                        run.device)
    port.sync(run.device)
    t1 = now()
    ckpt = tempfile.TemporaryDirectory(prefix="portbench-")
    n = d["train"]["questions"]
    tr = port.trainer(cfg, cell, run, port.Split(n), port.Split(n), ckpt.name)
    port.put_weights(tr.state.model, weights)
    tr.train_data = dict(split)
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
        tr.train_chunk(rows[K:], tr.train_data, None).cpu()  # the epoch's last, shorter chunk
    print(f"train_sd: set-up since process start {time.time() - run.t_start:.2f} s, of which data and weights "
          f"{t1 - t0:.2f} s, Trainer {t2 - t1:.2f} s, the checked chunk (captured) {t3 - t2:.2f} s, "
          f"the last chunk's capture {now() - t3:.2f} s", file=sys.stderr)
    return st


def checked_steps(st: State) -> Dict:
    """The first chunk, by the loop's own call and feed: each step's loss
    and gradient norm, and Adam's first moment and the parameters after it."""
    tr, names = st.trainer, reference_sd.parameter_names(st.cell.config["widths"], port.vocab_size())
    params = dict(tr.state.model.named_parameters())
    ms = tr.train_chunk(st.first_rows, tr.train_data, None).cpu().double().numpy()
    state = tr.state.adam.state
    moment = {n: state.get(params[n], {}).get("exp_avg", torch.zeros_like(params[n])).detach().clone() for n in names}
    after = {n: params[n].detach().clone() for n in names}
    return {"loss": ms[:, 0].tolist(), "grad_norm": ms[:, 2].tolist(), "moment": moment, "params": after}


def check_route(counts: Dict[str, int], steps: int) -> str:
    """Raise unless every step took the ``xla`` route and no pairwise kernel
    ran; the line that says what was counted."""
    kernels = {k: v for k, v in counts.items() if k != XLA_ROUTE and v}
    got = counts.get(XLA_ROUTE)
    if kernels or (got is not None and got != steps):
        raise RuntimeError(f"train_sd: {steps} steps should take the xla route once each and launch no pairwise "
                           f"kernel; the port counted {counts}")
    if got is None:
        return f"train_sd: the port counts no {XLA_ROUTE}; no pairwise kernel ran in {steps} steps"
    return f"train_sd: {got} {XLA_ROUTE} in {steps} steps, no pairwise kernel"


def reference_run(st: State, precision: Optional[reference.Precision] = None, half_batch: bool = False) -> Dict:
    """``reference_sd.train_steps`` over the checked chunk's rows, in
    ``precision`` (default: the traffic's ``reference_precision``)."""
    t = st.cell.traffic
    precision = reference.PRECISIONS[t["reference_precision"]] if precision is None else precision
    opt = dict(_train.ADAM, lr=t["lr"], clip_norm=t["clip_norm"])
    rows = list(st.first_rows)
    with reference.exact_float32():
        return reference_sd.train_steps(st.weights, st.cell.config["widths"], st.split, rows,
                                        data.stream_seed(st.run.seed, "train_state"), opt, precision, half_batch,
                                        t.get("reference_block", 64))


def run(r: core.Run) -> core.Outcome:
    from rnet_torch.kernels import pairwise

    tracer = Tracer(r.trace)
    st = prepare(r)
    pairwise.reset_launches()
    res = _train.window(st, tracer)
    print(check_route(dict(pairwise.launches), res["steps"]), file=sys.stderr)
    peak = port.memory_peak(r.device)
    _train.release(st)
    ref = reference_run(st)
    got = _train.readings(st.produced, ref, st.weights)
    counts = {"steps": res["traced_steps"], "batch_size": r.cell.traffic["batch_size"]}
    return core.Outcome(metrics={"train_qps": res["train_qps"], "setup_s": res["setup_s"]},
                        attempted=res["steps"], failed=res["failed"], readings=got, memory_peak_bytes=peak,
                        trace=tracer.slice, counts=counts)


def calibrate(r: core.Run, controls: List[str]) -> Dict[str, Dict[str, float]]:
    """The program's readings on this seed, and each control's: the
    reference in a lower precision (``fp8``) or with a fault
    (``half_batch``) put in the program's place."""
    st = prepare(r)
    _train.release(st)
    ref = reference_run(st)
    out = {"program": _train.readings(st.produced, ref, st.weights)}
    for name in controls:
        if name == "half_batch":
            other = reference_run(st, half_batch=True)
        else:
            other = reference_run(st, reference.PRECISIONS[name])
        out[name] = _train.readings(other, ref, st.weights)
    return out
