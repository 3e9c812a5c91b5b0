"""Benchmark of the port: ``python -m rnet_torch.bench``.

Port of the top-level ``bench.py``. It prints ONE JSON line with
``bench.py``'s keys, plus ``device``::

    {"metric": "clevr_fp_train_questions_per_sec_per_chip", "value": N,
     "unit": "questions/s", "vs_baseline": N, "backend": "cuda",
     "batch_size": B, "baseline_def": ..., "infer_qps": N,
     "xla_impl_train_qps": N, "vs_v100_fp32_flop_bound": N,
     "vs_a100_tf32_flop_bound": N, "device": "<name>, <power limit>"}

The metric is ``bench.py``'s: train-step throughput of the flagship
from-pixels RN (``original-fp`` at full width, bf16) through the kernels
(``rl_impl`` "auto": ``pairwise_fwd`` and ``pairwise_bwd``) at B =
``RNET_BENCH_BS`` (default 512), with seeded random weights, vocabulary 90,
Adam at LR 1e-4 (a device LR, capturable) and clip 50, on one resident
batch: uint8 128 x 128 images (unpadded, so nothing is augmented, as in
rnet), questions drawn from 1-79, answers from 0-27.

Timing. ``bench.py`` runs K steps in one jit dispatch (a ``fori_loop``) and
differences two K (``rnet/utils/timing.py``). Here one chunk of ``K`` steps
(``steps.make_chunked_steps``, every step on the same batch) is captured in
a CUDA graph once per arm and replayed. Windows of N1 and N2 replays are
timed on the host clock, each ending in ``torch.cuda.synchronize()``, the
least of 3 each, and a step takes (T(N2) - T(N1)) / ((N2 - N1) K). N2 is
picked from two probe windows so that a window lasts about ``target_s``
(2 s, as in rnet), with rnet's ``_pick_k`` guard against a poisoned probe
(``pick_windows``). The eval arm does the same with one eval chunk of K
evaluations, which the stream runs one after another as rnet's loop chains
each on the last.

Arms: "auto" (the metric), the eval arm on "auto" (``infer_qps``) and
"xla" (the decomposed plain-torch path, no kernel: ``xla_impl_train_qps``).
An eval or xla arm that fails prints its traceback to stderr and leaves its
key null, as in rnet. Each arm frees its graphs before the next.

``vs_baseline``: ``bench.py``'s baseline is its torch-CPU oracle's train
questions/s, cached in ``BENCH_BASELINE.json``
(``torch_cpu_oracle_train_qps``). The port reads that file as data and
never runs the oracle (``tests/torch_oracle.py``): without the file
``vs_baseline`` is -1.0, as ``bench.py`` gives when its oracle fails. The
FLOP-model bounds (``reference_gpu_bound_qps``) are ``bench.py``'s,
computed from the port's copy of the config.

Runs on CUDA; without a card it raises. ``--platform cpu`` runs the same
functions eagerly on the CPU (no graphs) for the tests: its
numbers are CPU numbers.

Example (on the card, from the repository root)::

    python -m rnet_torch.bench
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Callable, Optional, Tuple

import torch

from .config import _REPO_ROOT, load_config
from .models import RN
from .train import steps

METRIC = "clevr_fp_train_questions_per_sec_per_chip"
BASELINE_PATH = os.path.join(_REPO_ROOT, "BENCH_BASELINE.json")
MODEL = "original-fp"
VOCAB = 90  # bench.py's vocabulary size
LR, CLIP = 1e-4, 50.0  # bench.py's optimizer
SEED = 0
STEPS_PER_CHUNK = 16  # K: steps (or evaluations) a captured chunk runs
TARGET_S = 2.0  # seconds a long window should last (bench.py's target)
PROBES = (1, 6)  # chunk calls in the two probe windows (16 and 96 steps at K=16, as rnet probes)
REPEATS = 3  # windows of each length; the least is kept
MIN_STEPS, MAX_STEPS = 64, 50_000  # _pick_k's bounds on the long window, in steps


def reference_gpu_bound_qps(config_path: Optional[str] = None) -> dict:
    """``bench.py``'s FLOP-model upper bounds for the literal reference
    algorithm on GPUs, from the port's config: per-question training FLOPs
    (forward + ~2x backward) of the fp32 pair-materializing reference, over
    a V100's fp32 and an A100's TF32 peak (perfect MFU)."""
    cfg = load_config(MODEL, config_path)
    n = cfg.grid * cfg.grid
    c = cfg.obj_feat_dim
    h = cfg.lstm_hidden
    # g chain over n^2 pairs (layer 0 sees the 2c+h concat row)
    dims = [2 * c + h] + list(cfg.g_layers)
    g = sum(2 * n * n * dims[i] * dims[i + 1] for i in range(len(cfg.g_layers)))
    fdims = [cfg.g_layers[-1], *cfg.f_layers, cfg.n_answers]
    f = sum(2 * a * b for a, b in zip(fdims[:-1], fdims[1:]))
    # conv stack (stride-2, same channels) + LSTM over question_max_len
    conv, s, cin = 0, cfg.image_size, 3
    for ch in cfg.conv_channels:
        s //= 2
        conv += 2 * s * s * ch * cfg.conv_kernel**2 * cin
        cin = ch
    lstm = 2 * 4 * cfg.question_max_len * h * (cfg.lstm_word_emb + h)
    train = 3 * (g + f + conv + lstm)
    return {
        "v100_fp32_peak_tflops": 15.7,
        "a100_tf32_peak_tflops": 156.0,
        "train_flops_per_question": train,
        "v100_fp32_bound_qps": round(15.7e12 / train),
        "a100_tf32_bound_qps": round(156.0e12 / train),
    }


def get_torch_baseline(path: str = BASELINE_PATH) -> float:
    """``bench.py``'s cached torch-CPU oracle train questions/s, read as
    data; NaN without the file (the port never runs the oracle)."""
    if not os.path.exists(path):
        return float("nan")
    with open(path) as f:
        return float(json.load(f)["torch_cpu_oracle_train_qps"])


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (its
    first card); on the CPU "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(device)}, power limit not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]


def bench_setup(rl_impl: str, batch_size: int, device, config_path: Optional[str] = None):
    """(train state, batch) of ``bench.py``'s ``_bench_setup``: original-fp
    with ``rl_impl``, weights and dropout draws from ``SEED``, Adam (LR 1e-4,
    clip 50), and one resident batch made on ``device`` from ``SEED``."""
    dev = torch.device(device)
    cfg = load_config(MODEL, config_path, {"rl_impl": rl_impl})
    model = RN(cfg, VOCAB, generator=torch.Generator().manual_seed(SEED)).to(dev)
    state = steps.create_train_state(model, steps.make_optimizer(LR, CLIP), seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    S, B = cfg.image_size, batch_size
    batch = {
        "image": torch.randint(0, 255, (B, S, S, 3), generator=gen, device=dev, dtype=torch.int32).to(torch.uint8),
        "question": torch.randint(1, 80, (B, cfg.question_max_len), generator=gen, device=dev, dtype=torch.int32),
        "answer": torch.randint(0, 28, (B,), generator=gen, device=dev, dtype=torch.int32),
    }
    return state, batch


def pick_windows(ta: float, tb: float, k: int, target_s: float = TARGET_S) -> Tuple[int, int]:
    """(N1, N2) chunk calls of ``k`` steps from the probe windows' seconds
    ``ta`` = T(PROBES[0] calls) and ``tb`` = T(PROBES[1] calls): rnet's
    ``_pick_k`` in chunk units (at K=16 the probes are its 16 and 96 steps).
    The differenced per-step estimate stands unless a hiccup poisoned it (not
    in (0, tb's per-step time]), when that upper bound stands in; the long
    window is target_s / estimate steps, clamped to [MIN_STEPS, MAX_STEPS]
    and rounded up to whole chunks, the short one a fifth of it (at least 1)."""
    na, nb = PROBES
    est_ub = tb / (nb * k)  # per-step can never exceed this (the constant included)
    est = (tb - ta) / ((nb - na) * k)
    if not (0 < est <= est_ub):
        est = est_ub
    steps_long = int(min(max(target_s / est, MIN_STEPS), MAX_STEPS))
    n2 = max(-(-steps_long // k), 2)
    return max(n2 // 5, 1), n2


@dataclasses.dataclass
class Measured:
    """One arm's result: questions/s, the differenced seconds a step, the
    steps a chunk, the windows (N1, N2), the chunk calls made (warm-up,
    probes and windows: each ran ``k`` steps), the first call's outputs,
    the train state and the graph pool's MB (None eagerly)."""

    qps: float
    step_s: float
    k: int
    windows: Tuple[int, int]
    calls: int
    first: Any
    state: steps.TrainState
    pool_mb: Optional[float] = None

    @property
    def steps(self) -> int:
        return self.calls * self.k


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure(call: Callable[[], Any], state, k: int, batch_size: int, graphs, target_s: float) -> Measured:
    """Differenced windows of ``call``, one chunk of ``k`` steps (see the
    module docstring)."""
    dev = state.device
    calls = 0

    def window(n: int) -> float:
        nonlocal calls
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        _sync(dev)
        calls += n
        return time.perf_counter() - t0

    first = call()  # captures the chunk on CUDA
    calls += 1
    ta, tb = window(PROBES[0]), window(PROBES[1])
    n1, n2 = pick_windows(ta, tb, k, target_s)
    t1 = min(window(n1) for _ in range(REPEATS))
    t2 = min(window(n2) for _ in range(REPEATS))
    step_s = max((t2 - t1) / ((n2 - n1) * k), 1e-9)
    pool = None
    if graphs is not None:
        pool = sum(c.pool_bytes for c in graphs.captured.values()) / 2**20
        graphs.clear()
    return Measured(batch_size / step_s, step_s, k, (n1, n2), calls, first, state, pool)


def _chunk_inputs(batch_size: int, k: int, device: torch.device):
    idx = torch.arange(batch_size, dtype=torch.int32, device=device).repeat(k, 1)
    return idx, torch.ones((k, batch_size), dtype=torch.bool, device=device)


def measure_train_qps(rl_impl: str, batch_size: int, device="cuda", *, config_path: Optional[str] = None,
                      k: int = STEPS_PER_CHUNK, target_s: float = TARGET_S) -> Measured:
    """Train questions/s of original-fp through ``rl_impl``: one chunk of
    ``k`` train steps on the resident batch (``bench.py``'s ``fori_loop``),
    replayed from a CUDA graph on the card and run eagerly on the CPU."""
    state, batch = bench_setup(rl_impl, batch_size, device, config_path)
    graphs = steps.step_graphs(state) if state.device.type == "cuda" else None
    train_chunk, _ = steps.make_chunked_steps(state, graphs)
    idx, _ = _chunk_inputs(batch_size, k, state.device)
    return _measure(lambda: train_chunk(idx, batch), state, k, batch_size, graphs, target_s)


def measure_infer_qps(rl_impl: str, batch_size: int, device="cuda", *, config_path: Optional[str] = None,
                      k: int = STEPS_PER_CHUNK, target_s: float = TARGET_S) -> Measured:
    """Eval questions/s of original-fp through ``rl_impl``: one chunk of
    ``k`` eval steps on the resident batch, as the train arm."""
    state, batch = bench_setup(rl_impl, batch_size, device, config_path)
    graphs = steps.step_graphs(state) if state.device.type == "cuda" else None
    _, eval_chunk = steps.make_chunked_steps(state, graphs)
    idx, valid = _chunk_inputs(batch_size, k, state.device)
    return _measure(lambda: eval_chunk(idx, valid, batch), state, k, batch_size, graphs, target_s)


def _optional_arm(what: str, fn) -> float:
    """q/s of an arm whose failure leaves its key null (its traceback on stderr)."""
    try:
        return fn().qps
    except Exception:  # the run goes on without this arm, as bench.py's does
        print(f"bench: the {what} arm failed:", file=sys.stderr)
        traceback.print_exc()
        return float("nan")
    finally:
        torch.cuda.empty_cache()  # the arm's graph pool (a no-op without CUDA)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m rnet_torch.bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="default: run on CUDA (raises without a card); cpu: run eagerly on the CPU")
    p.add_argument("--config", default=None, help="config.json path (default: the repository's)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from .serve import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    batch_size = int(os.environ.get("RNET_BENCH_BS", "512"))
    kw = {"config_path": args.config, "k": STEPS_PER_CHUNK, "target_s": TARGET_S}
    fused = measure_train_qps("auto", batch_size, device, **kw).qps
    torch.cuda.empty_cache()
    infer = _optional_arm("infer", lambda: measure_infer_qps("auto", batch_size, device, **kw))
    xla_alg = _optional_arm("xla", lambda: measure_train_qps("xla", batch_size, device, **kw))
    torch_qps = get_torch_baseline(BASELINE_PATH)
    vs_baseline = fused / torch_qps if torch_qps == torch_qps else -1.0
    gpu = reference_gpu_bound_qps(args.config)
    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": round(fused, 1),
                "unit": "questions/s",
                "vs_baseline": round(vs_baseline, 2),
                "backend": device.type,
                "batch_size": batch_size,
                "baseline_def": "torch-CPU oracle train step (reference algorithm), as bench.py measured and cached "
                                "it in BENCH_BASELINE.json",
                "infer_qps": round(infer, 1) if infer == infer else None,
                "xla_impl_train_qps": round(xla_alg, 1) if xla_alg == xla_alg else None,
                # perfect-MFU FLOP-model bounds for the literal fp32 reference
                # algorithm on GPU hardware (see reference_gpu_bound_qps)
                "vs_v100_fp32_flop_bound": round(fused / gpu["v100_fp32_bound_qps"], 2),
                "vs_a100_tf32_flop_bound": round(fused / gpu["a100_tf32_bound_qps"], 2),
                "device": device_line(device),
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
