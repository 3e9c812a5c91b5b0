#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rnet_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal (exit 1, no result line) when it fails:
  1. CUDA present; print the card's name and power limit (nvidia-smi).
  2. Build every CUDA kernel of the serving path from ``rnet_torch/csrc``
     (one nvcc per source, started together); print ptxas' resource lines.
  3. Kernel vs plain version on the card at the serving path's shapes
     (original-fp B=1/64 with inject 0 and 2 as in ir-fp, wide-fp's H=512,
     a ragged small shape and a rectangular ni != nj), seeded numpy inputs
     in bf16.
  4. Serving: an ``InferenceServer`` for original-fp at full width with
     seeded random weights, buckets 1/8/64. After ``warmup()`` the launch
     counters are zeroed, a burst of encoded requests goes through the
     server's own chunk/bucket/pad code (``serve_samples``), and the
     counters are read: every served batch must have launched the kernel.
     Answers must decode with log_prob <= 0, and the log-probs must match
     the same server forced to ``rl_impl="xla"`` (decomposed plain torch).
  5. Times with CUDA events: kernel, plain version, a cuBLAS matmul chain
     on the materialised pair rows (``library_ms``) and the roofline bound,
     at B = 1, 64 and 512; serve latency per bucket on the host clock;
     a torch.profiler breakdown of one served forward at buckets 1 and 64
     (device busy time by kernel, and the device's idle share).
Then one JSON line of kernel records and, last, the device line.

Only torch, numpy and ``rnet_torch`` are imported (never JAX or ``rnet``).
fp32 comparisons run with TF32 off for matmuls and convolutions.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call of fn over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def pair_inputs(torch, B, n, H, L, seed):
    """Seeded numpy inputs of the pairwise core, as bf16 CUDA tensors."""
    import numpy as np

    rs = np.random.RandomState(seed)
    arrs = (
        rs.randn(B, n, H) * 0.3,
        rs.randn(B, n, H) * 0.3,
        rs.randn(B, H) * 0.1,
        rs.randn(B, H) * 0.1,
        rs.randn(L - 1, H, H) / np.sqrt(H),
        rs.randn(L - 1, H) * 0.05,
    )
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", torch.bfloat16) for a in arrs]


def library_chain(torch, u, v, s, qa, ws, bs, inject):
    """The same function through cuBLAS bf16 matmuls on materialised pair
    rows (the decomposed path): the yardstick, used nowhere in the port."""
    B, n, H = u.shape
    a = torch.relu(u[:, :, None, :] + v[:, None, :, :] + s[:, None, None, :]).reshape(B, n * n, H)
    for l in range(1, ws.shape[0] + 1):
        pre = torch.matmul(a, ws[l - 1]) + bs[l - 1]
        if l == inject:
            pre = pre + qa[:, None, :]
        a = torch.relu(pre)
    return a.float().sum(dim=1)


def bound(B, ni, nj, H, L):
    """(bound_ms, bound_by): tensor-core FLOPs of the L-1 layers vs bytes of
    the inputs read once and the output written once."""
    flops = 2.0 * B * ni * nj * (L - 1) * H * H
    nbytes = 2.0 * (B * ni * H + B * nj * H + 2 * B * H + (L - 1) * H * H + (L - 1) * H) + 4.0 * B * H
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_forward(torch, server, inputs, q, reps: int = 5):
    """Device time by kernel name for one served forward (torch.profiler):
    (busy_ms per forward, kernel launches per forward, top rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    server.log_probs(inputs, q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            server.log_probs(inputs, q)
        torch.cuda.synchronize()
    rows = [
        (e.self_device_time_total / 1e3 / reps, e.count / reps, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), sum(r[1] for r in rows), rows[:6]


def main() -> int:
    import torch

    # ---- 1. the card ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    try:
        import numpy as np

        from rnet_torch.config import load_config
        from rnet_torch.data.vocab import (
            CLEVR_BOOLS, CLEVR_COLORS, CLEVR_MATERIALS, CLEVR_NUMBERS,
            CLEVR_SHAPES, CLEVR_SIZES, Dictionaries,
        )
        from rnet_torch.kernels import build
        from rnet_torch.kernels import pairwise as pw
        from rnet_torch.serve import InferenceServer
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | device {kind}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.build([pw.KERNEL])
    log(f"build: {pw.KERNEL} in {time.perf_counter() - t0:.1f} s")
    with open(build.log_path(pw.KERNEL)) as f:
        for line in f:
            if "registers" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain ----
    # Tolerance: the kernel and the plain version round at the same points
    # (bf16 after every relu) but sum each product in a different fp32
    # order, which flips the bf16 rounding of a few activations by one ulp
    # (2^-8 relative); the flips add with random signs over the n^2 pooled
    # rows. Bound: 2e-3 of the largest pooled value, plus 1e-2.
    cases = [  # (B, ni, nj, H, L, inject): original-fp, ir-fp, wide-fp, ragged, rectangular
        (1, 64, 64, 256, 4, 0), (64, 64, 64, 256, 4, 0), (1, 64, 64, 256, 4, 2),
        (64, 64, 64, 256, 4, 2), (64, 64, 64, 512, 4, 0), (3, 12, 12, 128, 3, 1),
        (2, 16, 64, 256, 4, 1),
    ]
    max_err = 0.0
    for k, (B, ni, nj, H, L, inject) in enumerate(cases):
        args = pair_inputs(torch, B, nj, H, L, seed=k)
        args[0] = args[0][:, :ni].contiguous()
        out = pw.pairwise_fwd_cuda(*args, inject=inject)
        ref = pw.pairwise_core_reference(*args, inject=inject)
        torch.cuda.synchronize()
        if out.shape != (B, H) or not torch.isfinite(out).all():
            fail(f"kernel output at {(B, ni, nj, H, L, inject)} is not finite (B, H)")
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        tol = 2e-3 * scale + 1e-2
        log(f"kernel vs plain B={B} ni={ni} nj={nj} H={H} L={L} inject={inject}: "
            f"max_abs_err {err!r} (max|ref| {scale!r}, tol {tol!r})")
        if not err <= tol:
            fail(f"pairwise_fwd disagrees with its plain version at {(B, ni, nj, H, L, inject)}")
        max_err = max(max_err, err)

    # ---- 4. serving original-fp at full width ----
    answers = [*CLEVR_NUMBERS, *CLEVR_BOOLS, *CLEVR_COLORS, *CLEVR_SHAPES, *CLEVR_MATERIALS, *CLEVR_SIZES]
    words = (
        "are there any other things that have the same size as the what color is "
        "how many objects of material shape made behind in front of left right "
        "does it a an number greater less than more fewer both cubes spheres "
        "cylinders large small metal rubber either is there visible"
    ).split() + [*CLEVR_COLORS, *CLEVR_SHAPES]
    dicts = Dictionaries({w: i + 1 for i, w in enumerate(dict.fromkeys(words))}, {a: i for i, a in enumerate(answers)})
    cfg = load_config("original-fp").replace(n_answers=dicts.n_answers)
    server = InferenceServer(cfg, dicts, max_batch=64, device="cuda")
    server.init_weights(seed=0)
    if server.model.relational.resolve_impl(cfg.n_objects, server.device) != "pallas":
        fail("rl_impl=auto does not route original-fp to the kernel on the card")
    rs = np.random.RandomState(1)
    vocab = list(dicts.word_to_idx)

    def sample():
        q = " ".join(rs.choice(vocab, size=rs.randint(5, 30)))
        return {
            "question": dicts.encode_question(q, cfg.question_max_len),
            "image": rs.randint(0, 256, size=(cfg.image_size, cfg.image_size, 3), dtype=np.uint8),
        }

    burst = [sample() for _ in range(100)]
    server.warmup()
    torch.cuda.synchronize()
    pw.launches = 0
    results = server.serve_samples(burst) + server.serve_samples(burst[:1]) + server.serve_samples(burst[:5])
    main_launches = pw.launches
    served_batches = 2 + 1 + 1  # 64 + 36 (bucket 64), 1 (bucket 1), 5 (bucket 8)
    log(f"serve: {len(results)} answers, buckets {sorted({r['bucket'] for r in results})}, "
        f"pairwise_fwd launches {main_launches} for {served_batches} served batches")
    if main_launches != served_batches:
        fail(f"expected one pairwise_fwd launch per served batch ({served_batches}), counted {main_launches}")
    for r in results:
        if r["answer"] not in dicts.answer_to_idx or not r["log_prob"] <= 0.0:
            fail(f"bad served result {r}")
    if sorted({r["bucket"] for r in results}) != [1, 8, 64]:
        fail("the burst did not use every bucket")

    xla = InferenceServer(cfg.replace(rl_impl="xla"), dicts, max_batch=64, device="cuda")
    xla.init_weights(seed=0)
    inputs, q = server.batch_arrays(burst[:64], 64)
    lp_k = server.log_probs(inputs, q)
    lp_x = xla.log_probs(inputs, q)
    if lp_k.shape != (64, dicts.n_answers) or not torch.isfinite(lp_k).all():
        fail("served log-probs are not finite (64, n_answers)")
    # The xla path rounds the pooled sum to bf16 (2^-9 relative) and adds
    # u + v + s in bf16, where the kernel pools and adds in fp32; f_phi
    # carries those relative errors into the logits. Bound: 2e-2 of the
    # largest |log-prob| plus 2e-2.
    lp_err = (lp_k - lp_x).abs().max().item()
    lp_scale = lp_x.abs().max().item()
    agree = (lp_k.argmax(-1) == lp_x.argmax(-1)).float().mean().item()
    log(f"serve kernel vs xla log-probs: max_abs_err {lp_err!r} (max|logp| {lp_scale!r}), argmax agreement {agree!r}")
    if not lp_err <= 2e-2 * lp_scale + 2e-2:
        fail("served log-probs of the kernel path disagree with the xla path")

    # ---- 5. times ----
    rows = []
    for B in (1, 64, 512):
        n, H, L, inject = cfg.n_objects, cfg.g_layers[0], len(cfg.g_layers), cfg.question_injection_position
        args = pair_inputs(torch, B, n, H, L, seed=100 + B)
        iters = 50 if B <= 64 else 10
        ms = cuda_ms(torch, lambda: pw.pairwise_fwd_cuda(*args, inject=inject), iters)
        plain_ms = cuda_ms(torch, lambda: pw.pairwise_core_reference(*args, inject=inject), max(iters // 5, 2), warmup=1)
        library_ms = cuda_ms(torch, lambda: library_chain(torch, *args, inject), iters)
        b_ms, b_by = bound(B, n, n, H, L)
        rows.append({"B": B, "n": n, "H": H, "L": L, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "tflops": 2.0 * B * n * n * (L - 1) * H * H / (ms * 1e-3) / 1e12})
        log(f"time pairwise_fwd {json.dumps(rows[-1])}")
        del args
        torch.cuda.empty_cache()

    latency = {}
    for bucket in server.buckets:
        batch = burst[:bucket]
        for _ in range(3):
            server.serve_samples(batch)
        lat = sorted(server.serve_samples(batch)[0]["latency_ms"] for _ in range(20))
        latency[bucket] = {"median_ms": lat[len(lat) // 2], "min_ms": lat[0], "max_ms": lat[-1]}
    t0 = time.perf_counter()
    big = burst * 7  # 700 requests, 11 full buckets of 64 + one of 60
    server.serve_samples(big)
    qps = len(big) / (time.perf_counter() - t0)
    log(f"serve latency per bucket (host clock, ms): {json.dumps(latency)}")
    log(f"serve burst throughput: {qps!r} questions/s over {len(big)} requests")
    for bucket in (1, 64):
        inputs, q = server.batch_arrays(burst[:bucket], bucket)
        busy, n_kernels, top = profile_forward(torch, server, inputs, q)
        wall = cuda_ms(torch, lambda: server.log_probs(inputs, q), 20)
        log(f"profile bucket {bucket}: forward {wall!r} ms (CUDA events), device busy {busy!r} ms "
            f"in {n_kernels!r} kernels, idle share {1.0 - busy / wall!r}")
        for ms_k, count, name in top:
            log(f"  {ms_k!r} ms x{count!r} {name[:100]}")

    main_row = rows[1]  # the B=64 serving bucket
    record = {
        "name": pw.KERNEL, "route": "cuda", "source": "rnet_torch/csrc/pairwise_fwd.cu",
        "replaces": "rnet/kernels/pairwise.py:83", "launches": main_launches,
        "max_abs_err": max_err, "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "shape": {k: main_row[k] for k in ("B", "n", "H", "L")},
        "ok": True,
    }
    log(card)
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
