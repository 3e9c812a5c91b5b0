#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rnet_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal (exit 1, no result line) when it fails:
  1. CUDA present; print the card's name and power limit (nvidia-smi).
  2. Build every CUDA kernel of the serving, training and int8 inference
     paths from ``rnet_torch/csrc`` (one nvcc per source, started together),
     and beside them the phase-timing build of the two bf16 pairwise kernels
     (``-DRNET_PHASE_TIMES``); print ptxas' resource lines.
  3. Forward kernel vs plain version on the card at the paths' shapes
     (original-fp B=1/64/512 with inject 0 and 2 as in ir-fp, wide-fp's
     H=512 at B=64 and at B=140 > the SM count, a ragged small shape, a
     rectangular ni != nj and stretch-fp-32's 1,024 objects), seeded numpy
     inputs in bf16, at pair_keep 1 and 0.75.
  4. Philox pair mask: the mask kernel's bits equal ``pair_mask_reference``
     exactly.
  5. Backward kernel vs plain version at the same shapes and keeps, and the
     same launch twice gives bitwise-equal gradients. The shapes with B above
     the SM count (the training shape B=512, and B=140 at H=512) are the
     ones where a CTA of the backward's persistent grid owns several
     samples.
 5b. The int8 kernel (``pairwise_fwd_int8``) vs its plain version on the
     same folded inputs (``quantize_int8``): original-fp B = 1, 64, 512 and
     ir-fp (inject 2) B=64 through ``pairwise_core_int8``, wide-fp's H=512
     at B=64 and B=140, n=24 and a rectangular ni != nj through the wrapper;
     each within 1e-5 of max|plain| and within 3e-2 of the fp32
     ``pairwise_core_reference``; the B=512 launch twice, bitwise.
  6. Serving: an ``InferenceServer`` for original-fp at full width with
     seeded random weights, buckets 1/8/64. After ``warmup()`` the launch
     counters are zeroed, a burst of encoded requests goes through the
     server's own chunk/bucket/pad code (``serve_samples``), and the
     counters are read: every served batch must have launched the forward
     kernel. Answers must decode with log_prob <= 0, and the log-probs must
     match the same server forced to ``rl_impl="xla"``.
 6b. Int8 serving: the same server with ``rl_impl="pallas_int8"`` (same
     weights) and the same burst, with warnings as errors (a "NOT int8"
     fallback fails the run): one ``pairwise_fwd_int8`` launch per served
     batch and no ``pairwise_fwd`` launch; the share of answers equal to
     the bf16 server's and the largest |log-prob difference| are logged.
  7. Training original-fp at full width, B=512 (the shape rnet's bench.py
     times), ``rl_impl=auto``, through ``rnet_torch.train.steps``: after a
     warm-up step the counters are zeroed and K steps taken; forward and
     backward kernels must each count K launches; losses and gradient norms
     finite, the loss falling on the fixed batch; the same gradient twice
     bitwise; one step with pair dropout 0.25 draws the mask in both
     kernels; the kernel path's loss and gradients agree with the ``xla``
     path's.
  8. Times with CUDA events: each kernel, its plain version, one PyTorch
     yardstick (``library_ms``) and the roofline bound; the phase breakdown
     of ``pairwise_fwd`` and ``pairwise_bwd`` at B = 64 and 512 (the
     phase-timing build: clock64() cycles per phase summed over the CTAs'
     first consumer threads, as shares of their total); serve latency per
     bucket and train questions/s on the host clock (kernel and xla paths in
     the order kernel xla xla kernel); torch.profiler
     breakdowns of a served forward and of a train step (device busy time by
     kernel, and the device's idle share). The int8 kernel at B = 64 and
     512 (its yardstick: ``torch._int_mm`` on materialised pair rows), a
     profile of one int8 eval batch at B=512 beside the bf16 one (the
     calibration and folding ops around the kernel included), and serve
     latency per bucket and burst throughput of the bf16 and int8 servers,
     taken in turns (bf16 int8 int8 bf16).
  9. Augment kernel vs its plain version on the card: B = 1, 7 and 512, fp32
     and bf16 outputs, angles of ±2.8 degrees and 0, the four corner offsets
     (where the shears wrap around the canvas), repeated indices, a cache of
     2,048 canvases and a full-size CLEVR train cache of 70,000 x 144^2 x 3
     uint8 (4.35 GB, made on the card from a seed) with indices above
     34,500, and a batch-local source (idx = arange(B)). Angle 0 at offset
     (8, 8) must give the centre crop x (1/255) exactly; an index outside
     the cache gives NaN rows.
 10. Training through the entry point, ``rnet_torch.train.__main__.main``,
     on a synthetic CLEVR directory the script writes itself (seeded
     questions over every answer and family; the decoded caches written
     directly, so nothing is decoded): (a) original-fp, device pipeline,
     B=512, 2 epochs of 16 steps, checkpoints and reports; after the launch
     counters are zeroed, augment = pairwise_bwd = train steps and
     pairwise_fwd = train steps + eval batches; (b) the same resumed from a
     copy of epoch 1 must give epoch 2's loss and parameters bit for bit;
     (c) the cached pipeline (one augment launch per step, batch-local);
     (d) the device pipeline with --no-device-augment (no augment launch).
     Runs (a)-(d) use cuDNN's deterministic algorithms; (a) and (d) then run
     again in the order a d d a with cuDNN free to choose, as the entry
     point runs. Then the augment kernel's times (2,048 and 70,000
     canvases, cold in L2), its plain version and bound, the epoch
     questions/s of every run, one train step of (a) and of (d) timed
     alternately in both cuDNN modes, and a profile of each with the
     kernels whose device time differs most between them.
10b. The eval entry point, ``rnet_torch.evaluate.main``, on (a)'s epoch-2
     checkpoint: ``--data-pipeline device --split train --batch-size 512``
     (8,192 questions, 16 batches), as is (16 ``pairwise_fwd`` launches,
     no ``augment``, no int8) and with ``--rl-impl pallas_int8`` under
     warnings as errors (16 ``pairwise_fwd_int8`` launches and nothing else,
     the clip-fraction line printed), in the order bf16 int8 int8 bf16;
     finite accuracy and NLL and the report files from each, the share of
     equal predictions, and the eval questions/s of each run (host clock).
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
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)
PEAK_INT32_OPS = 33.5e12  # half the 67 TFLOP/s fp32 CUDA-core rate: 64 INT32 lanes per SM beside 128 FP32
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
TRAIN_B = 512  # rnet's bench.py batch
TRAIN_STEPS = 5
VOCAB = 90  # bench.py's vocabulary size
LR = 1e-4  # bench.py's learning rate (clip 50)
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
CANVAS, CROP = 144, 128  # padded CLEVR canvas, model input
CLEVR_TRAIN_IMAGES = 70_000  # CLEVR v1.0 train split
AUG_SMALL = 2_048  # the synthetic run's train images
SYN_TRAIN_Q, SYN_VAL_IMAGES, SYN_VAL_Q = 8_192, 256, 1_024  # 16 train steps of 512 per epoch


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


def upstream(torch, B, H, seed):
    """A seeded fp32 (B, H) upstream gradient of the pooled core."""
    import numpy as np

    return torch.from_numpy(np.random.RandomState(seed).randn(B, H).astype(np.float32)).cuda()


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


def library_vjp(torch, args, g, inject):
    """torch.autograd.grad through library_chain: the backward's yardstick
    (forward and backward of the cuBLAS chain, as the kernel recomputes)."""
    xs = [a.detach().requires_grad_() for a in args]
    return torch.autograd.grad(library_chain(torch, *xs, inject), xs, g, allow_unused=True)


def roofline(flops, nbytes, peak_ops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fwd_bound(B, ni, nj, H, L):
    """(bound_ms, bound_by): tensor-core FLOPs of the L-1 layers vs bytes of
    the inputs read once and the output written once."""
    flops = 2.0 * B * ni * nj * (L - 1) * H * H
    nbytes = 2.0 * (B * ni * H + B * nj * H + 2 * B * H + (L - 1) * H * H + (L - 1) * H) + 4.0 * B * H
    return roofline(flops, nbytes)


def int8_bound(B, ni, nj, H, L):
    """(bound_ms, bound_by) of the int8 kernel: int8 tensor-core operations
    of the L-1 layers vs the bytes of its folded inputs read once (u, v, s
    bf16; qa, m, b fp32; w8 int8) and the fp32 output written once."""
    ops = 2.0 * B * ni * nj * (L - 1) * H * H
    nbytes = 2.0 * (B * ni * H + B * nj * H + B * H) + 4.0 * (B * H + (L - 1) * (H + 1) + B * H) + (L - 1) * H * H
    return roofline(ops, nbytes, peak_ops=PEAK_INT8_OPS)


def bwd_bound(B, ni, nj, H, L):
    """Recompute, d = dpre W^T and dW = a^T dpre: 3x the forward's FLOPs;
    bytes: the bf16 inputs and fp32 g read once, the fp32 gradients written."""
    flops = 3 * 2.0 * B * ni * nj * (L - 1) * H * H
    n_in = B * ni * H + B * nj * H + 2 * B * H + (L - 1) * H * H + (L - 1) * H
    nbytes = 2.0 * n_in + 4.0 * B * H + 4.0 * n_in
    return roofline(flops, nbytes)


def mask_bound(B, npairs):
    """Philox4x32-10 for one word: 10 rounds of 2 mulhi, 2 mullo, 2 xor-3,
    2 key adds (~12 int32 ops) plus the threshold test; one byte written."""
    return roofline(B * npairs * 121.0, B * npairs * 1.0, peak_ops=PEAK_INT32_OPS)


def profile_device(torch, fn, reps: int = 3):
    """Device time by kernel name for one call of fn (torch.profiler):
    (busy_ms per call, kernel launches per call, top rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [
        (e.self_device_time_total / 1e3 / reps, e.count / reps, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), sum(r[1] for r in rows), rows


def log_profile(torch, what, fn, wall_ms, top=8):
    """Log the profile of fn; returns (busy ms, every (ms, count, name) row)."""
    busy, n_kernels, rows = profile_device(torch, fn)
    log(f"profile {what}: {wall_ms!r} ms (CUDA events), device busy {busy!r} ms "
        f"in {n_kernels!r} kernels, idle share {1.0 - busy / wall_ms!r}")
    for ms_k, count, name in rows[:top]:
        log(f"  {ms_k!r} ms x{count!r} {name[:100]}")
    return busy, rows


# Kernel agreement cases (B, ni, nj, H, L, inject): original-fp B=1/64,
# ir-fp (inject 2) B=1/64, wide-fp (H=512), ragged n=12, rectangular,
# stretch-fp-32's grid of 1,024 objects (a million pair rows), and two with
# B above the SM count (132 on an H100 SXM), where each CTA of the
# backward's persistent grid of min(B, SMs) takes several samples into one
# dW/db partial: original-fp at the training shape B=512 (3-4 samples a
# CTA, 128-row blocks) and H=512 with inject 2 at B=140 (64-row blocks).
TRAIN_CASE = (TRAIN_B, 64, 64, 256, 4, 0)
CASES = [
    (1, 64, 64, 256, 4, 0), (64, 64, 64, 256, 4, 0), (1, 64, 64, 256, 4, 2),
    (64, 64, 64, 256, 4, 2), (64, 64, 64, 512, 4, 0), (3, 12, 12, 128, 3, 1),
    (2, 16, 64, 256, 4, 1), (1, 1024, 1024, 256, 4, 1), TRAIN_CASE, (140, 64, 64, 512, 4, 2),
]
KEEPS = (1.0, 0.75)
GRAD_NAMES = ("du", "dv", "ds", "dqa", "dws", "dbs")


def check_forward(torch, pw, seed):
    """Phase 3; returns the largest |kernel - plain| over all cases and at
    TRAIN_CASE."""
    # Tolerance: the kernel and the plain version round at the same points
    # (bf16 after every relu) but sum each product in a different fp32
    # order, which flips the bf16 rounding of a few activations by one ulp
    # (2^-8 relative); the flips add with random signs over the n^2 pooled
    # rows. Bound: 2e-3 of the largest pooled value, plus 1e-2. Under pair
    # dropout the same holds, and a mask that differed from the plain
    # version's in even one pair would add a whole row (~1/n^2 of the pool
    # times 1/keep), above the bound at the ragged shape and, for a mask of
    # other bits, everywhere.
    max_err = at_shape = 0.0
    for k, (B, ni, nj, H, L, inject) in enumerate(CASES):
        args = pair_inputs(torch, B, nj, H, L, seed=k)
        args[0] = args[0][:, :ni].contiguous()
        for keep in KEEPS:
            out = pw.pairwise_fwd_cuda(*args, inject=inject, pair_keep=keep, seed=seed)
            ref = pw.pairwise_core_reference(*args, inject=inject, keep=keep, seed=seed)
            torch.cuda.synchronize()
            case = (B, ni, nj, H, L, inject, keep)
            if out.shape != (B, H) or not torch.isfinite(out).all():
                fail(f"pairwise_fwd output at {case} is not finite (B, H)")
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = 2e-3 * scale + 1e-2
            log(f"pairwise_fwd vs plain B={B} ni={ni} nj={nj} H={H} L={L} inject={inject} keep={keep}: "
                f"max_abs_err {err!r} (max|ref| {scale!r}, tol {tol!r})")
            if not err <= tol:
                fail(f"pairwise_fwd disagrees with its plain version at {case}")
            max_err = max(max_err, err)
            if CASES[k] == TRAIN_CASE:
                at_shape = max(at_shape, err)
        del args, out, ref
        torch.cuda.empty_cache()
    return max_err, at_shape


def check_mask(torch, pw, seed):
    """Phase 4; returns the number of bits that differ (must be 0)."""
    for B, ni, nj in ((TRAIN_B, 64, 64), (3, 12, 12), (2, 16, 64)):
        for keep in (0.75, 0.5):
            got = pw.pair_mask_cuda(seed, B, ni, nj, keep)
            want = pw.pair_mask_reference(seed, B, ni, nj, keep)
            torch.cuda.synchronize()
            wrong = int((got != want).sum().item())
            rate = got.float().mean().item()
            log(f"pair mask B={B} ni={ni} nj={nj} keep={keep}: {wrong} bits differ from "
                f"pair_mask_reference, keep rate {rate!r}")
            if wrong or got.shape != (B, ni * nj):
                fail(f"the Philox mask kernel differs from pair_mask_reference at {(B, ni, nj, keep)}")
            sigma = (keep * (1 - keep) / got.numel()) ** 0.5
            if abs(rate - keep) > 6 * sigma:
                fail(f"keep rate {rate} is more than 6 sigma from {keep}")
    return 0


def check_backward(torch, pw, seed):
    """Phase 5; returns the largest |kernel - plain| over all gradients, over
    all cases and at TRAIN_CASE."""
    # Tolerance: the same rounding points as the plain version (bf16 after
    # every relu and for every dpre_l, l >= 1); the sums run in another fp32
    # order, so a few bf16 roundings of activations or dpre values flip by
    # one ulp (2^-8 relative) and a flip at a relu boundary switches that
    # unit's derivative. The flips are rare and of random sign: the error
    # norm stays near 1e-3 of the gradient's norm, while a single element of
    # a small-sum gradient (du of one object: nj rows) can carry one flip at
    # up to ~1% of the gradient's largest value. Bound per gradient:
    # max|k - p| <= 3e-2 * max|p| + 1e-2 and ||k - p|| <= 1e-2 * ||p||.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if not any(c[0] > sms for c in CASES):
        fail(f"no backward case has more samples than the card's {sms} SMs")
    max_err = at_shape = 0.0
    for k, (B, ni, nj, H, L, inject) in enumerate(CASES):
        args = pair_inputs(torch, B, nj, H, L, seed=k)
        args[0] = args[0][:, :ni].contiguous()
        g = upstream(torch, B, H, seed=50 + k)
        for keep in KEEPS:
            got = pw.pairwise_bwd_cuda(*args, g, inject=inject, pair_keep=keep, seed=seed)
            want = pw.pairwise_core_bwd_reference(*args, g, inject, keep, seed)
            torch.cuda.synchronize()
            case = (B, ni, nj, H, L, inject, keep)
            parts = []
            for name, d, w in zip(GRAD_NAMES, got, want):
                if d.shape != w.shape or d.dtype != torch.float32 or not torch.isfinite(d).all():
                    fail(f"pairwise_bwd {name} at {case} is not a finite fp32 {tuple(w.shape)}")
                err = (d - w).abs().max().item()
                scale = w.abs().max().item()
                rel = ((d - w).norm() / w.norm().clamp_min(1e-30)).item()
                parts.append(f"{name} {err:.4g}/{scale:.4g} rel {rel:.3g}")
                if not (err <= 3e-2 * scale + 1e-2 and rel <= 1e-2):
                    fail(f"pairwise_bwd {name} disagrees with its plain version at {case}: "
                         f"max_abs_err {err} (max {scale}), relative norm {rel}")
                max_err = max(max_err, err)
                if CASES[k] == TRAIN_CASE:
                    at_shape = max(at_shape, err)
            log(f"pairwise_bwd vs plain B={B} ni={ni} nj={nj} H={H} L={L} inject={inject} keep={keep} "
                f"({-(-B // min(B, sms))} samples per CTA at most): " + " | ".join(parts))
        if CASES[k] == TRAIN_CASE:  # the same launch twice, bitwise
            again = pw.pairwise_bwd_cuda(*args, g, inject=inject, pair_keep=0.75, seed=seed)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail("pairwise_bwd is not bitwise repeatable")
            log(f"pairwise_bwd at B={B}: the same launch twice gives bitwise-equal gradients")
            del again
        del args, g, got, want
        torch.cuda.empty_cache()
    return max_err, at_shape


# Int8 agreement cases (B, ni, nj, H, L, inject, through the core?):
# original-fp B=1/64/512, ir-fp (inject 2) B=64, wide-fp (H=512) at B=64 and
# B=140 > the SM count through ``pairwise_core_int8``; n=24 (576 pairs, a
# ragged last block of 128 rows) and a rectangular ni != nj with the
# injection at the last layer through the wrapper.
INT8_MAIN = (TRAIN_B, 64, 64, 256, 4, 0)
INT8_CASES = [
    ((1, 64, 64, 256, 4, 0), True), ((64, 64, 64, 256, 4, 0), True), (INT8_MAIN, True),
    ((64, 64, 64, 256, 4, 2), True), ((64, 64, 64, 512, 4, 0), True), ((140, 64, 64, 512, 4, 0), True),
    ((3, 24, 24, 256, 4, 1), False), ((2, 16, 40, 256, 3, 2), False),
]


def int8_args(torch, pw, case, seed):
    """(bf16 core inputs, their folded int8 form) for an agreement case."""
    B, ni, nj, H, L, inject = case
    args = pair_inputs(torch, B, nj, H, L, seed=seed)
    args[0] = args[0][:, :ni].contiguous()
    return args, pw.quantize_int8(*args, inject)


def check_int8(torch, pw):
    """Phase 5b; returns (max |kernel - plain| at INT8_MAIN, over all cases,
    the largest drift from fp32)."""
    # Tolerance: the kernel and the plain version compute the same int8 codes
    # (exact int32 products, one fma and the same adds before each requant);
    # the pooled fp32 sum over up to 4,096 rows runs in another order:
    # 1e-5 of the largest pooled value. Drift: int8 within 3e-2 of the fp32
    # chain (the bound of rnet's int8 tests).
    at_main = worst = drift_max = 0.0
    for k, (case, through_core) in enumerate(INT8_CASES):
        B, ni, nj, H, L, inject = case
        args, folded = int8_args(torch, pw, case, seed=300 + k)
        before = pw.launches[pw.INT8_KERNEL]
        if through_core:
            out = pw.pairwise_core_int8(*args, inject=inject)
        else:
            out = pw.pairwise_fwd_int8_cuda(*folded, inject=inject)
        ref = pw.pairwise_core_int8_reference(*folded, inject=inject)
        fp32 = pw.pairwise_core_reference(*(a.float() for a in args), inject=inject)
        torch.cuda.synchronize()
        if out.shape != (B, H) or out.dtype != torch.float32 or not torch.isfinite(out).all():
            fail(f"pairwise_fwd_int8 output at {case} is not a finite fp32 (B, H)")
        if pw.launches[pw.INT8_KERNEL] != before + 1:
            fail(f"pairwise_fwd_int8 at {case} did not launch the kernel once")
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        drift = ((out - fp32).abs().max() / fp32.abs().max()).item()
        log(f"pairwise_fwd_int8 vs plain B={B} ni={ni} nj={nj} H={H} L={L} inject={inject} "
            f"({'pairwise_core_int8' if through_core else 'wrapper'}): max_abs_err {err!r} "
            f"(max|plain| {scale!r}, tol {1e-5 * scale!r}); drift from fp32 {drift!r}")
        if not err <= 1e-5 * scale:
            fail(f"pairwise_fwd_int8 disagrees with its plain version at {case}")
        if not drift < 3e-2:
            fail(f"pairwise_fwd_int8 drifts {drift} from the fp32 chain at {case}")
        worst, drift_max = max(worst, err), max(drift_max, drift)
        if case == INT8_MAIN:
            at_main = err
            again = pw.pairwise_fwd_int8_cuda(*folded, inject=inject)
            if not torch.equal(again, pw.pairwise_fwd_int8_cuda(*folded, inject=inject)):
                fail("pairwise_fwd_int8 is not bitwise repeatable")
            log(f"pairwise_fwd_int8 at B={B}: the same launch twice gives bitwise-equal outputs")
        del args, folded, out, ref, fp32
        torch.cuda.empty_cache()
    return at_main, worst, drift_max


def serve_phase(torch, np, pw, cfg, dicts):
    """Phase 6 (PR 1's serving checks); returns (server, burst, launches)."""
    from rnet_torch.serve import InferenceServer

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
    pw.reset_launches()
    results = server.serve_samples(burst) + server.serve_samples(burst[:1]) + server.serve_samples(burst[:5])
    counts = dict(pw.launches)
    served_batches = 2 + 1 + 1  # 64 + 36 (bucket 64), 1 (bucket 1), 5 (bucket 8)
    log(f"serve: {len(results)} answers, buckets {sorted({r['bucket'] for r in results})}, "
        f"launches {counts} for {served_batches} served batches")
    if counts[pw.KERNEL] != served_batches or counts[pw.BWD_KERNEL] or counts["pair_mask"] or counts[pw.INT8_KERNEL]:
        fail(f"expected one pairwise_fwd launch per served batch ({served_batches}) and nothing else, counted {counts}")
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
    return server, burst, counts[pw.KERNEL]


def int8_serve_phase(torch, np, pw, cfg, dicts, server, burst):
    """Phase 6b; returns (the int8 server, launches of the int8 kernel, share
    of answers equal to the bf16 server's, largest |log-prob difference|)."""
    import warnings

    from rnet_torch.serve import InferenceServer

    s8 = InferenceServer(cfg.replace(rl_impl="pallas_int8"), dicts, max_batch=64, device="cuda")
    s8.init_weights(seed=0)  # the bf16 server's weights
    if s8.model.relational.resolve_impl(cfg.n_objects, s8.device) != "pallas_int8":
        fail("rl_impl=pallas_int8 does not resolve to the int8 path")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a "NOT int8" fallback fails the run
        s8.warmup()
        torch.cuda.synchronize()
        pw.reset_launches()
        results = s8.serve_samples(burst) + s8.serve_samples(burst[:1]) + s8.serve_samples(burst[:5])
        counts = dict(pw.launches)
    served_batches = 4
    log(f"int8 serve: {len(results)} answers, buckets {sorted({r['bucket'] for r in results})}, "
        f"launches {counts} for {served_batches} served batches")
    if counts != {pw.KERNEL: 0, pw.BWD_KERNEL: 0, "pair_mask": 0, pw.INT8_KERNEL: served_batches}:
        fail(f"expected one pairwise_fwd_int8 launch per served batch and nothing else, counted {counts}")
    bf16 = server.serve_samples(burst) + server.serve_samples(burst[:1]) + server.serve_samples(burst[:5])
    for r in results:
        if r["answer"] not in dicts.answer_to_idx or not r["log_prob"] <= 0.0:
            fail(f"bad int8 served result {r}")
    agree = float(np.mean([a["answer"] == b["answer"] for a, b in zip(results, bf16)]))
    dlp = max(abs(a["log_prob"] - b["log_prob"]) for a, b in zip(results, bf16))
    log(f"int8 vs bf16 server, same weights and burst: {agree!r} of answers equal, max |d log_prob| {dlp!r}")
    return s8, counts[pw.INT8_KERNEL], agree, dlp


def train_batch(torch, np, cfg, B, seed):
    """A seeded random uint8 batch, resident on the card as bench.py's is."""
    rs = np.random.RandomState(seed)
    batch = {
        "image": rs.randint(0, 256, size=(B, cfg.image_size, cfg.image_size, 3), dtype=np.uint8),
        "question": rs.randint(1, VOCAB, size=(B, cfg.question_max_len)).astype(np.int32),
        "answer": rs.randint(0, cfg.n_answers, size=B).astype(np.int32),
    }
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def new_state(torch, cfg, state_dict=None):
    from rnet_torch.models import RN
    from rnet_torch.train import steps

    model = RN(cfg, VOCAB, generator=torch.Generator().manual_seed(0)).cuda()
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return steps.create_train_state(model, steps.make_optimizer(LR, 50.0), seed=0)


def train_phase(torch, np, pw, cfg):
    """Phase 7; returns (kernel-path state, batch, counts of the K steps,
    counts of the pair-dropout step)."""
    from rnet_torch.train import steps

    state = new_state(torch, cfg)
    dev = torch.device("cuda")
    if state.model.relational.resolve_impl(cfg.n_objects, dev) != "pallas":
        fail("rl_impl=auto does not route original-fp training to the kernels on the card")
    batch = train_batch(torch, np, cfg, TRAIN_B, seed=2)
    steps.train_step(state, batch)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    pw.reset_launches()
    metrics = [steps.train_step(state, batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = dict(pw.launches)
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    log(f"train original-fp B={TRAIN_B}: {TRAIN_STEPS} steps, launches {counts}, "
        f"loss {losses}, grad_norm {norms}, accuracy {[float(m['accuracy']) for m in metrics]}")
    if counts[pw.KERNEL] != TRAIN_STEPS or counts[pw.BWD_KERNEL] != TRAIN_STEPS or counts["pair_mask"]:
        fail(f"expected {TRAIN_STEPS} pairwise_fwd and pairwise_bwd launches and no mask draw, counted {counts}")
    if not all(np.isfinite(losses + norms)):
        fail("a train step gave a non-finite loss or gradient norm")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall over {TRAIN_STEPS} steps on a fixed batch: {losses}")

    # The same gradient twice from the same state and dropout seed, bitwise.
    # cuDNN's convolution backward may pick an algorithm with atomics; its
    # deterministic algorithms are asked for here, and only here.
    torch.backends.cudnn.deterministic = True
    grads = []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(11)
        grads.append([g.clone() for g in steps.loss_and_grads(state.model, batch, gen)[2]])
    torch.backends.cudnn.deterministic = False
    names = [n for n, _ in state.model.named_parameters()]
    differ = [n for n, a, b in zip(names, *grads) if not torch.equal(a, b)]
    log(f"train: the same step's gradients twice: {len(names) - len(differ)} of {len(names)} tensors bitwise equal")
    if differ:
        fail(f"train-step gradients are not bitwise repeatable: {differ}")

    # One step with pair dropout: both kernels draw the Philox mask.
    pd = new_state(torch, cfg.replace(pair_dropout=0.25), state.model.state_dict())
    pw.reset_launches()
    m = steps.train_step(pd, batch)
    torch.cuda.synchronize()
    pd_counts = dict(pw.launches)
    log(f"train with pair_dropout 0.25: launches {pd_counts}, loss {float(m['loss'])!r}, "
        f"grad_norm {float(m['grad_norm'])!r}")
    if pd_counts != {pw.KERNEL: 1, pw.BWD_KERNEL: 1, "pair_mask": 2, pw.INT8_KERNEL: 0}:
        fail(f"a pair-dropout step should launch each kernel once, both drawing the mask; counted {pd_counts}")
    if not (np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))):
        fail("the pair-dropout step is not finite")
    del pd
    return state, batch, counts, pd_counts


def xla_agreement(torch, np, cfg, state, batch):
    """Phase 7, last part: the kernel path vs the xla path, dropout off,
    same weights and batch: loss and every parameter's gradient, with the
    xla path in fp32 as the yardstick of both."""
    from rnet_torch.train import steps

    cfg0 = cfg.replace(dropout=0.0)
    sd = state.model.state_dict()
    out = {}
    for tag, over in (("kernel", {}), ("xla", {"rl_impl": "xla"}),
                      ("xla_fp32", {"rl_impl": "xla", "compute_dtype": "float32"})):
        st = new_state(torch, cfg0.replace(**over), sd)
        loss, _, grads = steps.loss_and_grads(st.model, batch)
        out[tag] = (float(loss), {n: g.clone() for (n, _), g in zip(st.model.named_parameters(), grads)})
        del st
        torch.cuda.empty_cache()
    (lk, gk), (lx, gx), (l32, g32) = out["kernel"], out["xla"], out["xla_fp32"]

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    # Tolerance: the xla path adds u + v + s in bf16, rounds every matmul
    # output and bias add to bf16 and pools in bf16, where the kernels add,
    # bias and pool in fp32 and round only after each relu; its backward
    # runs in bf16 too. Those 2^-8 relative roundings give gradients of the
    # g, f and LSTM weights within a few 1e-3 of each other: bound 5e-2
    # relative norm. Upstream of the pool, the train-mode BatchNorm backward
    # (g - mean(g) - x^ mean(g x^)) cancels most of its input gradient, so
    # the conv and BN gradients keep the bf16 noise at ~10x its relative
    # size: bound 0.25 there, and in addition the kernel path must be at
    # least as close to the fp32 xla path as the bf16 xla path is (within
    # 1.5x + 1e-2). The conv biases are left out: a train-mode BatchNorm
    # follows each conv and removes its bias, so their exact gradient is 0
    # and every path gives rounding noise. Loss: 1e-2 relative.
    loss_rel = abs(lk - lx) / abs(lx)
    rows = []
    for n in gx:
        if n.startswith("conv.conv") and n.endswith(".bias"):
            continue
        rows.append((rel(gk[n], gx[n]), n, rel(gk[n], g32[n]), rel(gx[n], g32[n])))
    rows.sort(reverse=True)
    log(f"train kernel path vs xla path (dropout 0, B={TRAIN_B}): loss {lk!r} vs {lx!r} (rel {loss_rel!r}), "
        f"fp32 xla loss {l32!r}")
    for r, n, r32, x32 in rows:
        log(f"  grad {n}: kernel vs xla {r:.3g} | kernel vs fp32 {r32:.3g} | xla vs fp32 {x32:.3g}")
    if not loss_rel <= 1e-2:
        fail("the kernel path's train loss disagrees with the xla path's")
    for r, n, r32, x32 in rows:
        tol = 0.25 if n.startswith("conv.") else 5e-2
        if not (r <= tol and r32 <= 1.5 * x32 + 1e-2):
            fail(f"the kernel path's gradient of {n} disagrees: {r} from the xla path (bound {tol}), "
                 f"{r32} from the fp32 xla path (xla: {x32})")
    return loss_rel, rows[0][0]


def time_kernels(torch, pw, seed):
    """Phase 8, kernels alone: rows for pairwise_fwd and pairwise_bwd at
    B = 1 (fwd), 64 and 512, and for the mask at B=512."""
    n, H, L, inject = 64, 256, 4, 0
    fwd, bwd = {}, {}
    for B in (1, 64, TRAIN_B):
        args = pair_inputs(torch, B, n, H, L, seed=100 + B)
        iters = 50 if B <= 64 else 10
        flops = 2.0 * B * n * n * (L - 1) * H * H
        ms = cuda_ms(torch, lambda: pw.pairwise_fwd_cuda(*args, inject=inject), iters)
        plain_ms = cuda_ms(torch, lambda: pw.pairwise_core_reference(*args, inject=inject), max(iters // 5, 2), warmup=1)
        library_ms = cuda_ms(torch, lambda: library_chain(torch, *args, inject), iters)
        b_ms, b_by = fwd_bound(B, n, n, H, L)
        fwd[B] = {"B": B, "n": n, "H": H, "L": L, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "tflops": flops / (ms * 1e-3) / 1e12}
        if B > 1:
            fwd[B]["ms_keep_0.75"] = cuda_ms(
                torch, lambda: pw.pairwise_fwd_cuda(*args, inject=inject, pair_keep=0.75, seed=seed), iters)
        log(f"time pairwise_fwd {json.dumps(fwd[B])}")
        if B > 1:
            g = upstream(torch, B, H, seed=200 + B)
            iters = 10 if B <= 64 else 3
            ms = cuda_ms(torch, lambda: pw.pairwise_bwd_cuda(*args, g, inject=inject), iters, warmup=2)
            ms_drop = cuda_ms(torch, lambda: pw.pairwise_bwd_cuda(*args, g, inject=inject, pair_keep=0.75, seed=seed),
                              iters, warmup=1)
            plain_ms = cuda_ms(torch, lambda: pw.pairwise_core_bwd_reference(*args, g, inject), 2, warmup=1)
            library_ms = cuda_ms(torch, lambda: library_vjp(torch, args, g, inject), iters, warmup=1)
            b_ms, b_by = bwd_bound(B, n, n, H, L)
            bwd[B] = {"B": B, "n": n, "H": H, "L": L, "ms": ms, "ms_keep_0.75": ms_drop, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "tflops": 3 * flops / (ms * 1e-3) / 1e12}
            log(f"time pairwise_bwd {json.dumps(bwd[B])}")
        del args
        torch.cuda.empty_cache()
    ms = cuda_ms(torch, lambda: pw.pair_mask_cuda(seed, TRAIN_B, n, n, 0.75), 50)
    plain_ms = cuda_ms(torch, lambda: pw.pair_mask_reference(seed, TRAIN_B, n, n, 0.75), 5, warmup=1)
    b_ms, b_by = mask_bound(TRAIN_B, n * n)
    mask = {"B": TRAIN_B, "n": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    log(f"time pair_mask {json.dumps(mask)}")
    return fwd, bwd, mask


def phase_breakdown(torch, pw):
    """Phase 8: one launch of each bf16 pairwise kernel's phase-timing build
    at original-fp B = 64 and 512: the clock64() cycles of every phase,
    summed over the CTAs, as shares of their total (and the total)."""
    n, H, L, inject = 64, 256, 4, 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for B in (64, TRAIN_B):
        args = pair_inputs(torch, B, n, H, L, seed=100 + B)
        g = upstream(torch, B, H, seed=200 + B)
        for kind, names in (("fwd", pw.FWD_PHASES), ("bwd", pw.BWD_PHASES)):
            plan = pw.tile_plan(kind, B, n, n, H, L, sms)
            cycles = torch.zeros((plan.grid, pw.PHASE_SLOTS), dtype=torch.int64, device="cuda")
            if kind == "fwd":
                got = pw.pairwise_fwd_cuda(*args, inject=inject, phases=cycles)
                want = pw.pairwise_fwd_cuda(*args, inject=inject)
            else:
                got = pw.pairwise_bwd_cuda(*args, g, inject=inject, phases=cycles)[4]
                want = pw.pairwise_bwd_cuda(*args, g, inject=inject)[4]
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"the phase-timing build of pairwise_{kind} computes other values than the kernel")
            total = cycles.sum(dim=0).double()
            row = {"B": B, "total_cycles": int(total.sum().item()), "ctas": plan.grid,
                   "shares": {name: (total[k] / total.sum()).item() for k, name in enumerate(names)}}
            out[(kind, B)] = row
            log(f"phases pairwise_{kind} {json.dumps(row)}")
        del args, g
        torch.cuda.empty_cache()
    return out


def library_chain_int8(torch, u, v, s, qa, w8, m, bs, inject):
    """The int8 function through cuBLAS int8 products (``torch._int_mm``) on
    materialised (B*ni*nj, H) pair rows, the epilogue in torch ops: the int8
    kernel's yardstick, used nowhere in the port."""
    B, ni, H = u.shape
    a = torch.relu(u.float()[:, :, None, :] + v.float()[:, None, :, :] + s.float()[:, None, None, :])
    a8 = torch.clamp(a.reshape(-1, H) + 0.5, max=127.0).to(torch.int8)
    for l in range(1, w8.shape[0] + 1):
        pre = torch._int_mm(a8, w8[l - 1]).float() * m[l - 1] + bs[l - 1]
        if l == inject:
            pre = (pre.view(B, -1, H) + qa[:, None, :]).view(-1, H)
        a = torch.relu(pre)
        if l < w8.shape[0]:
            a8 = torch.clamp(a + 0.5, max=127.0).to(torch.int8)
    return a.view(B, -1, H).sum(dim=1)


def time_int8(torch, pw):
    """Phase 8, the int8 kernel at B = 64 and 512 (original-fp's n, H, L):
    the wrapper on folded inputs, its plain version, the ``torch._int_mm``
    yardstick, the bound, and the whole core (calibration + folding +
    kernel)."""
    rows = {}
    for B in (64, TRAIN_B):
        case = (B, 64, 64, 256, 4, 0)
        args, folded = int8_args(torch, pw, case, seed=400 + B)
        iters = 50 if B <= 64 else 20
        ms = cuda_ms(torch, lambda: pw.pairwise_fwd_int8_cuda(*folded, inject=0), iters)
        core_ms = cuda_ms(torch, lambda: pw.pairwise_core_int8(*args, inject=0), iters)
        plain_ms = cuda_ms(torch, lambda: pw.pairwise_core_int8_reference(*folded, inject=0), 3, warmup=1)
        lib = library_chain_int8(torch, *folded, 0)
        ref = pw.pairwise_core_int8_reference(*folded, inject=0)
        lib_err = ((lib - ref).abs().max() / ref.abs().max()).item()
        library_ms = cuda_ms(torch, lambda: library_chain_int8(torch, *folded, 0), 5, warmup=1)
        b_ms, b_by = int8_bound(B, 64, 64, 256, 4)
        ops = 2.0 * B * 64 * 64 * 3 * 256 * 256
        rows[B] = {"B": B, "n": 64, "H": 256, "L": 4, "ms": ms, "ms_with_calibration": core_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library_rel_err": lib_err, "bound_ms": b_ms, "bound_by": b_by,
                   "tops": ops / (ms * 1e-3) / 1e12, "x_bound": ms / b_ms}
        log(f"time pairwise_fwd_int8 {json.dumps(rows[B])}")
        del args, folded, lib, ref
        torch.cuda.empty_cache()
    return rows


def profile_int8_eval(torch, np, cfg):
    """Phase 8: one eval batch of original-fp at B=512 (seeded weights and
    batch) through ``pallas_int8`` and through the bf16 kernel, profiled."""
    from rnet_torch.models import RN

    batch = train_batch(torch, np, cfg, TRAIN_B, seed=9)
    out = {}
    for impl in ("pallas_int8", "pallas"):
        model = RN(cfg.replace(rl_impl=impl), VOCAB, generator=torch.Generator().manual_seed(0)).cuda().eval()
        with torch.no_grad():
            def fwd():
                return model(batch["image"], batch["question"])

            wall = cuda_ms(torch, fwd, 10)
            busy, rows = log_profile(torch, f"eval batch of original-fp at B={TRAIN_B}, rl_impl={impl}", fwd, wall,
                                     top=16)
        kern = sum(r[0] for r in rows if "pairwise_fwd" in r[2])
        out[impl] = {"ms_events": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall, "pairwise_kernel_ms": kern}
        del model
    log(f"eval batch profile {json.dumps(out)}")
    return out


def time_training(torch, cfg, state, batch):
    """Phase 8, training: questions/s of the kernel and xla paths (host
    clock over windows of TRAIN_STEPS steps ending in a synchronize, taken
    in the order kernel xla xla kernel, so that neither path always runs
    later in the call; both are host-bound at times), and a profile of one
    step of each."""
    from rnet_torch.train import steps

    states = {"auto": state, "xla": new_state(torch, cfg.replace(rl_impl="xla"), state.model.state_dict())}
    for st in states.values():
        for _ in range(2):
            steps.train_step(st, batch)
    windows = {impl: [] for impl in states}
    for impl in ("auto", "xla", "xla", "auto"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            steps.train_step(states[impl], batch)
        torch.cuda.synchronize()
        windows[impl].append(time.perf_counter() - t0)
    out = {}
    for impl, st in states.items():
        dt = sum(windows[impl])
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(torch, lambda: steps.train_step(st, batch), 3, warmup=0)
        out[impl] = {"qps": TRAIN_B * TRAIN_STEPS * len(windows[impl]) / dt,
                     "qps_windows": [TRAIN_B * TRAIN_STEPS / w for w in windows[impl]],
                     "step_ms_host": dt / (TRAIN_STEPS * len(windows[impl])) * 1e3, "step_ms_events": step_ms,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"train {impl} path, original-fp B={TRAIN_B}: {json.dumps(out[impl])}")
        busy, _ = log_profile(torch, f"train step ({impl} path)", lambda: steps.train_step(st, batch), step_ms)
        out[impl]["busy_ms"] = busy
    del states
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 9. The augment kernel
# ---------------------------------------------------------------------------


def aug_work(aug, B, S=CANVAS, out=CROP, C=3, out_bytes=2):
    """(flops, bytes) the function needs. A crop reads canvas rows
    oy-KY..oy+out-1+KY and columns ox-2KX..ox+out-1+2KX (the y shear and
    the two x shears), each such pixel once; it writes the crop once and
    reads idx, angle and offsets (16 B). FLOPs: 2*(2K+1) per element of
    x1 (out+2KY rows x out+2KX columns), x2 (out x out+2KX) and x3
    (out x out), in fp32."""
    kx, ky = aug._shear_radii(S, out)
    nbytes = B * ((out + 2 * ky) * (out + 4 * kx) * C + out * out * C * out_bytes + 16)
    per_ch = ((out + 2 * ky) * (out + 2 * kx) * (2 * kx + 1) + out * (out + 2 * kx) * (2 * ky + 1)
              + out * out * (2 * kx + 1))
    return B * C * 2.0 * per_ch, nbytes


def aug_bound(aug, B):
    """(bound_ms, bound_by) of aug_work at the fp32 rate."""
    return roofline(*aug_work(aug, B), peak_ops=PEAK_FP32_FLOPS)


def aug_args(torch, np, N, B, seed, device="cuda"):
    """Seeded idx (B,) int32 over [0, N) with a repeated index and, on a
    large cache, indices above 34,500; angles with +-2.8 and 0 degrees;
    offsets with the four corners."""
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, N, B)
    if B >= 2:
        idx[1] = idx[0]
    if B >= 4 and N > 34_500:
        idx[2:4] = [N - 1, 34_561]
    deg = rs.uniform(-2.8, 2.8, B)
    deg[: min(B, 3)] = [2.8, -2.8, 0.0][: min(B, 3)]
    offs = rs.randint(0, CANVAS - CROP + 1, (B, 2))
    offs[: min(B, 4)] = [[0, 0], [16, 16], [0, 16], [16, 0]][: min(B, 4)]
    return (torch.from_numpy(idx.astype(np.int32)).to(device),
            torch.from_numpy(np.deg2rad(deg).astype(np.float32)).to(device),
            torch.from_numpy(offs.astype(np.int32)).to(device))


def check_augment(torch, np, aug, caches):
    """Phase 9; returns (max |kernel - plain| at B=512 in bf16 on the full
    cache, the same in fp32, and over all cases)."""
    # Limits: the kernel and the plain version do the same fp32 arithmetic
    # (the order of a few adds and FMA contraction differ): 1e-5 in fp32, as
    # test_fused_augment_kernel_interpret_matches_oracle. bf16 rounds nearly
    # equal fp32 values once: at most one bf16 step, 2^-8 below 1.0.
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0**-8}
    at_main = at_main32 = worst = 0.0
    for cname, cache in caches.items():
        N = cache.shape[0]
        for B in (1, 7, TRAIN_B):
            idx, ang, offs = aug_args(torch, np, N, B, seed=B + N)
            for dt in (torch.float32, torch.bfloat16):
                got = aug.augment_cuda(cache, idx, ang, offs, CROP, dt)
                want = aug.gather_augment_reference(cache, idx, ang, offs, CROP, dt)
                torch.cuda.synchronize()
                if got.shape != (B, CROP, CROP, 3) or got.dtype != dt or not torch.isfinite(got).all():
                    fail(f"augment output at cache {cname} B={B} {dt} is not a finite {dt} (B, 128, 128, 3)")
                err = (got.float() - want.float()).abs().max().item()
                log(f"augment vs plain cache={cname} B={B} {dt}: max_abs_err {err!r} (limit {tol[dt]!r})")
                if not err <= tol[dt]:
                    fail(f"augment disagrees with its plain version at cache {cname} B={B} {dt}")
                worst = max(worst, err)
                if cname == "full" and B == TRAIN_B:
                    if dt == torch.bfloat16:
                        at_main = err
                    else:
                        at_main32 = err
            del got, want
    # batch-local source, as the cached pipeline's: the batch's own canvases
    full = caches["full"]
    idx, ang, offs = aug_args(torch, np, full.shape[0], TRAIN_B, seed=3)
    src = full[idx.long()].contiguous()
    local = torch.arange(TRAIN_B, dtype=torch.int32, device="cuda")
    got = aug.augment_cuda(src, local, ang, offs, CROP, torch.bfloat16)
    same = aug.augment_cuda(full, idx, ang, offs, CROP, torch.bfloat16)
    want = aug.gather_augment_reference(src, local, ang, offs, CROP, torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    log(f"augment batch-local source B={TRAIN_B}: max_abs_err {err!r}, equal to the gathered launch: "
        f"{torch.equal(got, same)}")
    if not err <= tol[torch.bfloat16] or not torch.equal(got, same):
        fail("augment with a batch-local source disagrees")
    worst = max(worst, err)
    # angle 0 at offset (8, 8): exactly the centre crop times fp32(1/255)
    idx, _, _ = aug_args(torch, np, full.shape[0], 7, seed=4)
    zero = torch.zeros(7, dtype=torch.float32, device="cuda")
    eight = torch.full((7, 2), 8, dtype=torch.int32, device="cuda")
    centre = full[idx.long()][:, 8:8 + CROP, 8:8 + CROP].float() * (1.0 / 255.0)
    for dt in (torch.float32, torch.bfloat16):
        if not torch.equal(aug.augment_cuda(full, idx, zero, eight, CROP, dt), centre.to(dt)):
            fail(f"augment at angle 0, offset (8, 8) is not the centre crop x (1/255) in {dt}")
    log("augment at angle 0, offset (8, 8): exactly the centre crop x (1/255) in fp32 and bf16")
    # an index outside the cache: NaN rows, the others untouched
    bad = torch.tensor([0, -1, full.shape[0], 5], dtype=torch.int32, device="cuda")
    out = aug.augment_cuda(full, bad, zero[:4], eight[:4], CROP, torch.float32)
    if not (out[1:3].isnan().all() and torch.isfinite(out[[0, 3]]).all()):
        fail("augment with indices outside the cache does not give NaN rows (and only there)")
    log("augment with idx -1 and N: NaN rows, the others finite")
    return at_main, at_main32, worst


def time_augment(torch, np, aug, caches):
    """Phase 10, times of the augment kernel at B=512 in bf16 on each cache,
    cold in L2 (a fresh index vector every launch), and of its plain version."""
    rows = {}
    for cname, cache in caches.items():
        N = cache.shape[0]
        args = [aug_args(torch, np, N, TRAIN_B, seed=1000 + k) for k in range(32)]
        it = iter(range(10**9))

        def launch():
            idx, ang, offs = args[next(it) % len(args)]
            aug.augment_cuda(cache, idx, ang, offs, CROP, torch.bfloat16)

        def plain():
            idx, ang, offs = args[next(it) % len(args)]
            aug.gather_augment_reference(cache, idx, ang, offs, CROP, torch.bfloat16)

        b_ms, b_by = aug_bound(aug, TRAIN_B)
        rows[cname] = {"B": TRAIN_B, "cache_images": N, "ms": cuda_ms(torch, launch, 30),
                       "plain_ms": cuda_ms(torch, plain, 3, warmup=1), "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": None}
        # the bytes the function needs, over the kernel's time
        rows[cname]["GB_per_s"] = aug_work(aug, TRAIN_B)[1] / rows[cname]["ms"] / 1e6
        rows[cname]["x_bound"] = rows[cname]["ms"] / b_ms
        log(f"time augment {json.dumps(rows[cname])}")
    return rows


# ---------------------------------------------------------------------------
# 10. Training through the entry point on a synthetic CLEVR directory
# ---------------------------------------------------------------------------

# (program output function, question template, answers): every CLEVR family
FAMILIES = [
    ("count", "How many {c} {s}s are there?", "numbers"),
    ("exist", "Are there any {z} {m} {s}s?", "bools"),
    ("equal_integer", "Are there the same number of {c} things and {s}s?", "bools"),
    ("greater_than", "Are there more {s}s than {c} things?", "bools"),
    ("less_than", "Are there fewer {m} things than {s}s?", "bools"),
    ("query_color", "What color is the {z} {s}?", "colors"),
    ("query_shape", "What shape is the {c} {m} thing?", "shapes"),
    ("query_material", "What material is the {c} {s}?", "materials"),
    ("query_size", "What size is the {c} {s}?", "sizes"),
    ("equal_color", "Is the {s} the same color as the {m} thing?", "bools"),
    ("equal_shape", "Is the {c} thing the same shape as the {z} thing?", "bools"),
    ("equal_material", "Is the {z} {s} made of the same material as the {c} thing?", "bools"),
    ("equal_size", "Is the {m} {s} the same size as the {c} thing?", "bools"),
]


def write_synthetic_clevr(np, root, seed):
    """A CLEVR-schema directory without PNGs: seeded questions over the 28
    answers and every question family, and the decoded uint8 caches
    (rnet_cache/<split>_128p8.u8 + .json) of seeded noise canvases, which
    CachedClevrDataset reads as they are."""
    import os

    from rnet_torch.data.vocab import (
        CLEVR_BOOLS, CLEVR_COLORS, CLEVR_MATERIALS, CLEVR_NUMBERS, CLEVR_SHAPES, CLEVR_SIZES,
    )

    answers = {"numbers": CLEVR_NUMBERS, "bools": CLEVR_BOOLS, "colors": CLEVR_COLORS,
               "shapes": CLEVR_SHAPES, "materials": CLEVR_MATERIALS, "sizes": CLEVR_SIZES}
    rs = np.random.RandomState(seed)
    gen = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "questions"))
    os.makedirs(os.path.join(root, "rnet_cache"))
    for split, n_img, n_q in (("train", AUG_SMALL, SYN_TRAIN_Q), ("val", SYN_VAL_IMAGES, SYN_VAL_Q)):
        files = [f"CLEVR_{split}_{i:06d}.png" for i in range(n_img)]
        every = [(f, a) for f in FAMILIES for a in answers[f[2]]]  # each answer and family at least once
        qs = []
        for k in range(n_q):
            fam = every[k] if k < len(every) else None
            if fam is None:
                f = FAMILIES[rs.randint(len(FAMILIES))]
                fam = (f, answers[f[2]][rs.randint(len(answers[f[2]]))])
            (fn, text, _), ans = fam
            q = text.format(c=CLEVR_COLORS[rs.randint(8)], s=CLEVR_SHAPES[rs.randint(3)],
                            m=CLEVR_MATERIALS[rs.randint(2)], z=CLEVR_SIZES[rs.randint(2)])
            img = int(rs.randint(n_img))
            qs.append({"split": split, "image_index": img, "image_filename": files[img], "question": q,
                       "answer": ans, "question_index": k,
                       "program": [{"function": fn, "inputs": [], "value_inputs": []}]})
        with open(os.path.join(root, "questions", f"CLEVR_{split}_questions.json"), "w") as f:
            json.dump({"info": {"split": split, "synthetic": True}, "questions": qs}, f)
        base = os.path.join(root, "rnet_cache", f"{split}_{CROP}p8")
        mm = np.lib.format.open_memmap(base + ".u8", mode="w+", dtype=np.uint8, shape=(n_img, CANVAS, CANVAS, 3))
        for lo in range(0, n_img, 512):
            mm[lo : lo + 512] = gen.integers(0, 256, size=mm[lo : lo + 512].shape, dtype=np.uint8)
        mm.flush()
        del mm
        with open(base + ".json", "w") as f:
            json.dump({"files": files, "image_size": CROP, "pad": 8, "n": n_img}, f)


def run_cli(argv):
    from rnet_torch.train.__main__ import main as train_main

    t0 = time.perf_counter()
    rc = train_main(argv)
    if rc != 0:
        fail(f"python -m rnet_torch.train {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def read_history(path):
    import os

    with open(os.path.join(path, "history.json")) as f:
        return json.load(f)


def entry_point_phase(torch, np, pw, aug, root):
    """Phase 10, runs (a)-(d); returns (counts of (a), history of (a), (c), (d))."""
    import os
    import shutil

    write_synthetic_clevr(np, root, seed=5)
    base = ["--clevr-dir", root, "--model", "original-fp", "--batch-size", str(TRAIN_B), "--lr", str(LR),
            "--log-interval", "8", "--num-workers", "4"]
    d = {k: os.path.join(root, k) for k in ("ck_a", "res_a", "ck_b", "res_b", "ck_c", "res_c", "ck_d", "res_d")}
    steps_per_epoch = SYN_TRAIN_Q // TRAIN_B
    eval_batches = -(-SYN_VAL_Q // TRAIN_B)
    torch.backends.cudnn.deterministic = True  # (a) and (b) must agree bit for bit

    # (a) the main path: device pipeline, augmentation on, 2 epochs
    pw.reset_launches()
    aug.reset_launches()
    sec = run_cli(base + ["--data-pipeline", "device", "--epochs", "2", "--checkpoint-dir", d["ck_a"],
                          "--test-results-dir", d["res_a"]])
    torch.cuda.synchronize()
    counts = {**pw.launches, **aug.launches}
    hist_a = read_history(d["res_a"])
    n_steps = 2 * steps_per_epoch
    log(f"entry point (a) device pipeline, 2 epochs of {steps_per_epoch} steps at B={TRAIN_B}: "
        f"{sec:.1f} s, launches {counts}; history {json.dumps(hist_a)}")
    want = {aug.KERNEL: n_steps, pw.BWD_KERNEL: n_steps, pw.KERNEL: n_steps + 2 * eval_batches, "pair_mask": 0,
            pw.INT8_KERNEL: 0}
    if counts != want:
        fail(f"(a) expected launches {want} (augment = train steps, eval never augments), counted {counts}")
    for h in hist_a:
        if not (np.isfinite(h["train_loss"]) and np.isfinite(h["val_nll"]) and 0.0 <= h["val_acc"] <= 1.0):
            fail(f"(a) epoch {h['epoch']} is not finite: {h}")
    with open(os.path.join(d["res_a"], "val_epoch002_accuracy.csv")) as f:
        fams = {line.split(",")[0] for line in f if line.startswith("category_")}
    if len(fams) != 5:
        fail(f"(a) the per-family report lacks families: {sorted(fams)}")

    # (b) resume from a copy of epoch 1: epoch 2 again, bit for bit
    os.makedirs(d["ck_b"])
    for name in ("original-fp_epoch_001", "original-fp_dictionaries.json"):
        shutil.copy(os.path.join(d["ck_a"], name), d["ck_b"])
    run_cli(base + ["--data-pipeline", "device", "--epochs", "2", "--checkpoint-dir", d["ck_b"],
                    "--test-results-dir", d["res_b"], "--resume", "1"])
    (hb,) = read_history(d["res_b"])
    pa = torch.load(os.path.join(d["ck_a"], "original-fp_epoch_002"), map_location="cpu", weights_only=True)
    pb = torch.load(os.path.join(d["ck_b"], "original-fp_epoch_002"), map_location="cpu", weights_only=True)
    differ = [k for k in pa["model"] if not torch.equal(pa["model"][k], pb["model"][k])]
    log(f"entry point (b) resumed from epoch 1: epoch-2 loss {hb['train_loss']!r} vs {hist_a[1]['train_loss']!r}, "
        f"val_nll {hb['val_nll']!r} vs {hist_a[1]['val_nll']!r}, "
        f"{len(pa['model']) - len(differ)} of {len(pa['model'])} tensors bitwise equal, step {pb['step']} vs {pa['step']}")
    if differ or hb["train_loss"] != hist_a[1]["train_loss"] or hb["val_nll"] != hist_a[1]["val_nll"] \
            or pa["step"] != pb["step"]:
        fail(f"the resumed run is not bitwise equal to the uninterrupted one: {differ}")

    # (c) cached pipeline: host batches of padded canvases, augmented batch-locally
    pw.reset_launches()
    aug.reset_launches()
    run_cli(base + ["--data-pipeline", "cached", "--epochs", "2", "--checkpoint-dir", d["ck_c"],
                    "--test-results-dir", d["res_c"]])
    torch.cuda.synchronize()
    hist_c = read_history(d["res_c"])
    log(f"entry point (c) cached pipeline: launches {dict(aug.launches)}; history {json.dumps(hist_c)}")
    if aug.launches[aug.KERNEL] != n_steps or pw.launches[pw.BWD_KERNEL] != n_steps:
        fail(f"(c) expected {n_steps} augment and pairwise_bwd launches, counted {aug.launches} {pw.launches}")

    # (d) device pipeline without augmentation
    aug.reset_launches()
    run_cli(base + ["--data-pipeline", "device", "--no-device-augment", "--epochs", "2",
                    "--checkpoint-dir", d["ck_d"], "--test-results-dir", d["res_d"]])
    hist_d = read_history(d["res_d"])
    log(f"entry point (d) device pipeline, --no-device-augment: launches {dict(aug.launches)}; "
        f"history {json.dumps(hist_d)}")
    if aug.launches[aug.KERNEL] != 0:
        fail("(d) launched the augment kernel with --no-device-augment")
    for h in hist_c + hist_d:
        if not np.isfinite(h["train_loss"]):
            fail(f"(c)/(d) non-finite loss: {h}")
    torch.backends.cudnn.deterministic = False

    # (a) and (d) again in the entry point's own mode (cuDNN free to pick its
    # algorithms, as `python -m rnet_torch.train` runs), in the order a d d a
    # so that neither always runs later in the call
    abba = {"a": [], "d": []}
    for k, arm in enumerate("adda"):
        extra = [] if arm == "a" else ["--no-device-augment"]
        run_cli(base + ["--data-pipeline", "device", "--epochs", "2", *extra,
                        "--checkpoint-dir", os.path.join(root, f"ck_abba{k}"),
                        "--test-results-dir", os.path.join(root, f"res_abba{k}")])
        h = read_history(os.path.join(root, f"res_abba{k}"))
        if not all(np.isfinite(e["train_loss"]) for e in h):
            fail(f"run {k} ({arm}) of a d d a: non-finite loss {h}")
        abba[arm].append([e["qps"] for e in h])
    log(f"entry point (a) / (d) in the order a d d a, default cuDNN (epochs 1, 2 questions/s): {json.dumps(abba)}")
    return counts, hist_a, hist_c, hist_d, abba


def run_eval_cli(argv, int8):
    """``rnet_torch.evaluate.main(argv)`` with its standard output captured
    (and logged) and each eval step's predictions recorded; int8 runs under
    warnings as errors, so a "NOT int8" fallback fails the run. Returns
    (output, predictions by question index, seconds)."""
    import contextlib
    import io
    import warnings

    from rnet_torch.evaluate import main as eval_main
    from rnet_torch.train import steps

    preds = []
    real = steps.eval_step

    def recording(*a, **kw):
        out = real(*a, **kw)
        preds.append((out["index"], out["pred"], out["valid"]))
        return out

    buf = io.StringIO()
    steps.eval_step = recording
    try:
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            if int8:
                warnings.simplefilter("error")
            t0 = time.perf_counter()
            rc = eval_main(argv)
            sec = time.perf_counter() - t0
    finally:
        steps.eval_step = real
    text = buf.getvalue()
    log("\n".join(f"  | {line}" for line in text.splitlines()))
    if rc != 0:
        fail(f"python -m rnet_torch.evaluate {' '.join(argv)} exited {rc}")
    by_q = {}
    for idx, pred, valid in preds:
        for i, p, ok in zip(idx.tolist(), pred.tolist(), valid.tolist()):
            if ok:
                by_q[i] = p
    return text, by_q, sec


def eval_entry_phase(torch, np, pw, aug, root):
    """Phase 10b: ``python -m rnet_torch.evaluate`` on run (a)'s epoch 2, as
    is and with ``--rl-impl pallas_int8``, in the order bf16 int8 int8 bf16;
    returns (int8 launches, share of equal predictions, eval q/s of each
    run)."""
    import os
    import re

    n_batches = SYN_TRAIN_Q // TRAIN_B
    runs, qps_runs = {}, {"bf16": [], "int8": []}
    for k, tag in enumerate(("bf16", "int8", "int8", "bf16")):
        extra = ["--rl-impl", "pallas_int8"] if tag == "int8" else []
        res = os.path.join(root, f"eval_{k}_{tag}")
        argv = ["--clevr-dir", root, "--model", "original-fp", "--checkpoint", "2",
                "--checkpoint-dir", os.path.join(root, "ck_a"), "--test-results-dir", res,
                "--data-pipeline", "device", "--split", "train", "--batch-size", str(TRAIN_B),
                "--num-workers", "4", *extra]
        pw.reset_launches()
        aug.reset_launches()
        text, preds, sec = run_eval_cli(argv, int8=(tag == "int8"))
        torch.cuda.synchronize()
        counts = {**pw.launches, **aug.launches}
        m = re.search(r"overall accuracy: (\S+) \| mean NLL: (\S+)", text)
        q = re.search(r"\((\d+) q/s\)", text)
        if m is None or q is None:
            fail(f"eval ({tag}) printed no accuracy or q/s line")
        acc, nll, qps = float(m.group(1)), float(m.group(2)), float(q.group(1))
        want = {pw.KERNEL: 0 if tag == "int8" else n_batches, pw.INT8_KERNEL: n_batches if tag == "int8" else 0,
                pw.BWD_KERNEL: 0, "pair_mask": 0, aug.KERNEL: 0}
        log(f"eval entry point ({tag}): {sec:.1f} s, {qps!r} q/s (eval epoch, host clock), accuracy {acc!r}, "
            f"NLL {nll!r}, {len(preds)} questions, launches {counts}")
        if counts != want:
            fail(f"eval ({tag}) expected launches {want}, counted {counts}")
        if not (np.isfinite(acc) and np.isfinite(nll) and 0.0 <= acc <= 1.0) or len(preds) != SYN_TRAIN_Q:
            fail(f"eval ({tag}) is not finite or did not predict every question")
        for f in ("train_accuracy.csv", "train_confusion.csv"):
            if not os.path.exists(os.path.join(res, f)):
                fail(f"eval ({tag}) wrote no {f}")
        if tag == "int8" and "int8 calibration clip fractions per layer: [" not in text:
            fail("the int8 eval printed no clip-fraction line")
        runs.setdefault(tag, preds)
        qps_runs[tag].append(qps)
    same = float(np.mean([runs["int8"][i] == p for i, p in runs["bf16"].items()]))
    log(f"eval entry point, int8 vs bf16 on the same checkpoint: {same!r} of predictions equal; eval q/s in the "
        f"order bf16 int8 int8 bf16: {json.dumps(qps_runs)}")
    return n_batches, same, qps_runs


def entry_step(torch, root, extra):
    """One train step, as a function, of the entry point's Trainer for the
    device pipeline at B=512 with the flags `extra`."""
    from rnet_torch.cli import build_datasets, config_from_args, load_dicts
    from rnet_torch.train import steps
    from rnet_torch.train.__main__ import parse_args
    from rnet_torch.train.loop import Trainer
    from rnet_torch.train.schedules import DoublingSchedule

    args = parse_args(["--clevr-dir", root, "--model", "original-fp", "--data-pipeline", "device",
                       "--batch-size", str(TRAIN_B), *extra])
    dicts = load_dicts(args)
    cfg = config_from_args(args, dicts)
    ds = build_datasets(args, cfg, dicts)
    tr = Trainer(cfg, dicts.vocab_size, ds["train"], ds["val"], dicts, lr=DoublingSchedule(LR),
                 bs=DoublingSchedule(TRAIN_B), checkpoint_dir=root + "/ck_profile", device_data=True,
                 log_fn=lambda *a: None)
    batch = {k: v[:TRAIN_B] for k, v in tr.train_data.items()}
    return lambda: steps.train_step(tr.state, batch, tr.train_cache)


def profile_entry_step(torch, root):
    """One train step of run (a) (device pipeline with augmentation, B=512)
    and of run (d) (without): their steps timed alternately, one at a time
    (CUDA events around each step and the host clock to its synchronize),
    with cuDNN's deterministic algorithms and without; then a profile of
    each (device busy, idle share, the augment kernel's share) and the
    kernels whose device time differs most between the two."""
    fns = {"a": entry_step(torch, root, []), "d": entry_step(torch, root, ["--no-device-augment"])}
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = {}
    for det in (True, False):
        torch.backends.cudnn.deterministic = det
        ms = {arm: {"events": [], "host": []} for arm in fns}
        for k in range(8):
            for arm in ("ad" if k % 2 == 0 else "da"):
                if k == 0:
                    fns[arm]()  # first step in this mode: cuDNN's algorithm choice
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev0.record()
                fns[arm]()
                ev1.record()
                torch.cuda.synchronize()
                ms[arm]["host"].append((time.perf_counter() - t0) * 1e3)
                ms[arm]["events"].append(ev0.elapsed_time(ev1))
        mean = {arm: {clock: sum(v) / len(v) for clock, v in m.items()} for arm, m in ms.items()}
        times["deterministic" if det else "default"] = mean
        log(f"entry steps (a) / (d) alternated, cudnn.deterministic={det}, 8 each (ms): {json.dumps(ms)}; "
            f"means {json.dumps(mean)}")
    torch.backends.cudnn.deterministic = False
    out, kernel_ms = {"alternated_step_ms": times}, {}
    for arm, what in (("a", "(a) device pipeline with augmentation"), ("d", "(d) --no-device-augment")):
        wall = cuda_ms(torch, fns[arm], 5, warmup=1)
        busy, rows = log_profile(torch, f"train step through the entry point's Trainer, {what}, B=512", fns[arm],
                                 wall)
        kernel_ms[arm] = {}
        for r in rows:
            kernel_ms[arm][r[2]] = kernel_ms[arm].get(r[2], 0.0) + r[0]
        out[arm] = {"step_ms_events": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall}
    names = set(kernel_ms["a"]) | set(kernel_ms["d"])
    diff = sorted(((kernel_ms["a"].get(n, 0.0) - kernel_ms["d"].get(n, 0.0), n) for n in names),
                  key=lambda x: -abs(x[0]))
    for dms, name in diff[:8]:
        log(f"  device ms (a) - (d): {dms!r} {name[:100]}")
    aug_ms = sum(v for n, v in kernel_ms["a"].items() if "augment_kernel" in n)
    out["a"].update(augment_ms=aug_ms, augment_share_of_busy=aug_ms / out["a"]["busy_ms"])
    log(f"entry step profile {json.dumps(out)}")
    if aug_ms <= 0 or any("augment_kernel" in n for n in kernel_ms["d"]):
        fail("the profiled step of (a) shows no augment kernel, or that of (d) shows one")
    return out


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
        from rnet_torch.kernels import augment as aug
        from rnet_torch.kernels import build
        from rnet_torch.kernels import pairwise as pw
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | device {kind}")
    t_start = time.perf_counter()

    # ---- 2. build (the kernels and the phase-timing build, all nvcc at once) ----
    from concurrent.futures import ThreadPoolExecutor

    kernels = [pw.KERNEL, pw.BWD_KERNEL, aug.KERNEL, pw.INT8_KERNEL]
    timed = [pw.KERNEL, pw.BWD_KERNEL]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        for job in [ex.submit(build.build, kernels), ex.submit(build.build, timed, pw.PHASE_DEFINES)]:
            job.result()
    log(f"build: {kernels} and {timed} with {pw.PHASE_DEFINES} in {time.perf_counter() - t0:.1f} s")
    for name in kernels:
        with open(build.log_path(name)) as f:
            for line in f:
                if "registers" in line or "Compiling entry" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
    seed = torch.tensor([0x5EED_1234_ABCD], dtype=torch.int64, device="cuda")

    # ---- 3-5. kernels vs plain versions ----
    fwd_err, fwd_err_at_shape = check_forward(torch, pw, seed)
    mask_err = check_mask(torch, pw, seed)
    bwd_err, bwd_err_at_shape = check_backward(torch, pw, seed)
    int8_err, int8_err_all, int8_drift = check_int8(torch, pw)
    log(f"phases 1-5b done at {time.perf_counter() - t_start:.1f} s")

    # ---- 6. serving original-fp at full width ----
    answers = [*CLEVR_NUMBERS, *CLEVR_BOOLS, *CLEVR_COLORS, *CLEVR_SHAPES, *CLEVR_MATERIALS, *CLEVR_SIZES]
    words = (
        "are there any other things that have the same size as the what color is "
        "how many objects of material shape made behind in front of left right "
        "does it a an number greater less than more fewer both cubes spheres "
        "cylinders large small metal rubber either is there visible"
    ).split() + [*CLEVR_COLORS, *CLEVR_SHAPES]
    dicts = Dictionaries({w: i + 1 for i, w in enumerate(dict.fromkeys(words))}, {a: i for i, a in enumerate(answers)})
    cfg = load_config("original-fp").replace(n_answers=dicts.n_answers)
    server, burst, serve_launches = serve_phase(torch, np, pw, cfg, dicts)
    s8, int8_serve_launches, int8_agree, int8_dlp = int8_serve_phase(torch, np, pw, cfg, dicts, server, burst)
    log(f"phase 6b done at {time.perf_counter() - t_start:.1f} s")

    # ---- 7. training original-fp at full width, B=512 ----
    state, batch, train_counts, pd_counts = train_phase(torch, np, pw, cfg)
    xla_agreement(torch, np, cfg, state, batch)
    torch.cuda.empty_cache()
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 8. times ----
    fwd, bwd, mask = time_kernels(torch, pw, seed)
    phases = phase_breakdown(torch, pw)
    train_times = time_training(torch, cfg, state, batch)
    qps_ratio = train_times["auto"]["qps"] / train_times["xla"]["qps"]
    log(f"train questions/s, kernel path / xla path: {qps_ratio!r}")

    int8_rows = time_int8(torch, pw)
    profile_int8_eval(torch, np, cfg)
    # bf16 and int8 served in turns (bf16 int8 int8 bf16 ...): neither path
    # always runs later in the call
    servers, turns = {"bf16": server, "int8": s8}, ("bf16", "int8", "int8", "bf16")
    for bucket in server.buckets:
        sub = burst[:bucket]
        for srv in servers.values():
            for _ in range(3):
                srv.serve_samples(sub)
        lat = {tag: [] for tag in servers}
        for tag in turns * 5:
            lat[tag].append(servers[tag].serve_samples(sub)[0]["latency_ms"])
        latency = {tag: {"median_ms": sorted(v)[len(v) // 2], "min_ms": min(v), "max_ms": max(v)}
                   for tag, v in lat.items()}
        log(f"serve latency at bucket {bucket}, 10 calls each in turns (host clock, ms): {json.dumps(latency)}")
    big = burst * 7  # 700 requests, 11 full buckets of 64 + one of 60
    bursts = {"bf16": [], "int8": []}
    for tag in turns:
        t0 = time.perf_counter()
        servers[tag].serve_samples(big)
        bursts[tag].append(len(big) / (time.perf_counter() - t0))
    log(f"serve burst throughput over {len(big)} requests, in the order bf16 int8 int8 bf16 "
        f"(questions/s): {json.dumps(bursts)}")
    for bucket in (1, 64):
        inputs, q = server.batch_arrays(burst[:bucket], bucket)
        wall = cuda_ms(torch, lambda: server.log_probs(inputs, q), 20)
        log_profile(torch, f"served forward, bucket {bucket}", lambda: server.log_probs(inputs, q), wall)
    log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")
    del server, s8, state, batch
    torch.cuda.empty_cache()

    # ---- 9. the augment kernel vs its plain version ----
    gen = torch.Generator(device="cuda").manual_seed(70_000)
    caches = {
        str(AUG_SMALL): torch.randint(0, 256, (AUG_SMALL, CANVAS, CANVAS, 3), generator=gen, device="cuda",
                                      dtype=torch.uint8),
        "full": torch.randint(0, 256, (CLEVR_TRAIN_IMAGES, CANVAS, CANVAS, 3), generator=gen, device="cuda",
                              dtype=torch.uint8),
    }
    log(f"augment caches: {AUG_SMALL} and {CLEVR_TRAIN_IMAGES} canvases ({caches['full'].numel() / 1e9:.2f} GB)")
    aug_err, aug_err32, aug_err_all = check_augment(torch, np, aug, caches)
    aug_times = time_augment(torch, np, aug, caches)
    del caches
    torch.cuda.empty_cache()
    log(f"phase 9 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 10. training through the entry point ----
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="rnet_torch_smoke_")
    try:
        entry_counts, hist_a, hist_c, hist_d, abba = entry_point_phase(torch, np, pw, aug, root)
        int8_eval_launches, int8_eval_same, eval_runs = eval_entry_phase(torch, np, pw, aug, root)
        qps = {"a_device_augment": [h["qps"] for h in hist_a], "c_cached_augment": [h["qps"] for h in hist_c],
               "d_device_no_augment": [h["qps"] for h in hist_d]}
        log(f"entry point epoch questions/s (host clock; epochs 1, 2): {json.dumps(qps)}")
        log(f"epoch-2 questions/s, (a) / (d): {qps['a_device_augment'][1] / qps['d_device_no_augment'][1]!r}, "
            f"(c) / (a): {qps['c_cached_augment'][1] / qps['a_device_augment'][1]!r}")
        a2, d2 = (sum(r[1] for r in abba[arm]) / len(abba[arm]) for arm in "ad")
        log(f"epoch-2 questions/s in the order a d d a, default cuDNN: (a) {a2!r}, (d) {d2!r}, (a) / (d) {a2 / d2!r}")
        profile_entry_step(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"all phases done at {time.perf_counter() - t_start:.1f} s")

    # max_abs_err: at `shape`, the shape the times are taken at (keep 1 and
    # 0.75; the augment kernel's bf16 output); max_abs_err_all_cases: over
    # every checked case.
    def record(name, source, replaces, launches, err, row, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms"), **extra, "ok": True}

    shape = {"B": TRAIN_B, "n": 64, "H": 256, "L": 4}
    records = [
        record(pw.KERNEL, "rnet_torch/csrc/pairwise_fwd.cu", "rnet/kernels/pairwise.py:83",
               train_counts[pw.KERNEL], fwd_err_at_shape, fwd[TRAIN_B], shape=shape,
               max_abs_err_all_cases=fwd_err, serve_launches=serve_launches,
               phase_shares=phases[("fwd", TRAIN_B)]["shares"],
               entry_point_launches=entry_counts[pw.KERNEL]),
        record(pw.BWD_KERNEL, "rnet_torch/csrc/pairwise_bwd.cu", "rnet/kernels/pairwise.py:120",
               train_counts[pw.BWD_KERNEL], bwd_err_at_shape, bwd[TRAIN_B], shape=shape,
               max_abs_err_all_cases=bwd_err, entry_point_launches=entry_counts[pw.BWD_KERNEL],
               phase_shares=phases[("bwd", TRAIN_B)]["shares"]),
        record("pair_mask", "rnet_torch/csrc/philox.cuh", "rnet/kernels/pairwise.py:69",
               pd_counts["pair_mask"], float(mask_err), mask,
               shape={"B": TRAIN_B, "n": 64}, launches_of="one train step with pair_dropout 0.25"),
        record(aug.KERNEL, "rnet_torch/csrc/augment.cu", "rnet/kernels/augment.py:134",
               entry_counts[aug.KERNEL], aug_err, aug_times["full"],
               shape={"B": TRAIN_B, "canvas": CANVAS, "crop": CROP, "cache_images": CLEVR_TRAIN_IMAGES,
                      "out": "bfloat16"},
               max_abs_err_fp32=aug_err32, max_abs_err_all_cases=aug_err_all,
               ms_cache_2048=aug_times[str(AUG_SMALL)]["ms"],
               launches_of="run (a): python -m rnet_torch.train --data-pipeline device, 2 epochs of 16 steps"),
        record(pw.INT8_KERNEL, "rnet_torch/csrc/pairwise_fwd_int8.cu", "rnet/kernels/pairwise.py:190",
               int8_eval_launches, int8_err, int8_rows[TRAIN_B], shape=shape,
               max_abs_err_all_cases=int8_err_all, max_drift_from_fp32=int8_drift,
               serve_launches=int8_serve_launches, serve_answers_equal_to_bf16=int8_agree,
               serve_max_abs_dlogp=int8_dlp, eval_predictions_equal_to_bf16=int8_eval_same,
               eval_qps=eval_runs,
               ms_b64=int8_rows[64]["ms"], ms_with_calibration=int8_rows[TRAIN_B]["ms_with_calibration"],
               launches_of="python -m rnet_torch.evaluate --rl-impl pallas_int8 --data-pipeline device "
                           "--split train --batch-size 512 (16 batches)"),
    ]
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
