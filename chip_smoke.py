#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rnet_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal (exit 1, no result line) when it fails:
  1. CUDA present; print the card's name and power limit (nvidia-smi).
  2. Build every CUDA kernel of the serving and training paths from
     ``rnet_torch/csrc`` (one nvcc per source, started together); print
     ptxas' resource lines.
  3. Forward kernel vs plain version on the card at the paths' shapes
     (original-fp B=1/64/512 with inject 0 and 2 as in ir-fp, wide-fp's
     H=512 at B=64 and at B=140 > the SM count, a ragged small shape and a
     rectangular ni != nj), seeded numpy inputs in bf16, at pair_keep 1 and
     0.75.
  4. Philox pair mask: the mask kernel's bits equal ``pair_mask_reference``
     exactly.
  5. Backward kernel vs plain version at the same shapes and keeps, and the
     same launch twice gives bitwise-equal gradients. The shapes with B above
     the SM count (the training shape B=512, and B=140 at H=512) are the
     ones where a CTA of the backward's persistent grid owns several
     samples.
  6. Serving: an ``InferenceServer`` for original-fp at full width with
     seeded random weights, buckets 1/8/64. After ``warmup()`` the launch
     counters are zeroed, a burst of encoded requests goes through the
     server's own chunk/bucket/pad code (``serve_samples``), and the
     counters are read: every served batch must have launched the forward
     kernel. Answers must decode with log_prob <= 0, and the log-probs must
     match the same server forced to ``rl_impl="xla"``.
  7. Training original-fp at full width, B=512 (the shape rnet's bench.py
     times), ``rl_impl=auto``, through ``rnet_torch.train.steps``: after a
     warm-up step the counters are zeroed and K steps taken; forward and
     backward kernels must each count K launches; losses and gradient norms
     finite, the loss falling on the fixed batch; the same gradient twice
     bitwise; one step with pair dropout 0.25 draws the mask in both
     kernels; the kernel path's loss and gradients agree with the ``xla``
     path's.
  8. Times with CUDA events: each kernel, its plain version, one PyTorch
     yardstick (``library_ms``) and the roofline bound; serve latency per
     bucket and train questions/s on the host clock; torch.profiler
     breakdowns of a served forward and of a train step (device busy time by
     kernel, and the device's idle share).
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
PEAK_INT32_OPS = 33.5e12  # half the 67 TFLOP/s fp32 CUDA-core rate: 64 INT32 lanes per SM beside 128 FP32
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
TRAIN_B = 512  # rnet's bench.py batch
TRAIN_STEPS = 5
VOCAB = 90  # bench.py's vocabulary size
LR = 1e-4  # bench.py's learning rate (clip 50)


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
    return sum(r[0] for r in rows), sum(r[1] for r in rows), rows[:8]


def log_profile(torch, what, fn, wall_ms):
    busy, n_kernels, top = profile_device(torch, fn)
    log(f"profile {what}: {wall_ms!r} ms (CUDA events), device busy {busy!r} ms "
        f"in {n_kernels!r} kernels, idle share {1.0 - busy / wall_ms!r}")
    for ms_k, count, name in top:
        log(f"  {ms_k!r} ms x{count!r} {name[:100]}")
    return busy


# Kernel agreement cases (B, ni, nj, H, L, inject): original-fp B=1/64,
# ir-fp (inject 2) B=1/64, wide-fp (H=512), ragged n=12, rectangular, and
# two with B above the SM count (132 on an H100 SXM), where each CTA of the
# backward's persistent grid of min(B, SMs) takes several samples into one
# dW/db partial: original-fp at the training shape B=512 (3-4 samples a
# CTA, 128-row blocks) and H=512 with inject 2 at B=140 (64-row blocks).
TRAIN_CASE = (TRAIN_B, 64, 64, 256, 4, 0)
CASES = [
    (1, 64, 64, 256, 4, 0), (64, 64, 64, 256, 4, 0), (1, 64, 64, 256, 4, 2),
    (64, 64, 64, 256, 4, 2), (64, 64, 64, 512, 4, 0), (3, 12, 12, 128, 3, 1),
    (2, 16, 64, 256, 4, 1), TRAIN_CASE, (140, 64, 64, 512, 4, 2),
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
    if counts[pw.KERNEL] != served_batches or counts[pw.BWD_KERNEL] or counts["pair_mask"]:
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
    if pd_counts != {pw.KERNEL: 1, pw.BWD_KERNEL: 1, "pair_mask": 2}:
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


def time_training(torch, cfg, state, batch):
    """Phase 8, training: questions/s of the kernel and xla paths (host
    clock over TRAIN_STEPS steps ending in a synchronize), and a profile of
    one kernel-path step."""
    from rnet_torch.train import steps

    out = {}
    for impl in ("auto", "xla"):
        st = state if impl == "auto" else new_state(torch, cfg.replace(rl_impl="xla"), state.model.state_dict())
        for _ in range(2):
            steps.train_step(st, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            steps.train_step(st, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(torch, lambda: steps.train_step(st, batch), 3, warmup=0)
        out[impl] = {"qps": TRAIN_B * TRAIN_STEPS / dt, "step_ms_host": dt / TRAIN_STEPS * 1e3,
                     "step_ms_events": step_ms,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"train {impl} path, original-fp B={TRAIN_B}: {json.dumps(out[impl])}")
        busy = log_profile(torch, f"train step ({impl} path)", lambda: steps.train_step(st, batch), step_ms)
        out[impl]["busy_ms"] = busy
        if impl == "xla":
            del st
            torch.cuda.empty_cache()
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

    # ---- 2. build ----
    kernels = [pw.KERNEL, pw.BWD_KERNEL]
    t0 = time.perf_counter()
    build.build(kernels)
    log(f"build: {kernels} in {time.perf_counter() - t0:.1f} s")
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
    log(f"phases 1-5 done at {time.perf_counter() - t_start:.1f} s")

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
    log(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 7. training original-fp at full width, B=512 ----
    state, batch, train_counts, pd_counts = train_phase(torch, np, pw, cfg)
    xla_agreement(torch, np, cfg, state, batch)
    torch.cuda.empty_cache()
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 8. times ----
    fwd, bwd, mask = time_kernels(torch, pw, seed)
    train_times = time_training(torch, cfg, state, batch)
    qps_ratio = train_times["auto"]["qps"] / train_times["xla"]["qps"]
    log(f"train questions/s, kernel path / xla path: {qps_ratio!r}")

    latency = {}
    for bucket in server.buckets:
        sub = burst[:bucket]
        for _ in range(3):
            server.serve_samples(sub)
        lat = sorted(server.serve_samples(sub)[0]["latency_ms"] for _ in range(20))
        latency[bucket] = {"median_ms": lat[len(lat) // 2], "min_ms": lat[0], "max_ms": lat[-1]}
    t0 = time.perf_counter()
    big = burst * 7  # 700 requests, 11 full buckets of 64 + one of 60
    server.serve_samples(big)
    qps = len(big) / (time.perf_counter() - t0)
    log(f"serve latency per bucket (host clock, ms): {json.dumps(latency)}")
    log(f"serve burst throughput: {qps!r} questions/s over {len(big)} requests")
    for bucket in (1, 64):
        inputs, q = server.batch_arrays(burst[:bucket], bucket)
        wall = cuda_ms(torch, lambda: server.log_probs(inputs, q), 20)
        log_profile(torch, f"served forward, bucket {bucket}", lambda: server.log_probs(inputs, q), wall)
    log(f"all phases done at {time.perf_counter() - t_start:.1f} s")

    # max_abs_err: at `shape`, the shape the times are taken at (keep 1 and
    # 0.75); max_abs_err_all_cases: over every checked case.
    def record(name, source, replaces, launches, err, row, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms"), **extra, "ok": True}

    shape = {"B": TRAIN_B, "n": 64, "H": 256, "L": 4}
    records = [
        record(pw.KERNEL, "rnet_torch/csrc/pairwise_fwd.cu", "rnet/kernels/pairwise.py:83",
               train_counts[pw.KERNEL], fwd_err_at_shape, fwd[TRAIN_B], shape=shape,
               max_abs_err_all_cases=fwd_err, serve_launches=serve_launches),
        record(pw.BWD_KERNEL, "rnet_torch/csrc/pairwise_bwd.cu", "rnet/kernels/pairwise.py:120",
               train_counts[pw.BWD_KERNEL], bwd_err_at_shape, bwd[TRAIN_B], shape=shape,
               max_abs_err_all_cases=bwd_err),
        record("pair_mask", "rnet_torch/csrc/philox.cuh", "rnet/kernels/pairwise.py:69",
               pd_counts["pair_mask"], float(mask_err), mask,
               shape={"B": TRAIN_B, "n": 64}, launches_of="one train step with pair_dropout 0.25"),
    ]
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
