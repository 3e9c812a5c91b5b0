#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rnet_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal (exit 1, no result line) when it fails:
  1. CUDA present; print the card's name and power limit (nvidia-smi).
  2. Build every CUDA kernel of the serving, training, int8 inference and
     fp32 paths from ``rnet_torch/csrc`` (one nvcc per source, started together),
     and beside them the phase-timing build of the pairwise kernels (bf16,
     int8 and fp32; ``-DRNET_PHASE_TIMES``); print ptxas' resource lines.
  3. Forward kernel vs plain version on the card at the paths' shapes
     (original-fp B=1/64/512 with inject 0 and 2 as in ir-fp, wide-fp's
     H=512 at B=64 and at B=140 > the SM count, a ragged small shape, a
     rectangular ni != nj and stretch-fp-32's 1,024 objects; at H=512,
     where the forward runs on clusters of two CTAs, also the serving
     buckets B=1 and 8, B=3 with L=3 and the SD grid of 12), seeded numpy
     inputs in bf16, at pair_keep 1 and 0.75.
  4. Philox pair mask: the mask kernel's bits equal ``pair_mask_reference``
     exactly.
  5. Backward kernel vs plain version at the same shapes and keeps, and the
     same launch twice gives bitwise-equal gradients (at B=512 and B=64).
     The shapes with B above the SM count (the training shape B=512, and
     B=140 at H=512) are the ones where a CTA of the backward's persistent
     grid owns several samples; below it the one-CTA backward splits each
     sample over SMs // B CTAs (B = 1, 2, 3, 8, 64, and stretch-fp-16's 256
     objects at B=8); at H=512 the backward runs on clusters of two CTAs,
     also at B=3 (odd: one sample a cluster) and at the SD grid of 12 (a
     ragged block); at H=384 (B=8) the one-CTA backward on one warpgroup.
 5b. The int8 kernel (``pairwise_fwd_int8``) vs its plain version on the
     same folded inputs (``quantize_int8``): original-fp B = 1, 64, 512 and
     ir-fp (inject 2) B=64 through ``pairwise_core_int8``, wide-fp's H=512
     (the kernel on clusters of two CTAs) at its serving buckets B=1 and 8,
     at B=64, B=140 and its eval batch B=512, n=24 and a rectangular ni !=
     nj through the wrapper (at H=512 too: a ragged tile with a middle
     injection, fp32 u, v, s with the last), and original-fp B=64 with
     fp32 u, v, s; each
     within 1e-5 of max|plain| and within 3e-2 of the fp32
     ``pairwise_core_reference``; the B=512 launches (H=256 and 512) twice,
     bitwise.
 5c. The fp32 kernels (``csrc/pairwise_f32.cu``: ``pairwise_fwd_f32``,
     ``pairwise_bwd_f32``, 3xTF32) vs their plain fp32 versions at
     ``F32_CASES`` (original-fp B=512 and 64, ir-fp's injection 2, H=512 at
     n=64 and at the SD grid of 12, a rectangular grid, stretch-fp-32's
     1,024 objects at B=1, pair dropout at keep 0.9; L = 3 and 2 at H=256;
     the forward on clusters at H=512 also at B=1 and B=140):
     the forward within 1e-4 of max|plain|, each gradient's
     max|d|/max|plain| printed and its distance from the float64 chain held
     to 1e-4 + twice the plain fp32 version's; the B=512 backward (one
     owner CTA a sample) and the B=64 one (2 CTAs a sample) twice, bitwise;
     stretch-fp-16's grid at B=8.
  6. Serving: an ``InferenceServer`` for original-fp at full width with
     seeded random weights, buckets 1/8/64. After ``warmup()`` (which
     captures each bucket's CUDA graph) the launch counters are zeroed, a
     burst of encoded requests goes through the server's own
     chunk/bucket/pad code (``serve_samples``, one replay a batch), and the
     counters are read: every served batch must have launched the forward
     kernel once. Answers must decode with log_prob <= 0, and the log-probs must
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
 7b. One fp32 train step through the fp32 kernels (``compute_dtype``
     float32, ``rl_impl`` pallas) against the fp32 ``xla`` path, same
     weights and batch: one launch of each fp32 kernel, the loss within
     1e-5 relative.
  8. Times with CUDA events: each kernel, its plain version, one PyTorch
     yardstick (``library_ms``) and the roofline bound; the phase breakdown
     of ``pairwise_fwd``, ``pairwise_bwd``, ``pairwise_fwd_int8`` and the
     fp32 ``pairwise_fwd_f32`` / ``pairwise_bwd_f32`` at B = 64 and 512 (the phase-timing build: clock64() cycles per phase summed
     over the CTAs' first consumer threads, as shares of their total), and
     the int8 kernel's time over ``pairwise_fwd``'s; serve latency per
     bucket and train questions/s on the host clock (kernel and xla paths in
     the order kernel xla xla kernel); torch.profiler
     breakdowns of a served forward and of a train step (device busy time by
     kernel, and the device's idle share). The int8 kernel at B = 64 and
     512 (its yardstick: ``torch._int_mm`` on materialised pair rows), a
     profile of one int8 eval batch at B=512 beside the bf16 one (the
     calibration and folding ops around the kernel included), and serve
     latency per bucket and burst throughput of the bf16 and int8 servers,
     taken in turns (bf16 int8 int8 bf16). The fp32 kernels at B = 64 and
     512 beside the cuBLAS fp32 chain (TF32 off) and its autograd. The
     backward at stretch-fp-32's shape (B = 8 and 16, 1,024 objects; fp32
     at B=8) with its grid and CTAs per sample, bound and cuBLAS autograd
     ("OOM" where that does not fit), and the grid and splits of every
     B=64 row and phase breakdown. wide-fp's
     H=512 at B=512 (n=64): the bf16 forward and backward, int8 and the
     fp32 kernels, each with its plain version, yardstick, bound and plan
     (``cluster``), each forward and backward twice, bitwise, and held to
     its plain version (phases 3, 5 and 5c's tolerances; the fp32 gradients
     to the float64 chain), each forward at the serving buckets B=1 and 8
     replayed from a graph (int8 also with its calibration:
     ``ms_with_calibration``); the phase breakdown of the H=512 forwards
     and backwards (bf16 and fp32, on clusters of two CTAs; slot
     ``pair_wait`` the waits for the peer) and of the int8 forward at B=512
     and B=8.
  9. Augment kernel vs its plain version on the card: B = 1, 7 and 512, fp32
     and bf16 outputs, angles of ±2.8 degrees and 0, the four corner offsets
     (where the shears wrap around the canvas), repeated indices, a cache of
     2,048 canvases and a full-size CLEVR train cache of 70,000 x 144^2 x 3
     uint8 (4.35 GB, made on the card from a seed) with indices above
     34,500, and a batch-local source (idx = arange(B)). Angle 0 at offset
     (8, 8) must give the centre crop x (1/255) exactly; an index outside
     the cache gives NaN rows.
 9b. The question embedding's backward (``csrc/embedding_bwd.cu``) at
     (B, T, V, E) = (640, 48, 90, 32), (512, 48, 90, 32) and (3, 7, 11, 20)
     with CLEVR-like pads: bit for bit its plain version and itself, and
     both it and the parent route (``index_put_``'s gradient of
     ``weight[tokens] * mask``) within the fp32 bound of any summation
     order of the float64 sum; an all-pad batch gives zeros;
     ``QuestionEmbedModel`` at B=640 launches it once a backward and never
     under ``no_grad`` or inference mode, every other gradient bit for bit
     the parent route's; CUDA-event times at both train cells' shapes of the
     kernel (replayed), the parent route and ``F.embedding(...,
     padding_idx=0)``'s backward. Phases 7 and 12 count one launch a train
     step.
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
12d. wide-fp (g_theta 4 x 512, f_phi 512-512-28) in int8 against bf16 end
     to end (``wide_int8_phase``, after 10b): the replayed eval batch at
     B=512 through "auto" (the bf16 cluster forward) and "pallas_int8" in
     turns (host and busy ms, idle share, the g_theta kernel's ms, one
     launch a batch, replay bitwise equal to eager, equal predictions);
     ``python -m rnet_torch.evaluate --model wide-fp`` on a weights pkl of
     seeded weights on phase 10's directory, as is (16 ``pairwise_fwd``) and
     with ``--rl-impl pallas_int8`` under warnings as errors (16
     ``pairwise_fwd_int8``, nothing else), eval q/s in the order bf16 int8
     int8 bf16; wide-fp ``InferenceServer``s in bf16 and int8 at buckets
     1/8/64 (one launch per served batch and nothing else, replays bitwise
     equal to eager servers), latency per bucket in turns and the
     700-request burst, and the share of equal answers.
10c. ``python -m rnet_torch.train --model stretch-fp-32 --batch-size 16``
     on the same directory, device pipeline, capped at one epoch (512
     steps, 64 eval batches): 512 ``pairwise_bwd`` and ``augment`` and 576
     ``pairwise_fwd`` launches, nothing else, finite history (run after
     10b).
10b. The eval entry point, ``rnet_torch.evaluate.main``, on (a)'s epoch-2
     checkpoint: ``--data-pipeline device --split train --batch-size 512``
     (8,192 questions, 16 batches), as is (16 ``pairwise_fwd`` launches,
     no ``augment``, no int8) and with ``--rl-impl pallas_int8`` under
     warnings as errors (16 ``pairwise_fwd_int8`` launches and nothing else,
     the clip-fraction line printed), in the order bf16 int8 int8 bf16;
     finite accuracy and NLL and the report files from each, the share of
     equal predictions, and the eval questions/s of each run (host clock).
 12. Compiled dispatch (after phase 9; its Trainer epochs after 11):
     train steps of original-fp at full width, B=512, through
     ``make_chunked_steps`` on device-resident data (a 2,048-canvas cache,
     device augment on, f_phi dropout 0.5, cuDNN deterministic): from one
     saved state, 8 eager steps against 8 calls of the CUDA graph captured
     at the first (the LR tripled before step 5 in both), bitwise equal in
     per-step metrics, parameters, BatchNorm buffers and Adam state, with
     8 launches of pairwise_fwd, pairwise_bwd and augment counted; the same
     with pair_dropout 0.25 (16 mask draws) and in fp32 through the fp32
     kernels; a probe that two replays draw fresh augment angles and
     offsets, dropout masks and pair seeds, each equal to an eager draw;
     the eval batch at B=512 replayed against eager; the bf16 and int8
     servers' replayed log-probs and answers at buckets 1/8/64 against
     eager servers (``cuda_graphs=False``), one launch per served batch;
     then times in the order eager replay replay eager: the train step
     and the eval batch (host clock, profiler busy time, idle share, q/s),
     serve latency per bucket and the 700-request burst, bf16 and int8,
     each graph's capture time and pool; last, one Trainer epoch of run
     (a)'s setup with ``cuda_graphs=False`` and True (F T T F), loss, val
     NLL and parameters bitwise equal.
12b. wide-fp (g_theta 4 x 512) train steps at B=512 on device-resident
     data, replayed: bf16 through ``rl_impl="auto"`` (the kernels) against
     ``"xla"``, fp32 through ``"pallas"`` against ``"xla"``, and original-fp
     in fp32 through ``"pallas"`` against ``"xla"``, each pair in the order
     kernel xla xla kernel: host ms, q/s and the launches of every kernel
     per step; busy ms and idle share from one profiled window (host clock
     and profiler over the same replays); the first step's loss of the
     kernel arm against the ``xla`` arm's (same weights and draws).
12c. stretch-fp-32 (1,024 objects, mean pool) replayed bf16 train steps at
     B = 8 and 16, ``auto`` (the kernels, the backward on sample splits)
     against ``xla`` in the order auto xla xla auto, the same measurements
     and first-step loss check as 12b, one pairwise_fwd, pairwise_bwd and
     augment launch a step counted with the counters zeroed just before;
     ``xla``'s row says "OOM" where its step does not fit the card.
 11. fp32 and extraction: (a) ``python -m rnet_torch.train --precision
     float32 --rl-impl pallas``, one epoch of 16 steps (one
     ``pairwise_fwd_f32`` launch per train and eval batch, one
     ``pairwise_bwd_f32`` per step, no bf16 kernel); (b) ``RN.extract`` of
     ir-fp at full width, B=512, on the synthetic cache's canvases: bf16 vs
     fp32 on the card within 2e-2 and fp32 on the card vs the CPU within
     1e-5 of the largest feature, images/s of each; ``python -m
     rnet_torch.extract`` end to end for ir-sd (the synthetic scenes) and,
     where Pillow imports, ir-fp (PNGs written from the val canvases): one
     row per image, in order, with a ragged last batch. ``RN.extract`` of
     ir-fp at B=512, bf16 and fp32, replayed from a CUDA graph as the CLI
     runs it (``rnet_torch.extract.Extractor``) against eager: bitwise
     equal, both timed (eager replay replay eager), the graph's pool.
 14. rnet's own epoch directory (``tests/torch_fixtures/``: original-fp at
     full width after two Adam steps, saved by rnet's CheckpointManager with
     phase 10's dictionaries): restored by ``rnet_torch.ocdbt`` on the host
     (seconds, MB), every leaf equal to its recorded sha256;
     ``rnet_torch.evaluate`` on it in bf16 and ``--rl-impl pallas_int8``
     (16 launches of the bf16 / int8 kernel, nothing else);
     ``InferenceServer.load`` of it (one launch per served batch, log-probs
     against an ``xla`` server of the same epoch); ``rnet_torch.train
     --resume`` from it for one epoch of 16 steps (16 ``pairwise_bwd`` and
     ``augment`` launches, 18 ``pairwise_fwd``; Adam's step 2 + 16).
 13. Several processes (``rnet_torch/parallel/mesh.py``), after 12's Trainer
     epochs, on original-fp at full width in bf16 through the kernels,
     B=512 global, device data, dropout, pair dropout and augmentation off:
     the g_theta kernels timed in one process at the per-shard shapes
     (B, ni, nj) = (512, 32, 64) under pairs:2 and (256, 64, 64) under
     data:2 beside (512, 64, 64); (a) two processes sharing the card over
     gloo (file-based init, ``cuda_graphs`` off): 4 steps under data:2 and
     under pairs:2, each step's loss within 1e-2 of one process's at
     B=512 on the same weights and order (phase 7's bound), the parameters
     bitwise equal on both ranks, each rank's counters (zeroed just before)
     one pairwise_fwd and pairwise_bwd a step at the per-shard shape; 4
     steps with pair dropout under pairs:2, every launch at seed + shard_id
     * 1_000_003, its mask bit for bit ``pair_mask_reference``'s; an eval
     batch under data:2 (predictions gathered, against one process's) and
     under pairs:2 through ``pallas_int8`` (one int8 launch at ni=32 a
     rank); (b) a one-rank NCCL group under ``torch.distributed.run``: 8
     eager steps against 8 replays with the gradient all-reduce captured in
     the graph, bitwise, then ``rnet_torch.train --mesh data:1 --multihost``
     for one epoch of phase 10's directory with CUDA graphs (its launches
     counted); (c) with two or more cards, (a) again over NCCL, the steps
     replayed from CUDA graphs, one process a card; with one card a line
     says it was not run.
     A worker that fails fails the phase.
 16. ``python -m rnet_torch.bench`` (the port of ``bench.py``; after phase
     12): in process, ``measure_train_qps("auto", 512)``,
     ``measure_infer_qps("auto", 512)`` and ``measure_train_qps("xla",
     512)``, each with the launch counters zeroed just before: the train
     arm counts one ``pairwise_fwd`` and one ``pairwise_bwd`` per step its
     warm-up and timed replays took and nothing else (no ``augment``, no
     ``pair_mask``: the batch is unpadded), the infer arm ``pairwise_fwd``
     only, the ``xla`` arm no kernel. Then ``python -m rnet_torch.bench`` in
     a subprocess, as a user runs it: rc 0, the last line holds exactly
     ``bench.py``'s keys plus ``device`` (the card's line), ``backend``
     "cuda", finite positive ``value``, ``infer_qps`` and
     ``xla_impl_train_qps``; ``value`` within +-15 % of phase 12's replayed
     original-fp train q/s from the same run (the same replayed step; phase
     12 adds a 0.07 ms augment).
 15. rnet's trained wide-fp weights (``results/int8_eval_r4/
     wide-fp_epoch091_weights_dicts.pkl``, the dictionaries carried) on the
     val split rnet scored them on, expanded from the repository
     (``tests/torch_fixtures/clevr_v2_seed1_val/``, each file at its
     sha256; 600 images, 7,484 questions): ``rnet_torch.evaluate.main
     --data-pipeline device --batch-size 512`` in bf16 (``auto``), with
     ``--rl-impl pallas_int8`` (warnings as errors) and with ``--precision
     float32``, the counters zeroed before each: 15 launches of
     ``pairwise_fwd`` / ``pairwise_fwd_int8`` / ``pairwise_fwd_f32``
     respectively and nothing else. Bounds, fixed before the first run:
     overall accuracy within 0.3 pp of rnet's (bf16 and fp32 against
     0.977686, int8 against 0.978220), mean NLL within 0.005 of rnet's
     (0.059745 / 0.060663), each of the five ``category_*`` rows of the
     port's ``val_accuracy.csv`` within 1.0 pp of the same row of rnet's
     (``results/widefp_r3/int8_eval/{auto,pallas_int8}/val_accuracy.csv``),
     fp32 within 0.1 pp of the port's CPU accuracy 0.977819, bf16 and int8
     predictions equal on >= 0.99 of the questions. Then bf16 and int8
     ``InferenceServer``s loaded from the same pkl serve the first 64 val
     questions as three batches (buckets 1, 8, 64): one launch of the
     kernel per served batch and nothing else; bf16: every answer equal to
     ``evaluate``'s prediction; int8: every answer equal to the plain int8
     chain's on the same served batches (int8 calibrates its scales on a
     subsample of each call's batch, rnet's ``_activation_scales``, so a
     question's int8 answer depends on its batch; the answers that differ
     from ``evaluate``'s are logged: an open fault of the calibration,
     ROADMAP §3). (c) One replayed
     wide-fp bf16 train step at B = 1024 and 2048 through ``auto`` and
     through ``xla``, each in a worker process (``chip_smoke.py
     --wide-batch-worker B IMPL``): host ms, graph pool and peak memory, or
     "OOM"; ``auto`` out of memory where ``xla`` runs fails the phase.
17. The port's fixture generator (``rnet_torch.data.synth``) on the card
     and rnet's trained original-fp (``results/campaign_r3/
     original-fp_epoch119_weights.pkl``: 120 epochs on ``python -m
     rnet.data.synth <dir> --n-train 70000 --n-val 15000 --style v2 --seed
     1``; it carries no dictionaries) through the card's kernels, on that
     fixture regenerated here. (a) ``generate(<dir>, 4000, 600, style="v2",
     seed=1)`` and the port's val cache of it: ``CLEVR_val_questions.json``
     and the cache's ``.json`` at the sha256 rnet's generator gave
     (``tests/torch_fixtures/clevr_v2_seed1_val/digests.json``), the cache
     (600 x 144 x 144 x 3 uint8) at its sha256 too or, if the card's Pillow
     renders otherwise (its version is printed), against the committed
     cache of rnet's PNGs: at most 0.1 % of the bytes differ and none by
     more than 8 levels (a Pillow difference, not the port's). (b) The
     70,000 train scenes and questions drawn without rendering
     (``_draw_split``, the completion pass included) and written: both JSON
     files at the sha256 of ``tests/torch_fixtures/clevr_v2_seed1_70k/
     digests.json`` (``tests/torch_fixture_v2_70k_writer.py``, rnet's
     generator), 870,780 questions; ``rnet_torch.cli.load_dicts`` builds the
     dictionaries from them (the pkl carries none), each map equal to the
     committed ``dictionaries.json`` in content and order; the 15,000 val
     scenes drawn next, rendered in worker processes, their JSON at its
     sha256 (186,681 questions) and the val cache built (0.93 GB), at its
     sha256 unless (a) found a Pillow difference. (c) ``rnet_torch.evaluate
     .main --model original-fp`` on the pkl, the val split, device
     pipeline, B=512: bf16 (``auto``), ``--rl-impl pallas_int8`` (warnings
     as errors) and ``--precision float32``, the counters zeroed before
     each: 365 launches of ``pairwise_fwd`` / ``pairwise_fwd_int8`` /
     ``pairwise_fwd_f32`` respectively and nothing else. Bounds, fixed
     before the first run, against rnet's report (``results/campaign_r3/
     final_epoch119/val_accuracy.csv``: 0.999818, NLL 0.000719): bf16 and
     fp32 overall within 0.02 pp (37 questions), mean NLL within 0.0005,
     each of the five ``category_*`` rows within 0.05 pp. The int8 bounds
     fixed with them (int8 overall >= 0.9995, bf16 and int8 predictions
     equal on >= 0.999) failed on the card (0.997048: ``count`` 1.1 pp
     down). rnet's own int8 loses as much: on eval batches 0 and 45 (45 is
     where the card's int8 and bf16 differ most) its kernel in interpret
     mode on the CPU answers 512 and 489 of 512 right, its bf16 512 and 512
     (``tests/torch_fixtures/clevr_v2_seed1_70k/int8_batches.json``, from
     ``tests/torch_fixture_v2_70k_writer.py``; with fp32 compute the port's
     plain int8 chain equals it question for question). So int8 is held,
     by bounds set after the card's first run from those readings, to:
     overall at least bf16's less 0.5 pp, predictions equal to bf16's on
     >= 0.995, mean NLL <= 0.03, each ``category_*`` at least bf16's less
     2 pp; and on batches 0 and 45, the same folded inputs through the
     kernel and through ``pairwise_core_int8_reference`` on the card give
     every prediction equal, and the kernel's predictions equal rnet's int8
     ones on >= 0.98 of the batch, its right answers within 6 of rnet's and
     its mean NLL at most 1.5 x rnet's + 0.01. (d) bf16 and int8
     servers loaded from the pkl serve the first 64 val questions at buckets
     1, 8 and 64 under phase 15's rules (bf16 answers equal to
     ``evaluate``'s, int8 answers to the plain int8 chain's on the same
     batches, those that differ from ``evaluate``'s logged).
Then one JSON line of kernel records and, last, the device line.

Only torch, numpy and ``rnet_torch`` are imported (never JAX or ``rnet``).
fp32 comparisons run with TF32 off for matmuls and convolutions.
"""

from __future__ import annotations

import json
import os
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
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet)
CANVAS, CROP = 144, 128  # padded CLEVR canvas, model input
CLEVR_TRAIN_IMAGES = 70_000  # CLEVR v1.0 train split
AUG_SMALL = 2_048  # the synthetic run's train images
SYN_TRAIN_Q, SYN_VAL_IMAGES, SYN_VAL_Q = 8_192, 256, 1_024  # 16 train steps of 512 per epoch
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures")  # phase 14
VAL_FIXTURE = os.path.join(FIXTURE_DIR, "clevr_v2_seed1_val")  # phase 15
# phase 15's files and the CLEVR subdirectory each goes to; the large ones are committed xz-compressed
VAL_FIXTURE_FILES = {"CLEVR_val_questions.json": "questions", "val_128p8.u8": "rnet_cache",
                     "val_128p8.json": "rnet_cache"}
VAL_FIXTURE_XZ = ("CLEVR_val_questions.json", "val_128p8.u8")


def expand_val_fixture(root: str) -> dict:
    """Write the committed val split of the v2 seed-1 fixture
    (``tests/torch_fixture_val_writer.py``) into the CLEVR directory `root`:
    ``questions/CLEVR_val_questions.json`` and the decoded cache
    ``rnet_cache/val_128p8.u8`` with its ``.json``, each checked against its
    recorded sha256 (ValueError if one differs). Returns the digests file."""
    import hashlib
    import lzma

    with open(os.path.join(VAL_FIXTURE, "digests.json")) as f:
        digests = json.load(f)
    for name, sub in VAL_FIXTURE_FILES.items():
        src = os.path.join(VAL_FIXTURE, name)
        if name in VAL_FIXTURE_XZ:
            with lzma.open(src + ".xz") as f:
                data = f.read()
        else:
            with open(src, "rb") as f:
                data = f.read()
        if hashlib.sha256(data).hexdigest() != digests["files"][name]["sha256"]:
            raise ValueError(f"{name} of {VAL_FIXTURE} does not match its recorded sha256")
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, name), "wb") as f:
            f.write(data)
    return digests


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


def replay_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms per call of fn replayed from a CUDA graph of `calls` calls
    (no host gaps between them, as a served bucket's graph replays), the mean
    over `reps` replays after one warm-up call on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(torch, graph.replay, reps, warmup=1) / calls
    del graph
    return ms


def pair_inputs(torch, B, n, H, L, seed, dtype=None):
    """Seeded numpy inputs of the pairwise core, as CUDA tensors in `dtype`
    (bf16 if None)."""
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
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", dtype or torch.bfloat16) for a in arrs]


def upstream(torch, B, H, seed):
    """A seeded fp32 (B, H) upstream gradient of the pooled core."""
    import numpy as np

    return torch.from_numpy(np.random.RandomState(seed).randn(B, H).astype(np.float32)).cuda()


def library_chain(torch, u, v, s, qa, ws, bs, inject):
    """The same function through cuBLAS bf16 matmuls on materialised pair
    rows (the decomposed path): the yardstick, used nowhere in the port."""
    B, ni, H = u.shape
    a = torch.relu(u[:, :, None, :] + v[:, None, :, :] + s[:, None, None, :]).reshape(B, ni * v.shape[1], H)
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


def f32_fwd_bound(B, ni, nj, H, L):
    """(bound_ms, bound_by) of the fp32 forward: 3xTF32 runs three TF32
    products per fp32 product (3 x the FLOPs at the dense TF32 peak); bytes
    as fwd_bound's in 4-byte elements."""
    flops = 3 * 2.0 * B * ni * nj * (L - 1) * H * H
    nbytes = 4.0 * (B * ni * H + B * nj * H + 2 * B * H + (L - 1) * H * H + (L - 1) * H) + 4.0 * B * H
    return roofline(flops, nbytes, peak_ops=PEAK_TF32_FLOPS)


def f32_bwd_bound(B, ni, nj, H, L):
    """The fp32 backward: recompute, d and dW products, each 3xTF32; the
    fp32 inputs and g read once, the fp32 gradients written once."""
    flops = 3 * 3 * 2.0 * B * ni * nj * (L - 1) * H * H
    n_in = B * ni * H + B * nj * H + 2 * B * H + (L - 1) * H * H + (L - 1) * H
    return roofline(flops, 4.0 * n_in + 4.0 * B * H + 4.0 * n_in, peak_ops=PEAK_TF32_FLOPS)


def mask_bound(B, npairs):
    """Philox4x32-10 for one word: 10 rounds of 2 mulhi, 2 mullo, 2 xor-3,
    2 key adds (~12 int32 ops) plus the threshold test; one byte written."""
    return roofline(B * npairs * 121.0, B * npairs * 1.0, peak_ops=PEAK_INT32_OPS)


def profile_device(torch, fn, reps: int = 3, host=None):
    """Device time by kernel name for one call of fn (torch.profiler):
    (busy_ms per call, kernel launches per call, top rows). With a list
    ``host``, appends the host-clock ms per call of the same profiled reps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        if host is not None:
            host.append((time.perf_counter() - t0) * 1e3 / reps)
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
# CTA, 128-row blocks) and H=512 with inject 2 at B=140 (a cluster of two
# CTAs owning 2-3 samples). At H=512 the backward runs on clusters of two
# CTAs: B=64, and B=3 (odd, one sample a cluster, a grid of 3 clusters with
# L=3), and the SD grid of 12 objects at B=5 (144 pair rows: a ragged
# second block of 128). H=384 (B=8): the one-CTA backward on one consumer
# warpgroup, the only plan of the bf16 backward above H=256 but H=512. The
# forward at H=512 runs on clusters of two CTAs too: at wide-fp's serving
# buckets B=1 (one warpgroup a CTA on 64-row blocks: 64 tiles for 66
# clusters) and B=8 (two, 128-row blocks), B=3 with L=3 and inject 2 (96
# tiles: 30 clusters take a second), the SD grid (a ragged block), B=140.
# Below the SM count the one-CTA backward splits each sample over SMs // B
# CTAs (at most its blocks; tile_plan's ``splits``): B=1 (32 splits of one
# block at n=64, 132 of 62 blocks at the 1,024 objects), B=2, 3, 8 and 64
# (2 splits of 16 blocks), stretch-fp-16's grid of 256 objects at B=8 (16
# splits of 32 blocks) and stretch-fp-32's 1,024 objects at B=8 (16 splits
# of 512 blocks); the same launch twice is bitwise equal at B=64 and at
# stretch-fp-32's B=8, whose stored tiles run in two sample groups.
TRAIN_CASE = (TRAIN_B, 64, 64, 256, 4, 0)
SPLIT_CASE = (64, 64, 64, 256, 4, 0)
GROUPS_CASE = (8, 1024, 1024, 256, 4, 0)  # stretch-fp-32: the stored tiles in two sample groups
CASES = [
    (1, 64, 64, 256, 4, 0), (64, 64, 64, 256, 4, 0), (1, 64, 64, 256, 4, 2),
    (64, 64, 64, 256, 4, 2), (64, 64, 64, 512, 4, 0), (3, 12, 12, 128, 3, 1),
    (2, 16, 64, 256, 4, 1), (1, 1024, 1024, 256, 4, 1), TRAIN_CASE, (140, 64, 64, 512, 4, 2),
    (3, 64, 64, 512, 3, 1), (5, 12, 12, 512, 4, 2), (8, 64, 64, 384, 4, 1),
    (1, 64, 64, 512, 4, 0), (8, 64, 64, 512, 4, 0), (3, 64, 64, 512, 3, 2), (8, 256, 256, 256, 4, 0),
    GROUPS_CASE,
]
KEEPS = (1.0, 0.75)
GRAD_NAMES = ("du", "dv", "ds", "dqa", "dws", "dbs")
# fp32 kernel agreement cases (B, ni, nj, H, L, inject, keep): original-fp
# at the training batch and B=64, ir-fp's injection at layer 2, wide-fp's
# H=512, the SD grid of 12 objects at H=512 (144 pair rows: a ragged last
# block of the forward's 128-row blocks), a rectangular ni != nj,
# stretch-fp-32's 1,024 objects, and pair dropout at keep 0.9; then the
# other tile layouts of the backward at H=256 (L=3: dpre_2 in a_0's tile;
# L=2: in its own), with the injection at the last layer, a ragged block
# and dropout; at H=512 (the backward on clusters of two CTAs, as is the
# forward) B=3 (odd, one sample a cluster) with dropout and the SD grid at
# B=5 with L=3; the forward at wide-fp's
# serving bucket B=1 and at B=140 (clusters walk 67-68 tiles each);
# stretch-fp-16's grid at B=8 (the backward's 16 splits of 64 blocks a
# sample). Every backward case below B=132 at H=256 runs a split plan; B=64
# twice, bitwise.
F32_TRAIN_CASE = (TRAIN_B, 64, 64, 256, 4, 0, 1.0)
F32_CASES = [
    F32_TRAIN_CASE, (64, 64, 64, 256, 4, 0, 1.0), (64, 64, 64, 256, 4, 2, 1.0), (64, 64, 64, 512, 4, 0, 1.0),
    (64, 12, 12, 512, 4, 2, 1.0), (2, 16, 40, 256, 4, 1, 1.0), (1, 1024, 1024, 256, 4, 0, 1.0),
    (64, 64, 64, 256, 4, 0, 0.9), (4, 24, 24, 256, 3, 2, 0.75), (3, 10, 10, 256, 2, 1, 1.0),
    (3, 64, 64, 512, 4, 1, 0.75), (5, 12, 12, 512, 3, 2, 1.0),
    (1, 64, 64, 512, 4, 0, 1.0), (140, 64, 64, 512, 4, 2, 1.0), (8, 256, 256, 256, 4, 0, 1.0),
]
F32_SPLIT_CASE = (64, 64, 64, 256, 4, 0, 1.0)


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
            err = fwd_agreement(torch, pw, args, inject, keep, seed)
            max_err = max(max_err, err)
            if CASES[k] == TRAIN_CASE:
                at_shape = max(at_shape, err)
        del args
        torch.cuda.empty_cache()
    return max_err, at_shape


def fwd_agreement(torch, pw, args, inject, keep, seed, tag=""):
    """One bf16 forward launch against its plain version at phase 3's bound;
    returns max |kernel - plain|."""
    (B, ni, H), nj, L = args[0].shape, args[1].shape[1], args[4].shape[0] + 1
    out = pw.pairwise_fwd_cuda(*args, inject=inject, pair_keep=keep, seed=seed)
    ref = pw.pairwise_core_reference(*args, inject=inject, keep=keep, seed=seed)
    torch.cuda.synchronize()
    case = (B, ni, nj, H, L, inject, keep)
    if out.shape != (B, H) or not torch.isfinite(out).all():
        fail(f"pairwise_fwd output at {case} is not finite (B, H)")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = 2e-3 * scale + 1e-2
    log(f"pairwise_fwd vs plain{tag} B={B} ni={ni} nj={nj} H={H} L={L} inject={inject} keep={keep}: "
        f"max_abs_err {err!r} (max|ref| {scale!r}, tol {tol!r})")
    if not err <= tol:
        fail(f"pairwise_fwd disagrees with its plain version at {case}")
    return err


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
    if pw.tile_plan("bwd", *SPLIT_CASE[:5], sms).splits < 2:
        fail(f"the backward at {SPLIT_CASE} should split each sample over several CTAs on {sms} SMs")
    if len(pw.bwd_groups(*GROUPS_CASE[:5], sms)) < 2 or len(pw.bwd_groups(*TRAIN_CASE[:5], sms)) != 1:
        fail(f"the backward should run {GROUPS_CASE} in several sample groups and {TRAIN_CASE} in one")
    max_err = at_shape = 0.0
    for k, (B, ni, nj, H, L, inject) in enumerate(CASES):
        args = pair_inputs(torch, B, nj, H, L, seed=k)
        args[0] = args[0][:, :ni].contiguous()
        g = upstream(torch, B, H, seed=50 + k)
        for keep in KEEPS:
            got, err = bwd_agreement(torch, pw, args, g, inject, keep, seed)
            max_err = max(max_err, err)
            if CASES[k] == TRAIN_CASE:
                at_shape = max(at_shape, err)
        if CASES[k] in (TRAIN_CASE, SPLIT_CASE, GROUPS_CASE):  # the same launch twice, bitwise (one owner;
            # sample splits; sample groups)
            again = pw.pairwise_bwd_cuda(*args, g, inject=inject, pair_keep=0.75, seed=seed)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"pairwise_bwd is not bitwise repeatable at B={B}")
            log(f"pairwise_bwd at B={B}: the same launch twice gives bitwise-equal gradients")
            del again
        del args, g, got
        torch.cuda.empty_cache()
    return max_err, at_shape


def bwd_agreement(torch, pw, args, g, inject, keep, seed, tag="", chunk=None):
    """One bf16 backward launch against its plain version at phase 5's
    bounds, the plain version run on `chunk` samples at a time where given
    (``plain_in_chunks``); returns (the gradients, max |kernel - plain| over
    them)."""
    (B, ni, H), nj, L = args[0].shape, args[1].shape[1], args[4].shape[0] + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = pw.pairwise_bwd_cuda(*args, g, inject=inject, pair_keep=keep, seed=seed)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    groups = pw.bwd_groups(B, ni, nj, H, L, sms)
    # the stored tiles within the budget (or one sample's, where one alone is more), the rest (gradients,
    # split slices, partials, packed W) within BWD_OTHER_BYTES
    if peak > max(pw.BWD_STORE_BUDGET, pw.stored_bytes(groups[0][1])) + BWD_OTHER_BYTES:
        fail(f"pairwise_bwd at B={B} ni={ni} nj={nj} H={H} L={L} took {peak} B of device memory over "
             f"BWD_STORE_BUDGET {pw.BWD_STORE_BUDGET} + {BWD_OTHER_BYTES}")
    want = plain_in_chunks(torch, lambda a, gg: pw.pairwise_core_bwd_reference(*a, gg, inject, keep, seed),
                           args, g, chunk or B, keep)
    torch.cuda.synchronize()
    case = (B, ni, nj, H, L, inject, keep)
    parts, max_err = [], 0.0
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
    plan = groups[0][1]
    unit = "cluster of 2" if plan.cluster > 1 else "CTA"
    spread = (f"{plan.splits} CTAs per sample" if plan.splits > 1 else
              f"{-(-B // (plan.grid // plan.cluster))} samples per {unit} at most")
    chunks = f", plain {chunk} samples at a time" if chunk and chunk < B else ""
    log(f"pairwise_bwd vs plain{tag} B={B} ni={ni} nj={nj} H={H} L={L} inject={inject} keep={keep} "
        f"({len(groups)} sample groups of {plan.B}, grid {plan.grid}, {spread}{chunks}; peak {peak} B): "
        + " | ".join(parts))
    return got, max_err


# Device memory a bf16 backward call may take beside its stored tiles: the
# gradients, the sample splits' slices (277 MB at stretch-fp-32's groups of
# 4), the dW and db partials, the packed W.
BWD_OTHER_BYTES = 1 << 30
# Pair rows a plain backward takes at once on the card: the bf16 plain
# version's fp32 chain fits 8 x 2^20 rows (stretch-fp-32 at B=8), the float64
# chain (vjp64) 2^20 rows.
PLAIN_ROWS, F64_ROWS = 1 << 23, 1 << 20


def plain_in_chunks(torch, fn, args, g, chunk, keep=1.0):
    """fn(args, g) -> (du, dv, ds, dqa, dws, dbs) over `chunk` samples at a
    time: the per-sample gradients concatenated, dW and db added chunk by
    chunk in order. The pair-dropout mask is drawn for the whole batch, so
    a batch in chunks takes keep 1."""
    B = g.shape[0]
    if chunk >= B:
        return list(fn(args, g))
    if keep < 1.0:
        fail(f"a plain backward in chunks of {chunk} of {B} samples cannot draw the batch's pair mask")
    parts = list(zip(*(fn([a[b:b + chunk] for a in args[:4]] + list(args[4:]), g[b:b + chunk])
                       for b in range(0, B, chunk))))
    return [torch.cat(p) for p in parts[:4]] + [sum(p) for p in parts[4:]]


def rel64(a, z):
    """The relative distance in norm of a from the float64 value z."""
    return ((a.double() - z).norm() / z.norm().clamp_min(1e-300)).item()


def f32_grads_agreement(torch, case, got, want, exact):
    """Phase 5c's bound on each fp32 backward gradient (see check_f32):
    ||kernel - exact|| <= 1e-4 ||exact|| + 2 ||plain - exact||; logs and
    returns {name: (max |kernel - plain| / max |plain|, max |kernel - plain|)}."""
    parts, errs = [], {}
    for name, d, w, z in zip(GRAD_NAMES, got, want, exact):
        if d.shape != w.shape or d.dtype != torch.float32 or not torch.isfinite(d).all():
            fail(f"pairwise_bwd_f32 {name} at {case} is not a finite fp32 {tuple(w.shape)}")
        m = ((d - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        rk, rp = rel64(d, z), rel64(w, z)
        parts.append(f"{name} {m:.3g} (from float64: kernel {rk:.3g}, plain {rp:.3g})")
        if not rk <= 1e-4 + 2 * rp:
            fail(f"pairwise_bwd_f32 {name} at {case}: {rk} from the float64 gradient, plain fp32 {rp} "
                 f"(bound 1e-4 + 2 x plain)")
        errs[name] = (m, (d - w).abs().max().item())
    B, ni, nj, H, L, inject, keep = case
    log(f"pairwise_bwd_f32 vs plain B={B} ni={ni} nj={nj} H={H} L={L} inject={inject} keep={keep}, "
        "max|d|/max|ref|: " + " | ".join(parts))
    return errs


def vjp64(torch, pw, args, g, inject, keep, seed):
    """The pooled core and its VJP in float64 through autograd (the mask of
    ``_pair_scale`` under pair dropout): the exact answer both fp32 versions
    are measured against. Returns (out, [du, dv, ds, dqa, dws, dbs])."""
    xs = [a.double().requires_grad_() for a in args]
    u, v, s, qa, ws, bs = xs
    B, ni, H = u.shape
    nj = v.shape[1]
    a = torch.relu(u[:, :, None, :] + v[:, None, :, :] + s[:, None, None, :]).reshape(B, ni * nj, H)
    for l in range(1, ws.shape[0] + 1):
        pre = a @ ws[l - 1] + bs[l - 1]
        if l == inject:
            pre = pre + qa[:, None, :]
        a = torch.relu(pre)
    if keep < 1.0:
        a = a * pw._pair_scale(seed, B, ni, nj, keep).double()[..., None]
    out = a.sum(dim=1)
    grads = torch.autograd.grad(out, xs, g.double(), allow_unused=True)
    return out.detach(), [torch.zeros_like(x) if d is None else d for d, x in zip(grads, xs)]


def check_f32(torch, pw, seed):
    """Phase 5c; returns (forward max |k - p| / max |p| at F32_TRAIN_CASE and
    over all cases, the same of every gradient, the absolute errors at
    F32_TRAIN_CASE)."""
    # Tolerances. Forward: max |kernel - plain| <= 1e-4 max |plain| (both
    # fp32, the sums in other orders). Backward: where two fp32 computations
    # sum in different orders, the relu masks [a_l > 0] disagree at the few
    # activations within an ulp of zero (tens in 512 x 4,096 rows), and each
    # disagreement moves a whole dpre value, up to ~1e-2 of max |du| at one
    # element; the fp32 plain version is itself that far from the exact
    # gradients. So each gradient is held to the float64 chain (vjp64):
    # ||kernel - exact|| <= 1e-4 ||exact|| + 2 ||plain - exact||, with the
    # plain fp32 version's own distance printed beside it, and max |kernel -
    # plain| / max |plain| is printed for every gradient.
    fwd_at = fwd_all = bwd_at = bwd_all = 0.0
    abs_at = {}
    for k, (B, ni, nj, H, L, inject, keep) in enumerate(F32_CASES):
        args = pair_inputs(torch, B, nj, H, L, seed=500 + k, dtype=torch.float32)
        args[0] = args[0][:, :ni].contiguous()
        g = upstream(torch, B, H, seed=550 + k)
        case = (B, ni, nj, H, L, inject, keep)
        out = pw.pairwise_fwd_cuda(*args, inject=inject, pair_keep=keep, seed=seed)
        ref = pw.pairwise_core_reference(*args, inject=inject, keep=keep, seed=seed)
        exact, exact_grads = vjp64(torch, pw, args, g, inject, keep, seed)
        got = pw.pairwise_bwd_cuda(*args, g, inject=inject, pair_keep=keep, seed=seed)
        want = pw.pairwise_core_bwd_reference(*args, g, inject, keep, seed)
        torch.cuda.synchronize()
        if out.shape != (B, H) or out.dtype != torch.float32 or not torch.isfinite(out).all():
            fail(f"pairwise_fwd_f32 output at {case} is not a finite fp32 (B, H)")
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        log(f"pairwise_fwd_f32 vs plain B={B} ni={ni} nj={nj} H={H} L={L} inject={inject} keep={keep}: "
            f"max|d|/max|ref| {err!r} (tol 1e-4); rel. norm from float64: kernel {rel64(out, exact)!r}, "
            f"plain {rel64(ref, exact)!r}")
        if not err <= 1e-4:
            fail(f"pairwise_fwd_f32 disagrees with its plain version at {case}")
        fwd_all = max(fwd_all, err)
        for name, (m, a) in f32_grads_agreement(torch, case, got, want, exact_grads).items():
            bwd_all = max(bwd_all, m)
            if case == F32_TRAIN_CASE:
                bwd_at = max(bwd_at, m)
                abs_at[name] = a
        if case == F32_TRAIN_CASE:
            fwd_at = err
            abs_at["out"] = (out - ref).abs().max().item()
        if case in (F32_TRAIN_CASE, F32_SPLIT_CASE):  # one owner CTA a sample; sample splits
            again = pw.pairwise_bwd_cuda(*args, g, inject=inject, pair_keep=keep, seed=seed)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"pairwise_bwd_f32 is not bitwise repeatable at B={B}")
            splits = pw.tile_plan("bwd", B, ni, nj, H, L, torch.cuda.get_device_properties(0).multi_processor_count,
                                  esize=4).splits
            log(f"pairwise_bwd_f32 at B={B} ({splits} CTAs per sample): the same launch twice gives bitwise-equal "
                f"gradients")
            del again
        del args, g, out, ref, exact, exact_grads, got, want
        torch.cuda.empty_cache()
    return fwd_at, fwd_all, bwd_at, bwd_all, abs_at


# Int8 agreement cases (B, ni, nj, H, L, inject, through the core?, input
# dtype): original-fp B=1/64/512, ir-fp (inject 2) B=64, wide-fp (H=512) at
# B=64 and B=140 > the SM count through ``pairwise_core_int8``; n=24 (576
# pairs, a ragged last block of 64 rows) and a rectangular ni != nj with the
# injection at the last layer through the wrapper; original-fp B=64 with
# fp32 u, v, s (int8 with fp32 compute, as rnet's kernel reads them);
# original-fp's shard under pairs:2 at B=512 (ni=32 of nj=64, calibrated on
# its own rows, as phase 13 launches it); wide-fp's serving buckets B=1 (64
# clusters of one warpgroup) and B=8, and its eval batch B=512 (the cluster
# kernel's three warpgroups), whose launch is also repeated bitwise; and the
# cluster kernel through the wrapper with a ragged last tile (96 pairs) and
# the injection at a middle layer, and with fp32 u, v, s and the injection
# at the last layer.
INT8_MAIN = (TRAIN_B, 64, 64, 256, 4, 0)
INT8_WIDE = (TRAIN_B, 64, 64, 512, 4, 0)
INT8_CASES = [
    ((1, 64, 64, 256, 4, 0), True, "bfloat16"), ((64, 64, 64, 256, 4, 0), True, "bfloat16"),
    (INT8_MAIN, True, "bfloat16"), ((64, 64, 64, 256, 4, 2), True, "bfloat16"),
    ((64, 64, 64, 512, 4, 0), True, "bfloat16"), ((140, 64, 64, 512, 4, 0), True, "bfloat16"),
    ((3, 24, 24, 256, 4, 1), False, "bfloat16"), ((2, 16, 40, 256, 3, 2), False, "bfloat16"),
    ((64, 64, 64, 256, 4, 0), True, "float32"), ((TRAIN_B, 32, 64, 256, 4, 0), True, "bfloat16"),
    ((1, 64, 64, 512, 4, 0), True, "bfloat16"), ((8, 64, 64, 512, 4, 0), True, "bfloat16"),
    (INT8_WIDE, True, "bfloat16"), ((2, 8, 12, 512, 3, 1), False, "bfloat16"),
    ((3, 16, 24, 512, 4, 3), False, "float32"),
]


def int8_args(torch, pw, case, seed, dtype="bfloat16"):
    """(core inputs in `dtype`, their folded int8 form) for an agreement case."""
    B, ni, nj, H, L, inject = case
    args = [a.to(getattr(torch, dtype)) for a in pair_inputs(torch, B, nj, H, L, seed=seed)]
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
    for k, (case, through_core, dtype) in enumerate(INT8_CASES):
        B, ni, nj, H, L, inject = case
        args, folded = int8_args(torch, pw, case, seed=300 + k, dtype=dtype)
        if folded[0].dtype != getattr(torch, dtype):
            fail(f"quantize_int8 gave {folded[0].dtype} u for {dtype} inputs")
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
        log(f"pairwise_fwd_int8 vs plain B={B} ni={ni} nj={nj} H={H} L={L} inject={inject} {dtype} u, v, s "
            f"({'pairwise_core_int8' if through_core else 'wrapper'}): max_abs_err {err!r} "
            f"(max|plain| {scale!r}, tol {1e-5 * scale!r}); drift from fp32 {drift!r}")
        if not err <= 1e-5 * scale:
            fail(f"pairwise_fwd_int8 disagrees with its plain version at {case}")
        if not drift < 3e-2:
            fail(f"pairwise_fwd_int8 drifts {drift} from the fp32 chain at {case}")
        worst, drift_max = max(worst, err), max(drift_max, drift)
        if case == INT8_MAIN and dtype == "bfloat16":
            at_main = err
        if case in (INT8_MAIN, INT8_WIDE) and dtype == "bfloat16":
            again = pw.pairwise_fwd_int8_cuda(*folded, inject=inject)
            if not torch.equal(again, pw.pairwise_fwd_int8_cuda(*folded, inject=inject)):
                fail(f"pairwise_fwd_int8 is not bitwise repeatable at H={H}")
            log(f"pairwise_fwd_int8 at B={B} H={H}: the same launch twice gives bitwise-equal outputs")
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
    if counts != {**dict.fromkeys(counts, 0), pw.INT8_KERNEL: served_batches}:
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


def new_state(torch, cfg, state_dict=None, mesh=None):
    """A train state of seeded weights (or ``state_dict``); under a ``mesh``
    rank 0's weights on every rank."""
    from rnet_torch.models import RN
    from rnet_torch.parallel.mesh import replicate_state
    from rnet_torch.train import steps

    model = RN(cfg, VOCAB, generator=torch.Generator().manual_seed(0), mesh=mesh).cuda()
    if state_dict is not None:
        model.load_state_dict(state_dict)
    replicate_state(model, mesh)
    return steps.create_train_state(model, steps.make_optimizer(LR, 50.0), seed=0)


def train_phase(torch, np, pw, cfg):
    """Phase 7; returns (kernel-path state, batch, counts of the K steps,
    counts of the pair-dropout step)."""
    from rnet_torch.kernels import embedding as em
    from rnet_torch.train import steps

    state = new_state(torch, cfg)
    dev = torch.device("cuda")
    if state.model.relational.resolve_impl(cfg.n_objects, dev) != "pallas":
        fail("rl_impl=auto does not route original-fp training to the kernels on the card")
    batch = train_batch(torch, np, cfg, TRAIN_B, seed=2)
    steps.train_step(state, batch)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    pw.reset_launches()
    em.reset_launches()
    metrics = [steps.train_step(state, batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = dict(pw.launches)
    if em.launches[em.KERNEL] != TRAIN_STEPS:
        fail(f"expected one embedding_bwd launch per train step, {TRAIN_STEPS}; counted {dict(em.launches)}")
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    log(f"train original-fp B={TRAIN_B}: {TRAIN_STEPS} steps, launches {counts} ({pw.BWD_KERNEL} "
        f"{counts[pw.BWD_KERNEL]} in {counts[pw.STORED_GROUPS]} {pw.STORED_GROUPS}), "
        f"loss {losses}, grad_norm {norms}, accuracy {[float(m['accuracy']) for m in metrics]}")
    if counts[pw.KERNEL] != TRAIN_STEPS or counts[pw.BWD_KERNEL] != TRAIN_STEPS or counts["pair_mask"] or \
            counts[pw.STORED_GROUPS] != TRAIN_STEPS:
        fail(f"expected {TRAIN_STEPS} pairwise_fwd and pairwise_bwd launches, one sample group each, and no mask "
             f"draw, counted {counts}")
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
    if pd_counts != {**dict.fromkeys(pd_counts, 0), pw.KERNEL: 1, pw.BWD_KERNEL: 1, pw.STORED_GROUPS: 1,
                     "pair_mask": 2}:
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
            plan = pw.tile_plan("bwd", B, n, n, H, L, torch.cuda.get_device_properties(0).multi_processor_count)
            bwd[B] = {"B": B, "n": n, "H": H, "L": L, "ms": ms, "ms_keep_0.75": ms_drop, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "tflops": 3 * flops / (ms * 1e-3) / 1e12, "ctas": plan.grid, "splits": plan.splits}
            log(f"time pairwise_bwd {json.dumps(bwd[B])}")
        del args
        torch.cuda.empty_cache()
    ms = cuda_ms(torch, lambda: pw.pair_mask_cuda(seed, TRAIN_B, n, n, 0.75), 50)
    plain_ms = cuda_ms(torch, lambda: pw.pair_mask_reference(seed, TRAIN_B, n, n, 0.75), 5, warmup=1)
    b_ms, b_by = mask_bound(TRAIN_B, n * n)
    mask = {"B": TRAIN_B, "n": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    log(f"time pair_mask {json.dumps(mask)}")
    return fwd, bwd, mask


def auto_ms(torch, fn, iters=None, warmup=1):
    """cuda_ms of fn; with iters None, as many calls as take ~0.3 s (2 ..
    20) after the warm-up."""
    if iters is None:
        first = cuda_ms(torch, fn, 1, warmup=warmup)
        iters, warmup = max(2, min(20, int(300.0 / max(first, 1e-3)))), 0
    return cuda_ms(torch, fn, iters, warmup=warmup)


def ms_or_oom(torch, fn, iters=None, warmup=1):
    """auto_ms of fn, or "OOM" where fn runs out of the card's memory: for
    the yardsticks only (a kernel that does not fit fails its phase)."""
    import gc

    try:
        return auto_ms(torch, fn, iters, warmup)
    except torch.cuda.OutOfMemoryError:
        pass
    gc.collect()
    torch.cuda.empty_cache()
    return "OOM"


# Rows of the backward below and above the SM count (H=256, L=4, inject 0):
# (model, B, n, esize). original-fp at the CLI's default B=64 (2 CTAs a
# sample) and at B=512 (one owner CTA, several samples each); stretch-fp-32
# (1,024 objects, 1,048,576 pair rows a sample) at B=8 and 16, as rnet
# trained it (BS 16) and scripts/bench_stretch32.py times it (16 and 8 CTAs
# a sample); bf16 (esize 2) and fp32 (esize 4).
BWD_ROWS = (("original-fp", 64, 64, 2), ("original-fp", TRAIN_B, 64, 2), ("stretch-fp-32", 8, 1024, 2),
            ("stretch-fp-32", 16, 1024, 2), ("original-fp", 64, 64, 4), ("original-fp", TRAIN_B, 64, 4),
            ("stretch-fp-32", 8, 1024, 4))
STRETCH_BWD_ROWS = tuple(r for r in BWD_ROWS if r[0] == "stretch-fp-32")


def time_bwd_rows(torch, pw, rows=BWD_ROWS):
    """Phase 8, the backward at each (model, B, n, esize) of `rows` (H=256,
    L=4, inject 0; bf16 or fp32 inputs): ms (CUDA events, ~0.3 s of calls
    after a warm-up), the plan's grid and CTAs per sample (``splits``), the
    bound, the plain version (one call after one warm-up) and cuBLAS
    autograd (``library_vjp``, the forward included), each yardstick "OOM"
    where it does not fit the card's memory (the plain version's fp32
    activations are 8.6 GB each at stretch-fp-32's B=8). Each row's
    gradients are then held to the plain version at phase 5's bounds (bf16,
    ``bwd_agreement``) or phase 5c's against the float64 chain (fp32), the
    plain backwards run PLAIN_ROWS or F64_ROWS pair rows at a time
    (``plain_in_chunks``: stretch-fp-32's B=16 in halves, its fp32 B=8 one
    sample at a time). Keyed "bfloat16 B=8 n=1024" etc."""
    H, L, inject = 256, 4, 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for model, B, n, esize in rows:
        dt = torch.float32 if esize == 4 else torch.bfloat16
        args = pair_inputs(torch, B, n, H, L, seed=800 + B + n, dtype=dt)
        g = upstream(torch, B, H, seed=801 + B + n)
        plan = pw.tile_plan("bwd", B, n, n, H, L, sms, esize=esize)
        b_ms, b_by = (f32_bwd_bound if esize == 4 else bwd_bound)(B, n, n, H, L)
        row = {"model": model, "B": B, "n": n, "H": H, "L": L, "dtype": str(dt).split(".")[-1],
               "ms": auto_ms(torch, lambda: pw.pairwise_bwd_cuda(*args, g, inject=inject)),
               "ctas": plan.grid, "splits": plan.splits, "bound_ms": b_ms, "bound_by": b_by,
               "plain_ms": ms_or_oom(torch, lambda: pw.pairwise_core_bwd_reference(*args, g, inject), 1),
               "library_ms": ms_or_oom(torch, lambda: library_vjp(torch, args, g, inject), None)}
        row["x_bound"] = row["ms"] / b_ms
        if isinstance(row["library_ms"], float):
            row["ms_over_library"] = row["ms"] / row["library_ms"]
        key = f"{row['dtype']} B={B} n={n}"
        out[key] = row
        log(f"time pairwise_bwd{'_f32' if esize == 4 else ''} {model} {json.dumps(row)}")
        if esize == 2:
            bwd_agreement(torch, pw, args, g, inject, 1.0, None, f" ({model} row)", max(1, PLAIN_ROWS // (n * n)))
        else:
            chunk = max(1, F64_ROWS // (n * n))
            got = pw.pairwise_bwd_cuda(*args, g, inject=inject)
            want = plain_in_chunks(torch, lambda a, gg: pw.pairwise_core_bwd_reference(*a, gg, inject), args, g, chunk)
            exact = plain_in_chunks(torch, lambda a, gg: vjp64(torch, pw, a, gg, inject, 1.0, None)[1], args, g, chunk)
            f32_grads_agreement(torch, (B, n, n, H, L, inject, 1.0), got, want, exact)
            del got, want, exact
        del args, g
        torch.cuda.empty_cache()
    return out


def time_f32(torch, pw, seed):
    """Phase 8, the fp32 kernels at original-fp B = 64 and 512: each kernel,
    its plain version, the cuBLAS fp32 chain (TF32 off, the yardstick) and
    its autograd, and the 3xTF32 bound; rows keyed (kind, B)."""
    n, H, L, inject = 64, 256, 4, 0
    if torch.backends.cuda.matmul.allow_tf32:
        fail("the fp32 yardstick needs TF32 off for matmuls")
    rows = {}
    for B in (64, TRAIN_B):
        args = pair_inputs(torch, B, n, H, L, seed=600 + B, dtype=torch.float32)
        g = upstream(torch, B, H, seed=601 + B)
        flops = 2.0 * B * n * n * (L - 1) * H * H
        big = B == TRAIN_B
        b_ms, b_by = f32_fwd_bound(B, n, n, H, L)
        fwd = {"B": B, "n": n, "H": H, "L": L,
               "ms": cuda_ms(torch, lambda: pw.pairwise_fwd_cuda(*args, inject=0), 5 if big else 20),
               "plain_ms": cuda_ms(torch, lambda: pw.pairwise_core_reference(*args, inject=0), 3, warmup=1),
               "library_ms": cuda_ms(torch, lambda: library_chain(torch, *args, inject), 5, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by}
        fwd["ms_keep_0.9"] = cuda_ms(
            torch, lambda: pw.pairwise_fwd_cuda(*args, inject=0, pair_keep=0.9, seed=seed), 5, warmup=1)
        b_ms, b_by = f32_bwd_bound(B, n, n, H, L)
        plan = pw.tile_plan("bwd", B, n, n, H, L, torch.cuda.get_device_properties(0).multi_processor_count, esize=4)
        bwd = {"B": B, "n": n, "H": H, "L": L, "ctas": plan.grid, "splits": plan.splits,
               "ms": cuda_ms(torch, lambda: pw.pairwise_bwd_cuda(*args, g, inject=0), 3 if big else 10, warmup=1),
               "plain_ms": cuda_ms(torch, lambda: pw.pairwise_core_bwd_reference(*args, g, 0), 2, warmup=1),
               "library_ms": cuda_ms(torch, lambda: library_vjp(torch, args, g, inject), 3, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by}
        for kind, r, mult in (("fwd", fwd, 1), ("bwd", bwd, 3)):
            r["fp32_tflops"] = mult * flops / (r["ms"] * 1e-3) / 1e12
            r["x_bound"] = r["ms"] / r["bound_ms"]
            r["ms_over_library"] = r["ms"] / r["library_ms"]
            rows[(kind, B)] = r
            log(f"time pairwise_{kind}_f32 {json.dumps(r)}")
        del args, g
        torch.cuda.empty_cache()
    return rows


def phase_breakdown(torch, pw):
    """Phase 8: one launch of each pairwise kernel's phase-timing build
    (bf16 forward and backward, int8 forward, fp32 forward and backward) at
    original-fp B = 64 and 512, and of the backward at wide-fp's H=512, B=512
    (bf16 and fp32, on clusters of two CTAs): the clock64() cycles of every
    phase, summed over the CTAs, as shares of their total (and the total);
    the timing build must compute the kernel's values."""
    n, H, L, inject = 64, 256, 4, 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    kinds = (("fwd", pw.FWD_PHASES, 2), ("bwd", pw.BWD_PHASES, 2), ("int8", pw.INT8_PHASES, 2),
             ("fwd_f32", pw.FWD_PHASES, 4), ("bwd_f32", pw.F32_BWD_PHASES, 4))
    for B in (64, TRAIN_B):
        args = pair_inputs(torch, B, n, H, L, seed=100 + B)
        args32 = [a.float() for a in args]
        g = upstream(torch, B, H, seed=200 + B)
        folded = pw.quantize_int8(*args, inject)
        for kind, names, esize in kinds:
            plan = pw.tile_plan(kind[:3] if esize == 4 else kind, B, n, n, H, L, sms, esize=esize)
            cycles = torch.zeros((plan.grid, pw.PHASE_SLOTS), dtype=torch.int64, device="cuda")
            a = args32 if esize == 4 else args
            if kind.startswith("fwd"):
                got = pw.pairwise_fwd_cuda(*a, inject=inject, phases=cycles)
                want = pw.pairwise_fwd_cuda(*a, inject=inject)
            elif kind == "int8":
                got = pw.pairwise_fwd_int8_cuda(*folded, inject=inject, phases=cycles)
                want = pw.pairwise_fwd_int8_cuda(*folded, inject=inject)
            else:
                got = pw.pairwise_bwd_cuda(*a, g, inject=inject, phases=cycles)[4]
                want = pw.pairwise_bwd_cuda(*a, g, inject=inject)[4]
            torch.cuda.synchronize()
            name = {"int8": "pairwise_fwd_int8"}.get(kind, "pairwise_" + kind)
            if not torch.equal(got, want):
                fail(f"the phase-timing build of {name} computes other values than the kernel")
            total = cycles.sum(dim=0).double()
            row = {"B": B, "total_cycles": int(total.sum().item()), "ctas": plan.grid, "splits": plan.splits,
                   "warpgroups": plan.wgs, "shares": {nm: (total[k] / total.sum()).item() for k, nm in enumerate(names)}}
            out[(kind, B)] = row
            log(f"phases {name} {json.dumps(row)}")
        del args, args32, g, folded
        torch.cuda.empty_cache()
    out.update(phase_breakdown_wide(torch, pw))
    return out


# (kind, esize, B): the bf16 and fp32 forwards and backwards at B=512, and
# the int8 forward (esize 1: int8 W) at B=512 and at the serving bucket B=8.
WIDE_PHASE_KINDS = (("fwd", 2, TRAIN_B), ("fwd_f32", 4, TRAIN_B), ("bwd", 2, TRAIN_B), ("bwd_f32", 4, TRAIN_B),
                    ("int8", 1, TRAIN_B), ("int8", 1, 8))


def wide_phase_key(kind, B):
    return (kind, "H512") if B == TRAIN_B else (kind, f"H512 B={B}")


def phase_breakdown_wide(torch, pw, kinds=WIDE_PHASE_KINDS):
    """Phase 8 at wide-fp's H=512 (n=64, L=4): one launch of the
    phase-timing build of each of `kinds` ((kind, esize, B): the bf16 and
    fp32 forwards and backwards on clusters of two CTAs, the int8 forward),
    its cycles per phase as shares of their total, with the plan; the timing
    build must compute the kernel's values. Rows keyed ``wide_phase_key``."""
    n, H, L, inject = 64, 512, 4, 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    args = pair_inputs(torch, TRAIN_B, n, H, L, seed=700)
    g = upstream(torch, TRAIN_B, H, seed=701)
    out = {}
    for kind, esize, B in kinds:
        fwd = kind.startswith("fwd") or kind == "int8"
        plan = pw.tile_plan(kind if kind == "int8" else kind[:3], B, n, n, H, L, sms,
                            esize=4 if esize == 4 else 2)
        a = [x[:B] for x in args[:4]] + list(args[4:])
        a = [x.float() for x in a] if esize == 4 else a
        cycles = torch.zeros((plan.grid, pw.PHASE_SLOTS), dtype=torch.int64, device="cuda")
        if kind == "int8":
            folded = pw.quantize_int8(*a, inject)
            got = pw.pairwise_fwd_int8_cuda(*folded, inject=inject, phases=cycles)
            want = pw.pairwise_fwd_int8_cuda(*folded, inject=inject)
        elif fwd:
            got = pw.pairwise_fwd_cuda(*a, inject=inject, phases=cycles)
            want = pw.pairwise_fwd_cuda(*a, inject=inject)
        else:
            got = pw.pairwise_bwd_cuda(*a, g[:B], inject=inject, phases=cycles)[4]
            want = pw.pairwise_bwd_cuda(*a, g[:B], inject=inject)[4]
        torch.cuda.synchronize()
        name = "pairwise_" + ("fwd_int8" if kind == "int8" else kind)
        if not torch.equal(got, want):
            fail(f"the phase-timing build of {name} at H={H} B={B} computes other values than the kernel")
        total = cycles.sum(dim=0).double()
        names = (pw.INT8_PHASES if kind == "int8" else pw.FWD_PHASES if fwd else
                 pw.F32_BWD_PHASES if esize == 4 else pw.BWD_PHASES)
        row = {"B": B, "H": H, "cluster": plan.cluster, "total_cycles": int(total.sum().item()), "ctas": plan.grid,
               "warpgroups": plan.wgs, "bm": plan.bm,
               "shares": {nm: (total[k] / total.sum()).item() for k, nm in enumerate(names)}}
        out[wide_phase_key(kind, B)] = row
        log(f"phases {name} H=512{'' if B == TRAIN_B else f' B={B}'} {json.dumps(row)}")
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


def f32_train_agreement(torch, np, pw, cfg, state, batch):
    """Phase 7b: one fp32 train step's loss and gradients through the fp32
    kernels (``--precision float32 --rl-impl pallas``) and through the fp32
    ``xla`` path, dropout off, same weights and batch. Returns (the kernel
    path's counts, loss relative difference)."""
    from rnet_torch.train import steps

    cfg32 = cfg.replace(dropout=0.0, compute_dtype="float32")
    sd = state.model.state_dict()
    out = {}
    for impl in ("pallas", "xla"):
        st = new_state(torch, cfg32.replace(rl_impl=impl), sd)
        pw.reset_launches()
        loss, _, grads = steps.loss_and_grads(st.model, batch)
        torch.cuda.synchronize()
        out[impl] = (float(loss), dict(pw.launches), {n: g.clone() for (n, _), g in zip(st.model.named_parameters(), grads)})
        del st
        torch.cuda.empty_cache()
    (lk, counts, gk), (lx, _, gx) = out["pallas"], out["xla"]
    # Tolerance: both paths are fp32 end to end (convolutions and matmuls
    # with TF32 off); the pooled g sums differ by ~1e-7 relative (another
    # order of fp32 adds), which moves the loss by about as much: 1e-5
    # relative.
    loss_rel = abs(lk - lx) / abs(lx)
    # the conv biases are left out, as in xla_agreement: their exact gradient is 0
    rel = {n: ((gk[n] - gx[n]).norm() / gx[n].norm().clamp_min(1e-30)).item() for n in gx
           if not (n.startswith("conv.conv") and n.endswith(".bias"))}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:6]
    log(f"fp32 train step, kernels vs xla (dropout 0, B={TRAIN_B}): loss {lk!r} vs {lx!r}, relative difference "
        f"{loss_rel!r} (tol 1e-5); launches {counts}; largest gradient relative differences "
        + ", ".join(f"{n} {r:.3g}" for n, r in worst))
    want = {**dict.fromkeys(pw.launches, 0), pw.F32_KERNEL: 1, pw.F32_BWD_KERNEL: 1}
    if counts != want:
        fail(f"the fp32 pallas step should launch pairwise_fwd_f32 and pairwise_bwd_f32 once each, counted {counts}")
    if not (np.isfinite(lk) and loss_rel <= 1e-5):
        fail("the fp32 kernel path's train loss disagrees with the fp32 xla path's")
    return counts, loss_rel


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
    reads idx, angle and offsets (16 B). FLOPs: a multiply and an add for
    each of the two taps with a non-zero weight per element of x1 (out+2KY
    rows x out+2KX columns), x2 (out x out+2KX) and x3 (out x out), in
    fp32."""
    kx, ky = aug._shear_radii(S, out)
    nbytes = B * ((out + 2 * ky) * (out + 4 * kx) * C + out * out * C * out_bytes + 16)
    per_ch = ((out + 2 * ky) * (out + 2 * kx) + out * (out + 2 * kx) + out * out) * 2
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
# 9b. The question embedding's backward
# ---------------------------------------------------------------------------

# (B, T, V, E): osd.train.b640's and ofp.train.b512's questions (48 tokens, a
# vocabulary of 90, embedding 32), then a shape that is no multiple of 32
EMB_CASES = ((640, 48, VOCAB, 32), (TRAIN_B, 48, VOCAB, 32), (3, 7, 11, 20))
EMB_HIDDEN = 256  # original-sd's LSTM, for the model-level check
EMB_TARGET_MS = 0.03  # the kernel's aim a call (both passes) at the train cells' shapes; logged, not enforced


def emb_tokens(torch, B, T, V, seed):
    """(B, T) int64 ids with trailing pads: at T = 48, 5 to 32 words a
    question (18.5 on average, as CLEVR's 18.4), else 1 to T."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tok = torch.randint(1, V, (B, T), generator=gen, device="cuda")
    lo, hi = (5, 32) if T == 48 else (1, T)
    n = torch.randint(lo, hi + 1, (B, 1), generator=gen, device="cuda")
    return torch.where(torch.arange(T, device="cuda")[None, :] < n, tok, 0)


def sum_bound(torch, g, tok, V):
    """Elementwise bound on any fp32 order's error of the gradient (n terms
    of a row: n * 2**-24 * sum of |terms|), and the float64 sum."""
    E = g.shape[-1]
    keep = (tok != 0)[..., None]
    rows = tok.reshape(-1)
    exact = torch.zeros((V, E), dtype=torch.float64, device="cuda").index_add_(
        0, rows, (g * keep).reshape(-1, E).double())
    mag = torch.zeros_like(exact).index_add_(0, rows, (g.abs() * keep).reshape(-1, E).double())
    n = torch.zeros((V, 1), dtype=torch.float64, device="cuda").index_add_(
        0, rows, keep.reshape(-1, 1).double())
    return exact, n * 2.0**-24 * mag


def embedding_phase(torch, em):
    """Phase 9b: the kernel against its plain version (bit for bit) and the
    parent route, ``index_put_``'s gradient of ``weight[tokens] * mask``
    (both within the fp32 bound of any summation order); an all-pad batch;
    ``QuestionEmbedModel`` on the card (one launch a backward, none without
    gradients, every other gradient bit for bit the parent route's); times
    at both train cells' shapes. Returns the record's row."""
    import torch.nn.functional as F

    from rnet_torch.models.text import QuestionEmbedModel

    out = {}
    for k, (B, T, V, E) in enumerate(EMB_CASES):
        tok = emb_tokens(torch, B, T, V, seed=900 + k)
        g = torch.randn((B, T, E), generator=torch.Generator(device="cuda").manual_seed(910 + k), device="cuda")
        em.reset_launches()
        got = em.embedding_bwd_cuda(g, tok, V)
        again = em.embedding_bwd_cuda(g, tok, V)
        want = em.embedding_bwd_reference(g, tok, V)
        w = torch.randn((V, E), device="cuda", requires_grad=True)
        (parent,) = torch.autograd.grad(w[tok] * (tok != 0)[..., None], w, g)
        exact, bound = sum_bound(torch, g, tok, V)
        err, perr = (got.double() - exact).abs(), (parent.double() - exact).abs()
        row = {"plan": em.plan(B * T, V, E), "pads": float((tok == 0).float().mean()),
               "bitwise_plain": torch.equal(got, want), "bitwise_repeat": torch.equal(got, again),
               "max_abs_gap_to_parent": float((got - parent).abs().max()),
               "max_rel_gap_to_parent": float((got - parent).abs().max() / parent.abs().max()),
               "max_err_over_bound": float((err / bound.clamp_min(1e-300)).max()),
               "parent_max_err_over_bound": float((perr / bound.clamp_min(1e-300)).max()),
               "launches": em.launches[em.KERNEL]}
        log(f"embedding_bwd (B, T, V, E) = {(B, T, V, E)}: {json.dumps(row)}")
        if not (row["bitwise_plain"] and row["bitwise_repeat"]):
            fail(f"embedding_bwd at {(B, T, V, E)}: the kernel differs from its plain version or from itself")
        if not (err <= bound).all():
            fail(f"embedding_bwd at {(B, T, V, E)}: past the fp32 bound of any summation order")
        if row["launches"] != 2:
            fail(f"embedding_bwd: two calls counted {row['launches']}")
        out[(B, T, V, E)] = row
    # all pads: a zero gradient, equal to the plain version's
    tok = torch.zeros((TRAIN_B, 48), dtype=torch.long, device="cuda")
    g = torch.randn((TRAIN_B, 48, 32), device="cuda")
    got = em.embedding_bwd_cuda(g, tok, VOCAB)
    if not (torch.equal(got, em.embedding_bwd_reference(g, tok, VOCAB)) and not got.any()):
        fail("embedding_bwd of an all-pad batch is not zero, or not the plain version's")
    log("embedding_bwd all pads at (512, 48, 90, 32): zero, bitwise the plain version's")

    # QuestionEmbedModel on the card: the kernel against the parent route
    B, T = 640, 48
    tok = emb_tokens(torch, B, T, VOCAB, seed=920)
    m = QuestionEmbedModel(VOCAB, 32, EMB_HIDDEN, generator=torch.Generator().manual_seed(5)).cuda()
    proj = torch.randn((B, EMB_HIDDEN), device="cuda")
    grads, counts = {}, {}
    takes = em.takes_kernel
    for route in ("kernel", "parent"):
        em.takes_kernel = takes if route == "kernel" else (lambda *a: False)
        try:
            em.reset_launches()
            grads[route] = torch.autograd.grad((m(tok) * proj).sum(), list(m.parameters()))
            counts[route] = em.launches[em.KERNEL]
        finally:
            em.takes_kernel = takes
    em.reset_launches()
    with torch.no_grad():
        m(tok)
    with torch.inference_mode():
        m(tok)
    counts["no_grad"] = em.launches[em.KERNEL]
    names = [n for n, _ in m.named_parameters()]
    equal = {n: torch.equal(a, b) for n, a, b in zip(names, grads["kernel"], grads["parent"])}
    e_gap = float((grads["kernel"][0] - grads["parent"][0]).abs().max() / grads["parent"][0].abs().max())
    log(f"QuestionEmbedModel B={B} (hidden {EMB_HIDDEN}): launches {counts}, gradients bitwise equal to the parent "
        f"route's {equal}, the embedding's relative gap {e_gap!r}")
    if counts != {"kernel": 1, "parent": 0, "no_grad": 0}:
        fail(f"QuestionEmbedModel should launch embedding_bwd once a backward and never without gradients: {counts}")
    if names[0] != "embedding" or not all(v for n, v in equal.items() if n != "embedding") or not e_gap < 1e-5:
        fail(f"QuestionEmbedModel: gradients off the parent route's: {equal}, embedding gap {e_gap!r}")
    out["model"] = {"launches": counts, "equal": equal, "embedding_rel_gap": e_gap}

    # times at the train cells' shapes (CUDA events): the kernel replayed
    # from a graph (both passes, no host between calls), the parent route
    # (index_put_) and F.embedding(padding_idx=0)'s backward
    for B, T, V, E in EMB_CASES[:2]:
        tok = emb_tokens(torch, B, T, V, seed=930)
        g = torch.randn((B, T, E), device="cuda")
        w = torch.randn((V, E), device="cuda", requires_grad=True)
        x_parent = w[tok] * (tok != 0)[..., None]
        x_lib = F.embedding(tok, w, padding_idx=0)
        N = B * T
        bound_ms = (N * E * 4 + N * 8 + V * E * 4) / PEAK_BYTES * 1e3
        row = {"B": B, "T": T, "V": V, "E": E,
               "ms": replay_ms(torch, lambda: em.embedding_bwd_cuda(g, tok, V)),
               "ms_eager": cuda_ms(torch, lambda: em.embedding_bwd_cuda(g, tok, V), 50),
               "plain_ms": cuda_ms(torch, lambda: torch.autograd.grad(x_parent, w, g, retain_graph=True), 20),
               "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(x_lib, w, g, retain_graph=True), 20),
               "bound_ms": bound_ms, "bound_by": "bytes"}
        row["x_bound"], row["within_target"] = row["ms"] / bound_ms, row["ms"] <= EMB_TARGET_MS
        log(f"time embedding_bwd {json.dumps(row)}")
        out[("time", B)] = row
    return out


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


def write_synthetic_questions(np, root, seed):
    """The questions and scenes of a CLEVR-schema directory: seeded
    questions over the 28 answers and every question family, and a scene of
    3-10 seeded objects for every image (scenes/CLEVR_<split>_scenes.json,
    what state-description models read). The questions fix the directory's
    dictionaries, those of tests/torch_fixtures/."""
    import os

    from rnet_torch.data.vocab import (
        CLEVR_BOOLS, CLEVR_COLORS, CLEVR_MATERIALS, CLEVR_NUMBERS, CLEVR_SHAPES, CLEVR_SIZES,
    )

    answers = {"numbers": CLEVR_NUMBERS, "bools": CLEVR_BOOLS, "colors": CLEVR_COLORS,
               "shapes": CLEVR_SHAPES, "materials": CLEVR_MATERIALS, "sizes": CLEVR_SIZES}
    rs = np.random.RandomState(seed)
    srs = np.random.RandomState(seed + 1)  # the scenes' own stream: the questions stay as they were
    os.makedirs(os.path.join(root, "questions"))
    os.makedirs(os.path.join(root, "scenes"))
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
        scenes = [{"split": split, "image_index": i, "image_filename": name,
                   "objects": [{"3d_coords": [float(c) for c in srs.uniform(-3.0, 3.0, 3)],
                                "color": CLEVR_COLORS[srs.randint(8)], "shape": CLEVR_SHAPES[srs.randint(3)],
                                "material": CLEVR_MATERIALS[srs.randint(2)], "size": CLEVR_SIZES[srs.randint(2)]}
                               for _ in range(srs.randint(3, 11))]}
                  for i, name in enumerate(files)]
        with open(os.path.join(root, "scenes", f"CLEVR_{split}_scenes.json"), "w") as f:
            json.dump({"info": {"split": split, "synthetic": True}, "scenes": scenes}, f)


def write_synthetic_clevr(np, root, seed):
    """A CLEVR-schema directory without PNGs: ``write_synthetic_questions``
    and the decoded uint8 caches (rnet_cache/<split>_128p8.u8 + .json) of
    seeded noise canvases, which CachedClevrDataset reads as they are."""
    import os

    write_synthetic_questions(np, root, seed)
    gen = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "rnet_cache"))
    for split, n_img in (("train", AUG_SMALL), ("val", SYN_VAL_IMAGES)):
        files = [f"CLEVR_{split}_{i:06d}.png" for i in range(n_img)]
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
    want = {**dict.fromkeys(counts, 0), aug.KERNEL: n_steps, pw.BWD_KERNEL: n_steps, pw.STORED_GROUPS: n_steps,
            pw.KERNEL: n_steps + 2 * eval_batches}
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
    (and logged) and the epoch's predictions recorded where the Trainer hands
    them to its ``EvalAccumulator``; int8 runs under warnings as errors, so a
    "NOT int8" fallback fails the run. Returns (output, predictions by
    question index, seconds)."""
    import contextlib
    import io
    import warnings

    import numpy as np

    from rnet_torch.eval.metrics import EvalAccumulator
    from rnet_torch.evaluate import main as eval_main

    preds = []
    real = EvalAccumulator.update

    def recording(self, pred, labels, valid, nll_sum=0.0, qidx=None):
        preds.append((np.asarray(qidx), np.asarray(pred), np.asarray(valid)))
        return real(self, pred, labels, valid, nll_sum, qidx=qidx)

    buf = io.StringIO()
    EvalAccumulator.update = recording
    try:
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            if int8:
                warnings.simplefilter("error")
            t0 = time.perf_counter()
            rc = eval_main(argv)
            sec = time.perf_counter() - t0
    finally:
        EvalAccumulator.update = real
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


def eval_entry_phase(torch, np, pw, aug, root, model="original-fp", checkpoint=None):
    """Phase 10b: ``python -m rnet_torch.evaluate`` on run (a)'s epoch 2 (or,
    for phase 12d, ``--model`` `model` on the weights pkl `checkpoint`), as
    is and with ``--rl-impl pallas_int8``, in the order bf16 int8 int8 bf16;
    returns (int8 launches, share of equal predictions, eval q/s of each
    run)."""
    import os
    import re

    n_batches = SYN_TRAIN_Q // TRAIN_B
    ck = ["--checkpoint", checkpoint] if checkpoint else ["--checkpoint", "2", "--checkpoint-dir",
                                                            os.path.join(root, "ck_a")]
    runs, qps_runs = {}, {"bf16": [], "int8": []}
    for k, tag in enumerate(("bf16", "int8", "int8", "bf16")):
        extra = ["--rl-impl", "pallas_int8"] if tag == "int8" else []
        res = os.path.join(root, f"eval_{model}_{k}_{tag}")
        argv = ["--clevr-dir", root, "--model", model, *ck, "--test-results-dir", res,
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
            fail(f"eval {model} ({tag}) printed no accuracy or q/s line")
        acc, nll, qps = float(m.group(1)), float(m.group(2)), float(q.group(1))
        want = {**dict.fromkeys(counts, 0), pw.KERNEL: 0 if tag == "int8" else n_batches,
                pw.INT8_KERNEL: n_batches if tag == "int8" else 0}
        log(f"eval entry point {model} ({tag}): {sec:.1f} s, {qps!r} q/s (eval epoch, host clock), accuracy {acc!r}, "
            f"NLL {nll!r}, {len(preds)} questions, launches {counts}")
        if counts != want:
            fail(f"eval {model} ({tag}) expected launches {want}, counted {counts}")
        if not (np.isfinite(acc) and np.isfinite(nll) and 0.0 <= acc <= 1.0) or len(preds) != SYN_TRAIN_Q:
            fail(f"eval {model} ({tag}) is not finite or did not predict every question")
        for f in ("train_accuracy.csv", "train_confusion.csv"):
            if not os.path.exists(os.path.join(res, f)):
                fail(f"eval {model} ({tag}) wrote no {f}")
        if tag == "int8" and "int8 calibration clip fractions per layer: [" not in text:
            fail("the int8 eval printed no clip-fraction line")
        runs.setdefault(tag, preds)
        qps_runs[tag].append(qps)
    same = float(np.mean([runs["int8"][i] == p for i, p in runs["bf16"].items()]))
    log(f"eval entry point {model}, int8 vs bf16 on the same checkpoint: {same!r} of predictions equal; eval q/s "
        f"in the order bf16 int8 int8 bf16: {json.dumps(qps_runs)}")
    return n_batches, same, qps_runs


WIDE_INT8_WINDOW = 8  # wide-fp eval batches in a timed window


def wide_int8_phase(torch, np, pw, aug, root):
    """Phase 12d: wide-fp (g_theta 4 x 512, f_phi 512-512-28, bf16 compute,
    seeded weights) in int8 end to end on the card, against the bf16
    cluster forward that rl_impl "auto" picks:
    (a) the eval batch at B=512 replayed (``make_chunked_steps`` on a
    2,048-canvas device cache), "auto" against "pallas_int8" in the order
    bf16 int8 int8 bf16: host ms, busy ms and idle share (one profiled
    window), the g_theta kernel's device ms, one launch of its kernel and
    nothing else a replay, the replay bitwise equal to the eager batch, and
    the share of predictions int8 and bf16 agree on;
    (b) ``python -m rnet_torch.evaluate --model wide-fp`` on phase 10's
    directory with a weights pkl (``rnet_torch.checkpoint.export_weights``),
    as is and with ``--rl-impl pallas_int8`` under warnings as errors (16
    launches of ``pairwise_fwd`` / ``pairwise_fwd_int8`` and nothing else),
    eval questions/s in the order bf16 int8 int8 bf16 (``eval_entry_phase``);
    (c) ``InferenceServer``s of wide-fp in bf16 and int8 (same weights),
    buckets 1/8/64: one launch of the kernel per served batch and nothing
    else, every bucket's replayed answers and log-probs bitwise equal to an
    eager server's, serve latency per bucket in turns (bf16 int8 int8 bf16)
    and the 700-request burst, int8 against bf16: the share of equal answers
    and the largest |log-prob difference|. Returns the numbers for the
    result line."""
    import os
    import warnings

    from rnet_torch.checkpoint import export_weights
    from rnet_torch.config import load_config
    from rnet_torch.data.vocab import build_dictionaries
    from rnet_torch.models import RN
    from rnet_torch.serve import InferenceServer
    from rnet_torch.train import steps

    dicts = build_dictionaries(root)
    cfg = load_config("wide-fp").replace(n_answers=dicts.n_answers)
    impls = {"bf16": ("auto", pw.KERNEL), "int8": ("pallas_int8", pw.INT8_KERNEL)}  # rl_impl, its kernel
    out = {}

    # (a) the eval batch at B=512, replayed
    torch.backends.cudnn.deterministic = True  # replay and eager bitwise
    cache, data = device_data(torch, cfg, AUG_SMALL, TRAIN_B, seed=15)
    idx = torch.arange(TRAIN_B, dtype=torch.int32, device="cuda").view(1, TRAIN_B)
    valid = torch.ones((1, TRAIN_B), dtype=torch.bool, device="cuda")
    arms = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a "NOT int8" fallback fails the run
        for tag, (impl, kernel) in impls.items():
            state = new_state(torch, cfg.replace(rl_impl=impl))
            resolved = state.model.relational.resolve_impl(cfg.n_objects, torch.device("cuda"))
            if resolved != ("pallas" if impl == "auto" else impl):
                fail(f"wide-fp rl_impl={impl} resolves to {resolved}, not to its kernel, on the card")
            graphs = steps.step_graphs(state)
            replay = steps.make_chunked_steps(state, graphs)[1]
            replay(idx, valid, data, cache)  # captures
            torch.cuda.synchronize()
            pw.reset_launches()
            aug.reset_launches()
            got = replay(idx, valid, data, cache)
            torch.cuda.synchronize()
            counts = {k: v for k, v in {**pw.launches, **aug.launches}.items() if v}
            eager = steps.make_chunked_steps(state, None)[1](idx, valid, data, cache)
            same = all(torch.equal(got[k], eager[k]) for k in got)
            log(f"wide-fp eval batch B={TRAIN_B} {tag} ({impl}), replayed: launches {counts}, bitwise equal to the "
                f"eager batch {same}, nll_sum {float(got['nll_sum'].sum())!r}")
            if counts != {kernel: 1} or not same or not torch.isfinite(got["nll_sum"]).all():
                fail(f"wide-fp eval batch {tag}: expected one {kernel} launch and nothing else, and a finite replay "
                     f"equal to eager; counted {counts}, equal {same}")
            arms[tag] = (state, graphs, lambda r=replay: r(idx, valid, data, cache), got["pred"])
        win = timed_windows(torch, {t: a[2] for t, a in arms.items()}, order=("bf16", "int8", "int8", "bf16"),
                            n=WIDE_INT8_WINDOW)
    row = {"predictions_equal": (arms["int8"][3] == arms["bf16"][3]).float().mean().item()}
    for tag, (_, graphs, fn, _) in arms.items():
        host = sum(win[tag]) / len(win[tag])
        prof_host = []
        busy, kern, top = profile_device(torch, fn, reps=WIDE_INT8_WINDOW, host=prof_host)
        if kern == 0:
            fail(f"wide-fp eval batch {tag}: the profiler saw no kernel in the replays")
        g_ms = sum(ms for ms, _, name in top if "pairwise_fwd" in name)
        log(f"profile wide-fp eval batch B={TRAIN_B} {tag} (replayed): host {prof_host[0]!r} ms, device busy "
            f"{busy!r} ms in {kern!r} kernels over the same {WIDE_INT8_WINDOW} replays, g_theta kernel {g_ms!r} ms")
        for ms_k, count, name in top[:6]:
            log(f"  {ms_k!r} ms x{count!r} {name[:100]}")
        row[tag] = {"host_ms": host, "host_ms_windows": win[tag], "busy_ms": busy, "kernels": kern,
                    "profiled_host_ms": prof_host[0], "idle_share": 1.0 - busy / prof_host[0], "g_theta_ms": g_ms,
                    "qps": TRAIN_B / host * 1e3, "capture": graph_memory(graphs)}
    row["int8_over_bf16_host"] = row["int8"]["host_ms"] / row["bf16"]["host_ms"]
    log(f"wide-fp eval batch B={TRAIN_B}, replayed, {WIDE_INT8_WINDOW} a window in the order bf16 int8 int8 bf16: "
        f"{json.dumps(row)}")
    out["eval_batch"] = row
    del arms, cache, data
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False

    # (b) python -m rnet_torch.evaluate --model wide-fp on a weights pkl
    pkl = os.path.join(root, "wide-fp.pkl")
    export_weights(RN(cfg, dicts.vocab_size, generator=torch.Generator().manual_seed(0)), pkl, dicts=dicts)
    launches, same, qps = eval_entry_phase(torch, np, pw, aug, root, model="wide-fp", checkpoint=pkl)
    out["evaluate"] = {"int8_launches": launches, "predictions_equal": same, "qps": qps}

    # (c) serving: bf16 and int8 servers of the same weights, replayed against eager
    rs = np.random.RandomState(16)
    vocab = list(dicts.word_to_idx)
    burst = [{"question": dicts.encode_question(" ".join(rs.choice(vocab, size=rs.randint(5, 30))),
                                                cfg.question_max_len),
              "image": rs.randint(0, 256, size=(cfg.image_size, cfg.image_size, 3), dtype=np.uint8)}
             for _ in range(100)]
    servers, served = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for tag, (impl, kernel) in impls.items():
            for mode in ("eager", "replay"):
                srv = InferenceServer(cfg.replace(rl_impl=impl), dicts, max_batch=64, device="cuda",
                                      cuda_graphs=mode == "replay")
                srv.init_weights(seed=0)
                srv.warmup()
                servers[(tag, mode)] = srv
            sr, se = servers[(tag, "replay")], servers[(tag, "eager")]
            torch.cuda.synchronize()
            pw.reset_launches()
            aug.reset_launches()
            results = sr.serve_samples(burst) + sr.serve_samples(burst[:1]) + sr.serve_samples(burst[:5])
            counts = {k: v for k, v in {**pw.launches, **aug.launches}.items() if v}
            log(f"wide-fp serve {tag}: {len(results)} answers, buckets {sorted({r['bucket'] for r in results})}, "
                f"launches {counts} for 4 served batches")
            if counts != {kernel: 4}:
                fail(f"wide-fp serve {tag}: expected one {kernel} launch per served batch and nothing else, "
                     f"counted {counts}")
            if any(r["answer"] not in dicts.answer_to_idx or not r["log_prob"] <= 0.0 for r in results):
                fail(f"wide-fp serve {tag}: a bad served result")
            for bucket in sr.buckets:
                inputs, q = sr.batch_arrays(burst[:bucket], bucket)
                (pr, lr), (pe, le) = sr._predict(inputs, q), se._predict(inputs, q)
                ok = np.array_equal(pr, pe) and np.array_equal(lr, le)
                log(f"wide-fp serve {tag} bucket {bucket}: replayed answers and log-probs bitwise equal to eager: "
                    f"{ok}")
                if not ok:
                    fail(f"wide-fp serve {tag}: the replay at bucket {bucket} differs from the eager server")
            served[tag] = results
    agree = float(np.mean([a["answer"] == b["answer"] for a, b in zip(served["int8"], served["bf16"])]))
    dlp = max(abs(a["log_prob"] - b["log_prob"]) for a, b in zip(served["int8"], served["bf16"]))
    log(f"wide-fp serve int8 vs bf16, same weights and burst: {agree!r} of answers equal, max |d log_prob| {dlp!r}")
    out["serve"] = {"answers_equal": agree, "max_abs_dlogp": dlp}
    pair = {tag: servers[(tag, "replay")] for tag in impls}
    turns = ("bf16", "int8", "int8", "bf16")
    for bucket in pair["bf16"].buckets:
        sub = burst[:bucket]
        for srv in pair.values():
            for _ in range(3):
                srv.serve_samples(sub)
        lat = {tag: [] for tag in pair}
        for tag in turns * 5:
            lat[tag].append(pair[tag].serve_samples(sub)[0]["latency_ms"])
        row = {tag: {"median_ms": sorted(v)[len(v) // 2], "min_ms": min(v), "max_ms": max(v)} for tag, v in lat.items()}
        inputs, q = pair["bf16"].batch_arrays(sub, bucket)
        for tag, srv in pair.items():
            busy, kern = busy_of(torch, f"wide-fp served {tag} bucket {bucket}, replayed",
                                 lambda s=srv: s._predict(inputs, q), row[tag]["median_ms"])
            row[tag].update(busy_ms=busy, kernels=kern, idle_share=1.0 - busy / row[tag]["median_ms"])
        log(f"wide-fp serve latency bucket {bucket}, replayed, 10 calls each in turns: {json.dumps(row)}")
        out["serve"][f"bucket_{bucket}"] = row
    big = burst * 7
    rates = {tag: [] for tag in pair}
    for tag in turns:
        t0 = time.perf_counter()
        pair[tag].serve_samples(big)
        rates[tag].append(len(big) / (time.perf_counter() - t0))
    log(f"wide-fp serve burst, {len(big)} requests in the order bf16 int8 int8 bf16 (questions/s): "
        f"{json.dumps(rates)}")
    out["serve"]["burst_qps"] = rates
    del servers, pair
    torch.cuda.empty_cache()
    return out


def f32_entry_phase(torch, np, pw, aug, root):
    """Phase 11a: ``python -m rnet_torch.train --precision float32 --rl-impl
    pallas`` at original-fp, device pipeline, one epoch of 16 steps at B=512
    on the synthetic directory; returns the launch counts."""
    import os

    steps_per_epoch = SYN_TRAIN_Q // TRAIN_B
    eval_batches = -(-SYN_VAL_Q // TRAIN_B)
    pw.reset_launches()
    aug.reset_launches()
    sec = run_cli(["--clevr-dir", root, "--model", "original-fp", "--batch-size", str(TRAIN_B), "--lr", str(LR),
                   "--log-interval", "8", "--num-workers", "4", "--data-pipeline", "device", "--epochs", "1",
                   "--precision", "float32", "--rl-impl", "pallas", "--checkpoint-dir", os.path.join(root, "ck_f32"),
                   "--test-results-dir", os.path.join(root, "res_f32")])
    torch.cuda.synchronize()
    counts = {**pw.launches, **aug.launches}
    (h,) = read_history(os.path.join(root, "res_f32"))
    log(f"entry point, fp32 through the kernels (--precision float32 --rl-impl pallas), 1 epoch of "
        f"{steps_per_epoch} steps at B={TRAIN_B}: {sec:.1f} s, launches {counts}; history {json.dumps(h)}")
    want = {**dict.fromkeys(counts, 0), pw.F32_KERNEL: steps_per_epoch + eval_batches,
            pw.F32_BWD_KERNEL: steps_per_epoch, aug.KERNEL: steps_per_epoch}
    if counts != want:
        fail(f"the fp32 train run expected launches {want}, counted {counts}")
    if not (np.isfinite(h["train_loss"]) and np.isfinite(h["val_nll"])):
        fail(f"the fp32 train run is not finite: {h}")
    return counts


STRETCH_CLI_B = 16  # rnet's BS for stretch-fp-32 (results/stretch32_train_r4)


def stretch_entry_phase(torch, np, pw, aug, root):
    """Phase 10c: ``python -m rnet_torch.train --model stretch-fp-32
    --batch-size 16`` on phase 10's synthetic directory, device pipeline,
    capped at one epoch (512 steps, 64 eval batches): every g_theta launch
    through the kernels at 1,024 objects (the backward on sample splits:
    8 CTAs a sample), finite history; returns (launch counts, seconds,
    epoch questions/s)."""
    import os

    steps_per_epoch = SYN_TRAIN_Q // STRETCH_CLI_B
    eval_batches = -(-SYN_VAL_Q // STRETCH_CLI_B)
    pw.reset_launches()
    aug.reset_launches()
    sec = run_cli(["--clevr-dir", root, "--model", "stretch-fp-32", "--batch-size", str(STRETCH_CLI_B), "--lr",
                   str(LR), "--log-interval", "16", "--num-workers", "4", "--data-pipeline", "device", "--epochs",
                   "1", "--checkpoint-dir", os.path.join(root, "ck_stretch"),
                   "--test-results-dir", os.path.join(root, "res_stretch")])
    torch.cuda.synchronize()
    counts = {**pw.launches, **aug.launches}
    (h,) = read_history(os.path.join(root, "res_stretch"))
    log(f"entry point, stretch-fp-32 (1,024 objects), 1 epoch of {steps_per_epoch} steps at B={STRETCH_CLI_B}: "
        f"{sec:.1f} s, launches {counts}; history {json.dumps(h)}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = len(pw.bwd_groups(STRETCH_CLI_B, 1024, 1024, 256, 4, sms))
    want = {**dict.fromkeys(counts, 0), pw.KERNEL: steps_per_epoch + eval_batches, pw.BWD_KERNEL: steps_per_epoch,
            pw.STORED_GROUPS: groups * steps_per_epoch, aug.KERNEL: steps_per_epoch}
    if counts != want:
        fail(f"the stretch-fp-32 train run expected launches {want}, counted {counts}")
    if not (np.isfinite(h["train_loss"]) and np.isfinite(h["val_nll"]) and 0.0 <= h["val_acc"] <= 1.0):
        fail(f"the stretch-fp-32 train run is not finite: {h}")
    return counts, sec, h.get("qps")


def extract_phase(torch, np, pw, root):
    """Phase 11b: extraction. ir-fp at full width (128^2 images, 4 x 256 g,
    n=64, injection 2) at B=512 on 144^2 canvases of the synthetic cache
    (``RN.extract`` centre-crops them), seeded weights: bf16 on the card
    against fp32 on the card, fp32 on the card against fp32 on the CPU, and
    images/s of each on the card; then ``python -m rnet_torch.extract`` end
    to end on the card for ir-sd (the synthetic scenes) and, where Pillow
    imports, for ir-fp (PNGs of the val canvases)."""
    import os
    import pickle

    from rnet_torch.checkpoint import export_weights
    from rnet_torch.config import load_config
    from rnet_torch.data.vocab import build_dictionaries
    from rnet_torch.extract import main as extract_main
    from rnet_torch.models import RN

    cache = np.load(os.path.join(root, "rnet_cache", f"train_{CROP}p8.u8"), mmap_mode="r")
    x = torch.from_numpy(np.array(cache[:TRAIN_B]))
    cfg32 = load_config("ir-fp", overrides={"compute_dtype": "float32"})
    card32 = RN(cfg32, VOCAB, generator=torch.Generator().manual_seed(0)).eval()
    cpu32 = RN(cfg32, VOCAB).eval()
    cpu32.load_state_dict(card32.state_dict())
    card16 = RN(load_config("ir-fp"), VOCAB).eval()
    card16.load_state_dict(card32.state_dict())
    card32.cuda()
    card16.cuda()
    xc = x.cuda()
    pw.reset_launches()
    f32, f16 = card32.extract(xc), card16.extract(xc)
    torch.cuda.synchronize()
    counts = dict(pw.launches)
    fcpu = cpu32.extract(x)
    H = cfg32.g_layers[cfg32.question_injection_position - 1]
    for name, f in (("bf16", f16), ("fp32", f32), ("CPU fp32", fcpu)):
        if f.shape != (TRAIN_B, H) or f.dtype != torch.float32 or not torch.isfinite(f).all():
            fail(f"ir-fp extraction ({name}) is not a finite fp32 ({TRAIN_B}, {H})")
    # Tolerances: bf16 rounds the conv stem and every prefix op to 8 bits
    # (2^-9 relative), ~4.5e-3 of the largest feature measured: bound 2e-2.
    # fp32 on the card and on the CPU: both fp32 (this script turns TF32 off
    # for cuDNN's convolutions and for matmuls), sums in other orders, ~3e-7
    # measured: bound 1e-5.
    e16 = ((f16 - f32).abs().max() / f32.abs().max()).item()
    ecpu = ((f32.cpu() - fcpu).abs().max() / fcpu.abs().max()).item()
    log(f"extract ir-fp B={TRAIN_B} (TF32 for cuDNN convolutions: {torch.backends.cudnn.allow_tf32}, for matmuls: "
        f"{torch.backends.cuda.matmul.allow_tf32}): bf16 vs fp32 on the card max|d|/max|ref| {e16!r} (tol 2e-2); "
        f"fp32 card vs CPU {ecpu!r} (tol 1e-5); max|feature| {f32.abs().max().item()!r}; pairwise launches {counts}")
    if not (e16 <= 2e-2 and ecpu <= 1e-5):
        fail("ir-fp extraction disagrees between bf16 and fp32, or between the card and the CPU")
    if any(counts.values()):
        fail(f"extraction reached a pairwise kernel (it is plain torch): {counts}")
    rates = {}
    for name, m in (("bf16", card16), ("fp32", card32)):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, lambda: m.extract(xc), 5, warmup=1)
        rates[name] = {"B": TRAIN_B, "ms": ms, "images_per_s": TRAIN_B / ms * 1e3,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"extract ir-fp at B={TRAIN_B}, CUDA events: {json.dumps(rates)}")
    extract_replay(torch, {"bf16": card16, "fp32": card32}, xc)
    del card32, card16, cpu32, xc, f32, f16, fcpu
    torch.cuda.empty_cache()

    # the CLI end to end: weights exported by the port, its dictionaries carried
    dicts = build_dictionaries(root)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    cli_models = ["ir-sd"] + (["ir-fp"] if Image is not None else [])
    log("extraction CLI: " + ("Pillow imports: ir-sd (scenes) and ir-fp (PNGs) are run"
                             if Image is not None else "Pillow does not import: ir-sd (scenes) is run, ir-fp "
                                                       "(which reads PNGs through Pillow) is not"))
    if Image is not None:
        val = np.load(os.path.join(root, "rnet_cache", f"val_{CROP}p8.u8"), mmap_mode="r")
        with open(os.path.join(root, "rnet_cache", f"val_{CROP}p8.json")) as f:
            files = json.load(f)["files"]
        os.makedirs(os.path.join(root, "images", "val"))
        for name, canvas in zip(files, val):
            Image.fromarray(np.asarray(canvas)).save(os.path.join(root, "images", "val", name))
    with open(os.path.join(root, "scenes", "CLEVR_val_scenes.json")) as f:
        scene_names = [sc["image_filename"] for sc in json.load(f)["scenes"]]
    for name in cli_models:
        cfg = load_config(name).replace(n_answers=dicts.n_answers)
        pkl = os.path.join(root, f"{name}.pkl")
        export_weights(RN(cfg, dicts.vocab_size, generator=torch.Generator().manual_seed(1)), pkl, dicts=dicts)
        out = os.path.join(root, f"features_{name}")
        batch = 100  # 256 images: the last batch is ragged (56)
        t0 = time.perf_counter()
        rc = extract_main(["--clevr-dir", root, "--model", name, "--checkpoint", pkl, "--features-dirs", out,
                           "--split", "val", "--batch-size", str(batch), "--num-workers", "4"])
        sec = time.perf_counter() - t0
        if rc != 0:
            fail(f"python -m rnet_torch.extract --model {name} exited {rc}")
        with open(os.path.join(out, f"{name}_val_gfeatures.pkl"), "rb") as f:
            res = pickle.load(f)
        want = scene_names if name == "ir-sd" else sorted(scene_names)
        feats = res["features"]
        H = cfg.g_layers[cfg.question_injection_position - 1]
        log(f"python -m rnet_torch.extract --model {name} --batch-size {batch}: {sec:.1f} s, features "
            f"{feats.shape} {feats.dtype}, {len(res['filenames'])} file names, h5 "
            f"{os.path.exists(os.path.join(out, f'{name}_val_gfeatures.h5'))}")
        if res["filenames"] != want or feats.shape != (len(want), H) or not np.isfinite(feats).all():
            fail(f"the {name} extraction CLI gave the wrong rows or file names")


def extract_replay(torch, models, x):
    """Phase 11b's graphs: ``RN.extract`` of each model on ``x`` through
    ``rnet_torch.extract.Extractor`` as the CLI runs it on the card, one CUDA
    graph per (shape, dtype) replayed, against the same function eagerly
    (no autograd): bitwise equal at the capture's replay and a later one;
    then both timed with CUDA events in the order eager replay replay eager,
    with each graph's capture seconds and pool."""
    from rnet_torch.extract import Extractor
    from rnet_torch.train.graphs import StepGraphs

    out = {}
    for name, model in models.items():
        eager, replayed = Extractor(model), Extractor(model, StepGraphs(x.device))
        want = eager(x)
        got = [replayed(x), replayed(x)]
        torch.cuda.synchronize()
        (c,) = replayed.graphs.captured.values()
        if not all(torch.equal(g, want) for g in got):
            fail(f"replayed RN.extract ({name}) is not bitwise equal to eager: max|d| "
                 f"{max((g - want).abs().max().item() for g in got)!r}")
        times = {"eager": [], "replay": []}
        for arm in ("eager", "replay", "replay", "eager"):
            fn = eager if arm == "eager" else replayed
            times[arm].append(cuda_ms(torch, lambda: fn(x), 5, warmup=1))
        out[name] = {"B": int(x.shape[0]), "bitwise_equal": True, "eager_ms": times["eager"],
                     "replay_ms": times["replay"], "capture_s": c.capture_s, "pool_mb": c.pool_bytes / 2**20}
    log(f"extract ir-fp, eager (no autograd) against one CUDA graph replayed, CUDA events in the order eager replay "
        f"replay eager: {json.dumps(out)}")
    return out


def _leaves(tree, where=()):
    """{path joined with ".": leaf} of a restored checkpoint tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, where + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, where + (str(i),)).items()}
    return {} if tree is None else {".".join(where): tree}


def rnet_fixture_phase(torch, np, pw, aug, root):
    """Phase 14: the epoch directory rnet's CheckpointManager saved
    (``tests/torch_fixtures/``: original-fp at full width after two Adam
    steps, the synthetic directory's dictionaries) read by the port's own
    reader on the host (seconds and MB), every leaf against its recorded
    sha256; ``python -m rnet_torch.evaluate`` on it (bf16, then
    ``--rl-impl pallas_int8``; 16 batches of 512, launches counted);
    ``InferenceServer.load`` of it (the kernel server against an ``xla``
    one, one launch per served batch); ``python -m rnet_torch.train
    --resume`` from it for one epoch of 16 steps (launches counted, Adam's
    step = the fixture's count + 16, finite losses)."""
    import hashlib
    import math
    import os
    import re

    from rnet_torch.checkpoint import load_run_dicts
    from rnet_torch.config import load_config
    from rnet_torch.data.vocab import Dictionaries, build_dictionaries
    from rnet_torch.ocdbt import restore
    from rnet_torch.serve import InferenceServer

    with open(os.path.join(FIXTURE_DIR, "digests.json")) as f:
        rec = json.load(f)
    epoch = os.path.join(FIXTURE_DIR, rec["epoch"])
    files = [os.path.join(r, n) for r, _, fs in os.walk(epoch) for n in fs]
    mb = sum(os.path.getsize(p) for p in files) / 1e6
    t0 = time.perf_counter()
    leaves = _leaves(restore(epoch))
    restore_s = time.perf_counter() - t0
    bad = sorted(set(leaves) ^ set(rec["leaves"]))
    bad += [k for k, v in leaves.items() if k in rec["leaves"] and (
        hashlib.sha256(v.tobytes()).hexdigest() != rec["leaves"][k]["sha256"]
        or [str(v.dtype), list(v.shape)] != [rec["leaves"][k]["dtype"], rec["leaves"][k]["shape"]])]
    log(f"phase 14: restored rnet's {rec['epoch']} ({mb!r} MB in {len(files)} files) with the port's reader in "
        f"{restore_s!r} s on the host; {len(leaves) - len(bad)} of {len(rec['leaves'])} leaves equal to their digests")
    if bad:
        fail(f"restored leaves differ from the fixture's digests: {bad[:10]}")
    w2i, a2i = load_run_dicts(FIXTURE_DIR, rec["model"])
    data = build_dictionaries(root)
    if (w2i, a2i) != (dict(data.word_to_idx), dict(data.answer_to_idx)):
        fail("the fixture's dictionaries are not the synthetic directory's")
    dicts = Dictionaries(w2i, a2i)
    out = {"restore_s": restore_s, "restore_mb": mb, "leaves": len(leaves)}

    # evaluate through the kernels: bf16, then int8
    n_batches = SYN_TRAIN_Q // TRAIN_B
    preds = {}
    for tag in ("bf16", "int8"):
        argv = ["--clevr-dir", root, "--model", rec["model"], "--checkpoint", epoch, "--test-results-dir",
                os.path.join(root, f"eval14_{tag}"), "--data-pipeline", "device", "--split", "train",
                "--batch-size", str(TRAIN_B), "--num-workers", "4"] + (["--rl-impl", "pallas_int8"] if tag == "int8" else [])
        pw.reset_launches()
        aug.reset_launches()
        text, preds[tag], sec = run_eval_cli(argv, int8=(tag == "int8"))
        torch.cuda.synchronize()
        counts = {**pw.launches, **aug.launches}
        want = {**dict.fromkeys(counts, 0), pw.KERNEL: 0 if tag == "int8" else n_batches,
                pw.INT8_KERNEL: n_batches if tag == "int8" else 0}
        m = re.search(r"overall accuracy: (\S+) \| mean NLL: (\S+)", text)
        if m is None:
            fail(f"evaluate ({tag}) on the rnet fixture printed no accuracy line")
        acc, nll = float(m.group(1)), float(m.group(2))
        log(f"phase 14 evaluate ({tag}) on rnet's epoch: {sec:.1f} s, accuracy {acc!r}, NLL {nll!r}, "
            f"{len(preds[tag])} questions, launches {counts}")
        if counts != want or not (math.isfinite(acc) and math.isfinite(nll)) or len(preds[tag]) != SYN_TRAIN_Q:
            fail(f"evaluate ({tag}) on the rnet fixture: expected launches {want} and {SYN_TRAIN_Q} finite "
                 f"predictions, got {counts}, {len(preds[tag])}")
        out[f"eval_{tag}"] = {"accuracy": acc, "nll": nll, "launches": counts}
    out["eval_int8_equal_to_bf16"] = float(np.mean([preds["int8"][i] == p for i, p in preds["bf16"].items()]))

    # serve it: the kernel server against an xla server of the same epoch
    cfg = load_config(rec["model"]).replace(n_answers=dicts.n_answers)
    servers = {}
    for impl in ("auto", "xla"):
        servers[impl] = InferenceServer(cfg.replace(rl_impl=impl), dicts, max_batch=64, device="cuda")
        servers[impl].load(epoch)
    server = servers["auto"]
    with open(os.path.join(root, "questions", "CLEVR_val_questions.json")) as f:
        qs = json.load(f)["questions"][:100]
    canvases = np.load(os.path.join(root, "rnet_cache", f"val_{CROP}p8.u8"), mmap_mode="r")
    samples = [{"image": np.array(canvases[q["image_index"]][8 : 8 + CROP, 8 : 8 + CROP]),
                "question": dicts.encode_question(q["question"], cfg.question_max_len)} for q in qs]
    server.warmup()
    torch.cuda.synchronize()
    pw.reset_launches()
    results = server.serve_samples(samples)
    counts = dict(pw.launches)
    inputs, q = server.batch_arrays(samples[:64], 64)
    lp_k, lp_x = server.log_probs(inputs, q), servers["xla"].log_probs(inputs, q)
    lp_err, lp_scale = (lp_k - lp_x).abs().max().item(), lp_x.abs().max().item()
    log(f"phase 14 serve rnet's epoch: {len(results)} answers, launches {counts} for 2 served batches; kernel vs xla "
        f"log-probs max_abs_err {lp_err!r} (max|logp| {lp_scale!r})")
    if counts[pw.KERNEL] != 2 or any(v for k, v in counts.items() if k != pw.KERNEL):
        fail(f"serving the rnet fixture: expected 2 pairwise_fwd launches and nothing else, counted {counts}")
    if any(r["answer"] not in dicts.answer_to_idx or not r["log_prob"] <= 0.0 for r in results):
        fail("serving the rnet fixture gave a bad answer")
    if not lp_err <= 2e-2 * lp_scale + 2e-2:  # phase 6's bound
        fail("served log-probs of the rnet fixture disagree between the kernel and xla paths")
    out["serve"] = {"launches": counts, "max_abs_dlogp_vs_xla": lp_err}
    del servers, server
    torch.cuda.empty_cache()

    # resume training from it: one epoch of 16 steps through the entry point
    steps_per_epoch, eval_batches = SYN_TRAIN_Q // TRAIN_B, -(-SYN_VAL_Q // TRAIN_B)
    ck, res = os.path.join(root, "ck14"), os.path.join(root, "res14")
    resumed = int(re.search(r"_epoch_(\d+)", rec["epoch"]).group(1))
    pw.reset_launches()
    aug.reset_launches()
    sec = run_cli(["--clevr-dir", root, "--model", rec["model"], "--batch-size", str(TRAIN_B), "--lr", str(LR),
                   "--log-interval", "8", "--num-workers", "4", "--data-pipeline", "device", "--epochs",
                   str(resumed + 1), "--checkpoint-dir", ck, "--test-results-dir", res, "--resume", epoch])
    torch.cuda.synchronize()
    counts = {**pw.launches, **aug.launches}
    (h,) = read_history(res)
    payload = torch.load(os.path.join(ck, f"{rec['model']}_epoch_{resumed + 1:03d}"), map_location="cpu",
                         weights_only=True)
    adam_steps = sorted({float(st["step"]) for st in payload["adam"]["state"].values()})
    log(f"phase 14 train --resume rnet's epoch {resumed}: {sec:.1f} s, launches {counts}, step {payload['step']} "
        f"(fixture {rec['steps']} + {steps_per_epoch}), Adam steps {adam_steps}; history {json.dumps(h)}")
    want = {**dict.fromkeys(counts, 0), aug.KERNEL: steps_per_epoch, pw.BWD_KERNEL: steps_per_epoch,
            pw.STORED_GROUPS: steps_per_epoch, pw.KERNEL: steps_per_epoch + eval_batches}
    if counts != want:
        fail(f"train --resume from the rnet fixture: expected launches {want}, counted {counts}")
    total = rec["steps"] + steps_per_epoch
    if payload["step"] != total or adam_steps != [float(total)] or h["epoch"] != resumed + 1:
        fail(f"train --resume from the rnet fixture: step {payload['step']}, Adam {adam_steps}, expected {total}")
    if not (math.isfinite(h["train_loss"]) and math.isfinite(h["val_nll"])):
        fail(f"train --resume from the rnet fixture: non-finite losses {h}")
    out["train_resume"] = {"launches": counts, "step": payload["step"], "train_loss": h["train_loss"]}
    log(f"phase 14 summary {json.dumps(out)}")
    return out


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


# ---------------------------------------------------------------------------
# 12. Compiled dispatch: captured CUDA graphs against eager steps
# ---------------------------------------------------------------------------

GRAPH_STEPS = 8  # K eager steps against K replays
GRAPH_WINDOW = 8  # steps or batches in a timed window


def device_data(torch, cfg, n_canvas, n_questions, seed):
    """A uint8 canvas cache (n_canvas, 144, 144, 3) and per-question device
    tensors (image_idx, question, answer), seeded, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache = torch.randint(0, 256, (n_canvas, CANVAS, CANVAS, 3), generator=gen, device="cuda", dtype=torch.uint8)
    data = {
        "image_idx": torch.randint(0, n_canvas, (n_questions,), generator=gen, device="cuda", dtype=torch.int32),
        "question": torch.randint(1, VOCAB, (n_questions, cfg.question_max_len), generator=gen, device="cuda",
                                  dtype=torch.int32),
        "answer": torch.randint(0, cfg.n_answers, (n_questions,), generator=gen, device="cuda", dtype=torch.int32),
    }
    return cache, data


def state_tensors(state):
    """Copies of every tensor a train step changes: parameters, BatchNorm
    buffers, Adam moments and step counts."""
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.adam.state[p].items():
            out[f"adam.{name}.{k}"] = v.clone()
    return out


def graph_memory(graphs):
    return {str(k[0]): {"capture_s": c.capture_s, "pool_mb": c.pool_bytes / 2**20} for k, c in graphs.captured.items()}


def replay_vs_eager(torch, pw, aug, cfg, data, cache, tag, lr_change_at=None, mesh=None):
    """GRAPH_STEPS steps of (1, B) chunks through ``make_chunked_steps``
    eagerly, then from the same saved state (parameters, BN stats, Adam,
    generator) as GRAPH_STEPS calls of the captured chunk (the first call
    captures, then replays); the LR is changed before step ``lr_change_at``
    in both. Per-step metrics, every state tensor and the launch counts
    must be bitwise equal / as expected. Returns (state, eager and graph
    chunk fns, idx block, counts, capture record, peak GB of eager and of
    the capturing run)."""
    from rnet_torch.kernels import embedding as em
    from rnet_torch.train import steps

    state = new_state(torch, cfg, mesh=mesh)
    rb = steps.StateRollback(state)
    snap = rb.snapshot()
    n_q = data["answer"].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    order = torch.randperm(n_q, generator=gen, device="cuda")[: GRAPH_STEPS * TRAIN_B]
    order = order.to(torch.int32).view(GRAPH_STEPS, 1, TRAIN_B)
    graphs = steps.step_graphs(state)
    runs, fns = {}, {}
    for mode in ("eager", "replay"):
        rb.restore(snap)
        steps.set_learning_rate(state, LR)
        fns[mode] = steps.make_chunked_steps(state, graphs if mode == "replay" else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pw.reset_launches()
        aug.reset_launches()
        em.reset_launches()
        ms = []
        for k in range(GRAPH_STEPS):
            if k == lr_change_at:
                steps.set_learning_rate(state, 3 * LR)
            ms.append(fns[mode][0](order[k], data, cache))
        torch.cuda.synchronize()
        runs[mode] = (torch.cat(ms), state_tensors(state), {**pw.launches, **aug.launches, **em.launches},
                      torch.cuda.max_memory_allocated() / 1e9)
    steps.set_learning_rate(state, LR)
    (me, te, ce, peak_e), (mr, tr, cr, peak_r) = runs["eager"], runs["replay"]
    differ = [k for k in te if not torch.equal(te[k], tr[k])]
    log(f"graphs {tag}: {GRAPH_STEPS} eager steps vs {GRAPH_STEPS} replays (LR x3 from step {lr_change_at}): "
        f"metrics bitwise equal {torch.equal(me, mr)}, {len(te) - len(differ)} of {len(te)} state tensors bitwise "
        f"equal; loss {me[:, 0].tolist()}; launches eager {ce}, replay {cr}; capture {graph_memory(graphs)}; "
        f"peak GB eager {peak_e!r}, capturing run {peak_r!r}")
    if not torch.equal(me, mr) or differ:
        fail(f"graphs {tag}: replayed steps differ from eager ones: metrics equal {torch.equal(me, mr)}, {differ[:8]}")
    if not torch.isfinite(me).all():
        fail(f"graphs {tag}: non-finite metrics {me.tolist()}")
    if ce != cr:
        fail(f"graphs {tag}: the replays counted other launches than the eager steps: {cr} vs {ce}")
    return state, fns, order, cr, graphs, (peak_e, peak_r)


def draw_probe(torch):
    """Every random draw of a train step from a generator registered with a
    graph: the augment angles and offsets, the f_phi dropout mask and the
    pair-dropout seed, each as the step draws it. Two replays must draw
    different numbers, and each the numbers an eager call from the same
    generator state draws."""
    from rnet_torch.kernels.augment import draw_augment_params
    from rnet_torch.models.relational import dropout
    from rnet_torch.train.graphs import StepGraphs

    gen = torch.Generator(device="cuda").manual_seed(17)

    def draws(_):
        angles, offs = draw_augment_params(TRAIN_B, CANVAS, CROP, gen, "cuda")
        mask = dropout(torch.ones((TRAIN_B, 256), device="cuda"), 0.5, gen) > 0
        seed = torch.randint(0, 2**62, (1,), generator=gen, device="cuda")
        return {"angles": angles, "offs": offs, "mask": mask, "seed": seed}

    g = StepGraphs("cuda", generators=(gen,))
    g.run("draws", draws, {})
    start = gen.get_state()
    replays = [g.run("draws", draws, {}) for _ in range(2)]
    gen.set_state(start)
    eager = [draws(None) for _ in range(2)]
    same_as_eager = all(torch.equal(r[k], e[k]) for r, e in zip(replays, eager) for k in r)
    fresh = {k: not torch.equal(replays[0][k], replays[1][k]) for k in replays[0]}
    log(f"graphs draws: two replays draw fresh numbers {fresh}; equal to eager draws {same_as_eager}")
    if not (same_as_eager and all(fresh.values())):
        fail("a replay does not draw fresh numbers, or draws other numbers than eager calls")


def timed_windows(torch, fns, order=("eager", "replay", "replay", "eager"), n=GRAPH_WINDOW):
    """Host-clock ms per call of each fn over windows of n calls, each
    ending in a synchronize, in `order`."""
    out = {k: [] for k in fns}
    for k in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fns[k]()
        torch.cuda.synchronize()
        out[k].append((time.perf_counter() - t0) * 1e3 / n)
    return out


def busy_of(torch, what, fn, host_ms):
    """(device busy ms per call, kernels per call) from the profiler, and the
    idle share against the host clock. Where the profiler sees no kernel
    (a graph replay it cannot trace), CUDA events over back-to-back calls
    stand in for the busy time, and the line says so."""
    busy, n_kernels, rows = profile_device(torch, fn)
    source = "profiler"
    if n_kernels == 0:
        busy, source = cuda_ms(torch, fn, 5, warmup=1), "CUDA events (the profiler saw no kernel)"
    log(f"profile {what}: host {host_ms!r} ms, device busy {busy!r} ms ({source}) in {n_kernels!r} kernels, "
        f"idle share {1.0 - busy / host_ms!r}")
    for ms_k, count, name in rows[:5]:
        log(f"  {ms_k!r} ms x{count!r} {name[:100]}")
    return busy, n_kernels


def graph_phase(torch, np, pw, aug, cfg, dicts, burst):
    """Phase 12: replayed CUDA graphs against eager execution; returns the
    numbers for the result line."""
    from rnet_torch.serve import InferenceServer
    from rnet_torch.train import steps
    from rnet_torch.train.graphs import StepGraphs

    torch.backends.cudnn.deterministic = True  # eager and replay bitwise
    out = {}
    draw_probe(torch)
    cfg_dev = cfg.replace(device_augment=True)
    cache, data = device_data(torch, cfg_dev, AUG_SMALL, 4 * GRAPH_STEPS * TRAIN_B, seed=12)

    # 1. bf16 train steps, device augment and f_phi dropout 0.5; LR changed after 4 steps
    state, fns, order, counts, graphs, peaks = replay_vs_eager(
        torch, pw, aug, cfg_dev, data, cache, "bf16 train B=512", lr_change_at=GRAPH_STEPS // 2)
    want = {**dict.fromkeys(counts, 0), pw.KERNEL: GRAPH_STEPS, pw.BWD_KERNEL: GRAPH_STEPS,
            pw.STORED_GROUPS: GRAPH_STEPS, aug.KERNEL: GRAPH_STEPS, "embedding_bwd": GRAPH_STEPS}
    if counts != want:
        fail(f"graphs: {GRAPH_STEPS} replays should count {want}, counted {counts}")
    out["train_counts"], out["train_capture"] = counts, graph_memory(graphs)
    out["train_peak_gb"] = {"eager": peaks[0], "capturing_run": peaks[1]}
    # with pair dropout: both kernels draw the Philox mask in every replay
    _, _, _, pd_counts, pd_graphs, _ = replay_vs_eager(
        torch, pw, aug, cfg_dev.replace(pair_dropout=0.25), data, cache, "bf16 train, pair_dropout 0.25")
    if pd_counts[pw.KERNEL] != GRAPH_STEPS or pd_counts["pair_mask"] != 2 * GRAPH_STEPS:
        fail(f"graphs with pair dropout: expected {GRAPH_STEPS} forward launches and {2 * GRAPH_STEPS} mask "
             f"draws, counted {pd_counts}")
    del pd_graphs
    # fp32 through the fp32 kernels
    f32_state, _, _, f32_counts, f32_graphs, _ = replay_vs_eager(
        torch, pw, aug, cfg_dev.replace(compute_dtype="float32", rl_impl="pallas"), data, cache,
        "fp32 train (pallas) B=512")
    if f32_counts[pw.F32_KERNEL] != GRAPH_STEPS or f32_counts[pw.F32_BWD_KERNEL] != GRAPH_STEPS:
        fail(f"graphs fp32: expected {GRAPH_STEPS} launches of each fp32 kernel, counted {f32_counts}")
    del f32_state, f32_graphs
    torch.cuda.empty_cache()

    # 2. the eval batch, B=512, eager against replay
    (train_e, eval_e), (train_r, eval_r) = fns["eager"], fns["replay"]
    valid = torch.ones((1, TRAIN_B), dtype=torch.bool, device="cuda")
    valid[0, -7:] = False
    pw.reset_launches()
    er = eval_r(order[0], valid, data, cache)
    torch.cuda.synchronize()
    ev_counts = dict(pw.launches)
    ee = eval_e(order[0], valid, data, cache)
    same = {k: torch.equal(ee[k], er[k]) for k in ee}
    log(f"graphs eval batch B={TRAIN_B}: replay vs eager bitwise {same}; replay launches {ev_counts}")
    if not all(same.values()) or ev_counts[pw.KERNEL] != 1:
        fail(f"graphs: the replayed eval batch differs from the eager one ({same}) or counted {ev_counts}")

    # 3. serving buckets 1/8/64, bf16 and int8: log-probs and served answers
    servers = {}
    for impl, tag in (("auto", "bf16"), ("pallas_int8", "int8")):
        for mode in ("eager", "replay"):
            srv = InferenceServer(cfg.replace(rl_impl=impl), dicts, max_batch=64, device="cuda",
                                  cuda_graphs=mode == "replay")
            srv.init_weights(seed=0)
            srv.warmup()
            servers[(tag, mode)] = srv
    for tag in ("bf16", "int8"):
        se, sr = servers[(tag, "eager")], servers[(tag, "replay")]
        lp_graphs = StepGraphs("cuda")
        for bucket in sr.buckets:
            inputs, q = sr.batch_arrays(burst[:bucket], bucket)
            b = {"inputs": torch.from_numpy(inputs), "question": torch.from_numpy(q)}
            with torch.no_grad():
                lp_r = lp_graphs.run(bucket, lambda x: sr.model(x["inputs"], x["question"]), b)
            lp_e = se.log_probs(inputs, q)
            (pe, ve), (pr, vr) = se._predict(inputs, q), sr._predict(inputs, q)
            ok = torch.equal(lp_e, lp_r) and np.array_equal(pe, pr) and np.array_equal(ve, vr)
            log(f"graphs serve {tag} bucket {bucket}: replayed log-probs and served answers bitwise equal to "
                f"eager: {ok}")
            if not ok:
                fail(f"graphs: the {tag} server's replay at bucket {bucket} differs from eager")
        pw.reset_launches()
        sr.serve_samples(burst)
        sr.serve_samples(burst[:1])
        sr.serve_samples(burst[:5])
        kernel = pw.KERNEL if tag == "bf16" else pw.INT8_KERNEL
        if pw.launches[kernel] != 4:
            fail(f"graphs: 4 served {tag} batches counted {dict(pw.launches)}")
        out[f"serve_{tag}_capture"] = graph_memory(sr.graphs)

    # 5. times, eager against replayed (eager replay replay eager)
    k0 = order[0]
    train_fns = {"eager": lambda: train_e(k0, data, cache), "replay": lambda: train_r(k0, data, cache)}
    eval_fns = {"eager": lambda: eval_e(k0, valid, data, cache), "replay": lambda: eval_r(k0, valid, data, cache)}
    for what, fns_, n in (("train step", train_fns, TRAIN_B), ("eval batch", eval_fns, TRAIN_B)):
        win = timed_windows(torch, fns_)
        row = {}
        for mode in ("eager", "replay"):
            host = sum(win[mode]) / len(win[mode])
            busy, kern = busy_of(torch, f"{what} B={TRAIN_B}, {mode}", fns_[mode], host)
            row[mode] = {"host_ms": host, "host_ms_windows": win[mode], "busy_ms": busy, "kernels": kern,
                         "idle_share": 1.0 - busy / host, "qps": n / host * 1e3}
        log(f"graphs times {what} B={TRAIN_B} (host clock, {GRAPH_WINDOW} a window, order eager replay replay "
            f"eager): {json.dumps(row)}; replay / eager host {row['replay']['host_ms'] / row['eager']['host_ms']!r}")
        out[what.replace(" ", "_")] = row
    for tag in ("bf16", "int8"):
        se, sr = servers[(tag, "eager")], servers[(tag, "replay")]
        pair = {"eager": se, "replay": sr}
        for bucket in se.buckets:
            sub = burst[:bucket]
            lat = {m: [] for m in pair}
            for m in ("eager", "replay", "replay", "eager") * 5:
                lat[m].append(pair[m].serve_samples(sub)[0]["latency_ms"])
            row = {m: {"median_ms": sorted(v)[len(v) // 2], "min_ms": min(v), "max_ms": max(v)} for m, v in lat.items()}
            inputs, q = se.batch_arrays(sub, bucket)
            for m, srv in pair.items():
                busy, kern = busy_of(torch, f"served {tag} bucket {bucket}, {m}", lambda: srv._predict(inputs, q),
                                     row[m]["median_ms"])
                row[m].update(busy_ms=busy, kernels=kern, idle_share=1.0 - busy / row[m]["median_ms"])
            log(f"graphs serve latency {tag} bucket {bucket}, 10 calls each in turns: {json.dumps(row)}")
            out[f"serve_{tag}_{bucket}"] = row
        big = burst * 7
        rates = {m: [] for m in pair}
        for m in ("eager", "replay", "replay", "eager"):
            t0 = time.perf_counter()
            pair[m].serve_samples(big)
            rates[m].append(len(big) / (time.perf_counter() - t0))
        log(f"graphs serve burst {tag}, {len(big)} requests (questions/s): {json.dumps(rates)}")
        out[f"serve_{tag}_burst_qps"] = rates
    del servers, state, fns, graphs, cache, data
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


WIDE_WINDOW = 4  # wide-fp train steps in a timed window


# Phase 12b's cells: (model, compute dtype, the kernel arm's rl_impl).
STEP_CELLS = (("wide-fp", "bfloat16", "auto"), ("wide-fp", "float32", "pallas"), ("original-fp", "float32", "pallas"))


def wide_fp_steps(torch, pw, aug, n_answers):
    """Phase 12b: replayed train steps at B=512 on device-resident data (a
    2,048-canvas cache, device augment, as phase 12 builds it), through the
    kernels against "xla", in each of STEP_CELLS: wide-fp (g_theta 4 x 512,
    n = 64) in bf16 through rl_impl "auto" (the kernels) and in fp32 through
    "pallas", and original-fp in fp32 through "pallas" (what "auto" would
    pick in fp32 if it followed rnet); each pair in the order kernel xla xla
    kernel: host ms, device busy ms, idle share, questions/s and every
    kernel's launches per replayed step. The busy time and the idle share
    come from one profiled window of WIDE_WINDOW replays, host clock and
    profiler on the same replays. Both arms start from the same weights and
    draw the same augmentation and dropout, so the first replayed step's
    loss of the kernel arm must match the xla arm's: within 1e-2 relative in
    bf16 (phase 7's bound) and 1e-5 in fp32 (phase 7b's). Rows keyed by
    dtype for wide-fp, "original-fp float32" for the last."""
    from rnet_torch.config import load_config
    from rnet_torch.train import steps

    torch.backends.cudnn.deterministic = True
    idx = torch.arange(TRAIN_B, dtype=torch.int32, device="cuda").view(1, TRAIN_B)
    out = {}
    for model, dtype, kernel_impl in STEP_CELLS:
        cfg = load_config(model).replace(n_answers=n_answers, device_augment=True)
        cache, data = device_data(torch, cfg, AUG_SMALL, 2 * TRAIN_B, seed=13)
        key = dtype if model == "wide-fp" else f"{model} {dtype}"
        arms = {}
        for impl in (kernel_impl, "xla"):
            state = new_state(torch, cfg.replace(rl_impl=impl, compute_dtype=dtype))
            graphs = steps.step_graphs(state)
            train = steps.make_chunked_steps(state, graphs)[0]
            first = train(idx, data, cache)  # captures, then replays the first step
            torch.cuda.synchronize()
            loss0 = float(first[0, 0])
            pw.reset_launches()
            aug.reset_launches()
            metrics = train(idx, data, cache)
            torch.cuda.synchronize()
            if not torch.isfinite(metrics).all():
                fail(f"{model} {dtype} {impl}: non-finite step metrics {metrics.tolist()}")
            counts = {k: v for k, v in {**pw.launches, **aug.launches}.items() if v}
            arms[impl] = (state, graphs, lambda t=train: t(idx, data, cache), counts, loss0)
        resolved = arms[kernel_impl][0].model.relational.resolve_impl(64, torch.device("cuda"))
        bwd = pw.BWD_KERNEL if dtype == "bfloat16" else pw.F32_BWD_KERNEL
        if resolved != "pallas" or arms[kernel_impl][3].get(bwd) != 1 or bwd in arms["xla"][3]:
            fail(f"{key}: {kernel_impl} should run the kernels ({resolved}, launches "
                 f"{arms[kernel_impl][3]}) and xla none ({arms['xla'][3]})")
        lk, lx = arms[kernel_impl][4], arms["xla"][4]
        loss_rel, loss_tol = abs(lk - lx) / abs(lx), (1e-2 if dtype == "bfloat16" else 1e-5)
        log(f"{model} {dtype} first replayed step: loss {kernel_impl} {lk!r} vs xla {lx!r}, relative difference "
            f"{loss_rel!r} (tol {loss_tol!r})")
        if not loss_rel <= loss_tol:
            fail(f"{model} {dtype}: the kernel path's train loss disagrees with the xla path's")
        win = timed_windows(torch, {k: a[2] for k, a in arms.items()}, order=(kernel_impl, "xla", "xla", kernel_impl),
                            n=WIDE_WINDOW)
        row = {"first_step_loss": {kernel_impl: lk, "xla": lx}, "first_step_loss_rel_diff": loss_rel}
        for impl, (_, graphs, fn, counts, _) in arms.items():
            host = sum(win[impl]) / len(win[impl])
            prof_host = []
            busy, kern, top = profile_device(torch, fn, reps=WIDE_WINDOW, host=prof_host)
            if kern == 0:
                fail(f"{model} {dtype} {impl}: the profiler saw no kernel in the replayed steps")
            idle = 1.0 - busy / prof_host[0]
            log(f"profile {model} train step B={TRAIN_B} {dtype} {impl} (replayed): host {prof_host[0]!r} ms, device "
                f"busy {busy!r} ms in {kern!r} kernels over the same {WIDE_WINDOW} replays, idle share {idle!r}")
            for ms_k, count, name in top[:5]:
                log(f"  {ms_k!r} ms x{count!r} {name[:100]}")
            row[impl] = {"host_ms": host, "host_ms_windows": win[impl], "busy_ms": busy, "kernels": kern,
                         "profiled_host_ms": prof_host[0], "idle_share": idle, "qps": TRAIN_B / host * 1e3,
                         "launches_per_step": counts, "capture": graph_memory(graphs)}
        row["kernel_over_xla_host"] = row[kernel_impl]["host_ms"] / row["xla"]["host_ms"]
        log(f"{model} train step B={TRAIN_B} {dtype}, replayed, {WIDE_WINDOW} a window in the order {kernel_impl} "
            f"xla xla {kernel_impl}: {json.dumps(row)}")
        out[key] = row
        del arms, cache, data
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


STRETCH_BATCHES = (8, 16)  # rnet trained stretch-fp-32 at BS 16; scripts/bench_stretch32.py times 8 and 16
STRETCH_WINDOW = 4  # stretch-fp-32 train steps in a timed window


def stretch_steps(torch, pw, aug, n_answers, batches=STRETCH_BATCHES):
    """Phase 12c: stretch-fp-32 (2 convs, a 32 x 32 grid: 1,024 objects and
    1,048,576 pairs a question; g_theta 4 x 256, mean pool) replayed train
    steps in bf16 at each B of `batches` on device-resident data (a
    2,048-canvas cache, device augment, as phase 12b), through rl_impl
    "auto" (the kernels: n >= 32) against "xla", in the order auto xla xla
    auto: host ms, device busy ms and idle share from one profiled window,
    questions/s and every kernel's launches per replayed step, counted over
    one replay with the counters zeroed just before it (auto: one
    pairwise_fwd, pairwise_bwd and augment; xla: no g_theta kernel). The
    first replayed step's loss of auto against xla's within 1e-2 relative
    (phase 7's bound). Where xla's step does not fit the card's memory its
    row is "OOM" (the capture's eager warm-up raises OutOfMemoryError
    before anything is captured). Rows keyed by B."""
    import gc

    from rnet_torch.config import load_config
    from rnet_torch.train import steps

    torch.backends.cudnn.deterministic = True
    cfg = load_config("stretch-fp-32").replace(n_answers=n_answers, device_augment=True)
    cache, data = device_data(torch, cfg, AUG_SMALL, 2 * max(batches), seed=17)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for B in batches:
        idx = torch.arange(B, dtype=torch.int32, device="cuda").view(1, B)
        arms, row = {}, {}
        for impl in ("auto", "xla"):
            state = new_state(torch, cfg.replace(rl_impl=impl))
            graphs = steps.step_graphs(state)
            train = steps.make_chunked_steps(state, graphs)[0]
            try:
                first = train(idx, data, cache)  # captures, then replays the first step
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError:  # freed with the exception; the card is emptied below
                row[impl] = "OOM"
                log(f"stretch-fp-32 train step B={B} {impl}: OOM (the eager warm-up does not fit the card's memory)")
                continue
            loss0 = float(first[0, 0])
            pw.reset_launches()
            aug.reset_launches()
            metrics = train(idx, data, cache)
            torch.cuda.synchronize()
            if not torch.isfinite(metrics).all():
                fail(f"stretch-fp-32 B={B} {impl}: non-finite step metrics {metrics.tolist()}")
            counts = {k: v for k, v in {**pw.launches, **aug.launches}.items() if v}
            arms[impl] = (graphs, lambda t=train: t(idx, data, cache), counts, loss0)
        groups = len(pw.bwd_groups(B, 1024, 1024, 256, 4, sms))
        want = {pw.KERNEL: 1, pw.BWD_KERNEL: 1, pw.STORED_GROUPS: groups, aug.KERNEL: 1}
        if groups < 2:
            fail(f"stretch-fp-32 B={B}: the backward's stored tiles should run in several sample groups, not {groups}")
        if "auto" not in arms or arms["auto"][2] != want:
            fail(f"stretch-fp-32 B={B}: auto should launch {want} a step, counted "
                 f"{arms['auto'][2] if 'auto' in arms else row.get('auto')}")
        if "xla" in arms and (pw.KERNEL in arms["xla"][2] or pw.BWD_KERNEL in arms["xla"][2]):
            fail(f"stretch-fp-32 B={B}: xla launched a g_theta kernel: {arms['xla'][2]}")
        if "xla" in arms:
            lk, lx = arms["auto"][3], arms["xla"][3]
            row["first_step_loss"] = {"auto": lk, "xla": lx}
            row["first_step_loss_rel_diff"] = abs(lk - lx) / abs(lx)
            log(f"stretch-fp-32 B={B} first replayed step: loss auto {lk!r} vs xla {lx!r}")
            if not row["first_step_loss_rel_diff"] <= 1e-2:
                fail(f"stretch-fp-32 B={B}: the kernel path's train loss disagrees with the xla path's")
        order = ("auto", "xla", "xla", "auto") if "xla" in arms else ("auto", "auto")
        win = timed_windows(torch, {k: a[1] for k, a in arms.items()}, order=order, n=STRETCH_WINDOW)
        for impl, (graphs, fn, counts, _) in arms.items():
            host = sum(win[impl]) / len(win[impl])
            prof_host = []
            busy, kern, top = profile_device(torch, fn, reps=STRETCH_WINDOW, host=prof_host)
            idle = 1.0 - busy / prof_host[0]
            log(f"profile stretch-fp-32 train step B={B} {impl} (replayed): host {prof_host[0]!r} ms, device busy "
                f"{busy!r} ms in {kern!r} kernels, idle share {idle!r}")
            for ms_k, count, name in top[:4]:
                log(f"  {ms_k!r} ms x{count!r} {name[:100]}")
            row[impl] = {"host_ms": host, "host_ms_windows": win[impl], "busy_ms": busy, "idle_share": idle,
                         "qps": B / host * 1e3, "launches_per_step": counts, "capture": graph_memory(graphs)}
        if "xla" in arms:
            row["auto_over_xla_host"] = row["auto"]["host_ms"] / row["xla"]["host_ms"]
        log(f"stretch-fp-32 train step B={B} bf16, replayed, {STRETCH_WINDOW} a window in the order "
            f"{' '.join(order)}: {json.dumps(row)}")
        out[B] = row
        del arms
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    del cache, data
    torch.cuda.empty_cache()
    return out


def trainer_epochs(torch, root):
    """Phase 12, last part: Trainer epochs of run (a)'s setup (device
    pipeline with augmentation, B=512, 16 steps, then eval) with
    cuda_graphs=False and True in the order F T T F, two epochs each (the
    first with graphs captures them), cuDNN deterministic: the train loss,
    val NLL and every parameter bitwise equal after each epoch; seconds and
    questions/s of each epoch, and the graphs' capture times and pools."""
    from rnet_torch.cli import build_datasets, config_from_args, load_dicts
    from rnet_torch.train.__main__ import parse_args
    from rnet_torch.train.loop import Trainer
    from rnet_torch.train.schedules import DoublingSchedule

    torch.backends.cudnn.deterministic = True
    args = parse_args(["--clevr-dir", root, "--model", "original-fp", "--data-pipeline", "device",
                       "--batch-size", str(TRAIN_B)])
    dicts = load_dicts(args)
    cfg = config_from_args(args, dicts)
    ds = build_datasets(args, cfg, dicts)
    runs = {False: [], True: []}
    first = {}
    for k, graphs in enumerate((False, True, True, False)):
        tr = Trainer(cfg, dicts.vocab_size, ds["train"], ds["val"], dicts, lr=DoublingSchedule(LR),
                     bs=DoublingSchedule(TRAIN_B), checkpoint_dir=f"{root}/ck_graphs{k}", device_data=True,
                     log_interval=8, log_fn=lambda *a: None, cuda_graphs=graphs)
        epochs = []
        for epoch in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = tr.train_epoch(epoch)
            ev = tr.eval_epoch(epoch)
            torch.cuda.synchronize()
            epochs.append({"sec": time.perf_counter() - t0, "train_qps": st["qps"], "val_qps": ev["val_qps"],
                           "loss": st["train_loss"], "val_nll": ev["val_nll"],
                           "params": {n: v.detach().clone() for n, v in tr.state.model.state_dict().items()}})
        if graphs and k == 1:
            runs["capture"] = graph_memory(tr.graphs)
        first.setdefault(graphs, epochs)
        runs[graphs].append([{k_: v for k_, v in e.items() if k_ != "params"} for e in epochs])
        del tr
        torch.cuda.empty_cache()
    differ = []
    for e, (a, b) in enumerate(zip(first[False], first[True]), 1):
        differ += [f"epoch {e} {n}" for n in a["params"] if not torch.equal(a["params"][n], b["params"][n])]
        differ += [f"epoch {e} {m}" for m in ("loss", "val_nll") if a[m] != b[m]]
    log(f"graphs Trainer epochs 1, 2 (device pipeline, augmentation, B={TRAIN_B}, 16 steps + eval each), order "
        f"F T T F: {json.dumps({str(k): v for k, v in runs.items()})}; with graphs vs without: "
        f"{'bitwise equal' if not differ else differ[:8]} (loss, val_nll and {len(first[False][0]['params'])} "
        f"tensors after each epoch)")
    if differ:
        fail(f"graphs: the Trainer epochs with graphs differ from the eager ones: {differ[:8]}")
    torch.backends.cudnn.deterministic = False
    return runs


def wide_bwd_agreement(torch, pw, args, g, inject, got, dt):
    """The H=512 backward's gradients `got` at wide-fp B=512 held to phase 5's
    (bf16: against the plain version) or phase 5c's (fp32: against the
    float64 chain, with the plain fp32 version's own distance beside it)
    tolerances. The float64 chain runs 32 samples at a time (dW and db
    summed over the chunks). Returns the largest max |kernel - plain|."""
    want = pw.pairwise_core_bwd_reference(*args, g, inject)
    exact = None
    if dt == "fp32":
        chunks = [vjp64(torch, pw, [a[i:i + 32] for a in args[:4]] + list(args[4:]), g[i:i + 32], inject, 1.0, 0)[1]
                  for i in range(0, g.shape[0], 32)]
        exact = [torch.cat(p) for p in list(zip(*chunks))[:4]] + [sum(p) for p in list(zip(*chunks))[4:]]
        del chunks
    worst, parts = 0.0, []
    for k, (name, d, w) in enumerate(zip(GRAD_NAMES, got, want)):
        if d.shape != w.shape or not torch.isfinite(d).all():
            fail(f"pairwise_bwd {dt} {name} at wide-fp is not a finite {tuple(w.shape)}")
        err, scale = (d - w).abs().max().item(), w.abs().max().item()
        worst = max(worst, err)
        if dt == "bf16":
            rel = ((d - w).norm() / w.norm().clamp_min(1e-30)).item()
            parts.append(f"{name} {err:.4g}/{scale:.4g} rel {rel:.3g}")
            ok = err <= 3e-2 * scale + 1e-2 and rel <= 1e-2
        else:
            z = exact[k]
            rk, rp = (((x.double() - z).norm() / z.norm().clamp_min(1e-300)).item() for x in (d, w))
            parts.append(f"{name} {err / max(scale, 1e-30):.3g} (from float64: kernel {rk:.3g}, plain {rp:.3g})")
            ok = rk <= 1e-4 + 2 * rp
        if not ok:
            fail(f"pairwise_bwd {dt} {name} disagrees with its plain version at wide-fp: {parts[-1]}")
    log(f"pairwise_bwd {dt} vs plain at wide-fp B={g.shape[0]}: " + " | ".join(parts))
    del want, exact
    torch.cuda.empty_cache()
    return worst


WIDE_BUCKETS = (1, 8)  # wide-fp's serving buckets at which each H=512 forward is timed alone


def time_wide(torch, pw, seed):
    """Phase 8, wide-fp's H=512 at B=512 (n=64, L=4): the bf16 forward and
    backward, int8 and the fp32 forward and backward, each beside its plain
    version, its PyTorch yardstick and its bound, with its plan (the
    forwards and backwards on clusters of two CTAs); each forward and
    backward twice, bitwise, and held to its plain version, (bf16) the
    device ms of the kernels of one backward launch (profiler), and each
    forward at the serving buckets B=1 and 8 replayed from a graph."""
    B, n, H, L, inject = TRAIN_B, 64, 512, 4, 0
    rows = {}
    args = pair_inputs(torch, B, n, H, L, seed=700)
    g = upstream(torch, B, H, seed=701)
    for dt, args_ in (("bf16", args), ("fp32", [a.float() for a in args])):
        fb, bb = (fwd_bound, bwd_bound) if dt == "bf16" else (f32_fwd_bound, f32_bwd_bound)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plans = {k: pw.tile_plan(k, B, n, n, H, L, sms, esize=2 if dt == "bf16" else 4) for k in ("fwd", "bwd")}
        rows[f"fwd_{dt}"] = {
            "ms": cuda_ms(torch, lambda: pw.pairwise_fwd_cuda(*args_, inject=inject), 5, warmup=1),
            "plain_ms": cuda_ms(torch, lambda: pw.pairwise_core_reference(*args_, inject=inject), 2, warmup=1),
            "library_ms": cuda_ms(torch, lambda: library_chain(torch, *args_, inject), 3, warmup=1),
            "plan": {"wgs": plans["fwd"].wgs, "bm": plans["fwd"].bm, "cluster": plans["fwd"].cluster,
                     "stages": plans["fwd"].stages},
        }
        rows[f"fwd_{dt}"].update(zip(("bound_ms", "bound_by"), fb(B, n, n, H, L)))
        buckets = rows[f"fwd_{dt}"]["buckets"] = {}
        for b in WIDE_BUCKETS:  # replayed from a graph as the server replays them
            sub = [a[:b] for a in args_[:4]] + list(args_[4:])
            plan = pw.tile_plan("fwd", b, n, n, H, L, sms, esize=2 if dt == "bf16" else 4)
            buckets[b] = {"replay_ms": replay_ms(torch, lambda: pw.pairwise_fwd_cuda(*sub, inject=inject)),
                          "bm": plan.bm, "grid": plan.grid, "cluster": plan.cluster}
            buckets[b].update(zip(("bound_ms", "bound_by"), fb(b, n, n, H, L)))
            del sub
        rows[f"bwd_{dt}"] = {
            "ms": cuda_ms(torch, lambda: pw.pairwise_bwd_cuda(*args_, g, inject=inject), 3, warmup=1),
            "plain_ms": cuda_ms(torch, lambda: pw.pairwise_core_bwd_reference(*args_, g, inject), 2, warmup=1),
            "library_ms": cuda_ms(torch, lambda: library_vjp(torch, args_, g, inject), 2, warmup=1),
            "plan": {"wgs": plans["bwd"].wgs, "bm": plans["bwd"].bm, "cluster": plans["bwd"].cluster},
        }
        rows[f"bwd_{dt}"].update(zip(("bound_ms", "bound_by"), bb(B, n, n, H, L)))
        if dt == "bf16":  # device ms of each kernel of one launch: the fused kernel and dw_gemm_kernel
            _, _, top = profile_device(torch, lambda: pw.pairwise_bwd_cuda(*args_, g, inject=inject), reps=2)
            kernels_ms = {}
            for ms, _, name in top:
                short = name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
                kernels_ms[short] = kernels_ms.get(short, 0.0) + ms
            rows[f"bwd_{dt}"]["kernels_ms"] = kernels_ms
        first, again = (pw.pairwise_bwd_cuda(*args_, g, inject=inject) for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"pairwise_bwd {dt} at wide-fp B={B} is not bitwise repeatable")
        log(f"pairwise_bwd {dt} at wide-fp B={B} (plan cluster {plans['bwd'].cluster}): the same launch twice gives "
            "bitwise-equal gradients")
        del again
        rows[f"bwd_{dt}"]["err_vs_plain"] = wide_bwd_agreement(torch, pw, args_, g, inject, first, dt)
        first, again = (pw.pairwise_fwd_cuda(*args_, inject=inject) for _ in range(2))
        if not torch.equal(first, again) or not torch.isfinite(first).all():
            fail(f"pairwise_fwd {dt} at wide-fp B={B} is not finite and bitwise repeatable")
        log(f"pairwise_fwd {dt} at wide-fp B={B} (plan cluster {plans['fwd'].cluster}): the same launch twice gives "
            "bitwise-equal outputs")
        # Held to the plain version at phase 3's (bf16) and phase 5c's (fp32) tolerances.
        ref = pw.pairwise_core_reference(*args_, inject=inject)
        err, scale = (first - ref).abs().max().item(), ref.abs().max().item()
        tol = 2e-3 * scale + 1e-2 if dt == "bf16" else 1e-4 * scale
        log(f"pairwise_fwd {dt} vs plain at wide-fp B={B}: max_abs_err {err!r} (max|ref| {scale!r}, tol {tol!r})")
        if not err <= tol:
            fail(f"pairwise_fwd {dt} disagrees with its plain version at wide-fp B={B}")
        rows[f"fwd_{dt}"]["err_vs_plain"] = err
        del args_, first, again, ref
        torch.cuda.empty_cache()
    rows["int8"] = time_int8_wide(torch, pw, args, inject)
    for name, r in rows.items():
        r.update(B=B, n=n, H=H, L=L, x_bound=r["ms"] / r["bound_ms"], ms_over_library=r["ms"] / r["library_ms"])
        log(f"time H=512 {name} {json.dumps(r)}")
    for dt in ("bf16", "fp32"):
        r = rows[f"bwd_{dt}"]
        log(f"pairwise_bwd {dt} at wide-fp B={B}, same call: kernel {r['ms']!r} ms, autograd through cuBLAS "
            f"{r['library_ms']!r} ms: ms_over_library {r['ms_over_library']!r}")
        r = rows[f"fwd_{dt}"]
        log(f"pairwise_fwd {dt} at wide-fp B={B}, same call: kernel {r['ms']!r} ms, the cuBLAS chain "
            f"{r['library_ms']!r} ms: ms_over_library {r['ms_over_library']!r}, x_bound {r['x_bound']!r}")
    del args, g
    torch.cuda.empty_cache()
    return rows


def plan_fields(plan):
    return {"wgs": plan.wgs, "bm": plan.bm, "cluster": plan.cluster, "stages": plan.stages, "grid": plan.grid,
            "smem": plan.smem}


def time_int8_wide(torch, pw, args, inject=0):
    """Phase 8, the int8 forward at wide-fp's H=512 on the folded form of the
    core inputs `args` at B=512 (n=64, L=4): CUDA events beside its plain
    version, the ``torch._int_mm`` chain and the bound, with its plan, and
    the whole core (calibration + folding + kernel: ``ms_with_calibration``);
    and at the serving buckets B=1 and 8 (the first rows of the same folded
    inputs) replayed from a graph, as a server replays them, and by CUDA
    events, beside the plain version and the ``torch._int_mm`` chain."""
    folded = pw.quantize_int8(*args, inject)
    B, n, H, L = folded[0].shape[0], folded[0].shape[1], folded[0].shape[2], folded[4].shape[0] + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = {
        "ms": cuda_ms(torch, lambda: pw.pairwise_fwd_int8_cuda(*folded, inject=inject), 10, warmup=2),
        "plain_ms": cuda_ms(torch, lambda: pw.pairwise_core_int8_reference(*folded, inject=inject), 2, warmup=1),
        "library_ms": cuda_ms(torch, lambda: library_chain_int8(torch, *folded, inject), 3, warmup=1),
        "ms_with_calibration": cuda_ms(torch, lambda: pw.pairwise_core_int8(*args, inject=inject), 10, warmup=2),
        "plan": plan_fields(pw.tile_plan("int8", B, n, n, H, L, sms)),
    }
    row.update(zip(("bound_ms", "bound_by"), int8_bound(B, n, n, H, L)))
    buckets = row["buckets"] = {}
    for b in WIDE_BUCKETS:
        sub = [a[:b] for a in folded[:4]] + list(folded[4:])
        buckets[b] = {"replay_ms": replay_ms(torch, lambda: pw.pairwise_fwd_int8_cuda(*sub, inject=inject)),
                      "ms": cuda_ms(torch, lambda: pw.pairwise_fwd_int8_cuda(*sub, inject=inject), 50),
                      "plain_ms": cuda_ms(torch, lambda: pw.pairwise_core_int8_reference(*sub, inject=inject), 3),
                      "library_ms": cuda_ms(torch, lambda: library_chain_int8(torch, *sub, inject), 3),
                      "plan": plan_fields(pw.tile_plan("int8", b, n, n, H, L, sms))}
        buckets[b].update(zip(("bound_ms", "bound_by"), int8_bound(b, n, n, H, L)))
        del sub
    return row


# ---------------------------------------------------------------------------
# 13. Several processes: the data x pairs mesh (rnet_torch/parallel/mesh.py)
# ---------------------------------------------------------------------------

SHARD_STEPS = 4  # train steps under each mesh
SHARD_CANVAS = 2_048  # canvases of the phase's device cache
SHARD_PAIR_DROPOUT = 0.25
SHARD_TIMEOUT = 420  # seconds for one launch of the phase's processes
# Bound on |grad_norm - one process's| / one process's at every step: the
# sound meshes read up to ~1e-4 or 1e-3 (bf16 kernels over other batch
# splits, 4 Adam steps), a gradient off by the data group's size (summed,
# not averaged) reads ~1. Adam ignores a gradient's scale, so the losses
# alone cannot see such a fault.
SHARD_GRAD_NORM_REL = 1e-2
WORKER_FLAG = "--phase13-worker"
# Per-shard shapes of the g_theta kernels at original-fp B=512 (n=64):
# (B, ni, nj) under pairs:2, under data:2, and one process.
SHARD_SHAPES = {"pairs:2": (TRAIN_B, 32, 64), "data:2": (TRAIN_B // 2, 64, 64), "one process": (TRAIN_B, 64, 64)}


def shard_cfg(cfg):
    """Phase 13's model: original-fp at full width in bf16 through the
    kernels, dropout, pair dropout and augmentation off."""
    return cfg.replace(dropout=0.0, pair_dropout=0.0, device_augment=False)


def shard_data(torch, cfg):
    """The device cache, per-question data and (SHARD_STEPS, B) global index
    block, made from seeds on the card: the same in every process."""
    cache, data = device_data(torch, cfg, SHARD_CANVAS, SHARD_STEPS * TRAIN_B, seed=13)
    gen = torch.Generator(device="cuda").manual_seed(14)
    order = torch.randperm(SHARD_STEPS * TRAIN_B, generator=gen, device="cuda").to(torch.int32)
    return cache, data, order.view(SHARD_STEPS, TRAIN_B)


def state_digest(state):
    """sha256 of every parameter and BatchNorm buffer's bytes."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(state.model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


class LaunchRecorder:
    """Wraps the g_theta kernels' wrappers and ``pairwise_core_sharded`` in
    ``rnet_torch.kernels.pairwise`` (the module the core calls them
    through) to record each launch's (B, ni, nj) and pair-dropout seed, the
    base seed each sharded call was given and the inputs of the last
    forward with pair dropout. The wrappers' own counters count as before."""

    NAMES = ("pairwise_fwd_cuda", "pairwise_bwd_cuda", "pairwise_fwd_int8_cuda", "pairwise_core_sharded")

    def __init__(self, pw):
        self.pw = pw
        self.orig = {n: getattr(pw, n) for n in self.NAMES}
        self.launches = {"fwd": [], "bwd": [], "int8": []}
        self.base_seeds = []
        self.last_fwd = None

        def seed_of(kw):
            return None if kw.get("seed") is None else int(kw["seed"].item())

        def wrap(kind, name):
            def call(u, v, *a, **kw):
                self.launches[kind].append((u.shape[0], u.shape[1], v.shape[1], seed_of(kw)))
                if kind == "fwd" and kw.get("pair_keep", 1.0) < 1.0:
                    self.last_fwd = ((u, v, *a), kw)
                return self.orig[name](u, v, *a, **kw)
            return call

        def sharded(*a, **kw):
            self.base_seeds.append(seed_of(kw))
            return self.orig["pairwise_core_sharded"](*a, **kw)

        pw.pairwise_fwd_cuda = wrap("fwd", "pairwise_fwd_cuda")
        pw.pairwise_bwd_cuda = wrap("bwd", "pairwise_bwd_cuda")
        pw.pairwise_fwd_int8_cuda = wrap("int8", "pairwise_fwd_int8_cuda")
        pw.pairwise_core_sharded = sharded

    def close(self):
        for n, f in self.orig.items():
            setattr(self.pw, n, f)


def shard_train(torch, pw, cfg, mesh, graphs=False):
    """SHARD_STEPS train steps on this process's share of the phase's data
    (its ``data`` columns of each index row; all of it without a mesh),
    eagerly or replayed from a captured chunk of one step; the counters
    zeroed just before and read just after. Returns the per-step losses,
    the launches, each launch's (B, ni, nj, seed), the sharded calls' base
    seeds, the last dropout forward and a digest of the state."""
    from rnet_torch.parallel import mesh as pmesh
    from rnet_torch.train import steps

    cache, data, order = shard_data(torch, cfg)
    idx = pmesh.shard_batch(order, mesh, dim=1)
    state = new_state(torch, cfg, mesh=mesh)
    chunk = steps.make_chunked_steps(state, steps.step_graphs(state) if graphs else None)[0]
    rec = LaunchRecorder(pw)
    try:
        torch.cuda.synchronize()
        pw.reset_launches()
        ms = torch.cat([chunk(idx[k : k + 1], data, cache) for k in range(SHARD_STEPS)])
        torch.cuda.synchronize()
        counts = dict(pw.launches)
    finally:
        rec.close()
    return {"loss": ms[:, 0].tolist(), "grad_norm": ms[:, 2].tolist(), "counts": counts, "launches": rec.launches,
            "base_seeds": rec.base_seeds, "digest": state_digest(state), "last_fwd": rec.last_fwd,
            "shard_id": 0 if mesh is None else mesh.shard_id}


def shard_masks(torch, pw, run, keep):
    """The pair-dropout run's seeds and masks: every launch drew at its
    step's base seed + shard_id * 1_000_003, the mask kernel's bits at that
    seed equal ``pair_mask_reference``'s, and the last forward launch on
    its recorded inputs agrees with the plain version at that seed (phase
    3's bound: a mask differing in one pair exceeds it)."""
    from rnet_torch.parallel.mesh import SHARD_SEED_STRIDE

    off = run["shard_id"] * SHARD_SEED_STRIDE
    want = [b + off for b in run["base_seeds"]]
    got = {k: [ln[3] for ln in run["launches"][k]] for k in ("fwd", "bwd")}
    (args, kw) = run["last_fwd"]
    B, ni, nj = args[0].shape[0], args[0].shape[1], args[1].shape[1]
    seed = torch.tensor([want[-1]], dtype=torch.int64, device="cuda")
    mask_equal = torch.equal(pw.pair_mask_cuda(seed, B, ni, nj, keep), pw.pair_mask_reference(seed, B, ni, nj, keep))
    out = pw.pairwise_fwd_cuda(*args, inject=kw["inject"], pair_keep=keep, seed=seed)
    ref = pw.pairwise_core_reference(*args, inject=kw["inject"], keep=keep, seed=seed)
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    return {"seeds_offset": got["fwd"] == want and got["bwd"] == want, "mask_bitwise": mask_equal,
            "fwd_err": err, "fwd_tol": 2e-3 * scale + 1e-2, "seeds": want, "shape": [B, ni, nj]}


def shard_eval(torch, pw, cfg, mesh, int8=False):
    """One eval batch (the first B of the index block) on this process's
    share, its predictions gathered over ``data``, with the launches
    counted; int8 under warnings as errors (a "NOT int8" fallback fails)."""
    import warnings

    from rnet_torch.parallel import mesh as pmesh
    from rnet_torch.train import steps

    cache, data, order = shard_data(torch, cfg)
    idx = pmesh.shard_batch(order[0], mesh)
    state = new_state(torch, cfg.replace(rl_impl="pallas_int8") if int8 else cfg, mesh=mesh)
    rec = LaunchRecorder(pw)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            torch.cuda.synchronize()
            pw.reset_launches()
            out = steps.eval_step(state, {k: v[idx] for k, v in data.items()}, cache)
            torch.cuda.synchronize()
            counts = dict(pw.launches)
    finally:
        rec.close()
    pred = pmesh.fetch_global(out["pred"], mesh)
    nll = pmesh.fetch_global(out["nll_sum"].reshape(1), mesh).sum()
    return {"pred": pred.tolist(), "nll_sum": float(nll), "counts": counts, "launches": rec.launches}


def phase13_worker(argv) -> int:
    """``python chip_smoke.py --phase13-worker JOB.json [RANK]``: one
    process of phase 13. JOB names the tasks and, for gloo, the file of the
    process group (RANK given); under torchrun NCCL is joined from its
    environment. Writes <out>/<rank>.json."""
    import os

    import torch

    from rnet_torch.config import load_config
    from rnet_torch.kernels import augment as aug
    from rnet_torch.kernels import pairwise as pw
    from rnet_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(argv[0]) as f:
        job = json.load(f)
    rank = int(argv[1]) if len(argv) > 1 else int(os.environ["RANK"])
    cfg = shard_cfg(load_config("original-fp").replace(n_answers=job["n_answers"]))
    if job.get("init"):  # phase 13(a): two processes on one card, gloo
        pmesh.distributed_init("cuda", init_method=job["init"], world_size=job["world"], rank=rank, backend="gloo")
    out = {}
    for task in job["tasks"]:
        pmesh.distributed_init("cuda")  # under torchrun: its NCCL group (a no-op once joined)
        if task == "entry":  # 13(b): the entry point in the group joined
            pw.reset_launches()
            aug.reset_launches()
            run_cli(job["entry_argv"])
            torch.cuda.synchronize()
            out[task] = {**pw.launches, **aug.launches}
        elif task == "replay":  # 13(b): eager steps vs replays, the all-reduce in the graph
            import torch.distributed as dist

            captured = []
            all_reduce = dist.all_reduce

            def counting(t, *a, **kw):
                captured.append(torch.cuda.is_current_stream_capturing())
                return all_reduce(t, *a, **kw)

            dist.all_reduce = counting
            cache, data = device_data(torch, cfg, SHARD_CANVAS, GRAPH_STEPS * TRAIN_B, seed=15)
            mesh = pmesh.make_mesh(job["spec"], "cuda")
            captured.clear()
            counts = replay_vs_eager(torch, pw, aug, cfg, data, cache, f"nccl {job['spec']}", mesh=mesh)[3]
            dist.all_reduce = all_reduce
            out[task] = {"counts": counts, "all_reduce_calls": len(captured), "captured_all_reduces": sum(captured)}
        elif task == "steps":
            out[task] = {}
            for spec in job["specs"]:
                run = shard_train(torch, pw, cfg, pmesh.make_mesh(spec, "cuda"), graphs=job.get("graphs", False))
                run.pop("last_fwd")
                out[task][spec] = run
        elif task == "control":  # data:2 with the gradients summed over data, not averaged
            from rnet_torch.train import steps

            average = steps.average_over_data

            def summed(grads, metrics, mesh):
                out = average(grads, metrics, mesh)
                for g in grads:
                    g.mul_(mesh.size("data"))
                return out

            steps.average_over_data = summed
            try:
                out[task] = shard_train(torch, pw, cfg, pmesh.make_mesh("data:2", "cuda"))["grad_norm"]
            finally:
                steps.average_over_data = average
        elif task == "dropout":
            mesh = pmesh.make_mesh("pairs:2", "cuda")
            run = shard_train(torch, pw, cfg.replace(pair_dropout=SHARD_PAIR_DROPOUT), mesh)
            out[task] = {**shard_masks(torch, pw, run, 1.0 - SHARD_PAIR_DROPOUT),
                         **{k: run[k] for k in ("counts", "loss", "shard_id", "digest")}}
        elif task == "eval":
            out[task] = {"data:2": shard_eval(torch, pw, cfg, pmesh.make_mesh("data:2", "cuda")),
                         "pairs:2 int8": shard_eval(torch, pw, cfg, pmesh.make_mesh("pairs:2", "cuda"), int8=True)}
    with open(os.path.join(job["out"], f"{rank}.json"), "w") as f:
        json.dump(out, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


def launch_workers(job, path, cmd_prefix, ranks):
    """Start phase 13's worker processes (``cmd_prefix`` + the script, per
    rank or once under torchrun), wait for all under SHARD_TIMEOUT, fail the
    phase if one fails; returns each rank's results."""
    import os

    with open(path, "w") as f:
        json.dump(job, f)
    cmds = ([[*cmd_prefix, sys.executable, __file__, WORKER_FLAG, path, str(r)] for r in range(ranks)]
            if not cmd_prefix else [[sys.executable, *cmd_prefix, __file__, WORKER_FLAG, path]])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    try:
        logs = [p.communicate(timeout=SHARD_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        fail(f"phase 13: {job['tag']} did not finish within {SHARD_TIMEOUT} s")
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        for line in text.splitlines()[-40:]:
            log(f"  [{job['tag']}] {line}")
        if p.returncode != 0:
            fail(f"phase 13: a process of {job['tag']} exited {p.returncode}")
    results = []
    for r in range(ranks):
        with open(os.path.join(job["out"], f"{r}.json")) as f:
            results.append(json.load(f))
    return results


def shard_kernel_times(torch, pw, seed):
    """The bf16 g_theta kernels at the shapes phase 13 launches (pairs:2,
    data:2) beside the one-process shape, in one process: each forward and
    backward held to its plain version at phase 3 and 5's bounds, with and
    without pair dropout (phase 13 draws masks at (B, 32, 64)), then timed
    with CUDA events beside the plain versions and the cuBLAS chain and its
    autograd. The int8 kernel's shard shape is an ``INT8_CASES`` case of
    phase 5b."""
    n, H, L, inject = 64, 256, 4, 0
    rows = {}
    for tag, (B, ni, nj) in SHARD_SHAPES.items():
        args = pair_inputs(torch, B, nj, H, L, seed=300 + ni)
        args[0] = args[0][:, :ni].contiguous()
        g = upstream(torch, B, H, seed=301)
        errs = {"fwd": 0.0, "bwd": 0.0}
        for keep in KEEPS:
            errs["fwd"] = max(errs["fwd"], fwd_agreement(torch, pw, args, inject, keep, seed, f" ({tag} shard)"))
            errs["bwd"] = max(errs["bwd"], bwd_agreement(torch, pw, args, g, inject, keep, seed, f" ({tag} shard)")[1])
        torch.cuda.empty_cache()
        f_ms, f_by = fwd_bound(B, ni, nj, H, L)
        b_ms, b_by = bwd_bound(B, ni, nj, H, L)
        rows[tag] = {"B": B, "ni": ni, "nj": nj, "H": H, "L": L,
                     "fwd_max_abs_err": errs["fwd"], "bwd_max_abs_err": errs["bwd"],
                     "fwd_ms": cuda_ms(torch, lambda: pw.pairwise_fwd_cuda(*args, inject=inject), 10),
                     "fwd_bound_ms": f_ms, "fwd_bound_by": f_by,
                     "fwd_plain_ms": cuda_ms(torch, lambda: pw.pairwise_core_reference(*args, inject=inject), 2,
                                             warmup=1),
                     "fwd_library_ms": cuda_ms(torch, lambda: library_chain(torch, *args, inject), 10),
                     "bwd_ms": cuda_ms(torch, lambda: pw.pairwise_bwd_cuda(*args, g, inject=inject), 5, warmup=2),
                     "bwd_bound_ms": b_ms, "bwd_bound_by": b_by,
                     "bwd_plain_ms": cuda_ms(torch, lambda: pw.pairwise_core_bwd_reference(*args, g, inject), 2,
                                             warmup=1),
                     "bwd_library_ms": cuda_ms(torch, lambda: library_vjp(torch, args, g, inject), 3, warmup=1)}
        log(f"time per shard {tag} {json.dumps(rows[tag])}")
        del args, g
    torch.cuda.empty_cache()
    return rows


def check_shards(np, pw, ranks, one, ev_one, tag):
    """Phase 13's checks of two ranks' results (``phase13_worker``'s
    steps, dropout and eval tasks) against one process's; the summary."""
    def norm_rel(norms):
        return [abs(a - b) / abs(b) for a, b in zip(norms, one["grad_norm"])]

    summary = {}
    for spec in ("data:2", "pairs:2"):
        runs = [r["steps"][spec] for r in ranks]
        shape = list(SHARD_SHAPES[spec])
        rel = [abs(a - b) / abs(b) for a, b in zip(runs[0]["loss"], one["loss"])]
        nrel = [norm_rel(r["grad_norm"]) for r in runs]
        log(f"phase {tag} {spec}: losses per rank {[r['loss'] for r in runs]} vs one process {one['loss']} "
            f"(rel {rel}); grad_norm per rank {[r['grad_norm'] for r in runs]} vs one process {one['grad_norm']} "
            f"(rel per rank {nrel}, bound {SHARD_GRAD_NORM_REL}); launches per rank {[r['counts'] for r in runs]}; "
            f"(B, ni, nj) of pairwise_fwd {sorted({tuple(x[:3]) for r in runs for x in r['launches']['fwd']})}, "
            f"pairwise_bwd {sorted({tuple(x[:3]) for r in runs for x in r['launches']['bwd']})}; state digests "
            f"{[r['digest'][:16] for r in runs]}")
        if not all(x <= 1e-2 for x in rel):  # phase 7's bound between the kernel and xla paths' losses
            fail(f"phase {tag} {spec}: the losses disagree with one process's: rel {rel}")
        if not all(x <= SHARD_GRAD_NORM_REL for r in nrel for x in r):
            fail(f"phase {tag} {spec}: a rank's grad_norm disagrees with one process's: rel {nrel}")
        if runs[0]["loss"] != runs[1]["loss"] or runs[0]["digest"] != runs[1]["digest"]:
            fail(f"phase {tag} {spec}: the ranks' losses or parameters differ")
        for r in runs:
            want = {**dict.fromkeys(r["counts"], 0), pw.KERNEL: SHARD_STEPS, pw.BWD_KERNEL: SHARD_STEPS,
                    pw.STORED_GROUPS: SHARD_STEPS}
            shapes = {tuple(x[:3]) for k in ("fwd", "bwd") for x in r["launches"][k]}
            if r["counts"] != want or shapes != {tuple(shape)}:
                fail(f"phase {tag} {spec}: expected one pairwise_fwd and pairwise_bwd a step at {shape}, "
                     f"counted {r['counts']} at {shapes}")
        summary[spec] = {"launches_per_rank": [r["counts"] for r in runs], "shape": shape, "loss_rel": rel,
                         "grad_norm_rel": max(x for r in nrel for x in r)}
    control = [norm_rel(r["control"]) for r in ranks]
    log(f"phase {tag} control, data:2 with the gradients summed over data (a factor 2): grad_norm per rank "
        f"{[r['control'] for r in ranks]}, rel per rank {control} (bound {SHARD_GRAD_NORM_REL})")
    if not all(x > SHARD_GRAD_NORM_REL for r in control for x in r):
        fail(f"phase {tag}: the grad_norm check does not see gradients off by a factor 2: rel {control}")
    summary["control_grad_norm_rel"] = min(x for r in control for x in r)
    drop = [r["dropout"] for r in ranks]
    log(f"phase {tag} pairs:2 with pair_dropout {SHARD_PAIR_DROPOUT}: {json.dumps(drop)}")
    for d in drop:
        if not (d["seeds_offset"] and d["mask_bitwise"] and d["fwd_err"] <= d["fwd_tol"]):
            fail(f"phase {tag}: a shard's pair-dropout mask is not pair_mask_reference(seed + shard_id * 1_000_003): {d}")
        if d["counts"]["pair_mask"] != 2 * SHARD_STEPS:
            fail(f"phase {tag}: pair dropout drew {d['counts']['pair_mask']} masks, not {2 * SHARD_STEPS}")
    if drop[0]["digest"] != drop[1]["digest"] or drop[0]["seeds"] == drop[1]["seeds"]:
        fail(f"phase {tag}: with pair dropout the replicas differ, or the shards drew the same masks")
    summary["pair_dropout"] = {"mask_launches_per_rank": [d["counts"]["pair_mask"] for d in drop],
                               "fwd_err": [d["fwd_err"] for d in drop]}
    ev_two, ev_int8 = ([r["eval"][k] for r in ranks] for k in ("data:2", "pairs:2 int8"))
    same = float(np.mean(np.array(ev_two[0]["pred"]) == np.array(ev_one["bf16"]["pred"])))
    same8 = float(np.mean(np.array(ev_int8[0]["pred"]) == np.array(ev_one["int8"]["pred"])))
    nll_rel = abs(ev_two[0]["nll_sum"] - ev_one["bf16"]["nll_sum"]) / abs(ev_one["bf16"]["nll_sum"])
    log(f"phase {tag} eval batch B={TRAIN_B}: data:2 predictions equal to one process's {same!r}, NLL sum "
        f"{ev_two[0]['nll_sum']!r} vs {ev_one['bf16']['nll_sum']!r} (rel {nll_rel!r}), launches "
        f"{[e['counts'] for e in ev_two]}; pallas_int8 under pairs:2: launches {[e['counts'] for e in ev_int8]} at "
        f"{[e['launches']['int8'] for e in ev_int8]}, predictions equal to one process's int8 {same8!r}, NLL sum "
        f"{ev_int8[0]['nll_sum']!r} vs {ev_one['int8']['nll_sum']!r}")
    if any(e["pred"] != ev_two[0]["pred"] for e in ev_two) or any(e["pred"] != ev_int8[0]["pred"] for e in ev_int8):
        fail(f"phase {tag}: the ranks' gathered predictions differ")
    if not (same >= 0.99 and nll_rel <= 1e-2):
        fail(f"phase {tag}: the data:2 eval batch disagrees with one process's")
    # each pairs shard calibrates on its own rows, so the pooled values move
    # within the int8 drift bound (3e-2) and no prediction of the batch flips
    nll8_rel = abs(ev_int8[0]["nll_sum"] - ev_one["int8"]["nll_sum"]) / abs(ev_one["int8"]["nll_sum"])
    if not (same8 == 1.0 and nll8_rel <= 3e-2):
        fail(f"phase {tag}: pallas_int8 under pairs:2 disagrees with one process's int8: predictions equal "
             f"{same8}, NLL sum rel {nll8_rel}")
    for e in ev_int8:
        if e["counts"][pw.INT8_KERNEL] != 1 or e["counts"][pw.KERNEL] or e["launches"]["int8"][0][1] != 32:
            fail(f"phase {tag}: pallas_int8 under pairs:2 should launch the int8 kernel once at ni=32: {e}")
    summary["eval"] = {"data:2_equal_predictions": same, "int8_pairs:2_launches_per_rank": [e["counts"][pw.INT8_KERNEL]
                       for e in ev_int8], "int8_pairs:2_equal_to_one_process": same8, "int8_nll_rel": nll8_rel}
    return summary


def shard_phase(torch, np, pw, cfg, root):
    """Phase 13; returns its summary for the kernel records."""
    import os

    card_count = torch.cuda.device_count()
    scfg = shard_cfg(cfg)
    times = shard_kernel_times(torch, pw, torch.tensor([13], dtype=torch.int64, device="cuda"))

    # the one-process references: SHARD_STEPS steps at B=512, the eval batch in bf16 and int8
    one = shard_train(torch, pw, scfg, None)
    one.pop("last_fwd")
    ev_one = {"bf16": shard_eval(torch, pw, scfg, None), "int8": shard_eval(torch, pw, scfg, None, int8=True)}
    log(f"phase 13 one process, B={TRAIN_B}: loss {one['loss']}, launches {one['counts']}")
    torch.cuda.empty_cache()

    # (a) two processes on the one card over gloo, file-based init
    work = os.path.join(root, "phase13a")
    os.makedirs(work)
    job = {"tag": "13(a) gloo", "init": f"file://{work}/pg", "world": 2, "out": work,
           "n_answers": cfg.n_answers, "tasks": ["steps", "control", "dropout", "eval"], "specs": ["data:2", "pairs:2"]}
    t0 = time.perf_counter()
    ranks = launch_workers(job, os.path.join(work, "job.json"), [], 2)
    log(f"phase 13(a): two processes over gloo in {time.perf_counter() - t0:.1f} s")
    summary = {"seconds_a": time.perf_counter() - t0, "per_shard": times,
               **check_shards(np, pw, ranks, one, ev_one, "13(a)")}

    # (b) a one-rank NCCL group: the entry point and replayed steps with the all-reduce captured
    work = os.path.join(root, "phase13b")
    os.makedirs(work)
    entry = ["--clevr-dir", root, "--model", "original-fp", "--batch-size", str(TRAIN_B), "--lr", str(LR),
             "--log-interval", "8", "--num-workers", "4", "--data-pipeline", "device", "--epochs", "1",
             "--mesh", "data:1", "--multihost", "--checkpoint-dir", os.path.join(work, "ck"),
             "--test-results-dir", os.path.join(work, "res")]
    job = {"tag": "13(b) nccl", "out": work, "n_answers": cfg.n_answers, "tasks": ["replay", "entry"],
           "spec": "data:1", "entry_argv": entry}
    t0 = time.perf_counter()
    (res,) = launch_workers(job, os.path.join(work, "job.json"),
                            ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1"], 1)
    hist = read_history(os.path.join(work, "res"))
    n_steps, n_eval = SYN_TRAIN_Q // TRAIN_B, -(-SYN_VAL_Q // TRAIN_B)
    log(f"phase 13(b) in {time.perf_counter() - t0:.1f} s: python -m torch.distributed.run --nproc-per-node 1 "
        f"-m rnet_torch.train --mesh data:1 --multihost (NCCL, CUDA graphs): launches {res['entry']}, history "
        f"{json.dumps(hist)}; eager vs replayed steps: {json.dumps(res['replay'])}")
    want = {pw.KERNEL: n_steps + n_eval, pw.BWD_KERNEL: n_steps, "augment": n_steps}
    if any(res["entry"][k] != v for k, v in want.items()) or not np.isfinite(hist[0]["train_loss"]):
        fail(f"phase 13(b): the entry point under a one-rank NCCL mesh: launches {res['entry']}, want {want}")
    if not res["replay"]["captured_all_reduces"]:
        fail("phase 13(b): no all-reduce of the train step was captured in its graph")
    summary["nccl_one_rank"] = {"entry_launches": res["entry"], "replay": res["replay"]}

    # (c) NCCL across cards, where the machine has them
    if card_count < 2:
        log(f"phase 13(c) not run: torch.cuda.device_count() is {card_count}, the machine has one device; "
            "NCCL across two or more cards stays unproven")
        summary["nccl_two_cards"] = f"not run: device_count {card_count}"
        return summary
    work = os.path.join(root, "phase13c")
    os.makedirs(work)
    job = {"tag": "13(c) nccl", "out": work, "n_answers": cfg.n_answers,
           "tasks": ["steps", "control", "dropout", "eval"],
           "specs": ["data:2", "pairs:2"], "graphs": True}
    ranks = launch_workers(job, os.path.join(work, "job.json"),
                           ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"], 2)
    summary["nccl_two_cards"] = check_shards(np, pw, ranks, one, ev_one, f"13(c) on {card_count} cards")
    return summary


# Phase 15: rnet's trained wide-fp weights on the val split it was scored on,
# and the bounds fixed before the first run on the card.
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
TRAINED_PKL = os.path.join(REPO_DIR, "results", "int8_eval_r4", "wide-fp_epoch091_weights_dicts.pkl")
RNET_VAL_CSV = os.path.join(REPO_DIR, "results", "widefp_r3", "int8_eval", "{}", "val_accuracy.csv")
TRAINED_ACC_PP = 0.3  # overall accuracy within 0.3 percentage points of rnet's
TRAINED_NLL = 0.005  # mean NLL within 0.005 of rnet's
TRAINED_FAMILY_PP = 1.0  # each category_* row within 1.0 pp of rnet's
TRAINED_FP32_CPU = 0.977819  # the port's fp32 xla accuracy on the CPU (python -m rnet_torch.evaluate --platform cpu)
TRAINED_FP32_CPU_PP = 0.1
TRAINED_AGREE = 0.99  # bf16 and int8 predictions equal on at least this share
TRAINED_SERVED = (1, 8, 55)  # the first 64 val questions as three served batches (buckets 1, 8, 64)
# (tag, extra flags, the one kernel launched, rnet's results directory, its rl_impl)
TRAINED_ARMS = (("bf16", [], "pairwise_fwd", "auto", "auto"),
                ("int8", ["--rl-impl", "pallas_int8"], "pairwise_fwd_int8", "pallas_int8", "pallas_int8"),
                ("fp32", ["--precision", "float32"], "pairwise_fwd_f32", "auto", "auto"))
WIDE_BATCHES = (1024, 2048)  # ROADMAP §3 item 4: wide-fp bf16 at doubled batch sizes
WIDE_BATCH_FLAG = "--wide-batch-worker"
WIDE_BATCH_TIMEOUT = 300


# Phase 17: rnet's round-3 campaign fixture regenerated by the port, rnet's epoch-119 original-fp on it
CAMPAIGN_FIXTURE = os.path.join(FIXTURE_DIR, "clevr_v2_seed1_70k")
CAMPAIGN_PKL = os.path.join(REPO_DIR, "results", "campaign_r3", "original-fp_epoch119_weights.pkl")
CAMPAIGN_CSV = os.path.join(REPO_DIR, "results", "campaign_r3", "final_epoch119", "val_accuracy.csv")
CAMPAIGN_SYNTH = (70_000, 15_000, "v2", 1)  # n_train, n_val, style, seed
VAL_FIXTURE_SYNTH = (4_000, 600, "v2", 1)  # phase 15's committed val split came from this fixture
SYNTH_BYTE_SHARE = 1e-3  # (a): at most this share of the cache's bytes may differ from rnet's PNGs' ...
SYNTH_LEVELS = 8  # ... and none by more than this many levels (a Pillow difference)
CAMPAIGN_ACC_PP = 0.02  # bf16 and fp32 overall accuracy within 0.02 pp of rnet's 0.999818
CAMPAIGN_NLL = 5e-4  # mean NLL within 0.0005 of rnet's 0.000719
CAMPAIGN_FAMILY_PP = 0.05  # each category_* row within 0.05 pp of rnet's
# int8: the bounds fixed before the first run (int8 >= 0.9995, predictions equal to bf16's on >= 0.999) failed on
# the card (0.997048, agreement 0.99717, NLL 0.012017, count 1.10 pp down); these were set after it, from rnet's
# own int8 on the CPU on eval batches 0 and 45 (CAMPAIGN_INT8, tests/torch_fixture_v2_70k_writer.py: on batch 45
# 489 of 512 right, NLL 0.151, where its bf16 has 512) and from the card's reading
CAMPAIGN_INT8 = os.path.join(CAMPAIGN_FIXTURE, "int8_batches.json")
CAMPAIGN_INT8_PP = 0.5  # int8 overall at least bf16's less 0.5 pp
CAMPAIGN_INT8_AGREE = 0.995  # int8 and bf16 predictions equal on at least this share
CAMPAIGN_INT8_NLL = 0.03  # int8 mean NLL at most this
CAMPAIGN_INT8_FAMILY_PP = 2.0  # each int8 category_* at least bf16's less 2 pp
# on each eval batch of CAMPAIGN_INT8, against rnet's int8 there (bf16 compute, its kernel in interpret mode on
# the CPU; the port's plain chain on the CPU equals it on 507 and 512 of 512, 493 and 512 right against 489 and 512)
CAMPAIGN_INT8_RNET_AGREE = 0.98  # the card's int8 predictions equal rnet's on at least this share
CAMPAIGN_INT8_RNET_RIGHT = 6  # its right answers within 6 of rnet's
CAMPAIGN_INT8_RNET_NLL = (1.5, 0.01)  # its mean NLL at most 1.5 x rnet's + 0.01


def sha256_of(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def read_csv_metrics(path):
    """{metric: value} of an ``<split>_accuracy.csv``."""
    import csv

    with open(path) as f:
        return {row["metric"]: float(row["value"]) for row in csv.DictReader(f)}


def trained_wide_fp_phase(torch, np, pw, aug, root):
    """Phase 15: rnet's epoch-91 wide-fp weights (``TRAINED_PKL``, the
    dictionaries carried) through the card's kernels on the val split they
    were scored on (``expand_val_fixture``): ``rnet_torch.evaluate.main`` in
    bf16 (``auto``: the bf16 cluster forward), ``--rl-impl pallas_int8``
    (under warnings as errors) and ``--precision float32`` (the fp32 ring
    forward), each with the counters zeroed just before and one launch of its
    kernel per eval batch and nothing else; every bound of the module
    docstring; then bf16 and int8 ``InferenceServer``s loaded from the same
    pkl serve the first 64 val questions (three batches: buckets 1, 8, 64),
    one launch per served batch, each bf16 answer equal to ``evaluate``'s
    prediction and each int8 answer to the plain int8 chain's on the same
    batch (``plain_int8_answers``); then (c) wide-fp bf16 at doubled batch sizes in worker
    processes. Returns the numbers for the result line."""
    from rnet_torch.checkpoint import load_exported_dicts
    from rnet_torch.config import load_config
    from rnet_torch.data.vocab import Dictionaries

    clevr = os.path.join(root, "clevr_v2_seed1")
    t0 = time.perf_counter()
    try:
        digests = expand_val_fixture(clevr)
    except (OSError, ValueError) as e:
        fail(f"phase 15: the val fixture does not expand: {e}")
    n_q = digests["questions"]
    log(f"phase 15: val fixture expanded in {time.perf_counter() - t0:.2f} s ({n_q} questions, cache "
        f"{digests['cache_shape']}, every file at its sha256)")
    base = ["--model", "wide-fp", "--checkpoint", TRAINED_PKL, "--clevr-dir", clevr]
    out, preds = {}, {}
    for tag, extra, kernel, rnet_dir, _ in TRAINED_ARMS:
        got, row, by_q, problems = eval_arm(torch, pw, aug, base + extra, os.path.join(root, f"trained_{tag}"),
                                            tag == "int8", kernel, n_q)
        want = read_csv_metrics(RNET_VAL_CSV.format(rnet_dir))
        fams = {k: (got[k], want[k], 100 * (got[k] - want[k])) for k in sorted(want) if k.startswith("category_")}
        row.update(rnet_accuracy=want["overall_accuracy"],
                   accuracy_pp=100 * (got["overall_accuracy"] - want["overall_accuracy"]),
                   rnet_mean_nll=want["mean_nll"], nll_diff=got["mean_nll"] - want["mean_nll"],
                   families={k: {"port": p, "rnet": r, "pp": d} for k, (p, r, d) in fams.items()})
        if tag == "fp32":
            row["fp32_cpu_accuracy"] = TRAINED_FP32_CPU
            row["fp32_cpu_pp"] = 100 * (got["overall_accuracy"] - TRAINED_FP32_CPU)
        log(f"phase 15 trained wide-fp {tag}: {json.dumps(row)}")
        if not abs(row["accuracy_pp"]) <= TRAINED_ACC_PP:
            problems.append(f"accuracy {row['accuracy']!r} vs rnet's {row['rnet_accuracy']!r}")
        if not abs(row["nll_diff"]) <= TRAINED_NLL:
            problems.append(f"mean NLL {row['mean_nll']!r} vs rnet's {row['rnet_mean_nll']!r}")
        problems += [f"{k} {p!r} vs rnet's {r!r}" for k, (p, r, d) in fams.items() if not abs(d) <= TRAINED_FAMILY_PP]
        if tag == "fp32" and not abs(row["fp32_cpu_pp"]) <= TRAINED_FP32_CPU_PP:
            problems.append(f"fp32 accuracy {row['accuracy']!r} vs the port's CPU {TRAINED_FP32_CPU!r}")
        if len(fams) != 5:
            problems.append(f"{len(fams)} families")
        if problems:
            fail(f"phase 15 trained wide-fp {tag}: " + "; ".join(problems))
        out[tag], preds[tag] = row, by_q
    same = float(np.mean([preds["int8"][i] == p for i, p in preds["bf16"].items()]))
    out["int8_bf16_predictions_equal"] = same
    log(f"phase 15: int8 and bf16 predictions equal on {same!r} of {n_q} questions (bound >= {TRAINED_AGREE})")
    if not same >= TRAINED_AGREE:
        fail(f"phase 15: int8 and bf16 predictions equal on only {same!r} of the questions")

    # (b) servers loaded from the same pkl answer the first 64 val questions as evaluate did
    dicts = Dictionaries(*load_exported_dicts(TRAINED_PKL))
    cfg = load_config("wide-fp").replace(n_answers=dicts.n_answers)
    out.update(serve_trained(torch, np, pw, aug, "phase 15 served trained wide-fp", cfg, dicts, TRAINED_PKL, clevr,
                             preds))
    torch.cuda.empty_cache()
    out["doubled_batches"] = wide_batch_check()
    return out


def campaign_phase(torch, np, pw, aug, root):
    """Phase 17 (the module docstring has its steps and bounds): the port's
    fixture generator against rnet's digests, (a) at the committed val
    split's size and (b) at rnet's campaign fixture (70k / 15k), then (c)
    rnet's epoch-119 original-fp on that val split through the card's bf16,
    int8 and fp32 forwards and (d) served. Returns the numbers for the
    result line."""
    import argparse
    import random

    try:
        import PIL
    except ImportError:
        fail("phase 17: Pillow does not import, and the fixture generator renders through it")
    from rnet_torch.cli import load_dicts
    from rnet_torch.config import load_config
    from rnet_torch.data import synth
    from rnet_torch.data.cache import build_image_cache

    out = {"pillow": PIL.__version__, "render_workers": os.cpu_count()}

    # (a) the committed val split's fixture, written by generate as a user runs it
    small = os.path.join(root, "synth_v2_4000")
    n_train, n_val, style, seed = VAL_FIXTURE_SYNTH
    t0 = time.perf_counter()
    synth.generate(small, n_train, n_val, style=style, seed=seed)
    t1 = time.perf_counter()
    build_image_cache(small, "val")
    with open(os.path.join(VAL_FIXTURE, "digests.json")) as f:
        want = json.load(f)["files"]
    equal = {name: sha256_of(os.path.join(small, sub, name)) == want[name]["sha256"]
             for name, sub in VAL_FIXTURE_FILES.items()}
    row = out["val_fixture"] = {"generate_s": t1 - t0, "cache_s": time.perf_counter() - t1, "sha256_equal": equal}
    if not equal["val_128p8.u8"]:
        ref = os.path.join(root, "synth_v2_4000_rnet")
        expand_val_fixture(ref)
        a = np.load(os.path.join(small, "rnet_cache", "val_128p8.u8"), mmap_mode="r")
        b = np.load(os.path.join(ref, "rnet_cache", "val_128p8.u8"), mmap_mode="r")
        d = np.abs(a.astype(np.int16) - b.astype(np.int16)) if a.shape == b.shape else None
        row.update(cache_shape=list(a.shape), bytes_differing=float((d != 0).mean()) if d is not None else None,
                   max_level_difference=int(d.max()) if d is not None else None)
    log(f"phase 17 (a) generate(<dir>, {n_train}, {n_val}, style={style!r}, seed={seed}) with Pillow "
        f"{PIL.__version__}: {json.dumps(row)}")
    if not (equal["CLEVR_val_questions.json"] and equal["val_128p8.json"]):
        fail(f"phase 17 (a): the port's questions or cache meta differ from rnet's: {equal}")
    pillow_differs = not equal["val_128p8.u8"]
    if pillow_differs:
        log(f"phase 17 (a): the cache differs from the one of rnet's PNGs: Pillow {PIL.__version__} renders "
            "otherwise here than where rnet's digests were taken (the questions are rnet's byte for byte)")
        if row["bytes_differing"] is None or not (row["bytes_differing"] <= SYNTH_BYTE_SHARE
                                                   and row["max_level_difference"] <= SYNTH_LEVELS):
            fail(f"phase 17 (a): the cache differs beyond {SYNTH_BYTE_SHARE} of its bytes or {SYNTH_LEVELS} "
                 f"levels: {row}")

    # (b) rnet's campaign fixture: the train split drawn, not rendered; the val split rendered
    with open(os.path.join(CAMPAIGN_FIXTURE, "digests.json")) as f:
        want = json.load(f)
    with open(os.path.join(CAMPAIGN_FIXTURE, "dictionaries.json")) as f:
        want_dicts = json.load(f)
    clevr = os.path.join(root, "clevr_v2_seed1_70k")
    n_train, n_val, style, seed = CAMPAIGN_SYNTH
    rng = random.Random(seed)
    row = out["campaign_fixture"] = {}
    t0 = time.perf_counter()
    scenes, questions = synth._draw_split(rng, "train", n_train, style)
    t1 = time.perf_counter()
    synth._write_split(clevr, "train", scenes, questions)
    row.update(train_draw_s=t1 - t0, train_write_s=time.perf_counter() - t1, train_questions=len(questions))
    del scenes, questions
    t0 = time.perf_counter()
    dicts = load_dicts(argparse.Namespace(clevr_dir=clevr, oov="error"), checkpoint=CAMPAIGN_PKL)
    row["dictionaries_s"] = time.perf_counter() - t0
    row["dictionaries_equal"] = (list(dicts.word_to_idx.items()) == list(want_dicts["word_to_idx"].items())
                                 and list(dicts.answer_to_idx.items()) == list(want_dicts["answer_to_idx"].items()))
    t0 = time.perf_counter()
    scenes, questions = synth._draw_split(rng, "val", n_val, style)
    synth._write_split(clevr, "val", scenes, questions)
    t1 = time.perf_counter()
    H, W = synth._image_hw(style)
    synth._render_split(clevr, "val", scenes, H, W, style, workers=os.cpu_count())
    t2 = time.perf_counter()
    build_image_cache(clevr, "val")
    n_q = len(questions)
    row.update(val_draw_write_s=t1 - t0, val_render_s=t2 - t1, val_cache_s=time.perf_counter() - t2,
               val_questions=n_q, val_images=len(scenes))
    del scenes, questions
    names = {f"CLEVR_{split}_{kind}.json": os.path.join(clevr, kind, f"CLEVR_{split}_{kind}.json")
             for split in ("train", "val") for kind in ("questions", "scenes")}
    names.update({name: os.path.join(clevr, "rnet_cache", name) for name in ("val_128p8.u8", "val_128p8.json")})
    row["sha256_equal"] = {name: sha256_of(path) == want["files"][name]["sha256"] for name, path in names.items()}
    log(f"phase 17 (b) rnet's campaign fixture {CAMPAIGN_SYNTH}: {json.dumps(row)}")
    problems = [f"{name} differs from rnet's" for name, ok in row["sha256_equal"].items()
                if not ok and not (pillow_differs and name == "val_128p8.u8")]
    if (row["train_questions"], n_q) != (want["train_questions"], want["val_questions"]):
        problems.append(f"{row['train_questions']} train and {n_q} val questions, rnet's "
                        f"{want['train_questions']} and {want['val_questions']}")
    if not row["dictionaries_equal"]:
        problems.append("the dictionaries differ from rnet's")
    if problems:
        fail("phase 17 (b): " + "; ".join(problems))

    # (c) rnet's epoch-119 original-fp on the val split, in bf16, int8 and fp32
    rnet_row = read_csv_metrics(CAMPAIGN_CSV)
    base = ["--model", "original-fp", "--checkpoint", CAMPAIGN_PKL, "--clevr-dir", clevr]
    preds = {}
    for tag, extra, kernel, _, _ in TRAINED_ARMS:
        got, row, by_q, problems = eval_arm(torch, pw, aug, base + extra, os.path.join(root, f"campaign_{tag}"),
                                            tag == "int8", kernel, n_q)
        fams = {k: (got[k], r, 100 * (got[k] - r)) for k, r in sorted(rnet_row.items()) if k.startswith("category_")}
        row.update(rnet_accuracy=rnet_row["overall_accuracy"],
                   accuracy_pp=100 * (got["overall_accuracy"] - rnet_row["overall_accuracy"]),
                   rnet_mean_nll=rnet_row["mean_nll"], nll_diff=got["mean_nll"] - rnet_row["mean_nll"],
                   families={k: {"port": p, "rnet": r, "pp": d} for k, (p, r, d) in fams.items()})
        log(f"phase 17 (c) rnet's epoch-119 original-fp {tag}: {json.dumps(row)}")
        if tag == "int8":
            bf16 = out["bf16"]
            if not row["accuracy"] >= bf16["accuracy"] - CAMPAIGN_INT8_PP / 100:
                problems.append(f"accuracy {row['accuracy']!r} below bf16's {bf16['accuracy']!r} less "
                                f"{CAMPAIGN_INT8_PP} pp")
            if not row["mean_nll"] <= CAMPAIGN_INT8_NLL:
                problems.append(f"mean NLL {row['mean_nll']!r} above {CAMPAIGN_INT8_NLL}")
            problems += [f"{k} {p!r} below bf16's {bf16['families'][k]['port']!r} less {CAMPAIGN_INT8_FAMILY_PP} pp"
                         for k, (p, _, _) in fams.items()
                         if not p >= bf16["families"][k]["port"] - CAMPAIGN_INT8_FAMILY_PP / 100]
        else:
            if not abs(row["accuracy_pp"]) <= CAMPAIGN_ACC_PP:
                problems.append(f"accuracy {row['accuracy']!r} vs rnet's {row['rnet_accuracy']!r}")
            if not abs(row["nll_diff"]) <= CAMPAIGN_NLL:
                problems.append(f"mean NLL {row['mean_nll']!r} vs rnet's {row['rnet_mean_nll']!r}")
            problems += [f"{k} {p!r} vs rnet's {r!r}" for k, (p, r, d) in fams.items()
                         if not abs(d) <= CAMPAIGN_FAMILY_PP]
        if len(fams) != 5:
            problems.append(f"{len(fams)} families")
        if problems:
            fail(f"phase 17 (c) {tag}: " + "; ".join(problems))
        out[tag], preds[tag] = row, by_q
    same = float(np.mean([preds["int8"][i] == p for i, p in preds["bf16"].items()]))
    out["int8_bf16_predictions_equal"] = same
    differ = np.bincount([i // TRAIN_B for i, p in preds["bf16"].items() if preds["int8"][i] != p],
                         minlength=-(-n_q // TRAIN_B))
    out["int8_bf16_most_different_batch"] = [int(differ.argmax()), int(differ.max())]
    log(f"phase 17 (c): int8 and bf16 predictions equal on {same!r} of {n_q} questions (bound >= "
        f"{CAMPAIGN_INT8_AGREE}); most different on eval batch {differ.argmax()} ({differ.max()} of {TRAIN_B})")
    if not same >= CAMPAIGN_INT8_AGREE:
        fail(f"phase 17 (c): int8 and bf16 predictions equal on only {same!r} of the questions")
    cfg = load_config("original-fp").replace(n_answers=dicts.n_answers)
    # the int8 kernel against its plain version and against rnet's int8 on the eval batches rnet's was read on
    with open(CAMPAIGN_INT8) as f:
        rnet_int8 = json.load(f)
    batches = sorted(int(k) for k in rnet_int8["batches"])
    out["int8_plain"] = int8_batches_vs_plain(torch, np, pw, cfg, dicts, CAMPAIGN_PKL, clevr, batches, preds["int8"],
                                              rnet_int8)

    # (d) served
    out.update(serve_trained(torch, np, pw, aug, "phase 17 (d) served rnet's epoch-119 original-fp", cfg, dicts,
                             CAMPAIGN_PKL, clevr, preds))
    return out


def int8_batches_vs_plain(torch, np, pw, cfg, dicts, pkl, clevr, batches, evaluated, rnet):
    """Phase 17 (c): the int8 model of `pkl` on eval batches `batches` of
    the val split (B=512, in ``evaluate``'s order; the eval transform, the
    questions inverted), once through the int8 kernel and once with the
    kernel swapped for its plain version on the card (TF32 off: exact) on the
    same folded inputs (int8 calibrates on each batch, so the batch is the
    reference's unit). Fails unless every prediction agrees, and unless the
    kernel's predictions, right answers and mean NLL are within the
    ``CAMPAIGN_INT8_RNET_*`` bounds of rnet's int8 on the same batch
    (`rnet`, the committed ``CAMPAIGN_INT8``); logs the largest log-prob
    difference and the share of the kernel's predictions equal to
    ``evaluate``'s (`evaluated`, by question). Returns the rows."""
    from rnet_torch.checkpoint import load_weights
    from rnet_torch.data.cache import CachedClevrDataset
    from rnet_torch.data.vocab import invert_questions
    from rnet_torch.models import RN

    model = RN(cfg.replace(rl_impl="pallas_int8"), dicts.vocab_size)
    load_weights(model, pkl)
    model = model.to("cuda").eval()
    ds = CachedClevrDataset(clevr, "val", dicts, image_size=cfg.image_size, question_max_len=cfg.question_max_len,
                            train_transform=False)
    real = pw.pairwise_core_int8

    def plain(u, v, s, qa, ws, bs, *, inject):
        return pw.pairwise_core_int8_reference(*pw.quantize_int8(u, v, s, qa, ws, bs, inject), inject=inject)

    rows = {}
    for k in batches:
        idx = np.arange(k * TRAIN_B, min(len(ds), (k + 1) * TRAIN_B))
        batch = ds.get_batch(idx)
        x = torch.from_numpy(batch["image"]).cuda()
        q = torch.from_numpy(invert_questions(batch["question"])).cuda()
        before = pw.launches[pw.INT8_KERNEL]
        with torch.no_grad():
            got = model(x, q)
            pw.pairwise_core_int8 = plain
            try:
                ref = model(x, q)
            finally:
                pw.pairwise_core_int8 = real
        launched = pw.launches[pw.INT8_KERNEL] - before
        pred, ref_pred = got.argmax(-1).cpu().numpy(), ref.argmax(-1).cpu().numpy()
        labels = batch["answer"]
        want = rnet["batches"][str(k)]["rnet_int8"]
        rnet_pred = np.array([rnet["answer_digits"].index(c) for c in want["predictions"]])
        rows[k] = row = {"questions": len(idx), "launches": launched,
                         "predictions_equal_to_plain": int((pred == ref_pred).sum()),
                         "max_abs_logp_diff": float((got - ref).abs().max()),
                         "equal_to_evaluate": int(sum(evaluated[int(i)] == p for i, p in zip(idx, pred))),
                         "right": int((pred == labels).sum()),
                         "mean_nll": float(-got.double().cpu().numpy()[np.arange(len(idx)), labels].mean()),
                         "equal_to_rnet_int8": int((pred == rnet_pred).sum()),
                         "rnet_int8_right": want["right"], "rnet_int8_mean_nll": want["mean_nll"]}
        log(f"phase 17 (c) int8 eval batch {k} through the kernel and its plain version: {json.dumps(row)}")
        if launched != 1 or row["predictions_equal_to_plain"] != len(idx):
            fail(f"phase 17 (c): int8 eval batch {k}: {launched} launches, {row['predictions_equal_to_plain']} of "
                 f"{len(idx)} predictions equal to the plain int8 chain's")
        scale, add = CAMPAIGN_INT8_RNET_NLL
        if not (row["equal_to_rnet_int8"] >= CAMPAIGN_INT8_RNET_AGREE * len(idx)
                and abs(row["right"] - want["right"]) <= CAMPAIGN_INT8_RNET_RIGHT
                and row["mean_nll"] <= scale * want["mean_nll"] + add):
            fail(f"phase 17 (c): int8 eval batch {k} against rnet's int8 there: {row}")
    del model
    torch.cuda.empty_cache()
    return rows


def eval_arm(torch, pw, aug, argv, res, int8, kernel, n_q):
    """One ``rnet_torch.evaluate.main`` run of a trained-weights phase: the
    val split of ``--clevr-dir`` through the device pipeline at B=512 with
    `argv` (model, checkpoint, directory and the arm's flags), the counters
    zeroed just before (an int8 run under warnings as errors). Returns its
    ``val_accuracy.csv`` metrics, a row (seconds, launches, questions,
    accuracy, NLL), the predictions by question, and the problems found: any
    launch but one of `kernel` a batch, a question not predicted, a metric
    not finite."""
    import math

    argv = [*argv, "--data-pipeline", "device", "--batch-size", str(TRAIN_B), "--test-results-dir", res,
            "--num-workers", "4"]
    torch.cuda.synchronize()
    pw.reset_launches()
    aug.reset_launches()
    _, by_q, sec = run_eval_cli(argv, int8=int8)
    torch.cuda.synchronize()
    counts = {k: v for k, v in {**pw.launches, **aug.launches}.items() if v}
    got = read_csv_metrics(os.path.join(res, "val_accuracy.csv"))
    row = {"seconds": sec, "launches": counts, "questions": len(by_q), "accuracy": got["overall_accuracy"],
           "mean_nll": got["mean_nll"]}
    problems = []
    n_batches = -(-n_q // TRAIN_B)
    if counts != {kernel: n_batches}:
        problems.append(f"launches {counts}, expected {{{kernel!r}: {n_batches}}}")
    if len(by_q) != n_q:
        problems.append(f"{len(by_q)} questions predicted of {n_q}")
    if not all(math.isfinite(v) for v in (row["accuracy"], row["mean_nll"])):
        problems.append(f"accuracy {row['accuracy']!r}, NLL {row['mean_nll']!r}")
    return got, row, by_q, problems


def serve_trained(torch, np, pw, aug, what, cfg, dicts, pkl, clevr, preds):
    """bf16 and int8 ``InferenceServer``s loaded from `pkl` serve the first
    64 val questions of `clevr` as three batches (``TRAINED_SERVED``:
    buckets 1, 8, 64), the counters zeroed just before: one launch of the
    arm's kernel per served batch and nothing else; each bf16 answer equal to
    ``evaluate``'s prediction (`preds`, by question), each int8 answer to the
    plain int8 chain's on the same batch (``plain_int8_answers``), the int8
    answers that differ from ``evaluate``'s logged. Returns the rows."""
    import warnings

    from rnet_torch.serve import InferenceServer

    with open(os.path.join(clevr, "questions", "CLEVR_val_questions.json")) as f:
        questions = json.load(f)["questions"][: sum(TRAINED_SERVED)]
    with open(os.path.join(clevr, "rnet_cache", "val_128p8.json")) as f:
        meta = json.load(f)
    cache = np.load(os.path.join(clevr, "rnet_cache", "val_128p8.u8"), mmap_mode="r")
    row_of = {name: i for i, name in enumerate(meta["files"])}
    p, S = meta["pad"], meta["image_size"]
    samples = [{"question": dicts.encode_question(q["question"], cfg.question_max_len),
                "image": np.ascontiguousarray(cache[row_of[q["image_filename"]], p : p + S, p : p + S])}
               for q in questions]
    idx_to_answer = {i: a for a, i in dicts.answer_to_idx.items()}
    chunks, c0 = [], 0
    for n in TRAINED_SERVED:
        chunks.append(samples[c0 : c0 + n])
        c0 += n
    out = {}
    for tag, _, kernel, _, impl in TRAINED_ARMS[:2]:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            srv = InferenceServer(cfg.replace(rl_impl=impl), dicts, max_batch=64, device="cuda")
            srv.load(pkl)
            srv.warmup()
            torch.cuda.synchronize()
            pw.reset_launches()
            aug.reset_launches()
            results = [r for chunk in chunks for r in srv.serve_samples(chunk)]
            torch.cuda.synchronize()
        counts = {k: v for k, v in {**pw.launches, **aug.launches}.items() if v}
        want = [idx_to_answer[preds[tag][i]] for i in range(len(samples))]
        equal = [r["answer"] == w for r, w in zip(results, want)]
        right = [r["answer"] == str(q["answer"]).lower() for r, q in zip(results, questions)]
        row = out[f"serve_{tag}"] = {"launches": counts, "buckets": sorted({r["bucket"] for r in results}),
                                     "answers_equal_to_evaluate": sum(equal), "answers_right": sum(right),
                                     "served": len(results)}
        if tag == "int8":
            # int8 answers depend on the batch: its scales come from a subsample of each call's batch
            # (rnet's _activation_scales), so the reference is the plain int8 chain on the same batches
            plain = plain_int8_answers(torch, pw, srv, chunks)
            row["answers_equal_to_plain_int8"] = sum(r["answer"] == p for r, p in zip(results, plain))
            row["differ_from_evaluate"] = [
                {"question": i, "served": r["answer"], "evaluate": w, "label": str(questions[i]["answer"]).lower(),
                 "bucket": r["bucket"]} for i, (r, w) in enumerate(zip(results, want)) if r["answer"] != w]
        log(f"{what} {tag}: {json.dumps(row)}")
        if counts != {kernel: len(TRAINED_SERVED)}:
            fail(f"{what} {tag}: expected one {kernel} launch per served batch ({len(TRAINED_SERVED)}) and "
                 f"nothing else, counted {counts}")
        if tag == "int8" and row["answers_equal_to_plain_int8"] != len(results):
            fail(f"{what} int8: {row['answers_equal_to_plain_int8']} of {len(results)} answers equal to the "
                 "plain int8 chain's on the same batches")
        if tag == "bf16" and not all(equal):
            fail(f"{what} bf16: {sum(equal)} of {len(results)} answers equal to evaluate's")
        del srv
    torch.cuda.empty_cache()
    return out


def plain_int8_answers(torch, pw, srv, chunks):
    """The answers of ``srv``'s int8 model to each chunk of encoded samples,
    padded to its bucket as the server pads it, with the int8 kernel swapped
    for its plain version on the CPU (the same folded inputs, made on the
    card): the reference for int8 served answers, whose calibration depends
    on the batch they are served in."""
    real = pw.pairwise_core_int8

    def plain(u, v, s, qa, ws, bs, *, inject):
        folded = pw.quantize_int8(u, v, s, qa, ws, bs, inject)
        return pw.pairwise_core_int8_reference(*(t.cpu() for t in folded), inject=inject).to(u.device)

    pw.pairwise_core_int8 = plain
    try:
        answers = []
        for chunk in chunks:
            inputs, q = srv.batch_arrays(chunk, srv._bucket_for(len(chunk)))
            best = srv.log_probs(inputs, q).argmax(-1)[: len(chunk)]
            answers += [srv._idx_to_answer[int(k)] for k in best.tolist()]
    finally:
        pw.pairwise_core_int8 = real
    return answers


def wide_batch_check():
    """Phase 15 (c), ROADMAP §3 item 4: one replayed wide-fp bf16 train step
    at each B of ``WIDE_BATCHES`` through rl_impl "auto" (the kernels; the
    backward stores 25.2 MB of tiles a sample, in sample groups within
    ``BWD_STORE_BUDGET``) and through "xla", each in a worker
    process of its own (``wide_batch_worker``), so that running out of the
    card's memory leaves nothing behind. ``auto`` out of memory where ``xla``
    runs is a fault."""
    from rnet_torch.kernels import pairwise as pw

    rows = {}
    for B in WIDE_BATCHES:
        for impl in ("auto", "xla"):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, __file__, WIDE_BATCH_FLAG, str(B), impl], capture_output=True,
                                  text=True, timeout=WIDE_BATCH_TIMEOUT)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                log(proc.stderr[-3000:])
                fail(f"phase 15 (c): the worker for wide-fp B={B} {impl} exited {proc.returncode}")
            rows[f"{B} {impl}"] = row = json.loads(lines[-1])
            log(f"phase 15 (c) wide-fp bf16 replayed train step B={B} {impl} ({time.perf_counter() - t0:.1f} s "
                f"with the process): " + ("OOM: " + row["oom"] if "oom" in row else json.dumps(row)))
        auto, xla = rows[f"{B} auto"], rows[f"{B} xla"]
        if "oom" in auto and "oom" not in xla:
            fail(f"phase 15 (c): wide-fp B={B} runs out of memory through auto where xla runs")
        for impl, row in (("auto", auto), ("xla", xla)):
            if "oom" not in row and not row["finite"]:
                fail(f"phase 15 (c): wide-fp B={B} {impl} gave non-finite metrics")
        groups = len(pw.bwd_groups(B, 64, 64, 512, 4))
        if "oom" not in auto and auto["launches"] != {pw.KERNEL: 1, pw.BWD_KERNEL: 1, pw.STORED_GROUPS: groups,
                                                      "augment": 1}:
            fail(f"phase 15 (c): wide-fp B={B} auto launched {auto['launches']} in one replay, want {groups} "
                 f"sample groups of the backward")
    return rows


def wide_batch_worker(argv) -> int:
    """``chip_smoke.py --wide-batch-worker B IMPL``: one replayed wide-fp
    bf16 train step at batch size B through rl_impl IMPL, on device data (a
    2,048-canvas cache, device augment, as phase 12b); prints one JSON line:
    the replay's host ms, its launches, the first step's loss, the graph's
    pool and the peak allocated memory, or "oom" and the error's first
    line."""
    import torch

    from rnet_torch.config import load_config
    from rnet_torch.kernels import augment as aug
    from rnet_torch.kernels import pairwise as pw
    from rnet_torch.train import steps

    B, impl = int(argv[0]), argv[1]
    cfg = load_config("wide-fp").replace(device_augment=True, rl_impl=impl)
    row = {"B": B, "impl": impl}
    try:
        cache, data = device_data(torch, cfg, AUG_SMALL, B, seed=18)
        state = new_state(torch, cfg)
        graphs = steps.step_graphs(state)
        train = steps.make_chunked_steps(state, graphs)[0]
        idx = torch.arange(B, dtype=torch.int32, device="cuda").view(1, B)
        torch.cuda.reset_peak_memory_stats()
        first = train(idx, data, cache)  # captures, then replays the first step
        torch.cuda.synchronize()
        pw.reset_launches()
        aug.reset_launches()
        t0 = time.perf_counter()
        metrics = train(idx, data, cache)
        torch.cuda.synchronize()
        row.update(host_ms=(time.perf_counter() - t0) * 1e3, first_loss=float(first[0, 0]),
                   finite=bool(torch.isfinite(metrics).all()),
                   launches={k: v for k, v in {**pw.launches, **aug.launches}.items() if v},
                   pool_mb=sum(c.pool_bytes for c in graphs.captured.values()) / 2**20,
                   peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    except torch.cuda.OutOfMemoryError as e:
        row["oom"] = str(e).strip().splitlines()[0][:400]
    print(json.dumps(row), flush=True)
    return 0


# Phase 16: python -m rnet_torch.bench
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "backend", "batch_size", "baseline_def", "infer_qps",
              "xla_impl_train_qps", "vs_v100_fp32_flop_bound", "vs_a100_tf32_flop_bound", "device")
BENCH_TARGET_S = 0.5  # the in-process arms' long window (python -m rnet_torch.bench: 2 s, bench.py's)
BENCH_REL = 0.15  # the bench's value within 15 % of phase 12's replayed train q/s
BENCH_TIMEOUT = 600


def bench_phase(torch, pw, aug, card, phase12_qps):
    """Phase 16: ``rnet_torch.bench`` (the port of ``bench.py``) at
    original-fp B=512. In process, each arm with the launch counters zeroed
    just before: ``measure_train_qps("auto", ...)`` counts one
    ``pairwise_fwd`` and one ``pairwise_bwd`` launch per step its warm-up and
    timed replays took and nothing else (no ``augment``, no ``pair_mask``),
    ``measure_infer_qps("auto", ...)`` ``pairwise_fwd`` only, the ``xla``
    arm no kernel and one ``g_xla`` count (an ``xla``-route forward) a
    step. Then ``python -m rnet_torch.bench`` as a user runs it: rc 0, its
    last line with exactly ``BENCH_KEYS``, ``backend`` "cuda",
    finite positive q/s, ``device`` the card's line, and ``value`` within
    ``BENCH_REL`` of phase 12's replayed train q/s (both time the same
    replayed step; phase 12 adds a 0.07 ms augment). Returns the numbers for
    the result line."""
    import math

    from rnet_torch import bench

    out = {}
    arms = (("train auto", lambda: bench.measure_train_qps("auto", TRAIN_B, "cuda", target_s=BENCH_TARGET_S),
             (pw.KERNEL, pw.BWD_KERNEL, pw.STORED_GROUPS)),
            ("infer auto", lambda: bench.measure_infer_qps("auto", TRAIN_B, "cuda", target_s=BENCH_TARGET_S),
             (pw.KERNEL,)),
            ("train xla", lambda: bench.measure_train_qps("xla", TRAIN_B, "cuda", target_s=BENCH_TARGET_S),
             (pw.XLA_ROUTE,)))
    for what, run, kernels in arms:
        torch.cuda.synchronize()
        pw.reset_launches()
        aug.reset_launches()
        m = run()
        torch.cuda.synchronize()
        counts = {k: v for k, v in {**pw.launches, **aug.launches}.items() if v}
        out[what] = {"qps": m.qps, "step_ms": m.step_s * 1e3, "k": m.k, "windows": list(m.windows),
                     "replayed_steps": m.steps, "launches": counts, "pool_mb": m.pool_mb}
        log(f"phase 16 bench in process, {what} B={TRAIN_B}: {json.dumps(out[what])}")
        if counts != {k: m.steps for k in kernels}:
            fail(f"phase 16 {what}: expected {m.steps} launches of each of {kernels} and nothing else, "
                 f"counted {counts}")
        if not (math.isfinite(m.qps) and m.qps > 0):
            fail(f"phase 16 {what}: q/s {m.qps!r}")
        del m
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "rnet_torch.bench"], cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    sec = time.perf_counter() - t0
    log("\n".join(f"  | {line}" for line in (proc.stderr.strip().splitlines()[-8:] + proc.stdout.strip().splitlines())))
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"phase 16: python -m rnet_torch.bench exited {proc.returncode}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    qps_keys = ("value", "infer_qps", "xla_impl_train_qps")
    if set(line) != set(BENCH_KEYS) or line["backend"] != "cuda" or line["batch_size"] != TRAIN_B or \
            line["device"] != card or not all(isinstance(line[k], (int, float)) and math.isfinite(line[k])
                                              and line[k] > 0 for k in qps_keys):
        fail(f"phase 16: python -m rnet_torch.bench printed {line}")
    ratio = line["value"] / phase12_qps
    out["cli"] = {"seconds": sec, "line": line, "phase12_replay_qps": phase12_qps, "value_over_phase12": ratio}
    log(f"phase 16: python -m rnet_torch.bench in {sec:.1f} s: value {line['value']!r} q/s beside phase 12's "
        f"replayed train step {phase12_qps!r} q/s (ratio {ratio!r}, bound 1 +- {BENCH_REL}); infer "
        f"{line['infer_qps']!r}, xla {line['xla_impl_train_qps']!r}")
    if not abs(ratio - 1.0) <= BENCH_REL:
        fail(f"phase 16: the bench's {line['value']!r} q/s is not within {BENCH_REL} of phase 12's {phase12_qps!r}")
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
        from rnet_torch.kernels import embedding as em
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

    kernels = [pw.KERNEL, pw.BWD_KERNEL, aug.KERNEL, pw.INT8_KERNEL, pw.F32_LIB, em.KERNEL]
    timed = [pw.KERNEL, pw.BWD_KERNEL, pw.INT8_KERNEL, pw.F32_LIB]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        for job in [ex.submit(build.build, kernels), ex.submit(build.build, timed, pw.PHASE_DEFINES)]:
            job.result()
    log(f"build: {kernels} and {timed} with {pw.PHASE_DEFINES} in {time.perf_counter() - t0:.1f} s")
    for name in kernels:
        with open(build.log_path(name)) as f:
            for line in f:
                if "registers" in line or "Compiling entry" in line or "spill" in line or "C7520" in line:
                    log(f"  ptxas {name}: {line.strip()}")
    seed = torch.tensor([0x5EED_1234_ABCD], dtype=torch.int64, device="cuda")

    # ---- 3-5. kernels vs plain versions ----
    fwd_err, fwd_err_at_shape = check_forward(torch, pw, seed)
    mask_err = check_mask(torch, pw, seed)
    bwd_err, bwd_err_at_shape = check_backward(torch, pw, seed)
    int8_err, int8_err_all, int8_drift = check_int8(torch, pw)
    f32_fwd_err, f32_fwd_err_all, f32_bwd_err, f32_bwd_err_all, f32_abs = check_f32(torch, pw, seed)
    log(f"phases 1-5c done at {time.perf_counter() - t_start:.1f} s")

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
    f32_step_counts, f32_loss_rel = f32_train_agreement(torch, np, pw, cfg, state, batch)
    torch.cuda.empty_cache()
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # ---- 8. times ----
    fwd, bwd, mask = time_kernels(torch, pw, seed)
    f32_rows = time_f32(torch, pw, seed)
    log(f"fp32 kernels / cuBLAS fp32 chain (TF32 off) at original-fp B={TRAIN_B}, same call: forward "
        f"{f32_rows[('fwd', TRAIN_B)]['ms_over_library']!r}, backward (vs its autograd) "
        f"{f32_rows[('bwd', TRAIN_B)]['ms_over_library']!r}")
    wide = time_wide(torch, pw, seed)
    stretch_bwd = time_bwd_rows(torch, pw, STRETCH_BWD_ROWS)
    phases = phase_breakdown(torch, pw)
    train_times = time_training(torch, cfg, state, batch)
    qps_ratio = train_times["auto"]["qps"] / train_times["xla"]["qps"]
    log(f"train questions/s, kernel path / xla path: {qps_ratio!r}")

    int8_rows = time_int8(torch, pw)
    for B in (64, TRAIN_B):
        log(f"pairwise_fwd_int8 / pairwise_fwd at original-fp B={B}, same call: "
            f"{int8_rows[B]['ms'] / fwd[B]['ms']!r} ({int8_rows[B]['ms']!r} / {fwd[B]['ms']!r} ms)")
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
        log_profile(torch, f"served forward (eager log_probs), bucket {bucket}", lambda: server.log_probs(inputs, q),
                    wall)
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
    emb = embedding_phase(torch, em)
    log(f"phase 9b (embedding backward) done at {time.perf_counter() - t_start:.1f} s")

    # ---- 12. compiled dispatch: replayed CUDA graphs against eager steps ----
    graph_out = graph_phase(torch, np, pw, aug, cfg, dicts, burst)
    log(f"phase 12 (graphs) done at {time.perf_counter() - t_start:.1f} s")
    bench_out = bench_phase(torch, pw, aug, card, graph_out["train_step"]["replay"]["qps"])
    log(f"phase 16 (python -m rnet_torch.bench) done at {time.perf_counter() - t_start:.1f} s")
    graph_out["wide_fp_steps"] = wide_fp_steps(torch, pw, aug, dicts.n_answers)
    log(f"phase 12b (wide-fp steps) done at {time.perf_counter() - t_start:.1f} s")
    stretch = stretch_steps(torch, pw, aug, dicts.n_answers)
    log(f"phase 12c (stretch-fp-32 steps) done at {time.perf_counter() - t_start:.1f} s")

    # ---- 10. training through the entry point ----
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="rnet_torch_smoke_")
    try:
        entry_counts, hist_a, hist_c, hist_d, abba = entry_point_phase(torch, np, pw, aug, root)
        int8_eval_launches, int8_eval_same, eval_runs = eval_entry_phase(torch, np, pw, aug, root)
        wide_int8 = wide_int8_phase(torch, np, pw, aug, root)
        log(f"phase 12d (wide-fp in int8) done at {time.perf_counter() - t_start:.1f} s")
        stretch_cli = stretch_entry_phase(torch, np, pw, aug, root)
        qps = {"a_device_augment": [h["qps"] for h in hist_a], "c_cached_augment": [h["qps"] for h in hist_c],
               "d_device_no_augment": [h["qps"] for h in hist_d]}
        log(f"entry point epoch questions/s (host clock; epochs 1, 2): {json.dumps(qps)}")
        log(f"epoch-2 questions/s, (a) / (d): {qps['a_device_augment'][1] / qps['d_device_no_augment'][1]!r}, "
            f"(c) / (a): {qps['c_cached_augment'][1] / qps['a_device_augment'][1]!r}")
        a2, d2 = (sum(r[1] for r in abba[arm]) / len(abba[arm]) for arm in "ad")
        log(f"epoch-2 questions/s in the order a d d a, default cuDNN: (a) {a2!r}, (d) {d2!r}, (a) / (d) {a2 / d2!r}")
        profile_entry_step(torch, root)
        f32_entry_counts = f32_entry_phase(torch, np, pw, aug, root)
        extract_phase(torch, np, pw, root)
        rnet_fixture_phase(torch, np, pw, aug, root)
        log(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")
        trained = trained_wide_fp_phase(torch, np, pw, aug, root)
        log(f"phase 15 (rnet's trained wide-fp) done at {time.perf_counter() - t_start:.1f} s")
        campaign = campaign_phase(torch, np, pw, aug, root)
        log(f"phase 17 (the port's synth; rnet's epoch-119 original-fp) done at {time.perf_counter() - t_start:.1f} s")
        graph_out["trainer_epochs"] = trainer_epochs(torch, root)
        log(f"phase 12 (Trainer epochs) done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        shard = shard_phase(torch, np, pw, cfg, root)
        log(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
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
               entry_point_launches=entry_counts[pw.KERNEL], replay_launches=graph_out["train_counts"][pw.KERNEL],
               h512=wide["fwd_bf16"], h512_phase_shares=phases[("fwd", "H512")]["shares"],
               wide_fp_step_launches=graph_out["wide_fp_steps"]["bfloat16"]["auto"]["launches_per_step"],
               per_shard_ms={k: v["fwd_ms"] for k, v in shard["per_shard"].items()},
               per_shard_max_abs_err={k: v["fwd_max_abs_err"] for k, v in shard["per_shard"].items()},
               shard_launches_per_rank={k: shard[k]["launches_per_rank"] for k in SHARD_SHAPES if k in shard},
               bench_launches=bench_out["train auto"]["launches"], trained_wide_fp_launches=trained["bf16"]["launches"],
               campaign_epoch119_launches=campaign["bf16"]["launches"]),
        record(pw.BWD_KERNEL, "rnet_torch/csrc/pairwise_bwd.cu", "rnet/kernels/pairwise.py:120",
               train_counts[pw.BWD_KERNEL], bwd_err_at_shape, bwd[TRAIN_B], shape=shape,
               max_abs_err_all_cases=bwd_err, entry_point_launches=entry_counts[pw.BWD_KERNEL],
               phase_shares=phases[("bwd", TRAIN_B)]["shares"],
               replay_launches=graph_out["train_counts"][pw.BWD_KERNEL], h512=wide["bwd_bf16"],
               h512_phase_shares=phases[("bwd", "H512")]["shares"],
               wide_fp_step_launches=graph_out["wide_fp_steps"]["bfloat16"]["auto"]["launches_per_step"],
               per_shard_ms={k: v["bwd_ms"] for k, v in shard["per_shard"].items()},
               per_shard_max_abs_err={k: v["bwd_max_abs_err"] for k, v in shard["per_shard"].items()},
               shard_launches_per_rank={k: shard[k]["launches_per_rank"] for k in SHARD_SHAPES if k in shard},
               b64={k: bwd[64][k] for k in ("ms", "library_ms", "bound_ms", "ctas", "splits")},
               stretch={k: v for k, v in stretch_bwd.items() if k.startswith("bfloat16")},
               stretch_step_launches={B: r["auto"]["launches_per_step"] for B, r in stretch.items()},
               stretch_entry_point_launches=stretch_cli[0], bench_launches=bench_out["train auto"]["launches"]),
        record("pair_mask", "rnet_torch/csrc/philox.cuh", "rnet/kernels/pairwise.py:69",
               pd_counts["pair_mask"], float(mask_err), mask,
               shape={"B": TRAIN_B, "n": 64}, launches_of="one train step with pair_dropout 0.25",
               shard_pair_dropout=shard["pair_dropout"]),
        record(aug.KERNEL, "rnet_torch/csrc/augment.cu", "rnet/kernels/augment.py:134",
               entry_counts[aug.KERNEL], aug_err, aug_times["full"],
               shape={"B": TRAIN_B, "canvas": CANVAS, "crop": CROP, "cache_images": CLEVR_TRAIN_IMAGES,
                      "out": "bfloat16"},
               max_abs_err_fp32=aug_err32, max_abs_err_all_cases=aug_err_all,
               ms_cache_2048=aug_times[str(AUG_SMALL)]["ms"],
               replay_launches=graph_out["train_counts"][aug.KERNEL],
               launches_of="run (a): python -m rnet_torch.train --data-pipeline device, 2 epochs of 16 steps"),
        record(em.KERNEL, "rnet_torch/csrc/embedding_bwd.cu", "none (rnet: XLA's scatter-add)",
               graph_out["train_counts"][em.KERNEL], emb[EMB_CASES[0]]["max_abs_gap_to_parent"],
               emb[("time", EMB_CASES[0][0])], shape=dict(zip("BTVE", EMB_CASES[0])),
               b512=emb[("time", TRAIN_B)], bitwise_plain={str(c): emb[c]["bitwise_plain"] for c in EMB_CASES},
               model=emb["model"], launches_of=f"phase 12: {GRAPH_STEPS} replayed original-fp train steps"),
        record(pw.INT8_KERNEL, "rnet_torch/csrc/pairwise_fwd_int8.cu", "rnet/kernels/pairwise.py:190",
               int8_eval_launches, int8_err, int8_rows[TRAIN_B], shape=shape,
               max_abs_err_all_cases=int8_err_all, max_drift_from_fp32=int8_drift,
               serve_launches=int8_serve_launches, serve_answers_equal_to_bf16=int8_agree,
               serve_max_abs_dlogp=int8_dlp, eval_predictions_equal_to_bf16=int8_eval_same,
               eval_qps=eval_runs,
               ms_b64=int8_rows[64]["ms"], ms_with_calibration=int8_rows[TRAIN_B]["ms_with_calibration"],
               shard_eval=shard["eval"],
               phase_shares=phases[("int8", TRAIN_B)]["shares"], ms_over_pairwise_fwd=int8_rows[TRAIN_B]["ms"]
               / fwd[TRAIN_B]["ms"], tops=int8_rows[TRAIN_B]["tops"], h512=wide["int8"],
               h512_phase_shares=phases[("int8", "H512")]["shares"],
               h512_b8_phase_shares=phases[("int8", "H512 B=8")]["shares"],
               wide_fp=wide_int8, wide_fp_eval_launches=wide_int8["evaluate"]["int8_launches"],
               trained_wide_fp_launches=trained["int8"]["launches"],
               campaign_epoch119_launches=campaign["int8"]["launches"],
               launches_of="python -m rnet_torch.evaluate --rl-impl pallas_int8 --data-pipeline device "
                           "--split train --batch-size 512 (16 batches)"),
        record(pw.F32_KERNEL, "rnet_torch/csrc/pairwise_f32.cu", "rnet/kernels/pairwise.py:83",
               f32_entry_counts[pw.F32_KERNEL], f32_abs["out"], f32_rows[("fwd", TRAIN_B)], shape=shape,
               max_rel_err=f32_fwd_err, max_rel_err_all_cases=f32_fwd_err_all, precision="3xTF32",
               ms_over_library=f32_rows[("fwd", TRAIN_B)]["ms_over_library"], ms_b64=f32_rows[("fwd", 64)]["ms"],
               phase_shares=phases[("fwd_f32", TRAIN_B)]["shares"], step_launches=f32_step_counts[pw.F32_KERNEL],
               h512=wide["fwd_fp32"], h512_phase_shares=phases[("fwd_f32", "H512")]["shares"],
               wide_fp_step_launches=graph_out["wide_fp_steps"]["float32"]["pallas"]["launches_per_step"],
               trained_wide_fp_launches=trained["fp32"]["launches"],
               campaign_epoch119_launches=campaign["fp32"]["launches"],
               launches_of="python -m rnet_torch.train --precision float32 --rl-impl pallas --data-pipeline "
                           "device, 1 epoch of 16 steps at B=512 (16 train + 2 eval batches)"),
        record(pw.F32_BWD_KERNEL, "rnet_torch/csrc/pairwise_f32.cu", "rnet/kernels/pairwise.py:120",
               f32_entry_counts[pw.F32_BWD_KERNEL], max(v for k, v in f32_abs.items() if k != "out"),
               f32_rows[("bwd", TRAIN_B)], shape=shape, max_rel_err=f32_bwd_err, max_rel_err_all_cases=f32_bwd_err_all,
               precision="3xTF32", ms_over_library=f32_rows[("bwd", TRAIN_B)]["ms_over_library"],
               ms_b64=f32_rows[("bwd", 64)]["ms"], phase_shares=phases[("bwd_f32", TRAIN_B)]["shares"],
               train_loss_rel_diff_from_xla_fp32=f32_loss_rel, h512=wide["bwd_fp32"],
               stretch={k: v for k, v in stretch_bwd.items() if k.startswith("float32")},
               h512_phase_shares=phases[("bwd_f32", "H512")]["shares"],
               wide_fp_step_launches=graph_out["wide_fp_steps"]["float32"]["pallas"]["launches_per_step"],
               launches_of="python -m rnet_torch.train --precision float32 --rl-impl pallas --data-pipeline "
                           "device, 1 epoch of 16 steps at B=512"),
    ]
    log(f"graphs summary {json.dumps(graph_out)}")
    log(f"stretch-fp-32 summary {json.dumps({'steps': stretch, 'bwd': stretch_bwd, 'entry_point': stretch_cli})}")
    log(f"phase 13 summary {json.dumps(shard)}")
    log(f"phase 15 summary {json.dumps(trained)}")
    log(f"phase 17 summary {json.dumps(campaign)}")
    log(f"phase 16 summary {json.dumps(bench_out)}")
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == WORKER_FLAG:
        sys.exit(phase13_worker(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1] == WIDE_BATCH_FLAG:
        sys.exit(wide_batch_worker(sys.argv[2:]))
    sys.exit(main())
