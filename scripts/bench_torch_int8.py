#!/usr/bin/env python3
"""Time rnet_torch's int8 g_theta forward at wide-fp's H=512, and compare two
checkouts of the repository on one NVIDIA GPU.

    python3 scripts/bench_torch_int8.py --tree DIR --out FILE.json
    python3 scripts/bench_torch_int8.py --compare OLD_DIR --out-dir DIR

The first form imports ``rnet_torch`` from DIR (a checkout of this
repository; the kernels are built there, under ``rnet_torch/_build``) and
measures it with this checkout's ``chip_smoke.py`` functions, on seeded
inputs folded by the tree's own ``quantize_int8``:

* agreement: the int8 kernel against ``pairwise_core_int8_reference`` at
  wide-fp's B = 1, 8 and 512 (n=64, H=512, L=4) and original-fp's B=512
  (H=256), within 1e-5 of max|plain| (``check_int8``'s bound), and the B=512
  launch at H=512 twice, bitwise;
* times (CUDA events; the buckets also replayed from a graph):
  ``time_int8_wide`` (B=512 beside its plain version, the ``torch._int_mm``
  chain, the bound and the core with its calibration; B=1 and 8), the int8
  kernel at original-fp's B=512 (row 4) and the bf16 forward at wide-fp's
  B=512 (row 1w);
* phase shares of the int8 kernel's phase-timing build at H=512, B=512
  and B=8 (``phase_breakdown_wide``);
* with ``cuobjdump`` on the PATH or under /usr/local/cuda/bin, the count of
  each SASS opcode in every int8 kernel function of the library.

It writes one JSON object to FILE. The second form runs OLD_DIR, this
checkout, this checkout, OLD_DIR in turn, each as its own process on the
same card, writes each run's JSON under DIR and prints one JSON object of
the four runs with the card's name and power limit (nvidia-smi). Numbers
are comparable only within one such call.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE = (512, 64, 512, 4)  # (B, n, H, L) of wide-fp's eval batch
ORIGINAL = (512, 64, 256, 4)  # original-fp's


def _smoke():
    """This checkout's chip_smoke.py as a module (its functions import
    ``rnet_torch`` by name, so they time whichever tree is first on sys.path)."""
    spec = importlib.util.spec_from_file_location("bench_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_opcodes(lib_path: str):
    """{kernel function: {opcode: count}} of the int8 kernels in a built
    library, from ``cuobjdump -sass``; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn is not None:
            out[fn][m.group(1)] += 1
    return {f: dict(c.most_common()) for f, c in out.items() if "int8" in f}


def agreement(torch, smoke, pw, B, n, H, L, seed):
    """max |kernel - plain| at (B, n, H, L), held to 1e-5 of max|plain|;
    returns (err, max|plain|)."""
    args = [a.contiguous() for a in smoke.pair_inputs(torch, B, n, H, L, seed=seed)]
    folded = pw.quantize_int8(*args, 0)
    out = pw.pairwise_fwd_int8_cuda(*folded, inject=0)
    ref = pw.pairwise_core_int8_reference(*folded, inject=0)
    torch.cuda.synchronize()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    if not (torch.isfinite(out).all() and err <= 1e-5 * scale):
        raise RuntimeError(f"pairwise_fwd_int8 disagrees with its plain version at B={B} H={H}: {err} of {scale}")
    if B == WIDE[0] and H == WIDE[2] and not torch.equal(out, pw.pairwise_fwd_int8_cuda(*folded, inject=0)):
        raise RuntimeError(f"pairwise_fwd_int8 at B={B} H={H} is not bitwise repeatable")
    return err, scale


def run_tree(tree: str, out: str) -> int:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_int8: torch.cuda.is_available() is False: this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smoke = _smoke()
    from rnet_torch.kernels import build
    from rnet_torch.kernels import pairwise as pw

    if not pw.__file__.startswith(tree):
        raise RuntimeError(f"rnet_torch came from {pw.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build([pw.INT8_KERNEL, pw.KERNEL])
    build.build([pw.INT8_KERNEL], pw.PHASE_DEFINES)
    result = {"tree": tree, "card": smoke.card_line(), "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "build_s": time.perf_counter() - t0}
    with open(build.log_path(pw.INT8_KERNEL)) as f:
        result["ptxas"] = [ln.strip() for ln in f if "registers" in ln or "C75" in ln or "spill" in ln]
    result["agreement"] = {f"B={B} H={H}": agreement(torch, smoke, pw, B, n, H, L, seed=900 + B)
                           for B, n, H, L in ((1, 64, 512, 4), (8, 64, 512, 4), WIDE, ORIGINAL)}
    B, n, H, L = WIDE
    args = smoke.pair_inputs(torch, B, n, H, L, seed=700)
    result["int8_h512"] = smoke.time_int8_wide(torch, pw, args)
    result["fwd_bf16_h512_ms"] = smoke.cuda_ms(torch, lambda: pw.pairwise_fwd_cuda(*args, inject=0), 5, warmup=1)
    del args
    B, n, H, L = ORIGINAL
    args = smoke.pair_inputs(torch, B, n, H, L, seed=400 + B)
    folded = pw.quantize_int8(*args, 0)
    result["int8_h256_ms"] = smoke.cuda_ms(torch, lambda: pw.pairwise_fwd_int8_cuda(*folded, inject=0), 20)
    result["int8_h256_plan"] = smoke.plan_fields(pw.tile_plan("int8", B, n, n, H, L))
    del args, folded
    torch.cuda.empty_cache()
    phases = smoke.phase_breakdown_wide(torch, pw, kinds=(("int8", 1, WIDE[0]), ("int8", 1, 8)))
    result["phases"] = {" ".join(map(str, k)): v for k, v in phases.items()}
    result["sass"] = sass_opcodes(build.library_path(pw.INT8_KERNEL))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k not in ("sass", "ptxas")}))
    return 0


def compare(old: str, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for k, (tag, tree) in enumerate((("old", old), ("new", HERE), ("new", HERE), ("old", old))):
        out = os.path.join(out_dir, f"run{k}_{tag}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree, "--out", out]
        t0 = time.perf_counter()
        rc = subprocess.run(cmd).returncode
        print(f"run {k} ({tag}, {tree}): exit {rc} in {time.perf_counter() - t0:.1f} s", flush=True)
        if rc != 0:
            return rc
        with open(out) as f:
            runs.append({"tag": tag, **json.load(f)})
    summary = {"card": runs[0]["card"], "order": [r["tag"] for r in runs],
               "runs": [{k: v for k, v in r.items() if k not in ("sass", "ptxas")} for r in runs]}
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", help="the checkout whose rnet_torch is timed")
    p.add_argument("--out", help="JSON file of one run")
    p.add_argument("--compare", metavar="OLD_DIR", help="run OLD_DIR, this checkout, this checkout, OLD_DIR")
    p.add_argument("--out-dir", default=os.path.join(HERE, "rnet_torch", "_build", "bench_int8"),
                   help="where --compare writes each run's JSON")
    args = p.parse_args(argv)
    if args.compare:
        return compare(args.compare, args.out_dir)
    if not (args.tree and args.out):
        p.error("--tree and --out, or --compare")
    return run_tree(args.tree, args.out)


if __name__ == "__main__":
    sys.exit(main())
