"""Build and load the port's CUDA kernels (no ``rnet`` counterpart: Pallas
kernels are compiled by JAX itself).

Each ``rnet_torch/csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``rnet_torch/_build/`` (listed in ``.gitignore``), then loaded with ctypes.
The library's file name carries a hash of the source, the headers of
``csrc/`` (``*.cuh``), the flags and the compile-time defines (``-D``; the
phase-timing build of the pairwise kernels is one), so an edited source or
header is rebuilt, a variant never stands in for another, and a stale
library is never loaded. The build
happens at first use, inside the process that needs it; ``build`` starts one
``nvcc`` per source, all at once. A missing toolkit or a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of rnet_torch are "
        "built from source with the CUDA toolkit at first use"
    )


def _define_flags(defines: Sequence[str]) -> List[str]:
    return [f"-D{d}" for d in defines]


def library_path(name: str, defines: Sequence[str] = ()) -> str:
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *_define_flags(defines)]).encode())
    for path in [source_path(name), *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def log_path(name: str, defines: Sequence[str] = ()) -> str:
    """Compiler output of the last build (ptxas registers/smem per kernel)."""
    tag = "".join(f"-{d}" for d in defines)
    return os.path.join(BUILD_DIR, f"{name}{tag}.log")


def build(names: Iterable[str], defines: Sequence[str] = ()) -> List[str]:
    """Compile every named source that has no current library (with the
    compile-time `defines`), one nvcc per source, all started together.
    Returns the library paths."""
    names = list(names)
    todo = [n for n in names if not os.path.exists(library_path(n, defines))]
    if todo:
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for n in todo:
            out = library_path(n, defines)
            tmp = f"{out}.{os.getpid()}.tmp"
            log = open(log_path(n, defines), "w")
            cmd = [nvcc, *NVCC_FLAGS, *_define_flags(defines), "-o", tmp, source_path(n)]
            procs.append((n, out, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for n, out, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)
            else:
                with open(log_path(n, defines)) as f:
                    failed.append(f"{n}.cu (nvcc exit {rc}):\n{f.read()}")
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return [library_path(n, defines) for n in names]


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with `defines`, built
    first if needed."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        (path,) = build([name], defines)
        lib = _loaded[key] = ctypes.CDLL(path)
    return lib
