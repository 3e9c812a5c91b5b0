"""Build and load the port's CUDA kernels (no ``rnet`` counterpart: Pallas
kernels are compiled by JAX itself).

Each ``rnet_torch/csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``rnet_torch/_build/`` (listed in ``.gitignore``), then loaded with ctypes.
The library's file name carries a hash of the source, the headers of
``csrc/`` (``*.cuh``) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded. The build
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
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source_path(name), *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    """Compiler output of the last build (ptxas registers/smem per kernel)."""
    return os.path.join(BUILD_DIR, f"{name}.log")


def build(names: Iterable[str]) -> List[str]:
    """Compile every named source that has no current library, one nvcc per
    source, all started together. Returns the library paths."""
    names = list(names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if todo:
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for n in todo:
            out = library_path(n)
            tmp = f"{out}.{os.getpid()}.tmp"
            log = open(log_path(n), "w")
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(n)]
            procs.append((n, out, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for n, out, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)
            else:
                with open(log_path(n)) as f:
                    failed.append(f"{n}.cu (nvcc exit {rc}):\n{f.read()}")
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        (path,) = build([name])
        lib = _loaded[name] = ctypes.CDLL(path)
    return lib
