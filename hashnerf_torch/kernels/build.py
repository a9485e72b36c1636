"""Build hashnerf_torch/csrc/*.cu with nvcc and load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

`--fmad=false` keeps `a*b + c` as two roundings, as XLA and PyTorch compute
it, and fast math is never used: a contracted or approximate operation in
the voxel geometry can flip `floor` at a cell boundary (hash_encode.cu).

Libraries go into hashnerf_torch/build/ (git-ignored), named by a hash of
their source and of every header in csrc/ (`*.cuh`, which a source may
include), so an edited source or header is rebuilt and an unchanged one is
reused. The build happens at first use; `build_all` starts every nvcc at
once. A failed build raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("segment_accum", "hash_encode", "scatter_add", "packed_encode", "field_query")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

# Loaded libraries of this process, by source name.
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (Popen, tmp_path, final_path) or None."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> str:
    """Wait for one build; returns nvcc's output (ptxas register report)."""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, object]:
    """Build every library not yet built, all nvcc processes at once.

    Returns {"seconds": wall time, "logs": {name: nvcc output}}.
    """
    t0 = time.perf_counter()
    started = {n: _start_build(n) for n in names}
    logs = {n: _finish_build(n, s) for n, s in started.items() if s is not None}
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _start_build(name)
        if started is not None:
            _finish_build(name, started)
        lib = _LIBS[name] = ctypes.CDLL(library_path(name))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
