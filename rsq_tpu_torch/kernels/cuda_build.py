"""Build the CUDA sources in rsq_tpu_torch/csrc with nvcc and load them
with ctypes (plain C entry points; no PyTorch headers, so each source
compiles in seconds).

Each source becomes its own shared library, keyed by a hash of its text
and the shared headers' (csrc/*.cuh), in rsq_tpu_torch/_build/ (ignored by
git).  `build()` starts one nvcc per missing library, all at once, and
waits for them; `load(name)` builds on first use.  Nothing here runs at
import time.

Flags: sm_90a, -O3, and never --use_fast_math -- the kernels need IEEE
division and round-half-even to reproduce the reference's integer codes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {
    "w4a4_matmul": "w4a4_matmul.cu",
    "w8_matmul": "w8_matmul.cu",
    "decode_prep": "decode_prep.cu",
    "paged_attention": "paged_attention.cu",
    "contiguous_attention": "contiguous_attention.cu",
    "bf16_attention": "bf16_attention.cu",
    "w16_matmul": "w16_matmul.cu",
    "w4_matmul": "w4_matmul.cu",
    "launch_floor": "launch_floor.cu",    # an empty kernel, timed as a yardstick
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def _lib_path(name: str) -> Path:
    # the headers are part of every source's key: a source may include them
    text = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> float:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc process each, in parallel.  Returns the wall seconds taken; raises
    with nvcc's output if any compile fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for n, out, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            failed.append(f"--- {SOURCES[n]} (rc {p.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source `name`, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """The C launcher `symbol` of library `name` (returns cudaError_t as
    int), with its argument types declared once."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _fns[(name, symbol)] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
