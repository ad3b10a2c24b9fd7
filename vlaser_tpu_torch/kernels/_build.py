"""Build the port's CUDA kernels (`vlaser_tpu_torch/csrc/*.cu`) into one
shared library with a plain C interface, and load it with ctypes.

nvcc compiles for `sm_90a` (Hopper). The library lands in
`vlaser_tpu_torch/_build/` (git-ignored), named by a hash of the sources,
so it is rebuilt only when a source changes. Every C entry point returns
`cudaGetLastError()`; `check()` turns a non-zero code into an exception.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def build() -> Path:
    """Compile the sources if no library for their hash exists; -> path."""
    global last_build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libvlaser_kernels_{source_hash()}.so"
    if out.exists():
        last_build_seconds = 0.0
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cus = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), *cus]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc {proc.returncode}):\n{proc.stderr[-8000:]}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """Build on first use and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def bind(name: str, n_ptr: int, tail: tuple) -> ctypes._CFuncPtr:
    """C function `name`: `n_ptr` pointer args, then the ctypes types in
    `tail` (the stream pointer last). Returns int (a cudaError_t)."""
    fn = getattr(library(), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + list(tail)
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
