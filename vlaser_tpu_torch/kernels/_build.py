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
              "-Xcompiler", "-fPIC")

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
    """Compile the sources if no library for their hash exists; -> path.
    One nvcc per source, all started together, then one link."""
    global last_build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = source_hash()
    out = BUILD_DIR / f"libvlaser_kernels_{tag}.so"
    if out.exists():
        last_build_seconds = 0.0
        return out
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for cu in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{cu.stem}_{tag}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
               str(cu)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (rc {proc.returncode}):\n{stderr[-8000:]}")
    tmp = out.with_suffix(f".{pid}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (rc {proc.returncode}):\n{proc.stderr[-8000:]}")
    last_build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


def ptxas_report(stem: str, log_text: str | None = None) -> list[dict]:
    """ptxas's -v lines for the kernels of csrc/<stem>.cu, from `log_text`
    or the last build's nvcc.log ([] without one): [{"kernel": mangled
    name, "registers": n, "spill_bytes": stores + loads, "stack": bytes}],
    plus {"warning": line} for each ptxas warning of that source and each
    note that it serialized wgmma instructions."""
    import re

    if log_text is None:
        path = BUILD_DIR / "nvcc.log"
        log_text = path.read_text() if path.exists() else ""
    log = log_text.split("\n")
    out, cur, inside = [], None, False
    for line in log:
        if line.startswith(("/", "nvcc")) or " -c -o " in line:
            inside = f"{stem}.cu" in line
            continue
        if not inside:
            continue
        if "ptxas warning" in line or "Performance Loss" in line:
            out.append({"warning": line.strip()})
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["stack"] = int(m.group(1))
            cur["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
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


def tmap_cache(enable: bool | None = None) -> dict:
    """The tensor-map cache that every TMA kernel shares (csrc/sm90.cuh):
    turn it on or off (off also empties it) when `enable` is given. ->
    {"hits", "misses", "maps", "on"}; hits and misses (encodes) count every
    map since the library was loaded."""
    fn = getattr(library(), "sm90_tmap_cache")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stats = (ctypes.c_longlong * 4)()
    check(fn(-1 if enable is None else int(enable), stats), "sm90_tmap_cache")
    return {"hits": stats[0], "misses": stats[1], "maps": stats[2],
            "on": bool(stats[3])}


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
