"""Build the native image libraries (port of vlaser_tpu/native/build.py).

`build()` compiles `image_ops.cpp` (resize, normalize, tile crop) and
`build_dataloader()` compiles `dataloader.cpp` (the threaded JPEG loader,
linking `-ljpeg`), with the JAX package's g++ flags. The libraries land in
`vlaser_tpu_torch/_build/` (git-ignored), named by a hash of the sources
and the command, so a changed source gets a new library and a stale one is
never loaded. A build runs under an exclusive file lock in that directory
and writes to a temporary name first, then `os.replace`s it into place, so
processes that build at once (test workers) each end with a whole library.
A compiler failure raises with g++'s stderr; nothing falls back. Nothing
here runs at import time.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "image_ops.cpp"
DL_SRC = HERE / "dataloader.cpp"
BUILD_DIR = HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_lock = threading.Lock()


def _build(stem: str, sources, libs=()) -> str:
    """g++ the first of `sources` (the rest are the files it includes) into
    BUILD_DIR/lib<stem>_<hash>.so unless that file exists; -> its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"lib{stem}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.exists():  # another process built it while we waited
                return str(out)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, str(sources[0]), "-o", str(tmp), *libs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed (rc {proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stderr[-8000:]}")
            os.replace(tmp, out)
    return str(out)


def build() -> str:
    """The image-ops library (resize_batch, normalize_batch, crop_tiles)."""
    return _build("image_ops", (SRC,))


def build_dataloader() -> str:
    """The threaded JPEG decode + resize loader (links libjpeg)."""
    return _build("dataloader", (DL_SRC, SRC), ("-ljpeg",))


def jpeg_toolchain() -> dict:
    """Whether this machine can build the JPEG half: {"gxx": g++'s version
    line or None, "jpeglib_h": the header compiles, "libjpeg": a program
    using it links with -ljpeg}."""
    import shutil
    import tempfile

    if shutil.which("g++") is None:
        return {"gxx": None, "jpeglib_h": False, "libjpeg": False}
    ver = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    probe = ("#include <cstdio>\n#include <jpeglib.h>\n"
             "int main() { jpeg_decompress_struct c; jpeg_create_decompress(&c);"
             " jpeg_destroy_decompress(&c); return 0; }\n")
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "probe.cpp"
        src.write_text(probe)
        header = subprocess.run(["g++", "-fsyntax-only", str(src)],
                                capture_output=True).returncode == 0
        linked = header and subprocess.run(
            ["g++", str(src), "-o", str(Path(d) / "probe"), "-ljpeg"],
            capture_output=True).returncode == 0
    return {"gxx": ver, "jpeglib_h": header, "libjpeg": linked}
