"""The native threaded image loader (port of
vlaser_tpu/data/native_loader.py; ctypes over native/dataloader.cpp).

A C++ worker pool reads, JPEG-decodes (libjpeg), resizes (Lanczos-4 or
bicubic) and ImageNet-normalizes images outside the GIL, so Python threads
stay free for tokenization, packing and device dispatch.

Two surfaces:
  load_image_batch(paths, size)   — synchronous batch decode (threaded in C++)
  NativeImageLoader.submit/get    — async pipeline with backpressure
A file the C++ cannot decode (status -2, a non-JPEG; or -1, unreadable)
goes through PIL, imported in that branch only, as in JAX: on a machine
without PIL (the card's) that raises ImportError. The library builds on
first use into vlaser_tpu_torch/_build/ and raises if g++ or libjpeg is
missing.
"""

from __future__ import annotations

import atexit
import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_lib = None
_lock = threading.Lock()
_F32 = ctypes.POINTER(ctypes.c_float)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            from ..native.build import build_dataloader

            lib = ctypes.CDLL(build_dataloader())
            lib.dl_create.restype = ctypes.c_void_p
            lib.dl_create.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.dl_destroy.argtypes = [ctypes.c_void_p]
            lib.dl_submit.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.dl_try_submit.restype = ctypes.c_int
            lib.dl_try_submit.argtypes = lib.dl_submit.argtypes
            lib.dl_probe.restype = ctypes.c_int
            lib.dl_probe.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
            lib.dl_next.restype = ctypes.c_int
            lib.dl_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int), _F32, ctypes.c_longlong,
                ctypes.c_int]
            lib.dl_decode_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _F32, ctypes.POINTER(ctypes.c_int)]
            _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


MODE_BICUBIC = 0
MODE_LANCZOS = 1


def _pil_fallback(path: str, size: Tuple[int, int], normalize: bool):
    from PIL import Image

    from ..image.tiling import normalize_uint8

    img = np.asarray(
        Image.open(path).convert("RGB").resize((size[1], size[0]),
                                               Image.LANCZOS),
        np.uint8)
    if normalize:
        return normalize_uint8(img[None])[0].astype(np.float32)
    return img.astype(np.float32)


class NativeImageLoader:
    """Async decode pipeline: submit(job_id, path) then get() results."""

    def __init__(self, num_threads: int = 4, capacity: int = 32):
        self._lib = _load()
        self._h = self._lib.dl_create(num_threads, capacity)
        self._paths, self._pending = {}, []

    def close(self):
        if self._h is not None:
            self._lib.dl_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def submit(self, job_id: int, path: str, size: Tuple[int, int],
               mode: int = MODE_LANCZOS, normalize: bool = True):
        """Never blocks: jobs beyond the native pipeline's capacity are
        buffered here and flushed as get() drains results."""
        self._size, self._norm, self._mode = size, normalize, mode
        self._paths[job_id] = path
        self._pending.append((job_id, path))
        self._flush()

    def _flush(self):
        while self._pending:
            job_id, path = self._pending[0]
            if not self._lib.dl_try_submit(
                    self._h, job_id, path.encode(), self._size[0],
                    self._size[1], self._mode, int(self._norm)):
                break
            self._pending.pop(0)

    def get(self, timeout_ms: int = 60_000
            ) -> Optional[Tuple[int, np.ndarray]]:
        oh, ow = self._size
        buf = np.empty((oh, ow, 3), np.float32)
        jid, status = ctypes.c_longlong(), ctypes.c_int()
        got = self._lib.dl_next(self._h, ctypes.byref(jid),
                                ctypes.byref(status),
                                buf.ctypes.data_as(_F32), buf.size,
                                timeout_ms)
        self._flush()
        if not got:
            return None
        path = self._paths.pop(jid.value)
        if status.value != 0:  # non-JPEG or IO error -> PIL
            return jid.value, _pil_fallback(path, (oh, ow), self._norm)
        return jid.value, buf


def probe_jpeg(path: str) -> Optional[Tuple[int, int]]:
    """(h, w) from the JPEG header only, None for non-JPEG/unreadable."""
    lib = _load()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.dl_probe(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def load_image_tiles_native(
    path: str,
    image_size: int = 448,
    min_num: int = 1,
    max_num: int = 12,
    use_thumbnail: bool = True,
    dynamic: bool = True,
) -> Optional[np.ndarray]:
    """Native dynamic-resolution tiling: probe dims -> grid -> one bicubic
    resize + normalize to (gh*S, gw*S) in C++ -> numpy tile crop (+ the
    thumbnail), as image/tiling.dynamic_preprocess + to_array. None for a
    non-JPEG input (the caller takes the PIL path)."""
    from ..image.tiling import candidate_ratios, find_closest_aspect_ratio

    dims = probe_jpeg(path)
    if dims is None:
        return None
    h, w = dims
    if not dynamic:
        return load_image_batch([path], (image_size, image_size),
                                mode=MODE_BICUBIC)
    ratios = candidate_ratios(min_num, max_num)
    gw, gh = find_closest_aspect_ratio(w / h, ratios, w, h, image_size)
    jobs = [(gh * image_size, gw * image_size)]
    if use_thumbnail and gw * gh != 1:
        jobs.append((image_size, image_size))
    outs = [load_image_batch([path], size, mode=MODE_BICUBIC)[0]
            for size in jobs]
    s = image_size
    tiles = (outs[0].reshape(gh, s, gw, s, 3).transpose(0, 2, 1, 3, 4)
             .reshape(gh * gw, s, s, 3))
    if len(outs) > 1:
        tiles = np.concatenate([tiles, outs[1][None]], axis=0)
    return np.ascontiguousarray(tiles)


_shared: Optional[NativeImageLoader] = None


def _close_shared():  # registered at first use; joins the C++ worker pool
    global _shared
    if _shared is not None:
        _shared.close()
        _shared = None


def load_image_batch(
    paths: Sequence[str], size: Tuple[int, int],
    mode: int = MODE_LANCZOS, normalize: bool = True,
) -> np.ndarray:
    """[N, H, W, 3] float32 — threaded C++ decode of a path batch, with
    a PIL decode for each non-JPEG input."""
    global _shared
    lib = _load()
    if _shared is None:
        _shared = NativeImageLoader()
        atexit.register(_close_shared)
    n = len(paths)
    oh, ow = size
    out = np.empty((n, oh, ow, 3), np.float32)
    statuses = (ctypes.c_int * n)()
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.dl_decode_batch(_shared._h, arr, n, oh, ow, mode, int(normalize),
                        out.ctypes.data_as(_F32), statuses)
    for i in range(n):
        if statuses[i] != 0:
            out[i] = _pil_fallback(paths[i], size, normalize)
    return out
