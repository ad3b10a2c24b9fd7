"""ctypes bindings for the native image-ops library (port of
vlaser_tpu/image/native.py).

Resize (separable bicubic a = -0.5 or Lanczos-4), ImageNet normalization
and 448 px tile cropping in C++ (`native/image_ops.cpp`), threaded across
a batch. The library is built on first use into `vlaser_tpu_torch/_build/`
(native/build.py). Where the JAX package logs a warning and falls back to
PIL when g++ fails, the port raises: the card's machine has no PIL, and a
silent fallback would hide the missing library.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np

_lib = None
_lock = threading.Lock()

_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _load():
    """Build (if needed) and load the library once; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            from ..native.build import build

            lib = ctypes.CDLL(build())
            lib.resize_batch.argtypes = [
                _U8, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.normalize_batch.argtypes = [_U8, _F32, ctypes.c_longlong]
            lib.crop_tiles.argtypes = [_F32, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _F32]
            _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def resize_batch(
    images: np.ndarray,  # [N, H, W, 3] uint8
    size: Tuple[int, int],  # (oh, ow)
    mode: str = "bicubic",  # bicubic | lanczos
    normalize: bool = True,
) -> np.ndarray:
    """-> [N, oh, ow, 3] float32 (ImageNet-normalized when normalize)."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"resize_batch takes uint8 [N, H, W, 3], not "
                         f"{images.dtype} {images.shape}")
    oh, ow = size
    lib = _load()
    images = np.ascontiguousarray(images)
    n, h, w, _ = images.shape
    out = np.empty((n, oh, ow, 3), np.float32)
    lib.resize_batch(images.ctypes.data_as(_U8), n, h, w,
                     out.ctypes.data_as(_F32), oh, ow,
                     1 if mode == "lanczos" else 0, 1 if normalize else 0)
    return out


def normalize_batch(images: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] -> ImageNet-normalized float32."""
    lib = _load()
    images = np.ascontiguousarray(images)
    out = np.empty(images.shape, np.float32)
    npix = int(np.prod(images.shape[:-1]))
    lib.normalize_batch(images.ctypes.data_as(_U8), out.ctypes.data_as(_F32),
                        npix)
    return out


def tile_image(
    image: np.ndarray,  # [H, W, 3] uint8
    grid: Tuple[int, int],  # (cols, rows) from find_closest_aspect_ratio
    tile: int = 448,
    mode: str = "bicubic",
) -> np.ndarray:
    """Resize to the grid and crop tiles in one native pass ->
    [rows*cols, tile, tile, 3] normalized float32."""
    cols, rows = grid
    resized = resize_batch(image[None], (rows * tile, cols * tile), mode)[0]
    lib = _load()
    out = np.empty((rows * cols, tile, tile, 3), np.float32)
    resized = np.ascontiguousarray(resized)
    lib.crop_tiles(resized.ctypes.data_as(_F32), rows, cols, tile,
                   out.ctypes.data_as(_F32))
    return out
