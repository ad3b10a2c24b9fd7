"""Host-side frame normalization of the VLA serving path
(`normalize_uint8` of vlaser_tpu/image/tiling.py, copied unchanged).
Dynamic-resolution tiling is not ported yet."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_uint8(frames: np.ndarray) -> np.ndarray:
    """uint8 [..., H, W, 3] camera frames -> ImageNet-normalized float32."""
    x = frames.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
