"""Host-side image preprocessing: dynamic-resolution tiling and
normalization (a copy of vlaser_tpu/image/tiling.py; numpy, with PIL
imported inside the functions that take a PIL image, so that importing
this module needs no PIL).

Parity surface: internvl/train/dataset.py -- find_closest_aspect_ratio
(:813), dynamic_preprocess (:830-866: the best (i, j) grid with i * j <=
max_num, 448 px tiles and an optional thumbnail), build_transform (:276:
bicubic resize and ImageNet normalization). Tiles leave as one [T, H, W, 3]
float32 array (NHWC), the layout the port's ViT takes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def find_closest_aspect_ratio(
    aspect_ratio: float,
    target_ratios: Sequence[Tuple[int, int]],
    width: int,
    height: int,
    image_size: int,
) -> Tuple[int, int]:
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def candidate_ratios(min_num: int, max_num: int) -> List[Tuple[int, int]]:
    ratios = {
        (i, j)
        for n in range(min_num, max_num + 1)
        for i in range(1, n + 1)
        for j in range(1, n + 1)
        if min_num <= i * j <= max_num
    }
    return sorted(ratios, key=lambda r: r[0] * r[1])


def dynamic_preprocess(
    image,
    min_num: int = 1,
    max_num: int = 12,
    image_size: int = 448,
    use_thumbnail: bool = False,
):
    """PIL image -> list of PIL 448px tiles (+ thumbnail when >1 tile)."""
    from PIL import Image

    width, height = image.size
    aspect_ratio = width / height
    ratios = candidate_ratios(min_num, max_num)
    i, j = find_closest_aspect_ratio(aspect_ratio, ratios, width, height, image_size)
    target_w, target_h = image_size * i, image_size * j
    blocks = i * j
    resized = image.resize((target_w, target_h))
    tiles = []
    cols = target_w // image_size
    for idx in range(blocks):
        box = (
            (idx % cols) * image_size,
            (idx // cols) * image_size,
            ((idx % cols) + 1) * image_size,
            ((idx // cols) + 1) * image_size,
        )
        tiles.append(resized.crop(box))
    if use_thumbnail and len(tiles) != 1:
        tiles.append(image.resize((image_size, image_size)))
    return tiles


def to_array(image, image_size: int = 448, normalize: bool = True) -> np.ndarray:
    """PIL -> [H, W, 3] float32, bicubic-resized, ImageNet-normalized."""
    from PIL import Image

    if image.mode != "RGB":
        image = image.convert("RGB")
    if image.size != (image_size, image_size):
        image = image.resize((image_size, image_size), Image.BICUBIC)
    arr = np.asarray(image, np.float32) / 255.0
    if normalize:
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr


def load_image_tiles(
    image,
    image_size: int = 448,
    min_num: int = 1,
    max_num: int = 12,
    use_thumbnail: bool = True,
    dynamic: bool = True,
) -> np.ndarray:
    """Full pipeline: PIL -> [T, H, W, 3] normalized tile batch (NHWC)."""
    if image.mode != "RGB":
        image = image.convert("RGB")
    if dynamic:
        tiles = dynamic_preprocess(
            image, min_num=min_num, max_num=max_num, image_size=image_size,
            use_thumbnail=use_thumbnail,
        )
    else:
        tiles = [image]
    return np.stack([to_array(t, image_size) for t in tiles], axis=0)


def normalize_uint8(frames: np.ndarray) -> np.ndarray:
    """uint8 [..., H, W, 3] camera frames -> ImageNet-normalized float32
    (VLA serving path; processing.py:303-311)."""
    x = frames.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def simulate_jpeg_degradation(image, quality_range=(75, 100), rng=None):
    """Train-time JPEG round-trip augmentation
    (internvl/train/dataset.py:261-275 simulate_jpeg_degradation): re-encode
    the PIL image at a random quality."""
    import io
    import random as _random

    from PIL import Image

    rng = rng or _random
    quality = rng.randint(*quality_range)
    buf = io.BytesIO()
    image.convert("RGB").save(buf, format="JPEG", quality=quality)
    buf.seek(0)
    return Image.open(buf).convert("RGB")
