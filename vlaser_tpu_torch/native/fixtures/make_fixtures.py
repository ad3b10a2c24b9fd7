"""Make the JPEG fixtures of the native loader's tests and chip phase.

    python -m vlaser_tpu_torch.native.fixtures.make_fixtures

Writes, beside this file, three seeded JPEGs and each one's pixels as PIL
decodes them (uint8 [H, W, 3] .npy): `scene_4x3.jpg` (320 x 240, which
tiles into a 4 x 3 grid at max_num 12), `tall.jpg` (160 x 288) and
`gray.jpg` (a one-channel JPEG, 128 x 96). The images are smooth gradients
with a few discs and mild noise, so that the files stay small. Needs PIL;
the files are committed, so the machines that read them need none.
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = (("scene_4x3", 240, 320, "RGB"), ("tall", 288, 160, "RGB"),
            ("gray", 96, 128, "L"))


def _image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([255 * x / w, 255 * y / h,
                    127 + 100 * np.sin((x + y) / 23.0)], -1)
    for _ in range(5):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 40)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    from PIL import Image

    rng = np.random.default_rng(17)
    for name, h, w, mode in FIXTURES:
        img = Image.fromarray(_image(rng, h, w))
        if mode == "L":
            img = img.convert("L")
        path = os.path.join(HERE, name + ".jpg")
        img.save(path, quality=90)
        pixels = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        np.save(os.path.join(HERE, name + ".npy"), pixels)
        print(name, pixels.shape, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
