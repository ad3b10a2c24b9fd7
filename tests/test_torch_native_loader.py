"""The port's native threaded JPEG loader (vlaser_tpu_torch/data/
native_loader.py over its copy of native/dataloader.cpp) against the JAX
package's (vlaser_tpu/data/native_loader.py), on the JPEG fixtures
committed to the port (vlaser_tpu_torch/native/fixtures: a 4:3 scene, a
tall image, a one-channel JPEG) and on seeded noise JPEGs. Both packages
compile the same sources against the same libjpeg, so every output
is held bit for bit: the batch decode, probe_jpeg, load_image_tiles_native
(13 tiles for the 4:3 fixture at max_num 12), the async pipeline's ids
under backpressure, the PIL route of a non-JPEG file, and
ConversationDataset(use_native_loader=True). The decoded pixels against
the ones stored beside the fixtures are held to 1e-3 of a level (the
separable resample at the image's own size is not exactly the identity;
another libjpeg may differ by an IDCT rounding step)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vlaser_tpu.data import native_loader as jl
from vlaser_tpu_torch.data import native_loader as pl

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "vlaser_tpu_torch" / "native" / "fixtures"
NAMES = ("scene_4x3", "tall", "gray")


@pytest.fixture(scope="module")
def noise(tmp_path_factory):
    from PIL import Image

    assert jl.available() and pl.available()
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i in range(6):
        p = root / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (97 + i, 123, 3), np.uint8)).save(
            p, quality=95)
        paths.append(str(p))
    return root, paths


def test_fixtures_are_small_and_decode_to_their_pixels():
    total = sum(f.stat().st_size for f in FIX.iterdir() if f.is_file())
    assert total < 1 << 20, total
    for name in NAMES:
        path = str(FIX / f"{name}.jpg")
        want = np.load(FIX / f"{name}.npy")
        assert pl.probe_jpeg(path) == jl.probe_jpeg(path) == want.shape[:2]
        got = pl.load_image_batch([path], want.shape[:2], normalize=False)[0]
        assert np.array_equal(got, jl.load_image_batch(
            [path], want.shape[:2], normalize=False)[0])
        np.testing.assert_allclose(got, want.astype(np.float32), atol=1e-3)
        # control: the same pixels flipped left to right are far off
        assert np.abs(got - want[:, ::-1]).max() > 50


@pytest.mark.parametrize("mode", [pl.MODE_LANCZOS, pl.MODE_BICUBIC])
def test_batch_matches_jax(noise, mode):
    _, paths = noise
    paths = paths + [str(FIX / f"{n}.jpg") for n in NAMES]
    got = pl.load_image_batch(paths, (64, 80), mode=mode)
    assert got.shape == (9, 64, 80, 3)
    assert np.array_equal(got, jl.load_image_batch(paths, (64, 80),
                                                   mode=mode))


@pytest.mark.parametrize("name,tiles", [("scene_4x3", 13), ("tall", 3),
                                        ("gray", 13)])
def test_dynamic_tiles_match_jax(name, tiles):
    """load_image_tiles_native at max_num 12: the 4:3 fixture tiles 4 x 3
    plus a thumbnail, bit-equal to JAX's; two runs are bit-equal."""
    path = str(FIX / f"{name}.jpg")
    got = pl.load_image_tiles_native(path, 448, 1, 12)
    assert got.shape == (tiles, 448, 448, 3)
    assert np.array_equal(got, jl.load_image_tiles_native(path, 448, 1, 12))
    assert np.array_equal(got, pl.load_image_tiles_native(path, 448, 1, 12))
    flat = pl.load_image_tiles_native(path, 64, 1, 12, dynamic=False)
    assert np.array_equal(flat, jl.load_image_tiles_native(path, 64, 1, 12,
                                                           dynamic=False))


def test_async_pipeline_ids_and_backpressure(noise):
    """More jobs than the pipeline holds (capacity 2, 24 jobs): every id
    comes back once, each equal to JAX's synchronous decode of its file."""
    _, paths = noise
    loader = pl.NativeImageLoader(num_threads=2, capacity=2)
    try:
        for i in range(24):
            loader.submit(i, paths[i % len(paths)], (32, 32))
        got = {}
        for _ in range(24):
            jid, arr = loader.get(timeout_ms=30_000)
            assert jid not in got
            got[jid] = arr
        assert sorted(got) == list(range(24))
        assert loader.get(timeout_ms=10) is None
    finally:
        loader.close()
    want = jl.load_image_batch(paths, (32, 32))
    for jid, arr in got.items():
        assert np.array_equal(arr, want[jid % len(paths)]), jid


def test_a_non_jpeg_file_goes_through_pil(noise, tmp_path):
    from PIL import Image

    png = tmp_path / "x.png"
    Image.fromarray(np.random.default_rng(1).integers(
        0, 255, (50, 40, 3), np.uint8)).save(png)
    assert pl.probe_jpeg(str(png)) is None
    assert pl.load_image_tiles_native(str(png)) is None
    got = pl.load_image_batch([str(png), noise[1][0]], (32, 32))
    assert np.array_equal(got, jl.load_image_batch(
        [str(png), noise[1][0]], (32, 32)))
    loader = pl.NativeImageLoader(num_threads=1, capacity=4)
    try:
        loader.submit(7, str(png), (32, 32))
        jid, arr = loader.get()
    finally:
        loader.close()
    assert jid == 7 and np.array_equal(arr, got[0])


def _jsonl(root):
    row = {"image": str(FIX / "scene_4x3.jpg"), "conversations": [
        {"from": "human", "value": "<image>\nwhat is this?"},
        {"from": "gpt", "value": "a scene"}]}
    path = root / "d.jsonl"
    path.write_text(json.dumps(row) + "\n")
    return path


def test_dataset_native_loader_matches_jax(tmp_path):
    """ConversationDataset(use_native_loader=True) yields the JAX package's
    sample, array for array, bit for bit (the byte tokenizer)."""
    import vlaser_tpu.data.chat_dataset as jcd
    import vlaser_tpu_torch.data.chat_dataset as pcd
    from test_torch_data import _same, _toks

    path = _jsonl(tmp_path)
    out = []
    for mod, tok in zip((jcd, pcd), _toks()):
        cfg = mod.ChatDatasetConfig(
            jsonl_path=str(path), image_root=str(tmp_path), num_image_token=4,
            image_size=448, max_dynamic_patch=12, use_native_loader=True)
        out.append(mod.ConversationDataset(cfg, tok)[0])
    _same(out[0], out[1])
    assert out[1]["pixel_values"].shape == (13, 448, 448, 3)


_NO_PIL = """
import sys
sys.modules["PIL"] = None  # any import of PIL raises ImportError
from vlaser_tpu_torch.data.chat_dataset import (ChatDatasetConfig,
                                                ConversationDataset)
from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer
from vlaser_tpu_torch.utils.tools import ensure_special_tokens
tok = ByteTokenizer()
ensure_special_tokens(tok)
cfg = ChatDatasetConfig(jsonl_path=sys.argv[1], image_root="",
                        num_image_token=4, image_size=448,
                        max_dynamic_patch=12, use_native_loader=True)
s = ConversationDataset(cfg, tok)[0]
assert s["pixel_values"].shape == (13, 448, 448, 3), s["pixel_values"].shape
assert not [m for m, mod in sys.modules.items() if mod is not None
            and m.split(".")[0] in ("PIL", "jax", "vlaser_tpu")]
print("ok")
"""


def test_dataset_native_loader_needs_no_pil(tmp_path):
    """On a machine without PIL (the card's), a JSONL of JPEGs loads
    through the native loader; nothing imports PIL, jax or vlaser_tpu."""
    path = _jsonl(tmp_path)
    proc = subprocess.run([sys.executable, "-c", _NO_PIL, str(path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
