"""The port's native image ops (vlaser_tpu_torch/image/native.py over its
copy of native/image_ops.cpp) against the JAX package's
(vlaser_tpu/image/native.py): both compile the same source with the same
g++ flags where the tests run, so every output is held bit for bit. Plus the
port's build (native/build.py): its libraries land in
vlaser_tpu_torch/_build/, two processes that build at once both end with a
loadable library, and a compiler failure raises with g++'s message."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vlaser_tpu.image import native as jn
from vlaser_tpu.image.tiling import IMAGENET_MEAN, IMAGENET_STD
from vlaser_tpu_torch.image import native as pn
from vlaser_tpu_torch.native import build as pbuild

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def libs():
    if not jn.available():
        pytest.fail("the JAX package's native image ops did not build")
    pn._load()


def _img(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_normalize_matches_jax_and_numpy():
    x = _img(0, 2, 8, 8, 3)
    got = pn.normalize_batch(x)
    assert np.array_equal(got, jn.normalize_batch(x))
    want = (x.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["bicubic", "lanczos"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("src,dst", [((64, 96), (32, 48)),
                                     ((30, 40), (77, 51)),
                                     ((32, 32), (32, 32))])
def test_resize_batch_matches_jax(mode, normalize, src, dst):
    x = _img(1, 3, *src, 3)
    got = pn.resize_batch(x, dst, mode=mode, normalize=normalize)
    assert got.shape == (3, *dst, 3) and got.dtype == np.float32
    assert np.array_equal(got, jn.resize_batch(x, dst, mode=mode,
                                               normalize=normalize))
    if src == dst and not normalize and mode == "bicubic":
        np.testing.assert_allclose(got, x.astype(np.float32), atol=1e-3)


@pytest.mark.parametrize("grid", [(2, 1), (3, 2), (1, 1)])
def test_tile_image_matches_jax(grid):
    x = _img(4, 64, 128, 3)
    got = pn.tile_image(x, grid=grid, tile=32)
    cols, rows = grid
    assert got.shape == (cols * rows, 32, 32, 3)
    assert np.array_equal(got, jn.tile_image(x, grid=grid, tile=32))
    resized = pn.resize_batch(x[None], (rows * 32, cols * 32))[0]
    assert np.array_equal(got[-1], resized[-32:, -32:])


def test_the_build_writes_under_the_port_only():
    path = Path(pbuild.build())
    assert path.parent == REPO / "vlaser_tpu_torch" / "_build"
    assert path.name.startswith("libimage_ops_") and path.suffix == ".so"


_BUILD = ("import sys; from pathlib import Path; "
          "from vlaser_tpu_torch.native import build as b; "
          "b.BUILD_DIR = Path(sys.argv[1]); import ctypes; "
          "p = b.build(); ctypes.CDLL(p).resize_batch; print(p)")


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two interpreters build into one empty directory at the same moment:
    each ends with a whole library it can load (the lock and the rename
    keep a half-written file from ever carrying the final name), and only
    that one library is left there."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert sorted(f.name for f in tmp_path.glob("*.so")) == [
        Path(paths.pop()).name]
    assert not list(tmp_path.glob("*.tmp"))


def test_a_compiler_failure_raises_with_its_message(tmp_path, monkeypatch):
    bad = tmp_path / "image_ops.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(pbuild, "SRC", bad)
    monkeypatch.setattr(pbuild, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        pbuild.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "out").glob("*.so"))
