"""The port's QA generation CLI (vlaser_tpu_torch/scripts/generate_qa.py)
on the CPU: every JAX flag accepted, the frame reader over an HDF5 episode
and an image directory, the one-tile identity the card's phases rest on,
the generate functions answering as the JAX VlaserChat / EngineChat on the
same tiles (tiny_vlm at fp32, the same weights through
utils/convert.from_jax_variables, greedy: token-identical), `main` end to
end under --tiny --device cpu, and the refusal without a card."""

import argparse
import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu_torch.scripts import generate_qa

from test_chat_and_configs import ToyTok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_arguments():
    """{flag: {keyword: value}} of every add_argument in the JAX CLI."""
    with open(os.path.join(REPO, "scripts", "generate_qa.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords
                  if k.arg != "help"}
            out[node.args[0].value] = kw
    return out


def test_parser_takes_every_jax_flag():
    jax_args = _jax_arguments()
    acts = {a.option_strings[0]: a for a in
            generate_qa.build_parser()._actions if a.option_strings}
    assert set(acts) - set(jax_args) == {"-h", "--tiny", "--device"}
    for flag, kw in jax_args.items():
        act = acts[flag]
        if flag == "--model_path":  # --tiny needs none
            assert kw["required"] == "True" and act.default is None
            continue
        assert act.required == (kw.get("required") == "True"), flag
        if "default" in kw:
            assert act.default == ast.literal_eval(kw["default"]), flag
        if "choices" in kw:
            assert list(act.choices) == list(
                ast.literal_eval(kw["choices"])), flag
        if "type" in kw:
            assert act.type.__name__ == kw["type"], flag
        if kw.get("action") == "'store_true'":
            assert isinstance(act, argparse._StoreTrueAction), flag


def _args(root, **kw):
    base = dict(episodes_dir=str(root), max_frames=1000, engine=False,
                offline=False, kind="general")
    base.update(kw)
    return argparse.Namespace(**base)


def test_frames_from_hdf5_episodes_and_images(tmp_path):
    h5py = pytest.importorskip("h5py")
    from PIL import Image

    rng = np.random.default_rng(0)
    eps = tmp_path / "eps" / "sub"
    eps.mkdir(parents=True)
    clips = []
    for i, (n, instr) in enumerate(((23, b"stack the cups"),
                                    (11, "open the drawer"))):
        clip = rng.integers(0, 256, (n, 6, 8, 3), np.uint8)
        clips.append((clip, instr))
        with h5py.File(eps / f"ep{i}.hdf5", "w") as h:
            h.attrs["instruction"] = instr
            h["observations/head_camera"] = clip
    got = list(generate_qa.frames(_args(tmp_path / "eps")))
    want = [(c[t], i.decode() if isinstance(i, bytes) else i)
            for c, i in clips for t in range(0, c.shape[0], 10)]
    assert len(got) == len(want) == 5
    for g, (img, instr) in zip(got, want):
        np.testing.assert_array_equal(g["image"], img)
        assert g["instruction"] == instr
    assert len(list(generate_qa.frames(_args(tmp_path / "eps",
                                             max_frames=4)))) == 4

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    pics = {}
    for name in ("b.png", "a.jpg", "c.png"):
        arr = rng.integers(0, 256, (5, 7, 3), np.uint8)
        Image.fromarray(arr).save(imgs / name)
        pics[name] = np.asarray(Image.open(imgs / name).convert("RGB"))
    got = list(generate_qa.frames(_args(imgs, max_frames=2)))
    assert [g["instruction"] for g in got] == ["complete the task"] * 2
    for g, name in zip(got, ("a.jpg", "b.png")):
        np.testing.assert_array_equal(g["image"], pics[name])
    assert list(generate_qa.frames(_args(tmp_path / "none"))) == []


def test_one_tile_at_the_vit_size_is_normalize_uint8():
    """The card's phases hand 448 x 448 frames to frame_tiles, which then
    skips PIL: the tiles equal load_image_tiles' (both packages')."""
    from PIL import Image

    from vlaser_tpu.image.tiling import load_image_tiles as jtiles
    from vlaser_tpu_torch.image.tiling import load_image_tiles, normalize_uint8

    frame = np.random.default_rng(1).integers(0, 256, (448, 448, 3),
                                              np.uint8)
    kw = dict(max_num=1, use_thumbnail=False, dynamic=False)
    want = load_image_tiles(Image.fromarray(frame), 448, **kw)
    np.testing.assert_array_equal(want, normalize_uint8(frame)[None])
    np.testing.assert_array_equal(
        want, jtiles(Image.fromarray(frame), 448, **kw))
    np.testing.assert_array_equal(generate_qa.frame_tiles(frame, 448), want)
    odd = frame[:300, :200]
    np.testing.assert_array_equal(
        generate_qa.frame_tiles(odd, 448),
        load_image_tiles(Image.fromarray(odd), 448, **kw))


@pytest.fixture(scope="module")
def models():
    """tiny_vlm at fp32: the JAX model and variables, the port's model
    with the same weights."""
    from vlaser_tpu.core.config import tiny_vlm
    from vlaser_tpu.models.vlm import InternVLChatModel as JaxModel
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.utils.convert import from_jax_variables

    cfg = tiny_vlm()
    jm = JaxModel(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    rng = np.random.default_rng(0)
    npt = cfg.num_image_token
    ids = rng.integers(1, 400, (1, 8 + npt))
    ids[0, 2:2 + npt] = cfg.img_context_token_id
    img = cfg.vision.image_size
    px = rng.standard_normal((1, img, img, 3)).astype(np.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                         jnp.asarray(px), jnp.asarray([1], np.int32))
    tm = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(jax.tree_util.tree_map(np.asarray, v)))
    return cfg, jm, v, tm


def _jax_tiles(images, size):
    """The JAX CLI's tiling: load_image_tiles of each frame, one tile."""
    from PIL import Image

    from vlaser_tpu.image.tiling import load_image_tiles

    return [load_image_tiles(Image.fromarray(img), size, max_num=1,
                             use_thumbnail=False, dynamic=False)
            for img in images]


def test_generate_fns_answer_as_the_jax_chats(models):
    """VlaserChat route: one chat a prompt; --engine: one batch_chat over
    the batch; --engine --kind all: batch_chat_shared_image over a frame;
    each token-identical (greedy fp32) to the JAX backend on the JAX CLI's
    tiles. One frame is off the ViT's size (PIL tiling), the rest on it."""
    from vlaser_tpu.inference.chat import VlaserChat as JaxChat
    from vlaser_tpu.serve.engine_chat import EngineChat as JaxEngineChat

    cfg, jm, v, tm = models
    size = cfg.vision.image_size
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (size, size, 3), np.uint8)
              for _ in range(2)] + [rng.integers(0, 256, (40, 32, 3),
                                                 np.uint8)]
    prompts = ["what is in view?", "where is the cup?", "left or right?"]
    tiles = _jax_tiles(images, size)

    from vlaser_tpu_torch.inference.chat import VlaserChat
    from vlaser_tpu_torch.serve.engine_chat import EngineChat

    args = _args(".", temperature=0.0, num_slots=3, top_p=1.0, spec_draft=0)
    assert isinstance(generate_qa.build_chat(args, tm, ToyTok()), VlaserChat)
    chat = VlaserChat(tm, ToyTok(), max_new_tokens=MAX_NEW,
                      cache_dtype=torch.float32)
    jchat = JaxChat(jm, v, ToyTok(), max_new_tokens=MAX_NEW,
                    cache_dtype=jnp.float32)
    got = generate_qa.make_generate_fn(args, chat, cfg)(np.stack(images[:2]),
                                                         prompts[:2])
    got.append(generate_qa.make_generate_fn(args, chat, cfg)(
        [images[2]], prompts[2:])[0])
    assert got == [jchat.chat(p, t) for p, t in zip(prompts, tiles)]
    assert generate_qa.make_shared_image_fn(args, chat, cfg) is None

    kw = dict(max_new_tokens=MAX_NEW, num_slots=3, max_len=256,
              prefill_buckets=(128, 192), tile_buckets=(1, 2))
    args = _args(".", engine=True, kind="all", temperature=0.0,
                 num_slots=3, top_p=1.0, spec_draft=0)
    built = generate_qa.build_chat(args, tm, ToyTok())
    assert isinstance(built, EngineChat) and built.backend == "engine"
    assert built.max_new_tokens == 512 and built.engine.num_slots == 3
    del built
    echat = EngineChat(tm, ToyTok(), cache_dtype=torch.float32, **kw)
    jechat = JaxEngineChat(jm, v, ToyTok(), cache_dtype=jnp.float32, **kw)
    got = generate_qa.make_generate_fn(args, echat, cfg)(images, prompts)
    want = jechat.batch_chat(prompts, np.concatenate(tiles), [1, 1, 1])
    assert got == want
    shared = generate_qa.make_shared_image_fn(args, echat, cfg)
    got = shared(prompts, images[0])
    assert got == jechat.batch_chat_shared_image(prompts, tiles[0])
    assert got == want[:1] + jechat.batch_chat(
        prompts[1:], np.concatenate([tiles[0]] * 2), [1, 1])


def test_main_writes_and_filters_on_the_cpu(tmp_path, monkeypatch):
    """--tiny --device cpu --engine --kind all --filter over an image
    directory (the backend's answers cut from the CLI's 512 new tokens to
    8): the JSONL is written (and filtered), and every item, if any parsed,
    is an SFT conversation with its image saved."""
    import functools

    from PIL import Image

    monkeypatch.setattr(generate_qa, "build_chat", functools.partial(
        generate_qa.build_chat, max_new_tokens=8))

    imgs = tmp_path / "frames"
    imgs.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (28, 28, 3), np.uint8)).save(
            imgs / f"f{i}.png")
    out = tmp_path / "qa.jsonl"
    generate_qa.main(["--tiny", "--device", "cpu", "--engine", "--kind",
                      "all", "--filter", "--episodes_dir", str(imgs),
                      "--out", str(out), "--images_dir",
                      str(tmp_path / "qa_images"), "--max_frames", "2",
                      "--num_slots", "4"])
    assert out.exists()
    for line in out.read_text().splitlines():
        it = json.loads(line)
        assert it["conversations"][0]["value"].startswith("<image>\n")
        assert (tmp_path / "qa_images" / it["image"]).exists()


def test_generate_qa_refusals(tmp_path, monkeypatch):
    base = ["--episodes_dir", str(tmp_path), "--out", str(tmp_path / "o")]
    with pytest.raises(SystemExit):
        generate_qa.main(base + ["--device", "cpu"])  # no model, no --tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_qa.main(base + ["--tiny"])
    args = generate_qa.build_parser().parse_args(
        base + ["--tiny", "--temperature", "0.7"])
    with pytest.raises(AssertionError, match="--engine"):
        generate_qa.build_chat(args, None, None)
    args = generate_qa.build_parser().parse_args(
        base + ["--tiny", "--offline", "--temperature", "0.7"])
    with pytest.raises(AssertionError, match="greedy-only"):
        generate_qa.build_chat(args, None, None)
