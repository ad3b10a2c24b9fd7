"""The port's data pipeline (vlaser_tpu_torch: tokenizer/byte_tokenizer.py,
image/tiling.py, data/chat_dataset.py, data/prefetch.py,
data/preference_dataset.py) against the JAX package's copies on the same
inputs: every array bit for bit equal (dtype, shape and values), as
tests/test_data.py's pipeline emits them. Images are seeded numpy noise
saved as PNG; the tokenizer is the byte tokenizer with the InternVL
special tokens."""

import json
import random

import numpy as np
import pytest

import vlaser_tpu.data.chat_dataset as jcd
import vlaser_tpu.data.prefetch as jpf
import vlaser_tpu.data.preference_dataset as jpd
import vlaser_tpu.image.tiling as jtl
import vlaser_tpu_torch.data.chat_dataset as pcd
import vlaser_tpu_torch.data.prefetch as ppf
import vlaser_tpu_torch.data.preference_dataset as ppd
import vlaser_tpu_torch.image.tiling as ptl
from vlaser_tpu.tokenizer.byte_tokenizer import ByteTokenizer as JTok
from vlaser_tpu.utils.tools import ensure_special_tokens as j_special
from vlaser_tpu_torch.tokenizer.byte_tokenizer import ByteTokenizer as PTok
from vlaser_tpu_torch.utils.tools import ensure_special_tokens as p_special

IMG = 28  # tile side of the tiny configs
NT = 2    # image tokens a tile
_, CTX, START, END = p_special(PTok())  # <IMG_CONTEXT>, <img>, </img> ids


def _same(a, b, what=""):
    """Equal dicts / lists / arrays: keys, dtypes, shapes and bits."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), what


def _toks():
    jt, pt = JTok(), PTok()
    assert j_special(jt) == p_special(pt)
    return jt, pt


def _png(path, rng, w, h):
    from PIL import Image

    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A JSONL of text, image, multi-image and video items (and one whose
    image is missing, which the retry resamples), with the files."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("data")
    _png(root / "wide.png", rng, 96, 40)
    _png(root / "tall.png", rng, 30, 70)
    (root / "vid").mkdir()
    for i in range(5):
        _png(root / "vid" / f"f{i:03d}.png", rng, 32, 32)
    items = [
        {"conversations": [{"from": "human", "value": "hi there"},
                           {"from": "gpt", "value": "hello, robot!"}]},
        {"image": "wide.png", "conversations": [
            {"from": "human", "value": "<image>\ndescribe"},
            {"from": "gpt", "value": "noise"}]},
        {"image": ["wide.png", "tall.png"], "conversations": [
            {"from": "system", "value": "be brief"},
            {"from": "human", "value": "<image> vs <image>?"},
            {"from": "gpt", "value": "two"},
            {"from": "human", "value": "sure?"},
            {"from": "gpt", "value": "yes"}]},
        {"video": "vid", "conversations": [
            {"from": "human", "value": "<video>\nwhat happens?"},
            {"from": "gpt", "value": "it flickers"}]},
        {"image": "missing.png", "conversations": [
            {"from": "human", "value": "<image>\n?"},
            {"from": "gpt", "value": "x"}]},
    ]
    with open(root / "train.jsonl", "w") as f:
        for it in items:
            f.write(json.dumps(it) + "\n")
    text = random.Random(1)
    with open(root / "text.jsonl", "w") as f:
        for i in range(40):
            n = text.randint(5, 120)
            f.write(json.dumps({"conversations": [
                {"from": "human", "value": "q" * text.randint(1, 30)},
                {"from": "gpt", "value": "a" * n}]}) + "\n")
    return root


def _datasets(root, name="train.jsonl", **kw):
    jt, pt = _toks()
    out = []
    for mod, tok in ((jcd, jt), (pcd, pt)):
        cfg = mod.ChatDatasetConfig(
            jsonl_path=str(root / name), image_root=str(root),
            num_image_token=NT, image_size=IMG, max_dynamic_patch=4, **kw)
        out.append(mod.ConversationDataset(cfg, tok))
    return out


def test_byte_tokenizer_matches_jax():
    jt, pt = _toks()
    text = "<|im_start|>user\n<img><IMG_CONTEXT><IMG_CONTEXT></img>héllo"
    assert jt(text) == pt(text) and len(jt) == len(pt) == 265
    ids = pt(text)["input_ids"]
    for skip in (True, False):
        assert jt.decode(ids, skip) == pt.decode(ids, skip)
    assert pt.decode(ids, False) == text
    assert (jt.convert_tokens_to_ids(["<img>", "?"])
            == pt.convert_tokens_to_ids(["<img>", "?"]) == [START, -1])


@pytest.mark.parametrize("size", [(96, 40), (30, 70), (50, 50), (300, 20)])
def test_tiling_matches_jax(size):
    from PIL import Image

    rng = np.random.default_rng(size[0])
    img = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3),
                                       dtype=np.uint8))
    assert ptl.candidate_ratios(1, 12) == jtl.candidate_ratios(1, 12)
    for args in ((1, 6, IMG, True, True), (1, 12, 56, False, True),
                 (2, 4, IMG, True, False)):
        _same(ptl.load_image_tiles(img, args[2], args[0], args[1], args[3],
                                   args[4]),
              jtl.load_image_tiles(img, args[2], args[0], args[1], args[3],
                                   args[4]))
    _same(ptl.to_array(img, IMG, normalize=False),
          jtl.to_array(img, IMG, normalize=False))
    frames = rng.integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    _same(ptl.normalize_uint8(frames), jtl.normalize_uint8(frames))
    got = ptl.simulate_jpeg_degradation(img, (50, 90), random.Random(3))
    want = jtl.simulate_jpeg_degradation(img, (50, 90), random.Random(3))
    _same(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("template", ["internvl2_5", "Hermes-2",
                                      "internlm2-chat", "phi3-chat"])
def test_conversation_items_match_jax(root, template):
    """Text, image, multi-image and video items (and the retry's resample
    of a missing image) under each chat template."""
    jds, pds = _datasets(root, template=template, loss_reduction="square")
    assert len(jds) == len(pds) == 5
    for i in range(len(jds)):
        _same(pds[i], jds[i], f"item {i}")
    s = pds[2]
    assert s["pixel_values"].shape[1:] == (IMG, IMG, 3)
    assert int(s["image_flags"].sum()) == len(s["pixel_values"]) > 2
    assert pds[0]["image_flags"].tolist() == [0]  # the blank tile
    assert len(pds[3]["pixel_values"]) == 5       # one tile a frame


def test_dataset_helpers_match_jax(root, tmp_path):
    jds, pds = _datasets(root)
    for fn in ("estimate_lengths", "tokenized_lengths"):
        assert getattr(pcd, fn)(pds) == getattr(jcd, fn)(jds)
    lengths = pcd.tokenized_lengths(_datasets(root, "text.jsonl")[1])
    for bs, mult, seed in ((4, 50, 0), (2, 3, 7)):
        assert (pcd.length_grouped_indices(lengths, bs, mult, seed)
                == jcd.length_grouped_indices(lengths, bs, mult, seed))
    for n, red in ((0, "token"), (7, "token"), (7, "sample"), (9, "square")):
        assert pcd.len2weight(n, red) == jcd.len2weight(n, red)
    meta = {"a": {"annotation": str(root / "train.jsonl"), "root": str(root)},
            "b": {"annotation": str(root / "text.jsonl"), "repeat_time": 0.5,
                  "max_dynamic_patch": 2}}
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    jt, pt = _toks()
    got = [pcd.build_datasets(str(tmp_path / "meta.json"), tok,
                              mod.ChatDatasetConfig("", str(root),
                                                    num_image_token=NT,
                                                    image_size=IMG))
           for mod, tok in ((pcd, pt), (jcd, jt))]
    assert len(got[0]) == len(got[1]) == 5 + 20
    for i in (0, 3, 5, 24):
        _same(got[0][i], got[1][i], f"concat {i}")


def test_split_sample_and_pad_collate_match_jax(root):
    jds, pds = _datasets(root, max_seq_length=4096)
    s = pds[2]
    for mod, other in ((pcd, jcd),):
        args = (s, 24, START, END, NT, IMG)
        _same(mod.split_sample(*args), other.split_sample(*args), "split")
    samples = [pds[i] for i in range(4)]
    for kw in ({}, {"pad_to": 64}, {"pad_multiple": 8}):
        _same(pcd.pad_collate(samples, 0, **kw),
              jcd.pad_collate(samples, 0, **kw), str(kw))


@pytest.mark.parametrize("max_tokens,buffer", [(128, 16), (96, 2), (512, 4)])
def test_packer_and_its_resume_match_jax(root, max_tokens, buffer):
    """PackedDataset over the shuffled text items (overlong ones split): the
    same packs in the same order; a packer restored from the state after
    3 packs emits the uninterrupted packer's rest (both packages)."""
    jds, pds = _datasets(root, "text.jsonl")
    kw = dict(max_packed_tokens=max_tokens, pad_token_id=0,
              img_start_id=START, img_end_id=END, num_image_token=NT,
              image_size=IMG, max_buffer_size=buffer)
    jp, pp = jcd.PackedDataset(jds, **kw), pcd.PackedDataset(pds, **kw)
    want, got = list(jp), list(pp)
    assert len(got) > 3
    _same(got, want, "packs")
    states, rest = [], []
    for mod, ds in ((pcd, pds), (jcd, jds)):
        a = mod.PackedDataset(ds, **kw)
        it = iter(a)
        for _ in range(3):
            next(it)
        b = mod.PackedDataset(ds, **kw)
        b.load_state_dict(json.loads(json.dumps(a.state_dict())))
        assert b.cursor == a.cursor > 0
        states.append(a.state_dict())
        rest.append(list(b))
    assert states[0] == states[1]
    _same(rest[0], rest[1], "resumed")


def test_prefetch_matches_jax(root):
    out = list(ppf.PrefetchIterator(iter(range(20)), buffer_size=3))
    assert out == list(range(20))

    def bad():
        yield 1
        raise ValueError("boom")

    it = ppf.PrefetchIterator(bad())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)
    jds, pds = _datasets(root, "text.jsonl")
    order = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    got = list(ppf.map_prefetch(pds, order, lambda xs: pcd.pad_collate(xs, 0),
                                batch_size=3, num_threads=4))
    want = list(jpf.map_prefetch(jds, order,
                                 lambda xs: jcd.pad_collate(xs, 0),
                                 batch_size=3, num_threads=2))
    assert len(got) == 4
    _same(got, want, "map_prefetch")


def test_preference_dataset_and_collate_match_jax(root):
    items = [{"question": "which?", "chosen": "the left one, clearly",
              "rejected": "no"},
             {"image": "wide.png", "question": "what is it?",
              "chosen": "noise", "rejected": "a cat on a mat"},
             {"image": "tall.png", "question": "<image>\ncolor?",
              "chosen": "all of them", "rejected": "red"}]
    with open(root / "pairs.jsonl", "w") as f:
        for it in items:
            f.write(json.dumps(it) + "\n")
    jt, pt = _toks()
    ds = [mod.PreferenceDataset(mod.PreferenceDatasetConfig(
        str(root / "pairs.jsonl"), str(root), num_image_token=NT,
        image_size=IMG, max_dynamic_patch=3, max_seq_length=200), tok)
        for mod, tok in ((ppd, pt), (jpd, jt))]
    for i in range(3):
        _same(ds[0][i], ds[1][i], f"pair {i}")
    for idx in ((0,), (1, 2), (0, 1, 2)):
        _same(ppd.preference_collate([ds[0][i] for i in idx], 0),
              jpd.preference_collate([ds[1][i] for i in idx], 0), str(idx))
