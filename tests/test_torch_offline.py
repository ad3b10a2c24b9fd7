"""The port's offline schedule (vlaser_tpu_torch/serve/offline.run_offline)
vs the JAX package's on tiny_vlm at fp32, the same weights through
utils/convert.from_jax_variables; and the engine phase's fp32 gate of
chip_smoke.py rehearsed on the CPU.

Tolerance: completions token-identical to the JAX runner's, the port's
engine's and the port's solo decode (0 mismatched rows)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.serve.engine import Request as JRequest
from vlaser_tpu.serve.offline import run_offline as jax_offline
from vlaser_tpu_torch.serve.engine import ContinuousBatchingEngine, Request
from vlaser_tpu_torch.serve.offline import _width_groups, run_offline

from test_chat_and_configs import ToyTok
from test_torch_engine import one_thread  # noqa: F401 (autouse)
from test_torch_engine import EOS, build_models, image_prompt, port_solo


@pytest.fixture(scope="module")
def vlm():
    return build_models()


def offline_both(vlm, specs, **kw):
    """-> ({uid: tokens} of JAX's run_offline, of the port's), checking
    that both keep the request order."""
    cfg, jm, v, tm = vlm
    kw = dict(eos_token_ids=EOS, pad_token_id=0, **kw)
    want = jax_offline(jm, v, [JRequest(**s) for s in specs],
                       cache_dtype=jnp.float32, **kw)
    got = run_offline(tm, [Request(**s) for s in specs],
                      cache_dtype=torch.float32, **kw)
    assert [c.uid for c in got] == [c.uid for c in want] == \
        [s["uid"] for s in specs]
    assert [c.prompt_len for c in got] == [c.prompt_len for c in want]
    return ({c.uid: c.token_ids for c in want},
            {c.uid: c.token_ids for c in got})


def test_offline_text_matches_jax_and_engine(vlm):
    """9 text prompts, mixed lengths and budgets, through 3 slots (slot
    reuse, mid-chunk deaths, several admission waves): JAX's runner, the
    port's engine and the port's solo decode."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(21)
    budgets = [6, 3, 9, 6, 1, 4, 6, 2, 7]
    specs = [dict(uid=i, input_ids=rng.integers(1, 400, (n,)).astype(
        np.int32), max_new_tokens=m)
        for i, (n, m) in enumerate(zip((4, 9, 5, 13, 7, 3, 11, 6, 8),
                                       budgets))]
    want, got = offline_both(vlm, specs, num_slots=3, max_len=64,
                             chunk_size=4)
    assert got == want
    eng = ContinuousBatchingEngine(tm, num_slots=3, max_len=64,
                                   eos_token_ids=EOS, pad_token_id=0,
                                   prefill_buckets=(16,),
                                   cache_dtype=torch.float32)
    assert {c.uid: c.token_ids
            for c in eng.run([Request(**s) for s in specs])} == got
    assert got[2] == port_solo(tm, specs[2]["input_ids"], max_new=9)


def test_offline_mixed_image_text_and_width_groups_match_jax(vlm):
    """Image and text rows share the compact pixel buffer (text rows take
    flag-0 tiles); prompt buckets split into two width groups."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(5)
    ids, px = image_prompt(cfg, rng, 6)
    specs = [dict(uid=0, input_ids=ids, pixel_values=px, max_new_tokens=6),
             dict(uid=1, input_ids=rng.integers(1, 400, (5,)).astype(
                 np.int32), max_new_tokens=6)]
    want, got = offline_both(vlm, specs, num_slots=2, max_len=64,
                             chunk_size=8)
    assert got == want
    assert got[0] == port_solo(tm, ids, px)
    specs = [dict(uid=i, input_ids=rng.integers(1, 400, (n,)).astype(
        np.int32), max_new_tokens=5)
        for i, n in enumerate((4, 30, 9, 17, 5, 28, 12, 3))]
    want, got = offline_both(vlm, specs, num_slots=3, max_len=64,
                             chunk_size=4, prefill_buckets=(8, 16, 32),
                             max_width_groups=2)
    assert got == want
    groups = _width_groups([Request(**s) for s in specs], (8, 16, 32), 2)
    assert len(groups) == 2 and sum(len(g) for g in groups) == len(specs)


def test_image_admission_under_occupied_lane(vlm):
    """The dead-lane fix: an image request admitted while another lane is
    occupied must not lose its scatter slots to that lane's replicated
    row's <IMG_CONTEXT> tokens (tests/test_offline.py's case)."""
    cfg, jm, v, tm = vlm
    rng = np.random.default_rng(17)
    npt = cfg.num_image_token
    img = cfg.vision.image_size

    def img_req(uid, max_new):
        row = rng.integers(4, 400, (8 + npt,)).astype(np.int32)
        row[2:2 + npt] = cfg.img_context_token_id
        px = rng.standard_normal((1, img, img, 3)).astype(np.float32)
        return dict(uid=uid, input_ids=row, pixel_values=px,
                    max_new_tokens=max_new)

    specs = [dict(uid=0, input_ids=rng.integers(4, 400, (6,)).astype(
        np.int32), max_new_tokens=12), img_req(1, 2), img_req(2, 3)]
    want, got = offline_both(vlm, specs, num_slots=2, max_len=64,
                             chunk_size=2)
    assert got == want
    for s in specs:
        assert got[s["uid"]] == port_solo(tm, s["input_ids"],
                                          s.get("pixel_values"),
                                          max_new=s["max_new_tokens"])


def test_bucketed_prompt_width_up_to_max_len(vlm):
    """A prompt whose bucket pads up to max_len serves while its true
    length + max_new fits the cache."""
    rng = np.random.default_rng(19)
    specs = [dict(uid=0, input_ids=rng.integers(4, 400, (40,)).astype(
        np.int32), max_new_tokens=6)]
    want, got = offline_both(vlm, specs, num_slots=1, max_len=64,
                             prefill_buckets=(64,))
    assert got == want
    assert got[0] == port_solo(vlm[3], specs[0]["input_ids"])


def test_offline_validation(vlm):
    tm = vlm[3]
    kw = dict(num_slots=2, max_len=64, eos_token_ids=EOS, pad_token_id=0)
    with pytest.raises(ValueError, match="greedy-only"):
        run_offline(tm, [Request(uid=0, input_ids=np.asarray([5, 6]),
                                 temperature=0.7)], **kw)
    with pytest.raises(ValueError, match="max_new_tokens"):
        run_offline(tm, [Request(uid=0, input_ids=np.asarray([5, 6]),
                                 max_new_tokens=0)], **kw)


def test_engine_chat_offline_backend(vlm):
    """EngineChat(backend="offline") answers batch_chat as the engine
    backend does; a streamed call rides the engine."""
    from vlaser_tpu_torch.serve.engine_chat import EngineChat

    cfg, _, _, tm = vlm
    rng = np.random.default_rng(7)
    img = cfg.vision.image_size
    px = rng.standard_normal((2, img, img, 3)).astype(np.float32)
    kw = dict(max_new_tokens=5, num_slots=2, max_len=256,
              prefill_buckets=(128, 192), cache_dtype=torch.float32)
    qs = ["what is this?", "describe", "hi"]
    off = EngineChat(tm, ToyTok(), backend="offline", **kw)
    eng = EngineChat(tm, ToyTok(), **kw)
    assert off.batch_chat(qs, px, [1, 1, 0]) == eng.batch_chat(qs, px,
                                                               [1, 1, 0])
    seen = []
    out = off.chat_many([("hi", None, None)],
                        on_token=lambda i, t: seen.append(t))
    assert out == eng.chat_many([("hi", None, None)]) and seen


def test_chip_smoke_engine_gate_on_cpu():
    """chip_smoke.py's engine fp32 gate (bench.py's engine_fp32_* rows:
    bucketed, offline, spec, prefix_cached, auto_prefix), run here on the
    CPU on the port alone: every row 0."""
    import chip_smoke

    rows = chip_smoke.engine_fp32_gate(torch, np, torch.device("cpu"))
    assert set(rows) == {"bucketed", "offline", "spec", "prefix_cached",
                         "auto_prefix"}
    assert all(v == 0 for v in rows.values()), rows
