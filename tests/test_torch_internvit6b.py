"""The InternViT-6B layout in the port (vlaser_tpu_torch) against the JAX
package, at the port's tiny cut `tiny_vision_6b` (RMSNorm blocks, a
bias-free QKV, q/k RMSNorms over the flattened H*D width, head dim 16):
the encoder's layer loop, the chat model built on it, and the fused chat
route, which sends such an encoder to the layer loop (the fused ViT stack
computes LayerNorm blocks with a biased QKV only) and packs no stack for
it. fp32 on both sides; tolerances as stated."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core import config as jcfg
from vlaser_tpu.core.quant import quantize_for_serving as jax_quantize
from vlaser_tpu.inference.chat import VlaserChat as JaxChat
from vlaser_tpu.models.internvit import InternVisionModel as JaxViT
from vlaser_tpu.models.vlm import InternVLChatModel as JaxModel
from vlaser_tpu_torch.core import config as tcfg
from vlaser_tpu_torch.core.quant import quantize_for_serving
from vlaser_tpu_torch.inference import fused_runner
from vlaser_tpu_torch.inference.chat import VlaserChat
from vlaser_tpu_torch.kernels import fused_vit
from vlaser_tpu_torch.models.internvit import InternVisionModel
from vlaser_tpu_torch.models.layers import load_state
from vlaser_tpu_torch.models.vlm import InternVLChatModel
from vlaser_tpu_torch.utils.convert import from_jax_variables

from test_chat_and_configs import ToyTok

TOL = 1e-5  # fp32 on both sides: atol and rtol


def _vision():
    """The JAX package's VisionConfig with the port's tiny 6B cut."""
    return jcfg.VisionConfig(**dataclasses.asdict(tcfg.tiny_vision_6b()))


def _draw(v, rng):
    """Every leaf N(0, 0.1^2); norm weights and layer scales 1 + that."""
    def one(path, a):
        w = rng.standard_normal(a.shape).astype(np.float32) * 0.1
        key = jax.tree_util.keystr(path)
        return jnp.asarray(w + 1.0 if ("norm" in key or "ls" in key)
                           and "kernel" not in key else w)
    return jax.tree_util.tree_map_with_path(one, v)


def test_tiny_cut_has_the_6b_layout():
    six, cut = tcfg.internvit_6b(), tcfg.tiny_vision_6b()
    for f in ("norm_type", "qkv_bias", "qk_normalization"):
        assert getattr(cut, f) == getattr(six, f)
    assert cut.head_dim == 16 and six.head_dim == 128
    assert not fused_vit.supports_fused_vit(six)


@pytest.mark.parametrize("select_layer", [-1, -2])
def test_rms_vit_matches_jax(select_layer):
    """The layer loop (RMSNorm blocks, bias-free QKV, flattened q/k norms)
    on two tiles, against JAX's encoder: the hidden states within TOL."""
    vcfg = _vision()
    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    jm = JaxViT(vcfg, compute_dtype=jnp.float32, attn_impl="reference")
    v = _draw(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                             jnp.asarray(px))), rng)
    assert "bias" not in v["params"]["encoder"]["attn"]["qkv"]
    assert "bias" not in v["params"]["encoder"]["norm1"]
    want = jm.apply(v, jnp.asarray(px), select_layer=select_layer)
    tm = InternVisionModel(vcfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(jax.tree_util.tree_map(np.asarray, v)))
    with torch.no_grad():
        got = tm(torch.from_numpy(px), select_layer=select_layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    with pytest.raises(NotImplementedError):
        fused_vit.pack_vit_stack(tm)


def _chat_models(seed=1):
    """tiny_vlm with the RMS ViT, quantized for serving (vlm, w8a8) on both
    sides from the same draws."""
    cfg = dataclasses.replace(jcfg.tiny_vlm(), vision=_vision())
    jm = JaxModel(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    rng = np.random.default_rng(seed)
    t = cfg.num_image_token
    ids = rng.integers(1, 400, (1, 3 + 2 * t))
    ids[0, 1:1 + 2 * t] = cfg.img_context_token_id
    px = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    v = _draw(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(px), None)),
        rng)
    tm = InternVLChatModel(cfg, compute_dtype=torch.float32, device="cpu")
    load_state(tm, from_jax_variables(jax.tree_util.tree_map(np.asarray, v)))
    return cfg, jm, v, tm, ids, px


def test_rms_vit_chat_model_logits_match_jax():
    """The chat model's forward on tiles through the RMS ViT: logits within
    TOL of JAX's."""
    cfg, jm, v, tm, ids, px = _chat_models()
    want = jm.apply(v, jnp.asarray(ids), jnp.asarray(px), None)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(px), None)
    got = got[0] if isinstance(got, tuple) else got
    want = want[0] if isinstance(want, tuple) else want
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_fused_chat_sends_rms_vit_to_the_layer_loop():
    """VlaserChat(use_fused=True) on a quantized model with the RMS ViT
    builds (no ViT stack is packed), its tiles go through the encoder's
    layer loop and never through fused_visual_features, and it answers as
    the JAX package's fused chat does."""
    cfg, jm, v, tm, ids, px = _chat_models(seed=2)
    v = jax_quantize(v, target="vlm", mode="w8a8", min_size=1)
    quantize_for_serving(tm, target="vlm", mode="w8a8", min_size=1)
    chat = VlaserChat(tm, ToyTok(), max_new_tokens=4, bucket=32,
                      use_fused=True)
    assert chat.route == "fused"
    assert not fused_runner.fused_vit_eligible(tm, torch.from_numpy(px))
    calls = {"fused_vit": 0, "loop": 0}
    fv = fused_runner.fused_visual_features
    layer = tm.vision_model.encoder.layer

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    fused_runner.fused_visual_features = counted("fused_vit", fv)
    tm.vision_model.encoder.layer = counted("loop", layer)
    try:
        resp = chat.chat("what do you see?", px)
    finally:
        fused_runner.fused_visual_features = fv
        del tm.vision_model.encoder.layer
    assert calls == {"fused_vit": 0, "loop": cfg.vision.num_layers}
    jchat = JaxChat(jm, v, ToyTok(), max_new_tokens=4, bucket=32,
                    use_fused=True)
    assert resp == jchat.chat("what do you see?", px)
