"""The port's checkpoint converters (vlaser_tpu_torch/utils/hf_convert.py,
utils/tools.py) against the JAX package's on the same random HF-named
state dicts: every converted tree bit for bit equal (keys, dtypes, shapes,
values), every exporter's state dict too; the port's own safetensors
reader and writer interoperate with the `safetensors` package for fp32,
bf16 and int8 (bf16 read back as the JAX loader's ml_dtypes values,
widened to fp32 exactly); and the training CLIs' chain (HF directory ->
convert_internvl_chat -> resize_token_embeddings -> from_jax_variables)
loads a port model with the JAX model's weights."""

import json

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file

import vlaser_tpu.utils.hf_convert as jhc
import vlaser_tpu.utils.tools as jtools
import vlaser_tpu_torch.utils.hf_convert as phc
import vlaser_tpu_torch.utils.tools as ptools

L, C, H, KVH, D, I, V = 2, 16, 4, 2, 4, 24, 40  # a tiny LLM
VC, VI, P, N = 12, 20, 4, 9  # a tiny ViT: width, MLP, patch, patch tokens


def _same(a, b, what=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (what, sorted(set(a) ^ set(b)))
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.shape,
                                                           b.shape)
        assert np.array_equal(a, b), what


def _sd(seed, spec, as_torch=()):
    """{key: random fp32 array of shape}; keys containing one of `as_torch`
    become torch bf16 tensors (a torch checkpoint's dtype)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in spec.items():
        a = rng.standard_normal(shape).astype(np.float32)
        out[k] = (torch.from_numpy(a).to(torch.bfloat16)
                  if any(t in k for t in as_torch) else a)
    return out


def _llm(p="", bias=True, qk_norm=False, moe=0, head=True, emb=True):
    s = {}
    for i in range(L):
        q = f"{p}model.layers.{i}."
        for proj, o, n in (("q_proj", H * D, C), ("k_proj", KVH * D, C),
                           ("v_proj", KVH * D, C), ("o_proj", C, H * D)):
            s[f"{q}self_attn.{proj}.weight"] = (o, n)
            if bias and proj != "o_proj":
                s[f"{q}self_attn.{proj}.bias"] = (o,)
        if qk_norm:
            s[f"{q}self_attn.q_norm.weight"] = (D,)
            s[f"{q}self_attn.k_norm.weight"] = (D,)
        if moe:
            s[f"{q}mlp.gate.weight"] = (moe, C)
            for e in range(moe):
                for proj, shape in (("gate_proj", (I, C)), ("up_proj", (I, C)),
                                    ("down_proj", (C, I))):
                    s[f"{q}mlp.experts.{e}.{proj}.weight"] = shape
        else:
            for proj, shape in (("gate_proj", (I, C)), ("up_proj", (I, C)),
                                ("down_proj", (C, I))):
                s[f"{q}mlp.{proj}.weight"] = shape
        s[f"{q}input_layernorm.weight"] = (C,)
        s[f"{q}post_attention_layernorm.weight"] = (C,)
    s[f"{p}model.norm.weight"] = (C,)
    if emb:
        s[f"{p}model.embed_tokens.weight"] = (V, C)
    if head:
        s[f"{p}lm_head.weight"] = (V, C)
    return s


def _vit(p="", qkv_bias=True, norm_bias=True, qk_norm=False):
    s = {f"{p}embeddings.class_embedding": (1, 1, VC),
         f"{p}embeddings.position_embedding": (1, N + 1, VC),
         f"{p}embeddings.patch_embedding.weight": (VC, 3, P, P),
         f"{p}embeddings.patch_embedding.bias": (VC,)}
    for i in range(L):
        q = f"{p}encoder.layers.{i}."
        s[f"{q}attn.qkv.weight"] = (3 * VC, VC)
        if qkv_bias:
            s[f"{q}attn.qkv.bias"] = (3 * VC,)
        s[f"{q}attn.proj.weight"] = (VC, VC)
        s[f"{q}attn.proj.bias"] = (VC,)
        s[f"{q}mlp.fc1.weight"], s[f"{q}mlp.fc1.bias"] = (VI, VC), (VI,)
        s[f"{q}mlp.fc2.weight"], s[f"{q}mlp.fc2.bias"] = (VC, VI), (VC,)
        s[f"{q}ls1"], s[f"{q}ls2"] = (VC,), (VC,)
        for n in ("norm1", "norm2"):
            s[f"{q}{n}.weight"] = (VC,)
            if norm_bias:
                s[f"{q}{n}.bias"] = (VC,)
        if qk_norm:
            s[f"{q}attn.q_norm.weight"] = (VC,)
            s[f"{q}attn.k_norm.weight"] = (VC,)
    return s


def _mlp1(p="mlp1."):
    return {f"{p}0.weight": (4 * VC,), f"{p}0.bias": (4 * VC,),
            f"{p}1.weight": (C, 4 * VC), f"{p}1.bias": (C,),
            f"{p}3.weight": (C, C), f"{p}3.bias": (C,)}


def _mixture(p, bias):
    s = {}
    for i in range(L):
        q = f"{p}{i}."
        for proj, o, n in (("q_proj", H * D, C), ("k_proj", KVH * D, C),
                           ("v_proj", KVH * D, C), ("o_proj", C, H * D)):
            s[f"{q}self_attn.{proj}.weight"] = (o, n)
            if bias and proj != "o_proj":
                s[f"{q}self_attn.{proj}.bias"] = (o,)
        for proj, shape in (("gate_proj", (I, C)), ("up_proj", (I, C)),
                            ("down_proj", (C, I))):
            s[f"{q}mlp.{proj}.weight"] = shape
        s[f"{q}input_layernorm.weight"] = (C,)
        s[f"{q}post_attention_layernorm.weight"] = (C,)
    return s


def _pizero(vision, projector, vlm_norm=True, head=True):
    s = dict(vision)
    s.update(projector)
    s["embed_tokens.weight"] = (V, C)
    s.update(_mixture("joint_model.mixtures.vlm.layers.", True))
    s.update(_mixture("joint_model.mixtures.action.layers.", False))
    if vlm_norm:
        s["joint_model.mixtures.vlm.norm.weight"] = (C,)
    s["joint_model.mixtures.action.norm.weight"] = (C,)
    s["proprio_encoder.weight"], s["proprio_encoder.bias"] = (C, 7), (C,)
    for n, shape in (("linear_1", (C, 7)), ("linear_2", (C, 2 * C)),
                     ("linear_3", (C, C))):
        s[f"action_encoder.{n}.weight"] = shape
        s[f"action_encoder.{n}.bias"] = (C,)
    s["action_decoder.weight"], s["action_decoder.bias"] = (7, C), (7,)
    if head:
        s["lm_head.weight"] = (V, C)
    return s


def _siglip(p):
    s = {f"{p}embeddings.patch_embedding.weight": (VC, 3, P, P),
         f"{p}embeddings.patch_embedding.bias": (VC,),
         f"{p}embeddings.position_embedding.weight": (N, VC),
         f"{p}post_layernorm.weight": (VC,), f"{p}post_layernorm.bias": (VC,)}
    for i in range(L):
        q = f"{p}encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[f"{q}self_attn.{proj}.weight"] = (VC, VC)
            s[f"{q}self_attn.{proj}.bias"] = (VC,)
        s[f"{q}mlp.fc1.weight"], s[f"{q}mlp.fc1.bias"] = (VI, VC), (VI,)
        s[f"{q}mlp.fc2.weight"], s[f"{q}mlp.fc2.bias"] = (VC, VI), (VC,)
        for n in ("layer_norm1", "layer_norm2"):
            s[f"{q}{n}.weight"], s[f"{q}{n}.bias"] = (VC,), (VC,)
    return s


def _internlm2():
    g = H // KVH
    s = {"model.tok_embeddings.weight": (V, C), "model.norm.weight": (C,),
         "output.weight": (V, C)}
    for i in range(L):
        q = f"model.layers.{i}."
        s[f"{q}attention.wqkv.weight"] = (KVH * (g + 2) * D, C)
        s[f"{q}attention.wo.weight"] = (C, H * D)
        s[f"{q}feed_forward.w1.weight"] = (I, C)
        s[f"{q}feed_forward.w3.weight"] = (I, C)
        s[f"{q}feed_forward.w2.weight"] = (C, I)
        s[f"{q}attention_norm.weight"] = (C,)
        s[f"{q}ffn_norm.weight"] = (C,)
    return s


def _phi3():
    s = {"model.embed_tokens.weight": (V, C), "model.norm.weight": (C,),
         "lm_head.weight": (V, C)}
    for i in range(L):
        q = f"model.layers.{i}."
        s[f"{q}self_attn.qkv_proj.weight"] = ((H + 2 * KVH) * D, C)
        s[f"{q}self_attn.o_proj.weight"] = (C, H * D)
        s[f"{q}mlp.gate_up_proj.weight"] = (2 * I, C)
        s[f"{q}mlp.down_proj.weight"] = (C, I)
        s[f"{q}input_layernorm.weight"] = (C,)
        s[f"{q}post_attention_layernorm.weight"] = (C,)
    return s


# (name, the HF state-dict spec, fn(module, state dict) -> tree)
CASES = [
    ("qwen2", _llm(), lambda m, sd: m.convert_qwen2(sd, L)),
    ("qwen2_prefixed_no_bias_qk_norm",
     _llm("language_model.", bias=False, qk_norm=True, head=False),
     lambda m, sd: m.convert_qwen2(sd, L, "language_model.")),
    ("qwen3_moe", _llm(moe=3), lambda m, sd: m.convert_qwen2(sd, L)),
    ("llama", _llm(bias=False), lambda m, sd: m.convert_llama(sd, L)),
    ("internlm2", _internlm2(),
     lambda m, sd: m.convert_internlm2(sd, L, H, KVH, D)),
    ("phi3", _phi3(), lambda m, sd: m.convert_phi3(sd, L, H, KVH, D)),
    ("internvit", _vit(), lambda m, sd: m.convert_internvit(sd, L)),
    ("internvit_6b_style", _vit("v.", qkv_bias=False, norm_bias=False,
                                qk_norm=True),
     lambda m, sd: m.convert_internvit(sd, L, "v.")),
    ("internvl_chat", {**_vit("vision_model."), **_llm("language_model."),
                       **_mlp1()},
     lambda m, sd: m.convert_internvl_chat(sd, L, L)),
    ("pizero_internvl", _pizero(_vit("vision_tower.vision_model."),
                                _mlp1("multi_modal_projector.")),
     lambda m, sd: m.convert_pizero_internvl(sd, L, L)),
    ("siglip", _siglip("s."), lambda m, sd: m.convert_siglip(sd, L, "s.")),
    ("pizero_paligemma", _pizero(
        _siglip("vision_tower.vision_model."),
        {"multi_modal_projector.linear.weight": (C, VC),
         "multi_modal_projector.linear.bias": (C,)}),
     lambda m, sd: m.convert_pizero_paligemma(sd, L, L)),
    ("pizero_paligemma_tied_no_vlm_norm", _pizero(
        _siglip("vision_tower.vision_model."),
        {"multi_modal_projector.linear.weight": (C, VC),
         "multi_modal_projector.linear.bias": (C,)},
        vlm_norm=False, head=False),
     lambda m, sd: m.convert_pizero_paligemma(sd, L, L)),
]


@pytest.mark.parametrize("name,spec,fn", CASES, ids=[c[0] for c in CASES])
def test_converters_match_jax(name, spec, fn):
    sd = _sd(len(name), spec, as_torch=("mlp", "norm"))
    _same(fn(phc, sd), fn(jhc, sd), name)


def test_tools_match_jax(tmp_path):
    spec = _pizero(_vit("vision_tower.vision_model."),
                   _mlp1("multi_modal_projector."))
    sd = {f"_orig_mod.{k}": v for k, v in _sd(3, spec).items()}
    _same(ptools.convert_pizero_torch_checkpoint(sd, L, L),
          jtools.convert_pizero_torch_checkpoint(sd, L, L))
    assert ptools.strip_compile_prefix(sd).keys() == \
        jtools.strip_compile_prefix(sd).keys()
    tree = jhc.convert_internvl_chat(
        _sd(4, {**_vit("vision_model."), **_llm("language_model."),
                **_mlp1()}), L, L)
    for vocab in (V, V + 9):
        _same(ptools.resize_token_embeddings(tree, vocab),
              jtools.resize_token_embeddings(tree, vocab))
    _same(ptools.extract_vit_and_projector(tree),
          jtools.extract_vit_and_projector(tree))
    pos = np.random.default_rng(5).standard_normal(
        (1, 17, 3)).astype(np.float32)
    _same(ptools.resize_pos_embeddings(pos, 6),
          jtools.resize_pos_embeddings(pos, 6))
    for n, k in ((100, 8), (5, 8), (16, 16)):
        assert (ptools.video_frame_indices(n, k)
                == jtools.video_frame_indices(n, k))
    data = {"a": [{"x": 1}, {"id": 7, "y": 2}], "b": [{"z": 3}]}
    (tmp_path / "d.json").write_text(json.dumps(data))
    assert (ptools.json_to_jsonl(str(tmp_path / "d.json"),
                                 str(tmp_path / "p.jsonl"))
            == jtools.json_to_jsonl(str(tmp_path / "d.json"),
                                    str(tmp_path / "j.jsonl")) == 3)
    assert (tmp_path / "p.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    from PIL import Image

    rng = np.random.default_rng(6)
    views = {c: Image.fromarray(rng.integers(0, 256, (10, 14, 3),
                                             dtype=np.uint8))
             for c in ("FRONT", "BACK", "LEFT")}
    _same(np.asarray(ptools.stitch_images_grid(views, image_size=8, cols=2)),
          np.asarray(jtools.stitch_images_grid(views, image_size=8, cols=2)))


@pytest.mark.parametrize("which", ["qwen2", "internvit", "internvl_chat"])
def test_exporters_match_jax_and_round_trip(which):
    spec = {"qwen2": _llm(), "internvit": _vit(),
            "internvl_chat": {**_vit("vision_model."),
                              **_llm("language_model."), **_mlp1()}}[which]
    sd = _sd(11, spec)
    conv = {"qwen2": lambda m: m.convert_qwen2(sd, L),
            "internvit": lambda m: m.convert_internvit(sd, L),
            "internvl_chat": lambda m: m.convert_internvl_chat(sd, L, L)}
    export = {"qwen2": lambda m, t: m.export_qwen2(t),
              "internvit": lambda m, t: m.export_internvit(t),
              "internvl_chat": lambda m, t: m.export_internvl_chat(t)}
    tree = conv[which](jhc)
    got, want = export[which](phc, tree), export[which](jhc, tree)
    _same(got, want, which)
    _same(got, sd, "round trip")


DTYPES = {"fp32": np.float32, "bf16": ml_dtypes.bfloat16, "int8": np.int8}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_safetensors_interop(tmp_path, dtype):
    """safetensors' writer -> the port's reader, the port's writer ->
    safetensors' reader, bit for bit; load_safetensors_dir gives the JAX
    loader's values (its bf16 ml_dtypes arrays widened to fp32)."""
    rng = np.random.default_rng(len(dtype))
    dt = DTYPES[dtype]
    arrays = {"w": rng.standard_normal((5, 7)) * 50, "b": rng.standard_normal(
        (3,)), "s": np.array(2.5), "t": rng.standard_normal((4, 6)).T * 9}
    arrays = {k: v.astype(dt) for k, v in arrays.items()}
    bits = lambda a: a.reshape(-1).copy().view(np.uint8)
    save_file({k: v.copy(order="C") for k, v in arrays.items()},
              str(tmp_path / "theirs.safetensors"))
    got = phc.load_safetensors(str(tmp_path / "theirs.safetensors"))
    for k, v in arrays.items():
        assert tuple(got[k].shape) == v.shape
        assert np.array_equal(got[k].reshape(-1).view(torch.uint8).numpy(),
                              bits(v).reshape(-1)), k
    phc.save_safetensors(arrays, str(tmp_path / "ours.safetensors"))
    with safe_open(str(tmp_path / "ours.safetensors"), framework="np") as fh:
        assert sorted(fh.keys()) == sorted(arrays)
        for k in fh.keys():
            x = fh.get_tensor(k)
            assert x.dtype == arrays[k].dtype and x.shape == arrays[k].shape
            assert np.array_equal(bits(x), bits(arrays[k])), k
    want = jhc.load_safetensors_dir(str(tmp_path))
    mine = phc.load_safetensors_dir(str(tmp_path))
    assert sorted(want) == sorted(mine) == sorted(arrays)
    for k in arrays:
        w = np.asarray(want[k], np.float32 if dtype == "bf16" else None)
        _same(mine[k], w, k)
    # torch tensors (bf16 included) are written at their dtype
    t = torch.from_numpy(np.asarray(arrays["w"], np.float32)).to(
        torch.bfloat16)
    phc.save_safetensors({"x": t}, str(tmp_path / "torch.safetensors"))
    assert torch.equal(phc.load_safetensors(
        str(tmp_path / "torch.safetensors"))["x"], t)


def test_hf_checkpoint_dir_loads_the_jax_weights_into_the_port(tmp_path):
    """The CLIs' chain on a tiny InternVL: JAX weights exported by the
    port's export_internvl_chat and save_hf_checkpoint_dir (bf16, as real
    checkpoints are), read back by the port and by JAX; each converted tree
    equal; then resized for 9 added tokens and loaded into the port model,
    whose state to_jax_params turns back into that tree and whose logits
    equal the JAX model's on the same (resized) weights."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from vlaser_tpu.core.config import tiny_vlm
    from vlaser_tpu.models.vlm import InternVLChatModel as JVLM
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.utils.convert import (from_jax_variables,
                                                to_jax_params)

    cfg = tiny_vlm()
    img = cfg.vision.image_size
    ids = np.full((1, 8), 3, np.int32)
    ids[0, 1] = cfg.img_context_token_id
    pix = np.random.default_rng(0).standard_normal(
        (1, img, img, 3)).astype(np.float32)
    jm = JVLM(cfg, compute_dtype=jnp.float32, attn_impl="reference")
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), ids, pix, np.ones((1,), np.int32))["params"])
    hf = {k: torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16)
          for k, v in phc.export_internvl_chat(params).items()}
    phc.save_hf_checkpoint_dir(hf, str(tmp_path), config={"v": 1},
                               num_shards=3)
    index = json.loads((tmp_path / "model.safetensors.index.json")
                       .read_text())
    assert sorted(index["weight_map"]) == sorted(hf)
    Lv, Ll = cfg.vision.num_layers, cfg.llm.num_layers
    mine = phc.convert_internvl_chat(
        phc.load_safetensors_dir(str(tmp_path)), Lv, Ll)
    want = jhc.convert_internvl_chat(
        jhc.load_safetensors_dir(str(tmp_path)), Lv, Ll)
    _same(mine, want)
    vocab = cfg.llm.vocab_size + 9
    mine = ptools.resize_token_embeddings(mine, vocab)
    want = jtools.resize_token_embeddings(want, vocab)
    _same(mine, want)
    big = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, vocab_size=vocab))
    model = load_state(InternVLChatModel(
        big, compute_dtype=torch.float32, device="cpu",
        attn_impl="reference"), from_jax_variables({"params": mine}))
    _same(to_jax_params(model.state_dict()), mine, "to_jax_params")
    got, _, _ = model(torch.from_numpy(ids).long(), torch.from_numpy(pix),
                      torch.ones(1, dtype=torch.int32))
    wl, _, _ = JVLM(big, compute_dtype=jnp.float32,
                    attn_impl="reference").apply(
        {"params": want}, ids, pix, np.ones((1,), np.int32))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(wl),
                               rtol=1e-5, atol=1e-5)
