"""HF (torch) checkpoint <-> param-tree conversion (a copy of
vlaser_tpu/utils/hf_convert.py: numpy, and torch for the tensors it reads
and writes).

Covers Qwen2ForCausalLM, InternViT, and the full InternVLChat (Vlaser-2B/8B)
layout so published Vlaser weights load directly. Per-layer weights are
stacked along a leading [num_layers] axis, the layout of the JAX parameter
tree, which `utils/convert.from_jax_variables` then loads into a port
model. Torch nn.Linear stores [out, in]; the tree's Dense kernels are
[in, out] -> transpose.

The safetensors files are read and written here, without the
`safetensors` package: an 8-byte little-endian header length, a JSON
header ({name: {"dtype", "shape", "data_offsets"}}, padded with spaces to
8 bytes), then the raw little-endian buffers back to back. BF16 (the dtype
of real InternVL checkpoints) is read as a torch bfloat16 tensor, and
`load_safetensors_dir` widens it to fp32 exactly, the values the JAX
loader's ml_dtypes arrays give.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _stack(sd: Mapping, fmt: str, n: int, transpose: bool = False):
    mats = []
    for i in range(n):
        m = _np(sd[fmt.format(i)])
        mats.append(m.T if transpose else m)
    return np.stack(mats, axis=0)


def convert_qwen2(sd: Mapping, num_layers: int, prefix: str = "") -> Dict:
    """HF Qwen2ForCausalLM state_dict -> Qwen2ForCausalLM flax params."""
    p = prefix
    layers: Dict = {"self_attn": {}, "mlp": {}}
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        entry = {
            "kernel": _stack(
                sd, f"{p}model.layers.{{}}.self_attn.{proj}.weight", num_layers, True
            )
        }
        bias_key = f"{p}model.layers.0.self_attn.{proj}.bias"
        if bias_key in sd:
            entry["bias"] = _stack(
                sd, f"{p}model.layers.{{}}.self_attn.{proj}.bias", num_layers
            )
        layers["self_attn"][proj] = entry
    for norm in ("q_norm", "k_norm"):  # Qwen3 per-head q/k RMSNorm
        if f"{p}model.layers.0.self_attn.{norm}.weight" in sd:
            layers["self_attn"][norm] = {
                "weight": _stack(
                    sd, f"{p}model.layers.{{}}.self_attn.{norm}.weight",
                    num_layers,
                )
            }
    if f"{p}model.layers.0.mlp.gate.weight" in sd:
        # Qwen3-MoE sparse block (modeling_qwen3_moe.py): router 'gate' +
        # per-expert gate/up/down -> models/moe.MoEMLP layout (experts
        # stacked on a leading [E] dim)
        E = 0
        while f"{p}model.layers.0.mlp.experts.{E}.gate_proj.weight" in sd:
            E += 1
        layers["mlp"]["gate"] = _stack(
            sd, f"{p}model.layers.{{}}.mlp.gate.weight", num_layers, True
        )
        for proj in ("gate_proj", "up_proj", "down_proj"):
            per_layer = []
            for l in range(num_layers):
                per_layer.append(np.stack([
                    _np(sd[f"{p}model.layers.{l}.mlp.experts.{e}.{proj}.weight"]).T
                    for e in range(E)
                ]))
            layers["mlp"][f"experts_{proj}"] = np.stack(per_layer)
    else:
        for proj in ("gate_proj", "up_proj", "down_proj"):
            layers["mlp"][proj] = {
                "kernel": _stack(
                    sd, f"{p}model.layers.{{}}.mlp.{proj}.weight", num_layers,
                    True
                )
            }
    for norm in ("input_layernorm", "post_attention_layernorm"):
        layers[norm] = {
            "weight": _stack(sd, f"{p}model.layers.{{}}.{norm}.weight", num_layers)
        }
    params: Dict = {
        "model": {"layers": layers, "norm": {"weight": _np(sd[f"{p}model.norm.weight"])}},
    }
    if f"{p}model.embed_tokens.weight" in sd:
        params["embed_tokens"] = {"embedding": _np(sd[f"{p}model.embed_tokens.weight"])}
    if f"{p}lm_head.weight" in sd:
        params["lm_head"] = {"kernel": _np(sd[f"{p}lm_head.weight"]).T}
    return params


# Llama shares Qwen2's parameter naming (biases simply absent)
convert_llama = convert_qwen2


def convert_internlm2(
    sd: Mapping, num_layers: int, num_heads: int, num_kv_heads: int,
    head_dim: int, prefix: str = "",
) -> Dict:
    """Vendored InternLM2 (internvl/model/internlm2/modeling_internlm2.py) ->
    Qwen2Model layout: unpack the grouped-fused wqkv ([kvh, groups+2, D, in])
    and rename attention/feed_forward/norm keys."""
    p = prefix
    g = num_heads // num_kv_heads
    L = num_layers

    def split_wqkv(w):
        w = _np(w)  # [out, in]
        din = w.shape[1]
        w = w.reshape(num_kv_heads, g + 2, head_dim, din)
        q = w[:, :g].reshape(num_heads * head_dim, din)
        k = w[:, g].reshape(num_kv_heads * head_dim, din)
        v = w[:, g + 1].reshape(num_kv_heads * head_dim, din)
        return q.T, k.T, v.T

    qs, ks, vs = [], [], []
    for i in range(L):
        q, k, v = split_wqkv(sd[f"{p}model.layers.{i}.attention.wqkv.weight"])
        qs.append(q)
        ks.append(k)
        vs.append(v)
    layers: Dict = {
        "self_attn": {
            "q_proj": {"kernel": np.stack(qs)},
            "k_proj": {"kernel": np.stack(ks)},
            "v_proj": {"kernel": np.stack(vs)},
            "o_proj": {
                "kernel": _stack(sd, f"{p}model.layers.{{}}.attention.wo.weight", L, True)
            },
        },
        "mlp": {
            "gate_proj": {"kernel": _stack(sd, f"{p}model.layers.{{}}.feed_forward.w1.weight", L, True)},
            "up_proj": {"kernel": _stack(sd, f"{p}model.layers.{{}}.feed_forward.w3.weight", L, True)},
            "down_proj": {"kernel": _stack(sd, f"{p}model.layers.{{}}.feed_forward.w2.weight", L, True)},
        },
        "input_layernorm": {
            "weight": _stack(sd, f"{p}model.layers.{{}}.attention_norm.weight", L)
        },
        "post_attention_layernorm": {
            "weight": _stack(sd, f"{p}model.layers.{{}}.ffn_norm.weight", L)
        },
    }
    return {
        "embed_tokens": {"embedding": _np(sd[f"{p}model.tok_embeddings.weight"])},
        "model": {"layers": layers, "norm": {"weight": _np(sd[f"{p}model.norm.weight"])}},
        "lm_head": {"kernel": _np(sd[f"{p}output.weight"]).T},
    }


def convert_phi3(
    sd: Mapping, num_layers: int, num_heads: int, num_kv_heads: int,
    head_dim: int, prefix: str = "",
) -> Dict:
    """Phi3 (internvl/model/phi3/modeling_phi3.py) -> Qwen2Model layout:
    split fused qkv_proj and gate_up_proj."""
    p = prefix
    L = num_layers
    qd, kvd = num_heads * head_dim, num_kv_heads * head_dim
    qs, ks, vs, gates, ups = [], [], [], [], []
    for i in range(L):
        w = _np(sd[f"{p}model.layers.{i}.self_attn.qkv_proj.weight"])
        qs.append(w[:qd].T)
        ks.append(w[qd : qd + kvd].T)
        vs.append(w[qd + kvd :].T)
        gu = _np(sd[f"{p}model.layers.{i}.mlp.gate_up_proj.weight"])
        inter = gu.shape[0] // 2
        gates.append(gu[:inter].T)
        ups.append(gu[inter:].T)
    layers: Dict = {
        "self_attn": {
            "q_proj": {"kernel": np.stack(qs)},
            "k_proj": {"kernel": np.stack(ks)},
            "v_proj": {"kernel": np.stack(vs)},
            "o_proj": {
                "kernel": _stack(sd, f"{p}model.layers.{{}}.self_attn.o_proj.weight", L, True)
            },
        },
        "mlp": {
            "gate_proj": {"kernel": np.stack(gates)},
            "up_proj": {"kernel": np.stack(ups)},
            "down_proj": {"kernel": _stack(sd, f"{p}model.layers.{{}}.mlp.down_proj.weight", L, True)},
        },
        "input_layernorm": {
            "weight": _stack(sd, f"{p}model.layers.{{}}.input_layernorm.weight", L)
        },
        "post_attention_layernorm": {
            "weight": _stack(sd, f"{p}model.layers.{{}}.post_attention_layernorm.weight", L)
        },
    }
    return {
        "embed_tokens": {"embedding": _np(sd[f"{p}model.embed_tokens.weight"])},
        "model": {"layers": layers, "norm": {"weight": _np(sd[f"{p}model.norm.weight"])}},
        "lm_head": {"kernel": _np(sd[f"{p}lm_head.weight"]).T},
    }


def convert_internvit(sd: Mapping, num_layers: int, prefix: str = "") -> Dict:
    """InternVisionModel state_dict -> InternViT flax params.

    Reference layout: modeling_intern_vit.py (embeddings.{class_embedding,
    patch_embedding,position_embedding}, encoder.layers.{i}.{attn,mlp,norm1,
    norm2,ls1,ls2}).
    """
    p = prefix
    emb = {
        "class_embedding": _np(sd[f"{p}embeddings.class_embedding"]).reshape(1, 1, -1),
        "position_embedding": _np(sd[f"{p}embeddings.position_embedding"]),
        "patch_embedding": {
            # torch conv [out, in, kh, kw] -> flax conv [kh, kw, in, out]
            "kernel": _np(sd[f"{p}embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd[f"{p}embeddings.patch_embedding.bias"]),
        },
    }
    L = num_layers
    lay: Dict = {
        "attn": {
            "qkv": {"kernel": _stack(sd, f"{p}encoder.layers.{{}}.attn.qkv.weight", L, True)},
            "proj": {
                "kernel": _stack(sd, f"{p}encoder.layers.{{}}.attn.proj.weight", L, True),
                "bias": _stack(sd, f"{p}encoder.layers.{{}}.attn.proj.bias", L),
            },
        },
        "mlp": {
            "fc1": {
                "kernel": _stack(sd, f"{p}encoder.layers.{{}}.mlp.fc1.weight", L, True),
                "bias": _stack(sd, f"{p}encoder.layers.{{}}.mlp.fc1.bias", L),
            },
            "fc2": {
                "kernel": _stack(sd, f"{p}encoder.layers.{{}}.mlp.fc2.weight", L, True),
                "bias": _stack(sd, f"{p}encoder.layers.{{}}.mlp.fc2.bias", L),
            },
        },
        "ls1": _stack(sd, f"{p}encoder.layers.{{}}.ls1", L),
        "ls2": _stack(sd, f"{p}encoder.layers.{{}}.ls2", L),
    }
    if f"{p}encoder.layers.0.attn.qkv.bias" in sd:
        lay["attn"]["qkv"]["bias"] = _stack(
            sd, f"{p}encoder.layers.{{}}.attn.qkv.bias", L
        )
    for norm in ("norm1", "norm2"):
        lay[norm] = {"weight": _stack(sd, f"{p}encoder.layers.{{}}.{norm}.weight", L)}
        bias_key = f"{p}encoder.layers.0.{norm}.bias"
        if bias_key in sd:
            lay[norm]["bias"] = _stack(sd, f"{p}encoder.layers.{{}}.{norm}.bias", L)
    if f"{p}encoder.layers.0.attn.q_norm.weight" in sd:
        lay["attn"]["q_norm"] = {
            "weight": _stack(sd, f"{p}encoder.layers.{{}}.attn.q_norm.weight", L)
        }
        lay["attn"]["k_norm"] = {
            "weight": _stack(sd, f"{p}encoder.layers.{{}}.attn.k_norm.weight", L)
        }
    return {"embeddings": emb, "encoder": lay}


def convert_internvl_chat(sd: Mapping, vision_layers: int, llm_layers: int) -> Dict:
    """Full InternVLChatModel state_dict -> VLM flax params.

    mlp1 = Sequential(LayerNorm, Linear, GELU, Linear) (modeling_internvl_chat.py:91-96).
    """
    params = {
        "vision_model": convert_internvit(sd, vision_layers, "vision_model."),
        "language_model": convert_qwen2(sd, llm_layers, "language_model."),
        "mlp1": {
            "norm": {"weight": _np(sd["mlp1.0.weight"]), "bias": _np(sd["mlp1.0.bias"])},
            "fc1": {"kernel": _np(sd["mlp1.1.weight"]).T, "bias": _np(sd["mlp1.1.bias"])},
            "fc2": {"kernel": _np(sd["mlp1.3.weight"]).T, "bias": _np(sd["mlp1.3.bias"])},
        },
    }
    return params


def _linear(sd: Mapping, key: str) -> Dict:
    out = {"kernel": _np(sd[f"{key}.weight"]).T}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _mixture_layers(sd: Mapping, prefix: str, num_layers: int) -> Dict:
    """One joint-model mixture's Qwen2 decoder layers -> stacked flax tree.

    Reference layout: src/model/vla/pizero_internvl.py:252-262 assigns
    internvl_model.language_model.model.layers (vlm) and
    action_expert.model.layers (proprio/action, shared) into
    joint_model.mixtures.<name>.layers.
    """
    p = prefix
    lay: Dict = {"mlp": {}}
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        entry = {
            "kernel": _stack(sd, f"{p}{{}}.self_attn.{proj}.weight", num_layers, True)
        }
        if f"{p}0.self_attn.{proj}.bias" in sd:
            entry["bias"] = _stack(sd, f"{p}{{}}.self_attn.{proj}.bias", num_layers)
        lay[proj] = entry
    for norm in ("q_norm", "k_norm"):  # Qwen3 mixtures (InternVL3.5)
        if f"{p}0.self_attn.{norm}.weight" in sd:
            lay[norm] = {
                "weight": _stack(
                    sd, f"{p}{{}}.self_attn.{norm}.weight", num_layers
                )
            }
    for proj in ("gate_proj", "up_proj", "down_proj"):
        lay["mlp"][proj] = {
            "kernel": _stack(sd, f"{p}{{}}.mlp.{proj}.weight", num_layers, True)
        }
    for norm in ("input_layernorm", "post_attention_layernorm"):
        lay[norm] = {"weight": _stack(sd, f"{p}{{}}.{norm}.weight", num_layers)}
    return lay


def convert_pizero_internvl(
    sd: Mapping, vit_layers: int, joint_layers: int
) -> Dict:
    """Reference PiZero (InternVL backbone) state_dict -> PiZeroVLA flax params.

    Source model: src/model/vla/pizero_internvl.py:154-337 — vision tower =
    internvl vision_model, multi_modal_projector = internvl mlp1, vlm mixture
    layers = internvl language_model layers, proprio/action mixtures = the
    768-wide action expert (shared weights), plus proprio/action/time encoders
    and the action decoder.
    """
    params: Dict = {
        "vision_model": convert_internvit(
            sd, vit_layers, "vision_tower.vision_model."
        ),
        "embed_tokens": {"embedding": _np(sd["embed_tokens.weight"])},
        "mlp1": {
            "norm": {
                "weight": _np(sd["multi_modal_projector.0.weight"]),
                "bias": _np(sd["multi_modal_projector.0.bias"]),
            },
            "fc1": _linear(sd, "multi_modal_projector.1"),
            "fc2": _linear(sd, "multi_modal_projector.3"),
        },
        "joint": {
            "layers": {
                "vlm": _mixture_layers(
                    sd, "joint_model.mixtures.vlm.layers.", joint_layers
                ),
                "expert": _mixture_layers(
                    sd, "joint_model.mixtures.action.layers.", joint_layers
                ),
            },
            "vlm_norm": {"weight": _np(sd["joint_model.mixtures.vlm.norm.weight"])},
            "expert_norm": {
                "weight": _np(sd["joint_model.mixtures.action.norm.weight"])
            },
        },
        "proprio_encoder": _linear(sd, "proprio_encoder"),
        "action_encoder": {
            name: _linear(sd, f"action_encoder.{name}")
            for name in ("linear_1", "linear_2", "linear_3")
        },
        "action_decoder": _linear(sd, "action_decoder"),
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": _np(sd["lm_head.weight"]).T}
    return params


def convert_siglip(sd: Mapping, num_layers: int, prefix: str = "") -> Dict:
    """Reference SigLIP tower (src/model/paligemma/siglip.py, the HF
    SiglipVisionModel layout) -> models/siglip.SiglipVisionModel flax params."""
    p = prefix

    def lnorm(key):
        return {"weight": _np(sd[f"{key}.weight"]),
                "bias": _np(sd[f"{key}.bias"])}

    layers: Dict = {"self_attn": {}}
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        layers["self_attn"][proj] = {
            "kernel": _stack(
                sd, f"{p}encoder.layers.{{}}.self_attn.{proj}.weight",
                num_layers, True,
            ),
            "bias": _stack(
                sd, f"{p}encoder.layers.{{}}.self_attn.{proj}.bias",
                num_layers,
            ),
        }
    for fc in ("fc1", "fc2"):
        layers[fc] = {
            "kernel": _stack(sd, f"{p}encoder.layers.{{}}.mlp.{fc}.weight",
                             num_layers, True),
            "bias": _stack(sd, f"{p}encoder.layers.{{}}.mlp.{fc}.bias",
                           num_layers),
        }
    for ln in ("layer_norm1", "layer_norm2"):
        layers[ln] = {
            "weight": _stack(sd, f"{p}encoder.layers.{{}}.{ln}.weight",
                             num_layers),
            "bias": _stack(sd, f"{p}encoder.layers.{{}}.{ln}.bias",
                           num_layers),
        }
    conv_w = _np(sd[f"{p}embeddings.patch_embedding.weight"])
    return {
        "patch_embedding": {
            # torch conv [out, in, kh, kw] -> flax [kh, kw, in, out]
            "kernel": conv_w.transpose(2, 3, 1, 0),
            "bias": _np(sd[f"{p}embeddings.patch_embedding.bias"]),
        },
        "position_embedding": _np(
            sd[f"{p}embeddings.position_embedding.weight"]
        )[None],
        "encoder": layers,
        "post_layernorm": lnorm(f"{p}post_layernorm"),
    }


def convert_pizero_paligemma(sd: Mapping, vit_layers: int,
                             joint_layers: int) -> Dict:
    """Reference PiZero (PaliGemma backbone, src/model/vla/pizero.py:41-153)
    state_dict -> PiZeroVLA(backbone='paligemma') flax params: SigLIP tower,
    single-linear projector, Gemma vlm + action mixtures (proprio tied to
    action), encoders/decoder, tied lm_head."""
    params: Dict = {
        "vision_model": convert_siglip(sd, vit_layers,
                                       "vision_tower.vision_model."),
        "embed_tokens": {"embedding": _np(sd["embed_tokens.weight"])},
        "multi_modal_projector": _linear(sd, "multi_modal_projector.linear"),
        "joint": {
            "layers": {
                "vlm": _mixture_layers(
                    sd, "joint_model.mixtures.vlm.layers.", joint_layers
                ),
                "expert": _mixture_layers(
                    sd, "joint_model.mixtures.action.layers.", joint_layers
                ),
            },
            # Gemma final norms are GemmaRMSNorm ((1+w) scaling, created only
            # when use_final_norm — the vlm mixture has none in the paligemma
            # recipe); our JointModel final norms are plain RMSNorm, so fold
            # the +1 and default the missing vlm norm to identity.
            "vlm_norm": {
                "weight": (
                    1.0 + _np(sd["joint_model.mixtures.vlm.norm.weight"])
                    if "joint_model.mixtures.vlm.norm.weight" in sd
                    else np.ones(
                        _np(sd["embed_tokens.weight"]).shape[1], np.float32
                    )
                )
            },
            "expert_norm": {
                "weight": 1.0
                + _np(sd["joint_model.mixtures.action.norm.weight"])
            },
        },
        "proprio_encoder": _linear(sd, "proprio_encoder"),
        "action_encoder": {
            name: _linear(sd, f"action_encoder.{name}")
            for name in ("linear_1", "linear_2", "linear_3")
        },
        "action_decoder": _linear(sd, "action_decoder"),
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": _np(sd["lm_head.weight"]).T}
    elif "embed_tokens.weight" in sd:
        # reference ties lm_head.weight = embed_tokens.weight (pizero.py:122)
        params["lm_head"] = {"kernel": _np(sd["embed_tokens.weight"]).T}
    return params


# safetensors dtype name <-> torch dtype
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str, mmap: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """One .safetensors file -> {name: CPU tensor at the written dtype}.
    mmap: the tensors are views of the file mapped copy-on-write, so only
    the pages a caller touches are read."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        size = max((e for v in header.values()
                    for e in v["data_offsets"][1:]), default=0)
        if mmap:
            whole = os.path.getsize(path)
            buf = torch.from_file(path, shared=False, size=whole,
                                  dtype=torch.uint8)[8 + n:8 + n + size]
            size = 0  # nothing to read
        else:
            buf = torch.empty(size, dtype=torch.uint8)
        view, got = memoryview(buf.numpy()) if size else None, 0
        while got < size:  # reads of at most 1 GiB, as the OS gives them
            n = f.readinto(view[got:got + 2**30])
            if not n:
                raise ValueError(f"{path}: truncated data")
            got += n
    out = {}
    for name, v in header.items():
        dtype = _ST_DTYPES.get(v["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name}: dtype {v['dtype']} not read")
        b, e = v["data_offsets"]
        raw = buf[b:e]
        if b % dtype.itemsize:  # an unaligned buffer: its own storage
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(v["shape"])
    return out


def load_safetensors_dir(path: str) -> Dict[str, np.ndarray]:
    """Load all *.safetensors shards in a directory into one flat dict of
    numpy arrays; BF16 tensors come back as fp32 (exact)."""
    import glob
    import os

    sd = {}
    for f in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
        for k, t in load_safetensors(f).items():
            sd[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return sd


# ---------------------------------------------------------------------------
# flax -> HF export (inverse of the converters above; tools/internvl_custom2hf
# analogue so trained checkpoints interoperate with the HF ecosystem)
# ---------------------------------------------------------------------------


def _unstack(dst: Dict, fmt: str, stacked, transpose: bool = False):
    arr = np.asarray(stacked)
    for i in range(arr.shape[0]):
        m = arr[i]
        dst[fmt.format(i)] = m.T if transpose else m


def export_qwen2(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Qwen2ForCausalLM flax params -> HF state_dict arrays (fp32 numpy)."""
    p = prefix
    out: Dict[str, np.ndarray] = {}
    layers = params["model"]["layers"]
    L = np.asarray(layers["input_layernorm"]["weight"]).shape[0]
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        entry = layers["self_attn"][proj]
        _unstack(out, f"{p}model.layers.{{}}.self_attn.{proj}.weight",
                 entry["kernel"], transpose=True)
        if "bias" in entry:
            _unstack(out, f"{p}model.layers.{{}}.self_attn.{proj}.bias",
                     entry["bias"])
    for proj in ("gate_proj", "up_proj", "down_proj"):
        _unstack(out, f"{p}model.layers.{{}}.mlp.{proj}.weight",
                 layers["mlp"][proj]["kernel"], transpose=True)
    for norm in ("input_layernorm", "post_attention_layernorm"):
        _unstack(out, f"{p}model.layers.{{}}.{norm}.weight",
                 layers[norm]["weight"])
    out[f"{p}model.norm.weight"] = np.asarray(params["model"]["norm"]["weight"])
    if "embed_tokens" in params:
        out[f"{p}model.embed_tokens.weight"] = np.asarray(
            params["embed_tokens"]["embedding"])
    if "lm_head" in params:
        out[f"{p}lm_head.weight"] = np.asarray(params["lm_head"]["kernel"]).T
    return out


def export_internvit(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    p = prefix
    out: Dict[str, np.ndarray] = {}
    emb = params["embeddings"]
    out[f"{p}embeddings.class_embedding"] = np.asarray(
        emb["class_embedding"]).reshape(1, 1, -1)
    out[f"{p}embeddings.position_embedding"] = np.asarray(
        emb["position_embedding"])
    out[f"{p}embeddings.patch_embedding.weight"] = np.asarray(
        emb["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1)
    out[f"{p}embeddings.patch_embedding.bias"] = np.asarray(
        emb["patch_embedding"]["bias"])
    lay = params["encoder"]
    _unstack(out, f"{p}encoder.layers.{{}}.attn.qkv.weight",
             lay["attn"]["qkv"]["kernel"], transpose=True)
    if "bias" in lay["attn"]["qkv"]:
        _unstack(out, f"{p}encoder.layers.{{}}.attn.qkv.bias",
                 lay["attn"]["qkv"]["bias"])
    _unstack(out, f"{p}encoder.layers.{{}}.attn.proj.weight",
             lay["attn"]["proj"]["kernel"], transpose=True)
    _unstack(out, f"{p}encoder.layers.{{}}.attn.proj.bias",
             lay["attn"]["proj"]["bias"])
    for fc in ("fc1", "fc2"):
        _unstack(out, f"{p}encoder.layers.{{}}.mlp.{fc}.weight",
                 lay["mlp"][fc]["kernel"], transpose=True)
        _unstack(out, f"{p}encoder.layers.{{}}.mlp.{fc}.bias",
                 lay["mlp"][fc]["bias"])
    _unstack(out, f"{p}encoder.layers.{{}}.ls1", lay["ls1"])
    _unstack(out, f"{p}encoder.layers.{{}}.ls2", lay["ls2"])
    for norm in ("norm1", "norm2"):
        _unstack(out, f"{p}encoder.layers.{{}}.{norm}.weight",
                 lay[norm]["weight"])
        if "bias" in lay[norm]:
            _unstack(out, f"{p}encoder.layers.{{}}.{norm}.bias",
                     lay[norm]["bias"])
    if "q_norm" in lay["attn"]:
        _unstack(out, f"{p}encoder.layers.{{}}.attn.q_norm.weight",
                 lay["attn"]["q_norm"]["weight"])
        _unstack(out, f"{p}encoder.layers.{{}}.attn.k_norm.weight",
                 lay["attn"]["k_norm"]["weight"])
    return out


def export_internvl_chat(params: Mapping) -> Dict[str, np.ndarray]:
    """InternVLChatModel flax params -> full HF state_dict arrays
    (inverse of convert_internvl_chat; roundtrip-tested)."""
    out = export_internvit(params["vision_model"], "vision_model.")
    out.update(export_qwen2(params["language_model"], "language_model."))
    mlp1 = params["mlp1"]
    out["mlp1.0.weight"] = np.asarray(mlp1["norm"]["weight"])
    out["mlp1.0.bias"] = np.asarray(mlp1["norm"]["bias"])
    out["mlp1.1.weight"] = np.asarray(mlp1["fc1"]["kernel"]).T
    out["mlp1.1.bias"] = np.asarray(mlp1["fc1"]["bias"])
    out["mlp1.3.weight"] = np.asarray(mlp1["fc2"]["kernel"]).T
    out["mlp1.3.bias"] = np.asarray(mlp1["fc2"]["bias"])
    return out


def _as_torch(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    a = np.asarray(v)
    a = a if a.flags.c_contiguous else a.copy(order="C")  # 0-d stays 0-d
    if a.dtype.name == "bfloat16":  # an ml_dtypes array
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_safetensors(state_dict: Mapping, path: str):
    """Write an HF-layout state dict (numpy arrays or torch tensors, on any
    device; torch bfloat16 kept as BF16) to one .safetensors file. Tensors
    are laid out by decreasing element size, so every buffer is aligned to
    its element."""
    tensors = {k: _as_torch(v) for k, v in state_dict.items()}
    write_safetensors([(k, tuple(t.shape), t.dtype, lambda t=t: t)
                       for k, t in tensors.items()], path)


def write_safetensors(entries, path: Optional[str]):
    """Stream `entries` [(name, shape, dtype, fetch)] to one .safetensors
    file in save_safetensors' layout: the header from the shapes first,
    then fetch() -> each tensor, written and dropped one at a time. With
    path None every fetch is still made, in the same order, and nothing
    is written (a rank that joins collective fetches)."""
    items = sorted(entries, key=lambda e: (-e[2].itemsize, e[0]))
    header, ofs = {}, 0
    for k, shape, dtype, _ in items:
        if dtype not in _ST_NAMES:
            raise ValueError(f"{k}: dtype {dtype} has no safetensors name")
        n = math.prod(shape) * dtype.itemsize
        header[k] = {"dtype": _ST_NAMES[dtype], "shape": list(shape),
                     "data_offsets": [ofs, ofs + n]}
        ofs += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    f = open(path, "wb") if path is not None else None
    try:
        if f is not None:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
        for k, shape, dtype, fetch in items:
            t = fetch()
            if f is None:
                continue
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                raise ValueError(f"{k}: got {tuple(t.shape)} {t.dtype}, "
                                 f"declared {tuple(shape)} {dtype}")
            t = t.contiguous().cpu().reshape(-1)
            f.write(memoryview(t.view(torch.uint8).numpy()))
    finally:
        if f is not None:
            f.close()


def save_hf_checkpoint_dir(state_dict: Mapping, path: str,
                           config: Optional[Mapping] = None,
                           num_shards: int = 2):
    """Write a full HF-layout checkpoint DIRECTORY: sharded
    model-XXXXX-of-YYYYY.safetensors + model.safetensors.index.json
    (+ config.json when `config` is given) — the on-disk layout
    `load_safetensors_dir` / `scripts/eval_vlm.py --model_path` consume,
    and the layout a real Vlaser download has (reference loader:
    modeling_internvl_chat.py:48-110 via HF from_pretrained). Keys are
    greedily assigned to the currently-smallest shard, giving
    `num_shards` roughly-equal-byte shards."""
    import json
    import os

    os.makedirs(path, exist_ok=True)
    items = sorted(state_dict.items())
    shards: list = [dict() for _ in range(num_shards)]
    sizes = [0] * num_shards
    for k, v in items:
        i = sizes.index(min(sizes))  # greedy balance by bytes
        shards[i][k] = v
        sizes[i] += (v.numel() * v.element_size() if isinstance(
            v, torch.Tensor) else np.asarray(v).nbytes)
    index = {"metadata": {"total_size": int(sum(sizes))}, "weight_map": {}}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{num_shards:05d}.safetensors"
        save_safetensors(shard, os.path.join(path, name))
        for k in shard:
            index["weight_map"][k] = name
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f, indent=2)
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dict(config), f, indent=2)
