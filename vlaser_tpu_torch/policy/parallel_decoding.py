"""RoboTwin parallel-decoding VLA policy (internvla_2B_parallel_decoding),
the port of vlaser_tpu/policy/parallel_decoding.py.

One pass per control step: the static layout [bos | <soi> image <eoi> |
<sot> text <eot> | per-arm state | left slots | right slots | eos] goes
through InternViT + mlp1 + Qwen2 with full bidirectional attention (text
padding is segment 0, so no row attends it), the action-slot embeddings
are zeroed, and an MLPResNet L1 head maps each chunk row's concatenated
slot hidden states to its actions. The layout is static: the slot gather
is two fixed slices, concatenated left then right and reshaped to [B,
chunk, action_dim * D], the JAX module's order.

Module names are the JAX parameter tree's (`embed_tokens`, `language_model`
a bare Qwen2Model, `mlp1`, `vision_model`, `action_head`), so
utils/convert.from_jax_variables loads a JAX tree as it is. `attn_impl`
routes the ViT's and the LLM's attention ("auto" | "kernel" |
"reference"), as the JAX flag does; `set_impl` routes the LLM's RMSNorm
beside it (models/layers.set_rms_impl). The model is built on the CUDA
card unless another device is asked for (device="cpu").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import VLMConfig, vlaser_2b
from ..kernels import ops
from ..models.internvit import InternVisionModel
from ..models.layers import Dense, Embed, LayerNorm, set_rms_impl
from ..models.qwen2 import Qwen2Model
from ..models.vlm import MLP1, scatter_image_embeds


@dataclass(frozen=True)
class ParallelDecodingConfig:
    vlm: VLMConfig = field(default_factory=lambda: vlaser_2b())
    action_chunk: int = 8
    action_dim: int = 14  # dual-arm joint deltas
    state_dim: int = 14
    state_vocab_size: int = 512
    max_text_tokens: int = 32
    head_hidden: int = 1536

    @property
    def num_image_tokens(self) -> int:
        return self.vlm.num_image_token

    @property
    def slots_per_arm(self) -> int:
        return self.action_chunk * self.action_dim // 2

    def layout(self) -> Dict[str, Tuple[int, int]]:
        """Static [start, end) spans of each section."""
        spans = {}
        p = 0

        def put(name, n):
            nonlocal p
            spans[name] = (p, p + n)
            p += n

        put("bos", 1)
        put("soi", 1)
        put("image", self.num_image_tokens)
        put("eoi", 1)
        put("sot", 1)
        put("text", self.max_text_tokens)
        put("eot", 1)
        put("left_sost", 1)
        put("left_state", self.state_dim // 2)
        put("left_eost", 1)
        put("right_sost", 1)
        put("right_state", self.state_dim // 2)
        put("right_eost", 1)
        put("left_soa", 1)
        put("left_slots", self.slots_per_arm)
        put("left_eoa", 1)
        put("right_soa", 1)
        put("right_slots", self.slots_per_arm)
        put("right_eoa", 1)
        put("eos", 1)
        spans["total"] = (0, p)
        return spans


def discretize_state(qpos: np.ndarray, vocab: int = 512,
                     low: float = -1.0, high: float = 1.0) -> np.ndarray:
    """Continuous joint state -> <state_i> bin indices in [0, vocab)."""
    x = np.clip((qpos - low) / (high - low), 0.0, 1.0 - 1e-6)
    return (x * vocab).astype(np.int32)


class MLPResNetBlock(nn.Module):
    def __init__(self, dim: int, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.norm = LayerNorm(dim, 1e-5, (), param_dtype, device)
        self.fc = Dense(dim, dim, True, (), param_dtype, compute_dtype, device)

    def forward(self, x):
        return x + F.relu(self.fc(self.norm(x)))


class L1RegressionActionHead(nn.Module):
    """MLPResNet over each chunk row's concatenated slot hidden states:
    [B, chunk, action_dim * D] -> [B, chunk, action_dim] fp32."""

    def __init__(self, input_dim: int, hidden_dim: int, action_dim: int,
                 num_blocks: int = 2, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None):
        super().__init__()
        pd, cd = param_dtype, compute_dtype
        self.norm1 = LayerNorm(input_dim, 1e-5, (), pd, device)
        self.fc1 = Dense(input_dim, hidden_dim, True, (), pd, cd, device)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", MLPResNetBlock(hidden_dim, pd, cd,
                                                        device))
        self.norm2 = LayerNorm(hidden_dim, 1e-5, (), pd, device)
        self.fc2 = Dense(hidden_dim, action_dim, True, (), pd, cd, device)

    def forward(self, slot_hidden):
        x = F.relu(self.fc1(self.norm1(slot_hidden)))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return self.fc2(self.norm2(x)).float()


class ParallelDecodingVLA(nn.Module):
    """UnitModel: InternVL backbone + zero-slot parallel decoding + L1
    head. `device` None means the CUDA card (a box without one raises)."""

    def __init__(self, cfg: ParallelDecodingConfig, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, device=None,
                 remat: bool = False, attn_impl: str = "auto"):
        super().__init__()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ParallelDecodingVLA: no CUDA device; pass device='cpu' "
                    "to build on the CPU")
            device = torch.device("cuda")
        vlm = cfg.vlm
        pd, cd = param_dtype, compute_dtype
        self.cfg, self.attn_impl = cfg, attn_impl
        self.vision_model = InternVisionModel(vlm.vision, pd, cd, device,
                                              remat=remat,
                                              attn_impl=attn_impl)
        self.mlp1 = MLP1(vlm.vit_proj_in_dim, vlm.llm.hidden_size, pd, cd,
                         device)
        self.embed_tokens = Embed(vlm.llm.vocab_size, vlm.llm.hidden_size,
                                  pd, cd, device)
        self.language_model = Qwen2Model(vlm.llm, pd, cd, device, remat)
        self.action_head = L1RegressionActionHead(
            vlm.llm.hidden_size * cfg.action_dim, cfg.head_hidden,
            cfg.action_dim, param_dtype=pd, compute_dtype=cd, device=device)
        spans = cfg.layout()
        slot = torch.zeros(spans["total"][1], dtype=torch.bool)
        for k in ("left_slots", "right_slots"):
            s, e = spans[k]
            slot[s:e] = True
        self.slot_mask = slot  # a host constant, not a weight: [S] bool
        self.set_impl(attn_impl)

    def set_impl(self, attn_impl: str, rms_impl: str = "auto") -> None:
        """Route the ViT's and the LLM's attention and the LLM's RMSNorm
        ("auto" | "kernel" | "reference")."""
        self.attn_impl = self.vision_model.encoder.attn_impl = attn_impl
        set_rms_impl(self, rms_impl)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.embedding.device

    def backbone_hidden(self, input_ids, pixel_values, text_mask):
        """input_ids [B, S] the full static layout (slot ids arbitrary),
        pixel_values [B, H, W, 3], text_mask [B, S] (1 attended, 0 on text
        padding) -> the LLM's final hidden states [B, S, D]."""
        cfg = self.cfg.vlm
        tok = self.embed_tokens(input_ids)
        # action slots carry zero embeddings (train_mine_new.py:606-609)
        slot = self.slot_mask.to(tok.device, non_blocking=True)
        tok = torch.where(slot[None, :, None],
                          torch.zeros((), dtype=tok.dtype, device=tok.device),
                          tok)
        vit = self.vision_model(pixel_values, select_layer=cfg.select_layer)
        vit = vit[:, 1:, :]
        t, s, c = vit.shape
        side = int(s ** 0.5)
        vit = ops.pixel_shuffle(vit.reshape(t, side, side, c),
                                cfg.downsample_ratio, cfg.ps_version)
        vit = self.mlp1(vit.reshape(t, -1, vit.shape[-1]))
        embeds = scatter_image_embeds(input_ids, tok, vit, None,
                                      cfg.img_context_token_id)
        b, n, _ = embeds.shape
        positions = torch.arange(n, device=embeds.device)[None].expand(b, n)
        hidden, _ = self.language_model(embeds, positions, seg_ids=text_mask,
                                        causal=False,
                                        attn_impl=self.attn_impl)
        return hidden

    def forward(self, input_ids, pixel_values, text_mask):
        """-> predicted actions [B, chunk, action_dim] fp32 (one pass)."""
        cfg = self.cfg
        hidden = self.backbone_hidden(input_ids, pixel_values, text_mask)
        spans = cfg.layout()
        ls, le = spans["left_slots"]
        rs, re = spans["right_slots"]
        slots = torch.cat([hidden[:, ls:le], hidden[:, rs:re]], dim=1)
        # [B, chunk * action_dim, D] -> [B, chunk, action_dim * D]
        slots = slots.reshape(slots.shape[0], cfg.action_chunk, -1)
        return self.action_head(slots)

    def loss(self, input_ids, pixel_values, text_mask, actions):
        """L1 regression loss (train_mine_new.py:690-695)."""
        pred = self(input_ids, pixel_values, text_mask)
        return (pred - actions.float()).abs().mean()


# the reference's call-site name (envs/_base_task.py:2944)
UnitModel = ParallelDecodingVLA


class SequenceBuilder:
    """Host-side builder of the static token layout from tokenizer ids."""

    def __init__(self, cfg: ParallelDecodingConfig, token_ids: Dict[str, int],
                 state_token_start: int, pad_token_id: int):
        self.cfg = cfg
        self.tok = token_ids  # bos, eos, soi, eoi, sot, eot, per-arm markers
        self.state_token_start = state_token_start
        self.pad_token_id = pad_token_id
        self.spans = cfg.layout()

    def build(self, text_ids: np.ndarray, qpos: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """text_ids [B, <=max_text], qpos [B, state_dim] -> (input_ids
        int32 [B, S], mask int32 [B, S])."""
        cfg = self.cfg
        b = text_ids.shape[0]
        total = self.spans["total"][1]
        ids = np.full((b, total), self.pad_token_id, np.int64)
        mask = np.ones((b, total), np.int32)
        t = self.tok
        state_ids = self.state_token_start + discretize_state(
            qpos, cfg.state_vocab_size)

        def fill(name, value):
            s, e = self.spans[name]
            ids[:, s:e] = value

        fill("bos", t["bos"])
        fill("soi", t["soi"])
        fill("image", t["img_context"])
        fill("eoi", t["eoi"])
        fill("sot", t["sot"])
        s, e = self.spans["text"]
        n = min(text_ids.shape[1], e - s)
        ids[:, s:s + n] = text_ids[:, :n]
        mask[:, s:e] = 0
        mask[:, s:s + n] = (text_ids[:, :n] != self.pad_token_id).astype(
            np.int32)
        fill("eot", t["eot"])
        fill("left_sost", t["left_arm_sost"])
        s, e = self.spans["left_state"]
        ids[:, s:e] = state_ids[:, :cfg.state_dim // 2]
        fill("left_eost", t["left_arm_eost"])
        fill("right_sost", t["right_arm_sost"])
        s, e = self.spans["right_state"]
        ids[:, s:e] = state_ids[:, cfg.state_dim // 2:]
        fill("right_eost", t["right_arm_eost"])
        fill("left_soa", t["left_arm_soa"])
        fill("left_slots", self.pad_token_id)  # embeddings zeroed anyway
        fill("left_eoa", t["left_arm_eoa"])
        fill("right_soa", t["right_arm_soa"])
        fill("right_slots", self.pad_token_id)
        fill("right_eoa", t["right_arm_eoa"])
        fill("eos", t["eos"])
        return ids.astype(np.int32), mask
