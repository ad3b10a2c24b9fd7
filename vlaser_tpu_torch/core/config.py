"""Model configurations of the port: the four dataclasses and the named
factories it uses, copied from vlaser_tpu/core/config.py (fields and
defaults unchanged; the PaliGemma/SigLIP, 6B/8B and larger configs are not
copied).

The port's modules read a config only through attribute access, so they
take the JAX package's config objects as well as these: a test may build a
config on the JAX side and hand the same object to both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class VisionConfig:
    """InternViT-style vision transformer."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 448
    qkv_bias: bool = True
    qk_normalization: bool = False  # RMSNorm over the flattened (H*D) dim
    norm_type: str = "layer_norm"  # 'layer_norm' (300M) | 'rms_norm' (6B)
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu"
    initializer_factor: float = 0.1  # layer-scale init
    drop_path_rate: float = 0.0
    use_cls_token: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        n = self.num_patches_per_side ** 2
        return n + 1 if self.use_cls_token else n


@dataclass(frozen=True)
class LLMConfig:
    """Qwen2.5-style causal LM (also the 768-wide action expert)."""

    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_layers: int = 28
    num_heads: int = 12
    num_kv_heads: int = 2
    head_dim: int = 128  # not hidden_size // num_heads for the action expert
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    attention_bias: bool = True  # Qwen2: q/k/v bias, no o bias
    qk_norm: bool = False  # Qwen3 per-head q/k RMSNorm
    has_embed: bool = True
    has_lm_head: bool = True
    mlp_act: str = "silu"  # 'silu' | 'gelu_tanh' (Gemma)
    rms_plus_one: bool = False  # Gemma RMSNorm scales by (1 + weight)
    embed_scale: bool = False
    attn_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    query_pre_attn_scalar: Optional[float] = None
    rope_short_factor: Optional[Tuple[float, ...]] = None
    rope_long_factor: Optional[Tuple[float, ...]] = None
    original_max_position: Optional[int] = None
    context_parallel_axis: Optional[str] = None
    num_experts: int = 0
    num_experts_per_tok: int = 8
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = True
    moe_capacity_factor: Optional[float] = None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class VLMConfig:
    """InternVL-chat-style fusion of vision encoder + LLM."""

    vision: VisionConfig = field(default_factory=VisionConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    downsample_ratio: float = 0.5
    ps_version: str = "v2"
    select_layer: int = -1
    template: str = "internvl2_5"
    dynamic_image_size: bool = True
    use_thumbnail: bool = True
    min_dynamic_patch: int = 1
    max_dynamic_patch: int = 12
    img_context_token_id: int = 151667
    img_start_token_id: int = 151665
    img_end_token_id: int = 151666
    pad_token_id: int = 151643

    @property
    def num_image_token(self) -> int:
        """Tokens per 448px tile after pixel-shuffle: (448/14)^2 * 0.25."""
        v = self.vision
        return int((v.image_size // v.patch_size) ** 2
                   * (self.downsample_ratio ** 2))

    @property
    def vit_proj_in_dim(self) -> int:
        return self.vision.hidden_size * int(1 / self.downsample_ratio) ** 2


@dataclass(frozen=True)
class VLAConfig:
    """PiZero-style flow-matching VLA: VLM mixture + proprio/action expert."""

    vlm: VLMConfig = field(default_factory=VLMConfig)
    expert: LLMConfig = field(default_factory=LLMConfig)
    max_image_text_tokens: int = 384
    cond_steps: int = 1
    horizon_steps: int = 4
    action_dim: int = 7
    proprio_dim: int = 7
    num_inference_steps: int = 10
    flow_sig_min: float = 0.001
    flow_alpha: float = 1.5  # Beta(alpha, beta) time sampling, s*(1-z)
    flow_beta: float = 1.0
    flow_t_max: float = 1.0 - 0.001
    final_action_clip_value: Optional[float] = 1.0
    time_max_period: float = 10_000.0
    causal_image_text: bool = False
    backbone: str = "internvl"  # the port has the internvl backbone only
    siglip: Optional[object] = None
    use_lm_head: bool = False
    adaptive_mode: Optional[str] = None
    time_hidden_size: int = 256
    vision_in_expert: bool = False

    @property
    def num_proprio_tokens(self) -> int:
        return 1

    @property
    def num_action_tokens(self) -> int:
        return self.horizon_steps + self.cond_steps - 1

    @property
    def total_tokens(self) -> int:
        return (self.max_image_text_tokens + self.num_proprio_tokens
                + self.num_action_tokens)


def internvit_300m(image_size: int = 448) -> VisionConfig:
    """InternViT-300M-448px."""
    return VisionConfig(hidden_size=1024, intermediate_size=4096,
                        num_layers=24, num_heads=16, image_size=image_size,
                        qkv_bias=True, qk_normalization=False,
                        norm_type="layer_norm")


def qwen2_5_1_5b(vocab_size: int = 151936) -> LLMConfig:
    return LLMConfig(vocab_size=vocab_size, hidden_size=1536,
                     intermediate_size=8960, num_layers=28, num_heads=12,
                     num_kv_heads=2, head_dim=128, rope_theta=1_000_000.0)


def action_expert_2b() -> LLMConfig:
    """768-wide expert sharing the head layout of Qwen2.5-1.5B."""
    return LLMConfig(vocab_size=0, hidden_size=768, intermediate_size=8960,
                     num_layers=28, num_heads=12, num_kv_heads=2,
                     head_dim=128, rope_theta=1_000_000.0, has_embed=False,
                     has_lm_head=False)


def vlaser_2b(vocab_size: int = 151674) -> VLMConfig:
    """Vlaser-2B = InternViT-300M + Qwen2.5-1.5B (+9 special tokens)."""
    return VLMConfig(vision=internvit_300m(), llm=qwen2_5_1_5b(vocab_size))


def vlaser_2b_vla(vocab_size: int = 151674 + 256) -> VLAConfig:
    """Vlaser-2B-VLA: VLM mixture + 768-wide expert (256 action tokens
    appended to the vocab)."""
    return VLAConfig(vlm=vlaser_2b(vocab_size), expert=action_expert_2b())


def tiny_vision(image_size: int = 28) -> VisionConfig:
    return VisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                        num_heads=4, patch_size=14, image_size=image_size,
                        qkv_bias=True, qk_normalization=True,
                        norm_type="layer_norm")


def tiny_llm(vocab_size: int = 512) -> LLMConfig:
    return LLMConfig(vocab_size=vocab_size, hidden_size=64,
                     intermediate_size=128, num_layers=2, num_heads=4,
                     num_kv_heads=2, head_dim=16, rope_theta=10_000.0)


def tiny_expert() -> LLMConfig:
    return LLMConfig(vocab_size=0, hidden_size=32, intermediate_size=64,
                     num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                     rope_theta=10_000.0, has_embed=False, has_lm_head=False)


def tiny_vlm() -> VLMConfig:
    return VLMConfig(vision=tiny_vision(), llm=tiny_llm(),
                     img_context_token_id=500, img_start_token_id=498,
                     img_end_token_id=499, pad_token_id=0,
                     max_dynamic_patch=4)


def tiny_vla(max_image_text_tokens: int = 16) -> VLAConfig:
    return VLAConfig(vlm=tiny_vlm(), expert=tiny_expert(),
                     max_image_text_tokens=max_image_text_tokens,
                     horizon_steps=4, cond_steps=1, action_dim=7,
                     proprio_dim=7, num_inference_steps=4)
