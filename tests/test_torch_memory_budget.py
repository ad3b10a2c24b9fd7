"""The port's memory budget (vlaser_tpu_torch/utils/memory_budget.py) and the
rule layer of its mesh (core/mesh.py) against the JAX package's: the same
parameter paths and shapes from the port's meta-device models as JAX's
eval_shape gives, the same spec on every path under every rule set, and
equal budgets on the meshes and options of tests/test_memory_budget.py."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlaser_tpu.core import config as jcfg
from vlaser_tpu.core import mesh as jmesh
from vlaser_tpu.utils import memory_budget as jbudget
from vlaser_tpu_torch.core import config as tcfg
from vlaser_tpu_torch.core import mesh as tmesh
from vlaser_tpu_torch.utils import memory_budget as tbudget

META = torch.device("meta")
VLM_SIZES = {"2b": "vlaser_2b", "8b": "vlaser_8b",
             "30b-a3b": "internvl3_5_30b_a3b", "38b": "internvl3_38b",
             "78b": "internvl3_78b", "100b": "internvl_100b_class"}


def _vla_cfg(mod, size):
    if size == "8b":
        return mod.VLAConfig(vlm=mod.vlaser_8b(151674 + 256),
                             expert=mod.action_expert_8b())
    return mod.vlaser_2b_vla()


def _jax_vla_shapes(cfg):
    """vla_train_budget's eval_shape of PiZeroVLA.init."""
    from vlaser_tpu.policy.pizero import PiZeroVLA

    model = PiZeroVLA(cfg, param_dtype=jnp.float32,
                      compute_dtype=jnp.bfloat16)
    S, img, A = (cfg.max_image_text_tokens, cfg.vlm.vision.image_size,
                 cfg.num_action_tokens)
    f32 = jnp.float32
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32),
        jnp.zeros((1, img, img, 3), f32), jnp.ones((1, S), jnp.int32),
        jnp.zeros((1, cfg.cond_steps, cfg.proprio_dim), f32),
        jnp.zeros((1, A, cfg.action_dim), f32), jnp.zeros((1,), f32),
        jnp.zeros((1, A, cfg.action_dim), f32)))


def _jax_vlm_shapes(cfg, seq_len=4096):
    """vlm_sft_budget's eval_shape of InternVLChatModel.init."""
    from vlaser_tpu.models.vlm import InternVLChatModel

    model = InternVLChatModel(cfg, param_dtype=jnp.float32,
                              compute_dtype=jnp.bfloat16)
    img = cfg.vision.image_size
    n = max(seq_len // 8, cfg.num_image_token + 2)
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, n), jnp.int32),
        jnp.zeros((1, img, img, 3), jnp.float32), jnp.ones((1,), jnp.int32)))


def _jax_leaves(tree):
    return {jmesh._path_str(p): tuple(l.shape)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(model):
    return {p: s for p, s, _ in tbudget.param_leaves(model)}


def _models():
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA

    for size in ("2b", "8b"):
        yield (f"vla-{size}",
               lambda s=size: _jax_vla_shapes(_vla_cfg(jcfg, s)),
               lambda s=size: PiZeroVLA(_vla_cfg(tcfg, s), device=META))
    for size, fn in VLM_SIZES.items():
        yield (f"vlm-{size}",
               lambda fn=fn: _jax_vlm_shapes(getattr(jcfg, fn)()),
               lambda fn=fn: InternVLChatModel(getattr(tcfg, fn)(),
                                               device=META))


MODELS = {name: (j, t) for name, j, t in _models()}
RULE_SETS = {
    "default": (jmesh.default_param_rules(), tmesh.default_param_rules()),
    "fsdp_only": (jmesh.default_param_rules(fsdp_only=True),
                  tmesh.default_param_rules(fsdp_only=True)),
    "stageify": (jmesh.stageify_rules(jmesh.default_param_rules()),
                 tmesh.stageify_rules(tmesh.default_param_rules())),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_paths_shapes_and_specs_match_jax(name):
    """Every parameter's (path, shape) of the port's meta-device model
    equals JAX eval_shape's flattened tree (the patch convs in JAX's HWIO),
    and spec_for gives the same tuple on every path under every rule set."""
    jax_fn, port_fn = MODELS[name]
    want = _jax_leaves(jax_fn())
    got = _port_leaves(port_fn())
    assert got == want
    for jr, tr in RULE_SETS.values():
        for path in want:
            assert tmesh.spec_for(path, tr) == tuple(
                jmesh.spec_for(path, jr)), path


def test_rule_sets_and_batch_spec_match_jax():
    for jr, tr in RULE_SETS.values():
        assert [(p, tuple(s)) for p, s in jr] == list(tr)
    for n in (0, 1, 3):
        assert tmesh.batch_spec(n) == tuple(jmesh.batch_spec(n))
    for a in ("DATA_AXIS", "FSDP_AXIS", "CONTEXT_AXIS", "TENSOR_AXIS",
              "STAGE_AXIS", "AXES", "BATCH_AXES"):
        assert getattr(tmesh, a) == getattr(jmesh, a), a
    assert tmesh.path_str(
        "vision_model.embeddings.patch_embedding.weight") == \
        "params/vision_model/embeddings/patch_embedding/kernel"


def _same_budget(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float):
            assert math.isclose(got[k], w, rel_tol=1e-12, abs_tol=0.0), k
        else:
            assert got[k] == w, k


VLA_CASES = [
    dict(dp=1, fsdp=8, tp=1),
    dict(dp=2, fsdp=4, tp=1),
    dict(dp=8, fsdp=1, tp=1),
    dict(dp=1, fsdp=8, tp=1, frozen_patterns=(r"vision_model/",)),
    dict(dp=1, fsdp=8, tp=1, model_size="8b", param_bytes=2,
         frozen_patterns=(r"vision_model/",)),
    dict(dp=2, fsdp=16, tp=1, model_size="8b"),
    dict(dp=1, fsdp=4, tp=2, per_device_batch=4),
]
VLM_CASES = [
    dict(dp=1, fsdp=16, tp=4, pp=1, seq_len=4096),
    dict(dp=1, fsdp=16, tp=2, pp=2, seq_len=4096),
    dict(dp=1, fsdp=8, tp=4, pp=1, seq_len=4096, param_bytes=2),
    dict(dp=1, fsdp=16, tp=2, pp=2, seq_len=4096, model_size="30b-a3b"),
    dict(dp=1, fsdp=32, tp=2, pp=2, seq_len=4096, model_size="78b",
         offload_optimizer=True),
    dict(dp=1, fsdp=32, tp=2, pp=4, seq_len=4096, model_size="100b"),
    dict(dp=1, fsdp=1, tp=1, cp=8, seq_len=131072, model_size="2b"),
    dict(dp=2, fsdp=4, tp=1, model_size="8b", per_device_batch=2,
         frozen_patterns=(r"vision_model/",)),
]


@pytest.mark.parametrize("kw", VLA_CASES, ids=str)
def test_vla_train_budget_matches_jax(kw):
    _same_budget(tbudget.vla_train_budget(**kw),
                 jbudget.vla_train_budget(**kw))


@pytest.mark.parametrize("kw", VLM_CASES, ids=str)
def test_vlm_sft_budget_matches_jax(kw):
    _same_budget(tbudget.vlm_sft_budget(**kw), jbudget.vlm_sft_budget(**kw))


def test_chip_smoke_budget_rows_match_jax(monkeypatch):
    """The one-device rows chip_smoke.py's phase 53 prints: each equals the
    JAX package's arithmetic (phase 47's adaLN-Zero + vision-in-expert
    config, at its cut depth, through JAX's own vla_train_budget, its
    Vlaser-2B-VLA factory swapped for that config)."""
    import chip_smoke

    rows = chip_smoke.budget_rows(tcfg)
    assert len(rows) == 7
    for label, fn, kw, cfg_over in rows:
        got = (tbudget._vla_budget(cfg_over, **kw) if cfg_over is not None
               else getattr(tbudget, fn)(**kw))
        if cfg_over is not None:
            jover = dataclasses.replace(
                jcfg.vlaser_2b_vla(),
                **{f.name: getattr(cfg_over, f.name)
                   for f in dataclasses.fields(cfg_over)
                   if f.name not in ("vlm", "expert", "siglip")})
            # phase 47's depth (chip_smoke.ABLATION_LAYERS, both mixtures)
            jover = dataclasses.replace(
                jover, vlm=dataclasses.replace(
                    jover.vlm, llm=dataclasses.replace(
                        jover.vlm.llm,
                        num_layers=cfg_over.vlm.llm.num_layers)),
                expert=dataclasses.replace(
                    jover.expert, num_layers=cfg_over.expert.num_layers))
            monkeypatch.setattr(jcfg, "vlaser_2b_vla", lambda: jover)
        want = getattr(jbudget, fn)(**kw)
        monkeypatch.undo()
        _same_budget(got, want)
        assert got["mesh"].strip("x1") == "", label  # one device
    # the rows the roadmap's waits rest on (Vlaser-2B-VLA at B 32, the MoE)
    by = {label: fn for label, fn, _, _ in rows}
    assert "11 VLA b32, fp32 AdamW" in by and "30B-A3B SFT" in by
