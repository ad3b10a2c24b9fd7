"""The DeviceMesh half of the port's core/mesh.py (make_mesh,
tree_shardings, shard_batch, batch_shard) against the JAX package's
core/mesh.py on 8 devices: the same axis names and sizes in the same
order, the same rank grid, and for every parameter of the tiny models
(and tests/test_sharding.py:42-52's leaves) the DTensor placements that
JAX's PartitionSpec gives, non-dividing dims degraded to Replicate. The
port's meshes are built on 8 gloo ranks of one spawn
(tests/torch_ranks.py)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

MESHES = {  # (dp, fsdp, tp, cp, pp)
    "dp_fsdp": (-1, 2, 1, 1, 1),
    "dp_fsdp_tp": (2, 2, 2, 1, 1),
    "cp4": (-1, 1, 1, 4, 1),
    "fsdp_cp": (-1, 2, 1, 2, 1),
    "fsdp_pp": (-1, 2, 1, 1, 2),
    "all": (1, 2, 1, 2, 2),
}
RULE_MESHES = ("dp_fsdp", "dp_fsdp_tp", "fsdp_cp")
BATCH = {"x": (8, 3), "ids": (8,), "odd": (6, 3), "scalar": ()}


def _leaves():
    """{port parameter name: shape} of the tiny VLA, a tiny MoE stack and
    a few hand-made leaves (one whose fsdp dim does not divide)."""
    from vlaser_tpu_torch.core.config import tiny_llm, tiny_vla
    from vlaser_tpu_torch.models.qwen2 import Qwen2ForCausalLM
    from vlaser_tpu_torch.policy.pizero import PiZeroVLA

    meta = torch.device("meta")
    out = {n: tuple(p.shape) for n, p in PiZeroVLA(
        tiny_vla(), device=meta).named_parameters()}
    moe = dataclasses.replace(tiny_llm(), num_experts=4,
                              num_experts_per_tok=2,
                              moe_intermediate_size=32)
    out.update({f"moe.{n}": tuple(p.shape) for n, p in Qwen2ForCausalLM(
        moe, device=meta).named_parameters()})
    out["layers.self_attn.q_proj.kernel"] = (2, 64, 64)
    out["small"] = (3,)
    out["odd.layers.self_attn.q_proj.kernel"] = (2, 63, 64)
    return out


def _plain(placements):
    return [("shard", p.dim) if p.is_shard() else ("replicate",)
            for p in placements]


def _worker(rank, work):
    import torch.distributed as dist

    from vlaser_tpu_torch.core import mesh as mesh_lib

    res = {}
    for key, (dp, fsdp, tp, cp, pp) in MESHES.items():
        mesh = mesh_lib.make_mesh(dp=dp, fsdp=fsdp, tp=tp, cp=cp, pp=pp)
        shard = [None] * dist.get_world_size()
        dist.all_gather_object(shard, mesh_lib.batch_shard(mesh))
        res[key] = {"names": list(mesh.mesh_dim_names),
                    "shape": list(mesh_lib.mesh_shape(mesh).items()),
                    "grid": mesh.mesh.tolist(), "batch_shard": shard}
        if key in RULE_MESHES:
            res[key]["rules"] = {n: _plain(p) for n, p in
                                 mesh_lib.tree_shardings(
                                     _leaves(), mesh,
                                     mesh_lib.default_param_rules()).items()}
            res[key]["batch"] = {k: _plain(p) for k, p in
                                 mesh_lib.shard_batch(
                                     {k: torch.zeros(s) for k, s in
                                      BATCH.items()}, mesh).items()}
            # a spec longer than the leaf's rank: the dims past it stay
            # whole (JAX's tree_shardings indexes past the shape there)
            res[key]["short"] = _plain(mesh_lib.tree_shardings(
                {"language_model.embed_tokens.embedding": (8,)}, mesh,
                mesh_lib.default_param_rules())[
                "language_model.embed_tokens.embedding"])
    for bad in (dict(fsdp=3), dict(dp=3, fsdp=2)):
        try:
            mesh_lib.make_mesh(**bad)
            res[f"bad_{bad}"] = "built"
        except AssertionError as e:
            res[f"bad_{bad}"] = str(e)
    if rank == 0:
        torch.save(res, os.path.join(work, "res.pt"))


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    run_ranks(_worker, 8, work, str(work))
    return torch.load(os.path.join(work, "res.pt"))


def _jax_mesh(key):
    import jax

    from vlaser_tpu.core import mesh as jmesh

    dp, fsdp, tp, cp, pp = MESHES[key]
    return jmesh.make_mesh(dp=dp, fsdp=fsdp, tp=tp, cp=cp, pp=pp,
                           devices=jax.devices()[:8])


@pytest.mark.parametrize("key", sorted(MESHES))
def test_make_mesh_matches_jax(meshes, key):
    jm = _jax_mesh(key)
    got = meshes[key]
    assert got["names"] == list(jm.axis_names)
    assert got["shape"] == list(dict(jm.shape).items())
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert np.array_equal(np.asarray(got["grid"]), ids)
    # batch rows shard over (data, fsdp), data major: a rank's block is
    # its (data, fsdp) coordinate, shared by its context / stage peers
    names = list(jm.axis_names)
    n_batch = jm.shape["data"] * jm.shape["fsdp"]
    for rank, (index, count) in enumerate(got["batch_shard"]):
        coord = [int(c[0]) for c in np.nonzero(ids == rank)]
        d, f = coord[names.index("data")], coord[names.index("fsdp")]
        assert (index, count) == (d * jm.shape["fsdp"] + f, n_batch)


def test_make_mesh_refuses_what_jax_refuses(meshes):
    assert "not divisible" in meshes["bad_{'fsdp': 3}"]
    assert "!= 8" in meshes["bad_{'dp': 3, 'fsdp': 2}"]


def _want(spec, mesh_names):
    out = [("replicate",)] * len(mesh_names)
    for d, names in enumerate(tuple(spec)):
        if names is None:
            continue
        for a in (names if isinstance(names, tuple) else (names,)):
            out[mesh_names.index(a)] = ("shard", d)
    return out


@pytest.mark.parametrize("key", RULE_MESHES)
def test_tree_shardings_match_jax(meshes, key):
    import jax

    from vlaser_tpu.core import mesh as jmesh
    from vlaser_tpu_torch.core.mesh import path_str

    jm = _jax_mesh(key)
    leaves = _leaves()
    tree = {}
    for name, shape in leaves.items():
        node = tree
        *path, leaf = path_str(name).split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jax.ShapeDtypeStruct(shape, np.float32)
    sh = jmesh.tree_shardings(tree, jm, jmesh.default_param_rules())
    got = meshes[key]["rules"]
    names = list(jm.axis_names)
    n_split = 0
    for name in leaves:
        node = sh
        for k in path_str(name).split("/"):
            node = node[k]
        want = _want(node.spec, names)
        assert got[name] == want, (name, node.spec)
        n_split += any(p[0] == "shard" for p in want)
    assert n_split > 10
    # test_sharding.py:42-52: q_proj over (fsdp, tensor), small replicated,
    # the non-dividing fsdp dim degraded
    q = got["layers.self_attn.q_proj.kernel"]
    assert q[names.index("fsdp")] == ("shard", 1)
    assert got["small"] == [("replicate",)] * len(names)
    assert got["odd.layers.self_attn.q_proj.kernel"][
        names.index("fsdp")] == ("replicate",)
    assert meshes[key]["short"][names.index("fsdp")] == ("replicate",)


@pytest.mark.parametrize("key", RULE_MESHES)
def test_shard_batch_matches_jax(meshes, key):
    import jax

    from vlaser_tpu.core import mesh as jmesh

    jm = _jax_mesh(key)
    want = jmesh.shard_batch({k: jax.ShapeDtypeStruct(s, np.float32)
                              for k, s in BATCH.items()}, jm)
    for k in BATCH:
        assert meshes[key]["batch"][k] == _want(want[k].spec,
                                                list(jm.axis_names)), k
