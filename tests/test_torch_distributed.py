"""The port's core/distributed.py against the JAX package's and
tests/test_distributed.py: `initialize` is a no-op for one process and
derives the rendezvous from the torchrun variables or slurm (the slurm
node list parsed as JAX parses it), `shard_for_process` partitions a
PackedDataset's order as JAX's does, `put_global_batch` views the ranks'
blocks as the global batch (rank i's rows [i b, (i + 1) b)), and the SFT
loss over a data 4 x fsdp 2 group, each rank holding another number of
trained tokens, equals the JAX loss of the whole batch on one device to
rtol 1e-6. The multi-rank half runs on 8 gloo ranks of one spawn
(tests/torch_ranks.py)."""

import os

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from vlaser_tpu_torch.core import distributed as pdist


@pytest.fixture
def clean_env(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_NODELIST",
              "SLURM_STEP_NODELIST", "SLURM_LOCALID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(pdist.initialize, "_done", False, raising=False)
    return monkeypatch


def test_initialize_single_process_noop(clean_env):
    import torch.distributed as dist

    assert pdist.initialize() is False
    assert pdist.initialize() is False  # idempotent
    assert not dist.is_initialized()
    assert pdist.process_count() == 1 and pdist.process_index() == 0


def test_slurm_coordinator_parsing(clean_env):
    from vlaser_tpu.core.distributed import _slurm_coordinator as jax_parse

    cases = {"node01": "node01", "node[12-15]": "node12",
             "gpu-a[3,7,9]": "gpu-a3", "host12,host13": "host12"}
    for nodelist, want in cases.items():
        clean_env.setenv("SLURM_NODELIST", nodelist)
        assert pdist._slurm_coordinator() == want == jax_parse(), nodelist


@pytest.mark.parametrize("source", ["slurm", "torchrun", "arguments"])
def test_initialize_reads_the_rendezvous(clean_env, source):
    """The process group is started with the rendezvous, rank and size of
    each source, in the JAX resolution order (arguments first)."""
    import torch.distributed as dist

    calls = []
    clean_env.setattr(dist, "init_process_group",
                      lambda *a, **kw: calls.append((a, kw)))
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    clean_env.setenv("SLURM_NTASKS", "4")
    clean_env.setenv("SLURM_PROCID", "2")
    clean_env.setenv("SLURM_NODELIST", "node[12-15]")
    kw = {}
    if source in ("torchrun", "arguments"):
        for k, v in (("MASTER_ADDR", "h0"), ("MASTER_PORT", "29500"),
                     ("WORLD_SIZE", "2"), ("RANK", "1")):
            clean_env.setenv(k, v)
    if source == "arguments":
        kw = dict(coordinator_address="c:1", num_processes=3, process_id=0)
    assert pdist.initialize(**kw) is True
    want = {"slurm": ("tcp://node12:8476", 4, 2),
            "torchrun": ("tcp://h0:29500", 2, 1),
            "arguments": ("tcp://c:1", 3, 0)}[source]
    (args, got), = calls
    assert args == ("gloo",)
    assert (got["init_method"], got["world_size"], got["rank"]) == want


def test_shard_for_process_partitions_packed_order():
    from vlaser_tpu.core.distributed import shard_for_process as jax_shard
    from vlaser_tpu.data.chat_dataset import PackedDataset as JPacked
    from vlaser_tpu_torch.data.chat_dataset import PackedDataset

    class Dummy:
        def __len__(self):
            return 13

        def __getitem__(self, i):
            raise AssertionError("not iterated in this test")

    shards = []
    for idx in range(3):
        p = pdist.shard_for_process(PackedDataset(Dummy(), shuffle_seed=7),
                                    num_shards=3, index=idx)
        j = jax_shard(JPacked(Dummy(), shuffle_seed=7), num_shards=3,
                      index=idx)
        assert list(p.order) == list(j.order)
        shards.append(list(p.order))
    assert sorted(sum(shards, [])) == list(range(13))  # disjoint, complete
    assert all(len(s) in (4, 5) for s in shards)
    assert pdist.shard_for_process("one process", num_shards=1) == \
        "one process"
    with pytest.raises(ValueError, match="not shardable"):
        pdist.shard_for_process([1, 2], num_shards=2, index=0)


# -- the ranks ----------------------------------------------------------------

def _worker(rank, work):
    from vlaser_tpu_torch.core import mesh as mesh_lib
    from vlaser_tpu_torch.core.config import tiny_vlm
    from vlaser_tpu_torch.models.layers import load_state
    from vlaser_tpu_torch.models.vlm import InternVLChatModel
    from vlaser_tpu_torch.train.losses import make_sft_loss, weighted_ce_loss

    import torch.distributed as dist

    cases = torch.load(os.path.join(work, "cases.pt"))
    mesh = mesh_lib.make_mesh(dp=4, fsdp=2)
    index, count = mesh_lib.batch_shard(mesh)
    glob = cases["global"]
    local = {k: (v[index * (v.shape[0] // count):
                   (index + 1) * (v.shape[0] // count)] if v.dim() else v)
             for k, v in glob.items()}
    g = pdist.put_global_batch(local, mesh)
    res = {"batch": {k: [v.full_tensor(), list(v.placements)]
                     for k, v in g.items()},
           "local": {k: torch.equal(v.to_local(), local[k])
                     for k, v in g.items()}}

    model = load_state(InternVLChatModel(
        tiny_vlm(), compute_dtype=torch.float32, attn_impl="reference",
        device="cpu"), cases["vlm_state"])
    b = cases["sft_batch"]
    rows = b["input_ids"].shape[0] // count
    mine = {k: v[index * rows:(index + 1) * rows] for k, v in b.items()}
    with torch.no_grad():
        loss = make_sft_loss(model, mesh=mesh)(mine)
        # control: each rank's own mean, averaged over the ranks
        logits, _, _ = model(mine["input_ids"], mine["pixel_values"],
                             mine["image_flags"], seg_ids=mine["seg_ids"])
        naive = weighted_ce_loss(logits, mine["labels"],
                                 mine["loss_weight"]) / count
    both = torch.stack([loss, naive])
    dist.all_reduce(both)
    res["sft"] = both
    if rank == 0:
        torch.save(res, os.path.join(work, "res.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from vlaser_tpu.core.config import tiny_vlm
    from vlaser_tpu.models.vlm import InternVLChatModel
    from vlaser_tpu.train.losses import make_sft_loss
    from vlaser_tpu_torch.utils.convert import from_jax_variables

    work = tmp_path_factory.mktemp("dist")
    glob = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
            "ids": np.arange(8, dtype=np.int32),
            "scalar": np.asarray(3.5, np.float32)}
    cfg = tiny_vlm()
    model = InternVLChatModel(cfg, compute_dtype=jnp.float32,
                              attn_impl="reference")
    rng = np.random.default_rng(0)
    B, n = 8, 16
    ids = rng.integers(1, 300, (B, n)).astype(np.int32)
    ids[:, 1] = cfg.img_context_token_id
    labels = ids.copy()
    for i in range(B):  # another number of trained tokens on every row
        labels[i, :2 + i] = -100
    img = cfg.vision.image_size
    batch = {"input_ids": ids, "labels": labels,
             "loss_weight": rng.uniform(0.5, 1.5, (B, n)).astype(np.float32),
             "seg_ids": np.ones((B, n), np.int32),
             "pixel_values": rng.standard_normal((B, img, img, 3)).astype(
                 np.float32),
             "image_flags": np.ones((B,), np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = model.init(jax.random.PRNGKey(0), jb["input_ids"][:1],
                        jb["pixel_values"][:1], jb["image_flags"][:1])
    want = float(make_sft_loss(model)(params, jb, jax.random.PRNGKey(1)))
    t = lambda a: torch.from_numpy(np.array(a, copy=True))
    torch.save({"global": {k: t(v) for k, v in glob.items()},
                "vlm_state": from_jax_variables(
                    jax.tree_util.tree_map(np.asarray, params)),
                "sft_batch": {k: t(v) for k, v in batch.items()}},
               os.path.join(work, "cases.pt"))
    run_ranks(_worker, 8, work, str(work))
    return {"res": torch.load(os.path.join(work, "res.pt"),
                              weights_only=False),
            "glob": glob, "sft": want}


def test_put_global_batch_assembles_the_global_batch(ranks):
    from torch.distributed.tensor import Replicate, Shard

    res = ranks["res"]
    for k, v in ranks["glob"].items():
        full, placements = res["batch"][k]
        np.testing.assert_array_equal(full.numpy(), v)
        assert res["local"][k], k
        want = ([Shard(0), Shard(0), Replicate()] if v.ndim
                else [Replicate()] * 3)
        assert placements == want, (k, placements)


def test_sharded_sft_loss_matches_jax(ranks):
    loss, naive = ranks["res"]["sft"].tolist()
    np.testing.assert_allclose(loss, ranks["sft"], rtol=1e-6)
    # the ranks' own means, averaged, are another number: the numerator
    # and the denominator must be reduced apart
    assert abs(naive - ranks["sft"]) > 1e-4 * abs(ranks["sft"])
