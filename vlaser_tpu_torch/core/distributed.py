"""Multi-process wiring: torch.distributed init + per-process data -> the
global batch (port of vlaser_tpu/core/distributed.py; no jax).

- one `initialize()` call per process (rendezvous and rank from explicit
  arguments, the torchrun variables, slurm, or a single-process no-op);
  NCCL for the card, gloo for the CPU;
- data is sharded per process (PackedDataset.shard) and each process feeds
  only its local slice;
- `put_global_batch` views the local slices as one global batch: rank
  i's block of rows is rows [i * b, (i + 1) * b) of it (i its batch
  coordinate over (data, fsdp), core/mesh.batch_shard), as JAX's
  make_array_from_process_local_data assembles it. The train step runs on
  each rank's local block; the trainers reduce gradients and the losses'
  sums over the batch ranks (train/train_step.py).
"""

from __future__ import annotations

import os
import re
from typing import Optional


def _slurm_coordinator() -> Optional[str]:
    nodelist = os.environ.get("SLURM_STEP_NODELIST") or os.environ.get(
        "SLURM_NODELIST")
    if not nodelist:
        return None
    # "host[12-15,20],other" -> "host12" (dist_utils.py:54-66 scontrol
    # parity, without shelling out)
    m = re.match(r"([^\[,]+)(?:\[(\d+)[-,\]])?", nodelist)
    if not m:
        return None
    return m.group(1) + (m.group(2) or "")


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               port: int = 8476, backend: Optional[str] = None) -> bool:
    """Start the default process group from arguments or the environment;
    -> True if a multi-process group was started (or one already runs),
    False for the single-process fallback.

    Resolution order: explicit arguments > the torchrun variables
    (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK) > slurm (SLURM_NTASKS,
    SLURM_PROCID, the node list at `port`). backend None: NCCL when a card
    is visible, else gloo; under NCCL each process takes the card
    LOCAL_RANK (or its rank modulo the cards). Safe to call twice."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if getattr(initialize, "_done", False):
        return False

    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', port)}")
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")

    if num_processes is None and "SLURM_NTASKS" in os.environ:
        num_processes = int(os.environ["SLURM_NTASKS"])
        process_id = int(os.environ.get("SLURM_PROCID", 0))
        if coordinator_address is None:
            host = _slurm_coordinator()
            coordinator_address = f"{host}:{port}" if host else None

    multi = bool(num_processes and num_processes > 1)
    if multi:
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            local = _int_env("LOCAL_RANK")
            if local is None:
                local = _int_env("SLURM_LOCALID")
            if local is None:
                local = process_id % torch.cuda.device_count()
            torch.cuda.set_device(local)
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    initialize._done = True
    return multi


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def put_global_batch(batch: dict, mesh, shardings=None) -> dict:
    """This rank's local block of a batch (numpy or tensors) -> {key:
    DTensor} of the global batch on the mesh's device: every leaf with a
    leading dim is a block of rows, the global leaf (data x fsdp) times as
    long with this rank's block at its batch coordinate (sharded by
    core/mesh.shard_batch of the global shapes); a scalar is replicated.
    `.to_local()` gives the block back."""
    import torch
    from torch.distributed.tensor import DTensor

    from . import mesh as mesh_lib

    count = mesh_lib.batch_shard(mesh)[1]
    if shardings is None:
        shardings = mesh_lib.shard_batch(
            {k: torch.empty((v.shape[0] * count,) + tuple(v.shape[1:])
                            if v.ndim else (), device="meta")
             for k, v in batch.items()}, mesh)
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return {k: DTensor.from_local(torch.as_tensor(v).to(dev), mesh,
                                  shardings[k], run_check=False)
            for k, v in batch.items()}


def shard_for_process(dataset, *, num_shards: Optional[int] = None,
                      index: Optional[int] = None):
    """Give each process a disjoint slice of the data stream (a dataset
    with .shard, PackedDataset's). num_shards / index default to the
    process count and index; the trainers pass the batch coordinate
    (core/mesh.batch_shard), which context ranks share."""
    n = num_shards if num_shards is not None else process_count()
    i = index if index is not None else process_index()
    if n <= 1:
        return dataset
    if hasattr(dataset, "shard"):
        return dataset.shard(n, i)
    raise ValueError(
        f"{type(dataset).__name__} is not shardable; wrap it or slice "
        "upstream")
