"""Run a function on n gloo ranks of spawned CPU processes: the harness of
the port's multi-rank tests (tests/test_torch_mesh.py,
test_torch_distributed.py, test_torch_sharded_train.py,
test_torch_ring_attention.py).

A spawned process imports the module that defines its target, so each
test module keeps its rank workers at top level and imports jax only
inside its test functions and fixtures. The group meets through a file
under the test's temporary directory (no fixed TCP port: the xdist
workers run side by side)."""

import os

import torch


def _entry(rank, n, init, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=n)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n, workdir, *args):
    """fn(rank, *args) on each of n ranks of a gloo group; raises if one
    fails."""
    import torch.multiprocessing as mp

    mp.spawn(_entry, args=(n, os.path.join(str(workdir), "pg_init"), fn,
                           args), nprocs=n)
