"""Checkpoint and resume of the port's trainers (the contract of
vlaser_tpu/utils/checkpoint.py, written for torch: no orbax, no
distributed checkpoint format).

`<directory>/<step>/` holds
- `params.safetensors`: the model's state dict (every parameter and
  persistent buffer) at its dtype;
- `optimizer.safetensors`: each parameter's AdamW state under
  "<parameter name>/<key>" (`exp_avg`, `exp_avg_sq` and its `step` count);
- `meta.json`: {"step": the train step's counter, from which the learning
  rate schedule resumes, "data": the data-stream state or null}.
A step is written into `<directory>/.tmp-<step>` and renamed into place,
so a reader never finds half a step; the `max_to_keep` newest steps stay.
The files are safetensors (utils/hf_convert.save_safetensors /
load_safetensors), so restoring unpickles nothing.

A train step over a mesh (`train_step.sharded`, ZeRO-3 shards over fsdp
of a model cut over tensor, layer stacks over stage) saves the same files
as the one-device state, leaf by leaf: every rank joins the gathers of a
leaf to rank 0 (its fsdp shards, its stages' layers, then its tensor
shards, put back at their columns:
the strided ViT qkv un-strided, a KV copy written once;
ShardedState.whole), which writes it and drops it before the next
(hf_convert.write_safetensors), so no rank ever holds more than one whole
leaf. The AdamW moments go the same way. Restoring maps the files and
keeps each rank's shards of the trainer's own mesh (the tensor cut, then
the stage's layers and the fsdp shard), reading only those, so a
checkpoint moves between meshes (and to and from one device) unchanged.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

from .hf_convert import load_safetensors, write_safetensors

PARAMS, OPTIMIZER, META = ("params.safetensors", "optimizer.safetensors",
                           "meta.json")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit()
                  and os.path.isfile(os.path.join(directory, d, META)))


def _param_names(model) -> Dict[int, str]:
    return {id(p): n for n, p in model.named_parameters()}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier(sharded) -> None:
    if sharded is not None and sharded.world > 1:
        import torch.distributed as dist

        dist.barrier()


def _entries(model, train_step):
    """-> (the model's state dict, the optimizer's "<name>/<key>" state) as
    write_safetensors entries of whole tensors, in an order every rank
    shares: a sharded step's split leaf (and each state tensor of its
    shape) is gathered to rank 0 when its turn comes."""
    sharded = getattr(train_step, "sharded", None)
    named = dict(model.named_parameters())

    def entry(key, name, p, t):
        if p is not None and t.shape != p.shape:  # an optimizer's count
            p = None
        if sharded is None or (name not in sharded.layout and (
                p is None or not sharded.is_split(p))):
            return key, tuple(t.shape), t.dtype, lambda: t.detach()
        return (key, sharded.whole_shape(name, p, t.shape), t.dtype,
                lambda: sharded.whole(name, p, t))

    params = [entry(k, k, named.get(k), t)
              for k, t in model.state_dict(keep_vars=True).items()]
    opt, state = [], train_step.optimizer.state
    for name, p in named.items():
        opt.extend(entry(f"{name}/{key}", name, p, v)
                   for key, v in state.get(p, {}).items())
    return params, opt


def save_checkpoint(directory: str, step: int, model, train_step,
                    data_state: Optional[Dict[str, Any]] = None,
                    max_to_keep: int = 3) -> str:
    """Write step `step`: the model's state, the AdamW state of
    `train_step.optimizer` (train/train_step.make_train_step's step), its
    counter `train_step.count` and `data_state` (JSON). -> the step's
    directory."""
    directory = os.path.abspath(directory)
    sharded = getattr(train_step, "sharded", None)
    params, opt = _entries(model, train_step)
    final = os.path.join(directory, str(step))
    if _rank() != 0:  # join the gathers
        write_safetensors(params, None)
        write_safetensors(opt, None)
        _barrier(sharded)
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    write_safetensors(params, os.path.join(tmp, PARAMS))
    write_safetensors(opt, os.path.join(tmp, OPTIMIZER))
    with open(os.path.join(tmp, META), "w") as f:
        json.dump({"step": int(train_step.count), "data": data_state}, f)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))
    _barrier(sharded)
    return final


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def restore_params(directory: str, model, step: Optional[int] = None
                   ) -> int:
    """Load only the model's state of step `step` (the latest when None)
    into `model`, as a server restores a trained policy. -> the step."""
    directory = os.path.abspath(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    model.load_state_dict(load_safetensors(
        os.path.join(directory, str(step), PARAMS)))
    return step


def restore_checkpoint(directory: str, model, train_step,
                       step: Optional[int] = None) -> Optional[Dict]:
    """Load step `step` (the latest when None) into `model` (in place: the
    parameters keep their identity, so the optimizer still holds them),
    `train_step.optimizer` and `train_step.count`. -> the data state (None
    when none was saved)."""
    directory = os.path.abspath(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, str(step))
    sharded = getattr(train_step, "sharded", None)
    mapped = sharded is not None
    sd = load_safetensors(os.path.join(path, PARAMS), mmap=mapped)
    saved = load_safetensors(os.path.join(path, OPTIMIZER), mmap=mapped)
    if mapped:  # read this rank's shards (and copy the whole leaves)
        named = dict(model.named_parameters())
        for k, t in list(sd.items()) + list(saved.items()):
            name = k.split("/")[0]
            p = named.get(name)
            t = sharded.cut(name, t)  # its tensor shard, then fsdp's
            split = (p is not None and sharded.is_split(p)
                     and t.dim() == p.dim())
            (saved if "/" in k else sd)[k] = (sharded.local(p, t) if split
                                              else t.clone())
    model.load_state_dict(sd)
    opt = train_step.optimizer
    sd = opt.state_dict()  # the live groups; their params are indices
    names, index = _param_names(model), 0
    state = {}
    for group in opt.param_groups:
        for p in group["params"]:
            prefix = names[id(p)] + "/"
            s = {k[len(prefix):]: v for k, v in saved.items()
                 if k.startswith(prefix)}
            if s:
                state[index] = s
            index += 1
    if sum(len(s) for s in state.values()) != len(saved):
        raise KeyError(f"{path}: optimizer state of parameters the "
                       "optimizer does not hold")
    sd["state"] = state
    opt.load_state_dict(sd)
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    train_step.count = meta["step"]
    return meta["data"]
