"""Checkpoint and resume of the port's trainers (the contract of
vlaser_tpu/utils/checkpoint.py, written for torch on one device: no orbax,
no distributed checkpoint).

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
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

from .hf_convert import load_safetensors, save_safetensors

PARAMS, OPTIMIZER, META = ("params.safetensors", "optimizer.safetensors",
                           "meta.json")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit()
                  and os.path.isfile(os.path.join(directory, d, META)))


def _param_names(model) -> Dict[int, str]:
    return {id(p): n for n, p in model.named_parameters()}


def save_checkpoint(directory: str, step: int, model, train_step,
                    data_state: Optional[Dict[str, Any]] = None,
                    max_to_keep: int = 3) -> str:
    """Write step `step`: the model's state, the AdamW state of
    `train_step.optimizer` (train/train_step.make_train_step's step), its
    counter `train_step.count` and `data_state` (JSON). -> the step's
    directory."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_safetensors(model.state_dict(), os.path.join(tmp, PARAMS))
    names, opt = _param_names(model), {}
    for p, state in train_step.optimizer.state.items():
        for key, v in state.items():
            opt[f"{names[id(p)]}/{key}"] = v
    save_safetensors(opt, os.path.join(tmp, OPTIMIZER))
    with open(os.path.join(tmp, META), "w") as f:
        json.dump({"step": int(train_step.count), "data": data_state}, f)
    final = os.path.join(directory, str(step))
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))
    return final


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


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
    model.load_state_dict(load_safetensors(os.path.join(path, PARAMS)))
    saved = load_safetensors(os.path.join(path, OPTIMIZER))
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
