"""EMA / SWA of the parameters (port of vlaser_tpu/train/model_averaging.py)
over a {name: tensor} dict, on the parameters' device.

EMA: a <- a * d + p * (1 - d); SWA: a <- a + (p - a) / (n + 1), in the JAX
formulas' order of operations (each product and sum rounded on its own).
The first update at or after `start` takes a copy (never an alias: the
trainer updates its parameters in place); later ones run every `freq`
steps counted from `start`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class AveragingConfig:
    mode: Optional[str] = None  # None | 'ema' | 'swa'
    start: int = 0
    freq: int = 1
    ema_decay: float = 0.99


class ModelAveraging:
    def __init__(self, cfg: AveragingConfig):
        if cfg.mode not in (None, "ema", "swa"):
            raise ValueError(f"unknown averaging mode {cfg.mode!r}")
        self.cfg = cfg
        self.avg_params: Optional[Dict[str, torch.Tensor]] = None
        self.n_averaged = 0

    @torch.no_grad()
    def update(self, step: int, params: Dict[str, torch.Tensor]) -> None:
        cfg = self.cfg
        if cfg.mode is None or step < cfg.start:
            return
        if self.avg_params is None:
            self.avg_params = {k: p.detach().clone()
                               for k, p in params.items()}
            self.n_averaged = 1
            return
        if (step - cfg.start) % cfg.freq != 0:
            return
        # one leaf at a time: the temporaries stay at the largest leaf
        for k, a in self.avg_params.items():
            p = params[k].detach().to(a.dtype)
            if cfg.mode == "ema":
                d = cfg.ema_decay
                a.mul_(d).add_(p * (1.0 - d))
            else:  # the running mean; a tensor divisor keeps a true division
                n = torch.tensor(float(self.n_averaged + 1), dtype=a.dtype,
                                 device=a.device)
                a.add_((p - a) / n)
        self.n_averaged += 1

    def params_for_eval(self, params: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        return self.avg_params if self.avg_params is not None else params

    def state_dict(self) -> Dict:
        return {"avg_params": self.avg_params, "n_averaged": self.n_averaged}

    def load_state_dict(self, st: Dict) -> None:
        self.avg_params = st["avg_params"]
        self.n_averaged = int(st["n_averaged"])
