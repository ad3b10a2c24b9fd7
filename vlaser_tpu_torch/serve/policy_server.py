"""Closed-loop policy serving (port of vlaser_tpu/serve/policy_server.py).

Per control step: host camera preprocess (adapter) -> one device call
(ViT + VLM prefix + 10-step denoise) -> host postprocess. `fused=True` is
the serving path (policy/fused_infer.py, batch 1 through the Hopper
kernels); `fused=False` runs the plain `PiZeroVLA.infer_action`, the
oracle. The server runs on the CUDA card unless it is given another
device (device="cpu"). Noise comes from a seeded `torch.Generator` on that
device, drawn by `draw_noise` (one method, so a test can feed other noise).
Mesh / tensor-parallel serving is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..image.tiling import normalize_uint8
from ..models.layers import load_state


class PolicyServer:
    def __init__(self, model, params: Optional[Mapping] = None, adapter=None,
                 processor=None, act_steps: int = 4, seed: int = 0,
                 fused: bool = False, device=None):
        """params: optional flat state (utils/convert.from_jax_variables or
        another port state) loaded into `model`; None keeps its weights.
        The model should already be quantized for serving when fused:
        `core.quant.quantize_for_serving(model, target="policy")`, whose
        default mode "w8a8" is the serving default (int8 weights streamed
        by the denoise stacks, int8 activations through the int8 GEMM in
        the ViT stack and the VLM prefix), as in the JAX package; mode
        "int8" keeps every matmul weight-only. On an H100 the batch-1 w8a8
        step is for now slower than the int8 one (PERF.md, "Where the time
        goes"): a latency-bound batch-1 caller may prefer mode "int8".
        device: None is the CUDA card."""
        if params is not None:
            load_state(model, params)
        self.device = torch.device(device if device is not None else "cuda")
        self.model = model.to(self.device)
        self.adapter = adapter
        self.processor = processor
        self.act_steps = act_steps
        self.cfg = model.cfg
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._instruction: Optional[str] = None
        self._cached_inputs: Optional[Dict[str, torch.Tensor]] = None
        self.serving_path = "fused" if fused else "plain"
        if fused:
            from ..policy.fused_infer import make_fused_infer_action

            self._infer = make_fused_infer_action(self.model)
        else:
            self._infer = self.model.infer_action

    def reset(self, instruction: str):
        self.adapter.reset()
        self._instruction = instruction
        proc = self.processor(
            [instruction],
            np.zeros((1, 1, *self.adapter.image_size[::-1], 3), np.uint8),
        )
        self._cached_inputs = {
            "input_ids": torch.from_numpy(proc["input_ids"]).to(self.device),
            "text_mask": torch.from_numpy(proc["attention_mask"])
            .to(self.device),
        }

    def draw_noise(self) -> torch.Tensor:
        """[1, num_action_tokens, action_dim] ~ N(0, I), fp32 on device."""
        return torch.randn(
            (1, self.cfg.num_action_tokens, self.cfg.action_dim),
            generator=self.generator, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def step(self, obs: Dict, image: np.ndarray) -> np.ndarray:
        """obs: env observation dict; image: raw camera frame HxWx3 uint8.
        Returns [act_steps, 7] env-space actions."""
        assert self._cached_inputs is not None, "call reset(instruction) first"
        pre = self.adapter.preprocess(obs, image)
        pixels = normalize_uint8(pre["image"][None]).astype(np.float32)
        proprios = pre["proprio"][None, None]  # [1, cond, dim]
        noise = self.draw_noise()
        actions = self._infer(
            self._cached_inputs["input_ids"],
            torch.from_numpy(pixels).to(self.device),
            self._cached_inputs["text_mask"],
            torch.from_numpy(np.ascontiguousarray(proprios)).to(self.device),
            noise,
        )
        chunk = actions[0].float().cpu().numpy()  # [horizon, action_dim]
        return self.adapter.postprocess(chunk)[: self.act_steps]
