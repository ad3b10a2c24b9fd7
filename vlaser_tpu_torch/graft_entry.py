"""The port's twin of the repository's `__graft_entry__.entry()`: the
north-star path (Vlaser-2B-VLA's cached `infer_action`: the ViT, the joint
prefix and the 10-step denoise) as a callable and its example arguments.

    from vlaser_tpu_torch.graft_entry import entry
    fn, args = entry()          # on the CUDA card
    actions = fn(*args)         # [1, 4, 7]

The model is built in bf16 with every parameter zero (the JAX entry's
zero tree), so the call exercises shapes and routes, not weights. The
example batch is the JAX entry's: one 448 px tile, a 384-token prompt whose
first 256 slots are image-context tokens followed by 44 text tokens, text
mask over those 300, zero proprio and zero noise. `entry(cfg, "cpu")` runs
any config on the CPU (the tests' tiny ones), the prompt cut to fit.
"""

from __future__ import annotations

import torch

TEXT_TOKENS = 44  # the JAX entry's text tokens after the image slots
TEXT_ID = 7


def entry(cfg=None, device=None):
    """-> (fn, example_args): fn = model.infer_action of a zero-parameter
    bf16 PiZeroVLA on `device` (None: the CUDA card), example_args =
    (input_ids, pixel_values, text_mask, proprios, noise) on that device."""
    from .core.config import vlaser_2b_vla
    from .policy.pizero import PiZeroVLA

    cfg = cfg if cfg is not None else vlaser_2b_vla()
    bf = torch.bfloat16
    model = PiZeroVLA(cfg, param_dtype=bf, compute_dtype=bf, device=device)
    with torch.no_grad():
        for t in model.parameters():
            t.zero_()
    dev = model.device
    B, S = 1, cfg.max_image_text_tokens
    img = cfg.vlm.vision.image_size
    n_img = cfg.vlm.num_image_token
    n_valid = min(n_img + TEXT_TOKENS, S)
    ids = torch.full((B, S), cfg.vlm.pad_token_id, dtype=torch.long)
    ids[:, n_img:n_valid] = TEXT_ID
    ids[:, :n_img] = cfg.vlm.img_context_token_id
    text_mask = torch.zeros((B, S), dtype=torch.int32)
    text_mask[:, :n_valid] = 1
    f32 = dict(dtype=torch.float32, device=dev)
    args = (ids.to(dev), torch.zeros((B, img, img, 3), **f32),
            text_mask.to(dev),
            torch.zeros((B, cfg.cond_steps, cfg.proprio_dim), **f32),
            torch.zeros((B, cfg.num_action_tokens, cfg.action_dim), **f32))
    return model.infer_action, args
