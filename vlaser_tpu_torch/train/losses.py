"""SFT losses (port of vlaser_tpu/train/losses.py).

Weighted shifted cross-entropy (modeling_internvl_chat.py:206-243): the
logits at token i predict label i + 1, labels of IGNORE_TOKEN_ID are
ignored, each token's loss is scaled by `loss_weight`, and the sum is
divided by the weight sum. The loss functions take the batch alone (the
model holds its parameters), as train/train_step.make_train_step calls
them. Batch keys: input_ids, labels, loss_weight, seg_ids, pixel_values,
image_flags, optional positions (packing).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IGNORE_TOKEN_ID = -100


def _weights(labels, loss_weight):
    """-> (labels with ignored ones set to 0, fp32 weights, 0 where
    ignored)."""
    valid = labels != IGNORE_TOKEN_ID
    w = (loss_weight.float() if loss_weight is not None
         else torch.ones(labels.shape, device=labels.device))
    return torch.where(valid, labels, 0).long(), w * valid


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     loss_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """logits [B, N, V] (fp32 math), labels [B, N] -> the shift-by-one
    weighted CE, a 0-dim fp32 tensor."""
    safe, w = _weights(labels[:, 1:], None if loss_weight is None
                       else loss_weight[:, 1:])
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * w).sum() / w.sum().clamp_min(1e-8)


def _model_kwargs(batch):
    return dict(seg_ids=batch.get("seg_ids"), positions=batch.get("positions"))


def make_sft_loss(model, moe_aux_coef: float = 0.0):
    """-> loss_fn(batch) for the VLM SFT step: the model's full logits and
    weighted_ce_loss. The router loss of MoE backbones (moe_aux_coef > 0)
    waits for models/moe.py."""
    if moe_aux_coef > 0.0:
        raise NotImplementedError(
            "moe_aux_coef > 0: MoE backbones (models/moe.py) are not ported "
            "yet")

    def loss_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _, _ = model(batch["input_ids"], batch.get("pixel_values"),
                             batch.get("image_flags"), **_model_kwargs(batch))
        return weighted_ce_loss(logits, batch["labels"],
                                batch.get("loss_weight"))

    return loss_fn


def _chunk_nll(h_c, lab_c, w_c, kern):
    """sum over the chunk of w * -log softmax(h_c @ kern)[label]; the
    [chunk, V] logits are fp32 sums of the compute-dtype products."""
    logp = F.log_softmax(h_c.float() @ kern, dim=-1)
    return -(logp.gather(-1, lab_c[:, None])[:, 0] * w_c).sum()


def chunked_weighted_ce(hidden: torch.Tensor, vocab_table: torch.Tensor,
                        labels: torch.Tensor,
                        loss_weight: Optional[torch.Tensor] = None,
                        chunk: int = 512, table_is_kernel: bool = False
                        ) -> torch.Tensor:
    """weighted_ce_loss of hidden [B, N, H] against the vocab table ([V, H]
    tied embedding, or the [H, V] head kernel with table_is_kernel), in
    chunks of `chunk` rows so that the [N, V] fp32 logits never exist
    whole: the rows are padded to a multiple of the chunk (weight 0), and
    each chunk runs under torch.utils.checkpoint (jax.checkpoint), so its
    logits are freed after its forward and recomputed in its backward; one
    chunk's logits are live at a time. The table is rounded to the hidden
    dtype, as the JAX dot reads it, and the products are summed in fp32
    (its preferred_element_type)."""
    h = hidden.shape[-1]
    sh = hidden[:, :-1].reshape(-1, h)
    safe, w = _weights(labels[:, 1:].reshape(-1), None if loss_weight is None
                       else loss_weight[:, 1:].reshape(-1))
    pad = (-sh.shape[0]) % chunk
    if pad:
        sh = F.pad(sh, (0, 0, 0, pad))
        safe, w = F.pad(safe, (0, pad)), F.pad(w, (0, pad))
    kernel = vocab_table if table_is_kernel else vocab_table.T  # [H, V]
    kern = kernel.to(sh.dtype).float()
    total = sh.new_zeros((), dtype=torch.float32)
    for i in range(0, sh.shape[0], chunk):
        s = slice(i, i + chunk)
        total = total + checkpoint(_chunk_nll, sh[s], safe[s], w[s], kern,
                                   use_reentrant=False)
    return total / w.sum().clamp_min(1e-8)


def _vocab_table(model):
    """-> (the LM's vocab table, whether it is the [H, V] head kernel): the
    tied embedding or the untied lm_head, an int8 one dequantized in bf16
    (q.bf16 * scale.bf16), as the JAX loss reads the `quant` collection."""
    lm, bf = model.language_model, torch.bfloat16
    if model.cfg.llm.tie_word_embeddings:
        e = lm.embed_tokens
        if "embedding_q" in e._buffers:
            return e.embedding_q.to(bf) * e.embedding_scale.to(bf), False
        return e.embedding, False
    head = lm.lm_head
    if "kernel_q" in head._buffers:
        return head.kernel_q.to(bf) * head.kernel_scale.to(bf), True
    return head.kernel, True


def make_sft_loss_chunked(model, chunk: int = 512):
    """make_sft_loss that never materializes the full logits: the model's
    final hidden states (return_logits=False) go through
    chunked_weighted_ce against its vocab table."""

    def loss_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        _, hidden, _ = model(batch["input_ids"], batch.get("pixel_values"),
                             batch.get("image_flags"), return_logits=False,
                             **_model_kwargs(batch))
        table, is_kernel = _vocab_table(model)
        return chunked_weighted_ce(hidden, table, batch["labels"],
                                   batch.get("loss_weight"), chunk=chunk,
                                   table_is_kernel=is_kernel)

    return loss_fn
