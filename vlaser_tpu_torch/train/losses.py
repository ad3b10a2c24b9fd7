"""SFT losses (port of vlaser_tpu/train/losses.py).

Weighted shifted cross-entropy (modeling_internvl_chat.py:206-243): the
logits at token i predict label i + 1, labels of IGNORE_TOKEN_ID are
ignored, each token's loss is scaled by `loss_weight`, and the sum is
divided by the weight sum. The loss functions take the batch alone (the
model holds its parameters), as train/train_step.make_train_step calls
them. Batch keys: input_ids, labels, loss_weight, seg_ids, pixel_values,
image_flags, optional positions (packing).

Over a mesh (`mesh`) each rank holds a block of the global batch's rows
(and, with a `context` axis, a contiguous slice of its sequence): the
loss is the rank's weighted CE sum over the global weight sum (the batch
ranks' sums of weights, all-reduced without a gradient), so the batch
ranks' losses and gradients sum to the one-device ones. The ranks of a
tensor group hold the same rows and compute the same loss: every sum
runs over the batch ranks (core/mesh.batch_group), never over tensor.
Where the vocab table is cut over tensor the CE is vocab-parallel
(chunked_weighted_ce's `tp`). A context rank's logits
at positions [i0, i1) predict the labels at [i0 + 1, i1 + 1): the labels
are shifted over the whole sequence, then sliced (`context_labels`).
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


def _global_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the mesh's batch ranks (core/mesh.batch_group: data x
    fsdp x context, never tensor, whose ranks hold the same rows), without
    a gradient."""
    from ..core.mesh import batch_group

    group, n = batch_group(mesh)
    if n == 1:
        return x
    import torch.distributed as dist

    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x



def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     loss_weight: Optional[torch.Tensor] = None,
                     mesh=None, shifted: bool = False) -> torch.Tensor:
    """logits [B, N, V] (fp32 math), labels [B, N] -> the shift-by-one
    weighted CE, a 0-dim fp32 tensor. shifted: labels[i] is already the
    label that logits[i] predict (context_labels). mesh: the weight sum is
    the global one (this rank's share of the global loss)."""
    if not shifted:
        logits, labels = logits[:, :-1], labels[:, 1:]
        loss_weight = None if loss_weight is None else loss_weight[:, 1:]
    safe, w = _weights(labels, loss_weight)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * w).sum() / _global_sum(w.sum(), mesh).clamp_min(1e-8)


def context_labels(labels: torch.Tensor, loss_weight, mesh):
    """-> (labels, loss_weight) that this context rank's logits predict:
    shifted by one over the whole sequence (IGNORE_TOKEN_ID, weight 0
    past its end), then cut to the rank's slice."""
    from ..core.mesh import context_slice

    labels = F.pad(labels[:, 1:], (0, 1), value=IGNORE_TOKEN_ID)
    if loss_weight is not None:
        loss_weight = context_slice(F.pad(loss_weight[:, 1:], (0, 1)), mesh)
    return context_slice(labels, mesh), loss_weight


def _context_parallel(model, mesh) -> bool:
    """Whether the model's LLM runs its context route on this mesh."""
    from ..core.mesh import axis_size

    axis = model.cfg.llm.context_parallel_axis
    return axis is not None and axis_size(mesh, axis) > 1


def _model_kwargs(batch):
    return dict(seg_ids=batch.get("seg_ids"), positions=batch.get("positions"))


def make_sft_loss(model, moe_aux_coef: float = 0.0, mesh=None):
    """-> loss_fn(batch) for the VLM SFT step: the model's full logits and
    weighted_ce_loss. moe_aux_coef > 0 adds moe_aux_coef x the router
    load-balancing loss of each MoE stack (models/moe.router_aux_loss over
    its layers' router vectors, summed over the stacks), as the JAX loss
    adds it from the sown `intermediates`. mesh: the rank's share of the
    global loss (the module's docstring); the router statistics are the
    batch ranks' means, each rank's probabilities taking their share of
    the gradient. The model runs inside core/mesh.set_mesh(mesh) when its
    LLM is context-parallel. A model whose vocab table is cut over the
    tensor axis takes make_sft_loss_chunked's vocab-parallel CE (the same
    function of the same weights, which never forms the [N, V] logits
    that the gathered head would put on every rank; at bf16 compute its
    logits are fp32 sums where an untied head's Dense rounds them to
    bf16)."""
    cp = mesh is not None and _context_parallel(model, mesh)

    def forward(batch):
        logits, _, _ = model(batch["input_ids"], batch.get("pixel_values"),
                             batch.get("image_flags"), **_model_kwargs(batch))
        labels, weight = batch["labels"], batch.get("loss_weight")
        if cp:
            labels, weight = context_labels(labels, weight, mesh)
        return weighted_ce_loss(logits, labels, weight, mesh=mesh,
                                shifted=cp)

    if _vocab_split(model) is not None:  # the vocab table over tensor
        forward = make_sft_loss_chunked(model, mesh=mesh)

    if moe_aux_coef <= 0.0:
        return forward

    from ..core.mesh import batch_group
    from ..models.moe import collect_router_stats, router_aux_loss

    ranks = batch_group(mesh)[1]

    def loss_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with collect_router_stats(model) as stacks:
            ce = forward(batch)
        # the global fractions (no gradient) against this rank's
        # probabilities, whose mean over the ranks is the global one
        aux = sum(router_aux_loss(_global_sum(f, mesh) / ranks, p)
                  for f, p in stacks)
        return ce + moe_aux_coef * aux / ranks

    return loss_fn


def _chunk_nll(h_c, lab_c, w_c, kern):
    """sum over the chunk of w * -log softmax(h_c @ kern)[label]; the
    [chunk, V] logits are fp32 sums of the compute-dtype products."""
    logp = F.log_softmax(h_c.float() @ kern, dim=-1)
    return -(logp.gather(-1, lab_c[:, None])[:, 0] * w_c).sum()


def _sum_exp_over_vocab(s: torch.Tensor, tp) -> torch.Tensor:
    """The rows' sums of exp over the ranks' vocab columns."""
    from ..core.tensor_parallel import all_reduce

    return all_reduce(s, tp.group)


class _VocabParallelNLL(torch.autograd.Function):
    """_chunk_nll of one chunk against this rank's vocab columns [H, n]
    (global ids lo:lo + n): the local fp32 logits, the row max all-reduced
    (MAX), the sum of exp and the label's logit (taken on the rank that
    owns it) all-reduced, -> sum of w * (logsumexp - label logit). Only
    the inputs and each row's logsumexp are kept; the backward recomputes
    the local logits (the chunk's checkpoint) and needs no collective:
    the hidden state's gradient is this rank's columns' part, which the
    caller's `enter` sums."""

    @staticmethod
    def forward(ctx, h_c, lab_c, w_c, kern, tp, lo):
        import torch.distributed as dist

        from ..core.tensor_parallel import all_reduce

        logits = h_c.float() @ kern
        n = logits.shape[-1]
        m = all_reduce(logits.amax(-1), tp.group, dist.ReduceOp.MAX)
        s = _sum_exp_over_vocab(torch.exp(logits - m[:, None]).sum(-1), tp)
        mine = (lab_c >= lo) & (lab_c < lo + n)
        at = torch.where(mine, lab_c - lo, 0)
        ll = all_reduce(torch.where(
            mine, logits.gather(-1, at[:, None])[:, 0], 0.0), tp.group)
        lse = m + torch.log(s)
        ctx.save_for_backward(h_c, w_c, kern, lse, mine, at)
        return ((lse - ll) * w_c).sum()

    @staticmethod
    def backward(ctx, g):
        h_c, w_c, kern, lse, mine, at = ctx.saved_tensors
        hf = h_c.float()
        d = torch.exp(hf @ kern - lse[:, None])  # softmax's columns here
        rows = torch.nonzero(mine)[:, 0]
        d[rows, at[rows]] -= 1.0
        d = d * (w_c * g)[:, None]
        dh = (d @ kern.T).to(h_c.dtype) if ctx.needs_input_grad[0] else None
        dk = hf.T @ d if ctx.needs_input_grad[3] else None
        return dh, None, None, dk, None, None


def chunked_weighted_ce(hidden: torch.Tensor, vocab_table: torch.Tensor,
                        labels: torch.Tensor,
                        loss_weight: Optional[torch.Tensor] = None,
                        chunk: int = 512, table_is_kernel: bool = False,
                        mesh=None, shifted: bool = False,
                        tp=None) -> torch.Tensor:
    """weighted_ce_loss of hidden [B, N, H] against the vocab table ([V, H]
    tied embedding, or the [H, V] head kernel with table_is_kernel), in
    chunks of `chunk` rows so that the [N, V] fp32 logits never exist
    whole: the rows are padded to a multiple of the chunk (weight 0), and
    each chunk runs under torch.utils.checkpoint (jax.checkpoint), so its
    logits are freed after its forward and recomputed in its backward; one
    chunk's logits are live at a time. The table is rounded to the hidden
    dtype, as the JAX dot reads it, and the products are summed in fp32
    (its preferred_element_type). mesh / shifted: as weighted_ce_loss.

    Vocab-parallel (`tp`, the TensorSplit of a table cut over tensor:
    this rank holds the vocab block [tp.rank n, (tp.rank + 1) n) of the
    table's n rows or columns): the hidden state is entered (its gradient
    summed over the ranks) and each chunk runs _VocabParallelNLL on its
    [chunk, n] local logits; no rank forms a [chunk, V] tensor."""
    h = hidden.shape[-1]
    if not shifted:
        hidden, labels = hidden[:, :-1], labels[:, 1:]
        loss_weight = None if loss_weight is None else loss_weight[:, 1:]
    sh = hidden.reshape(-1, h)
    safe, w = _weights(labels.reshape(-1), None if loss_weight is None
                       else loss_weight.reshape(-1))
    pad = (-sh.shape[0]) % chunk
    if pad:
        sh = F.pad(sh, (0, 0, 0, pad))
        safe, w = F.pad(safe, (0, pad)), F.pad(w, (0, pad))
    kernel = vocab_table if table_is_kernel else vocab_table.T  # [H, V]
    kern = kernel.to(sh.dtype).float()
    total = sh.new_zeros((), dtype=torch.float32)
    if tp is not None:
        sh, lo = tp.enter(sh), tp.rank * kern.shape[-1]
    for i in range(0, sh.shape[0], chunk):
        s = slice(i, i + chunk)
        if tp is not None:
            total = total + _VocabParallelNLL.apply(sh[s], safe[s], w[s],
                                                    kern, tp, lo)
        else:
            total = total + checkpoint(_chunk_nll, sh[s], safe[s], w[s],
                                       kern, use_reentrant=False)
    return total / _global_sum(w.sum(), mesh).clamp_min(1e-8)


def _vocab_module(model):
    lm = model.language_model
    if model.cfg.llm.tie_word_embeddings:
        return lm.embed_tokens
    return lm.lm_head


def _vocab_split(model):
    """The TensorSplit of the LM's vocab table when it is cut over the
    tensor axis (core/tensor_parallel), else None."""
    return getattr(_vocab_module(model), "tp", None)


def _vocab_table(model):
    """-> (the LM's vocab table, whether it is the [H, V] head kernel): the
    tied embedding or the untied lm_head (this rank's vocab block of it
    when it is cut over tensor; gathered over fsdp), an int8 one
    dequantized in bf16 (q.bf16 * scale.bf16), as the JAX loss reads the
    `quant` collection."""
    bf = torch.bfloat16
    m = _vocab_module(model)
    if model.cfg.llm.tie_word_embeddings:
        if "embedding_q" in m._buffers:
            return m.embedding_q.to(bf) * m.embedding_scale.to(bf), False
        return m.leaf("embedding"), False
    if "kernel_q" in m._buffers:
        return m.kernel_q.to(bf) * m.kernel_scale.to(bf), True
    return m.leaf("kernel"), True


def make_sft_loss_chunked(model, chunk: int = 512, mesh=None):
    """make_sft_loss that never materializes the full logits: the model's
    final hidden states (return_logits=False) go through
    chunked_weighted_ce against its vocab table (vocab-parallel when the
    table is cut over tensor). mesh: as make_sft_loss."""
    cp = mesh is not None and _context_parallel(model, mesh)
    split = _vocab_split(model)

    def loss_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        _, hidden, _ = model(batch["input_ids"], batch.get("pixel_values"),
                             batch.get("image_flags"), return_logits=False,
                             **_model_kwargs(batch))
        table, is_kernel = _vocab_table(model)
        labels, weight = batch["labels"], batch.get("loss_weight")
        if cp:
            labels, weight = context_labels(labels, weight, mesh)
        return chunked_weighted_ce(hidden, table, labels, weight,
                                   chunk=chunk, table_is_kernel=is_kernel,
                                   mesh=mesh, shifted=cp, tp=split)

    return loss_fn
