"""HF-parity chat API (port of vlaser_tpu/inference/chat.py): `chat` and
`batch_chat` over the generators.

Prompt assembly follows modeling_internvl_chat.py chat / batch_chat: the
conversation template, <image> -> <img> + N*<IMG_CONTEXT> + </img>, EOS from
the template separator, the response split at the separator. Prompts are
right-padded to multiples of `bucket`, as in JAX (there it bounds the
compile count; here it keeps the two packages' caches, positions and
outputs the same).

Routing, as in JAX: a single-stream greedy request on an int8-quantized LLM
takes the fused serving runner (`inference/fused_runner.py`: the fused ViT
for <= 13 tiles, the model's prefill, one fused decode stack per token);
sampled, penalised and batched requests take `sampling.make_generate_fn`.
use_fused "auto" routes to the fused runner when the model sits on a CUDA
device and the cache is bf16 (the JAX gate is a TPU backend); True forces
it (on CPU tensors that means the kernels' plain versions); False turns it
off. speculative_draft_len > 0 takes the prompt-lookup speculative
decoder (`inference/speculative.py`: greedy, single stream, the same tokens
as greedy decode). num_beams > 1 takes the beam searcher
(`inference/beam_search.py`, greedy beams, never the fused runner); as in
JAX, that route ignores repetition_penalty.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..tokenizer.conversation import build_chat_query, get_conv_template
from .sampling import make_generate_fn, trim_output


def _llm_is_quantized(model) -> bool:
    """True when the LLM carries an int8 decode stack (the DEFAULT_PATTERNS
    layout): the precondition of the fused serving runner."""
    lm = model.language_model
    return ("embedding_q" in lm.embed_tokens._buffers
            and "kernel_q" in lm.model.layers.self_attn.q_proj._buffers)


def build_batch_queries(template: str, questions: Sequence[str],
                        num_patches_list, num_image_token: int,
                        system_message: Optional[str] = None) -> List[str]:
    """batch_chat prompt assembly: one entry of `num_patches_list` per
    question, an int (the tiles of one image) or a list of ints (one per
    <image> tag)."""
    queries = []
    for i, q in enumerate(questions):
        entry = num_patches_list[i] if i < len(num_patches_list) else 0
        if isinstance(entry, (list, tuple)):
            per_img = [n for n in entry if n]
        else:
            per_img = [entry] if entry else []
        if per_img and "<image>" not in q:
            q = "<image>\n" + q
        queries.append(build_chat_query(template, q, per_img, num_image_token,
                                        system_message=system_message))
    return queries


class VlaserChat:
    def __init__(self, model, tokenizer, *, max_new_tokens: int = 256,
                 temperature: float = 0.0, top_k: int = 0,
                 repetition_penalty: float = 1.0, num_beams: int = 1,
                 speculative_draft_len: int = 0, bucket: int = 256,
                 system_message: Optional[str] = None,
                 cache_dtype=torch.bfloat16, use_fused="auto"):
        """model: an InternVLChatModel holding its weights (quantized with
        `core.quant.quantize_for_serving` for the fused runner). Sampling
        draws from a generator seeded with 0 on the model's device (the JAX
        chat's PRNGKey(0))."""
        self.model, self.tokenizer = model, tokenizer
        self.cfg = model.cfg
        self.bucket, self.system_message = bucket, system_message
        self.sep = get_conv_template(self.cfg.template).sep.strip()
        self.eos_token_id = tokenizer.convert_tokens_to_ids(self.sep)
        gen_kw = dict(max_new_tokens=max_new_tokens,
                      eos_token_ids=[self.eos_token_id],
                      pad_token_id=self.cfg.pad_token_id)
        self.device = model.device
        self._fused_gen = None
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        if speculative_draft_len > 0:
            # prompt-lookup speculative decoding: greedy-exact, single
            # stream (chat(), not batch_chat)
            from .speculative import make_speculative_generate_fn

            if (num_beams != 1 or temperature != 0.0
                    or repetition_penalty != 1.0):
                raise ValueError("speculative decode is greedy (no beams, "
                                 "penalty or sampling)")
            self._gen = make_speculative_generate_fn(
                model, draft_len=speculative_draft_len,
                cache_dtype=cache_dtype, **gen_kw)
            return
        if num_beams > 1:
            from .beam_search import make_beam_generate_fn

            if temperature != 0.0:
                raise ValueError("beam search is greedy (do_sample=False)")
            self._gen = make_beam_generate_fn(
                model, num_beams=num_beams, cache_dtype=cache_dtype,
                **gen_kw)
            return
        self._gen = make_generate_fn(
            model, temperature=temperature, top_k=top_k,
            repetition_penalty=repetition_penalty, cache_dtype=cache_dtype,
            **gen_kw)
        fused_ok = use_fused is True or (
            use_fused == "auto" and self.device.type == "cuda"
            and cache_dtype == torch.bfloat16)
        if (fused_ok and temperature == 0.0 and repetition_penalty == 1.0
                and _llm_is_quantized(model)):
            from .fused_runner import make_fused_generate_fn

            self._fused_gen = make_fused_generate_fn(model, **gen_kw)

    def _encode(self, queries: Sequence[str]) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        all_ids = [self.tokenizer(q, add_special_tokens=False)["input_ids"]
                   for q in queries]
        n = max(len(i) for i in all_ids)
        n = -(-n // self.bucket) * self.bucket
        ids = torch.full((len(all_ids), n), self.cfg.pad_token_id,
                         dtype=torch.int64)
        seg = torch.zeros((len(all_ids), n), dtype=torch.int32)
        for i, row in enumerate(all_ids):
            ids[i, :len(row)] = torch.as_tensor(row)
            seg[i, :len(row)] = 1
        return ids.to(self.device), seg.to(self.device)

    def _generate(self, queries, pixel_values) -> List[str]:
        ids, seg = self._encode(queries)
        pix = None
        if pixel_values is not None:
            pix = torch.as_tensor(pixel_values).to(self.device)
        gen = self._gen
        if self._fused_gen is not None and ids.shape[0] == 1:
            gen = self._fused_gen  # single-stream greedy: fused serving
        tokens, num = gen(ids, seg, pix, self._generator)
        texts = []
        for row in trim_output(tokens, num, [self.eos_token_id]):
            text = self.tokenizer.decode(row, skip_special_tokens=True)
            texts.append(text.split(self.sep)[0].strip())
        return texts

    def chat(self, question: str, pixel_values=None,
             history: Optional[List[Tuple[str, str]]] = None,
             num_patches_list: Optional[List[int]] = None,
             return_history: bool = False):
        """pixel_values: [T, H, W, 3] tiles (normalized), or None."""
        if num_patches_list is None:
            num_patches_list = ([pixel_values.shape[0]]
                                if pixel_values is not None else [])
        if (history is None and pixel_values is not None
                and "<image>" not in question):
            question = "<image>\n" + question
        query = build_chat_query(
            self.cfg.template, question, num_patches_list,
            self.cfg.num_image_token, history=history,
            system_message=self.system_message)
        response = self._generate([query], pixel_values)[0]
        if return_history:
            return response, (history or []) + [(question, response)]
        return response

    def batch_chat(self, questions: Sequence[str], pixel_values=None,
                   num_patches_list: Optional[List] = None) -> List[str]:
        """pixel_values: the tiles of every sample, concatenated."""
        if num_patches_list is None:
            num_patches_list = ([pixel_values.shape[0]]
                                if pixel_values is not None else [])
        queries = build_batch_queries(
            self.cfg.template, questions, num_patches_list,
            self.cfg.num_image_token, system_message=self.system_message)
        return self._generate(queries, pixel_values)
