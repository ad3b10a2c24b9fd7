"""Engine-backed chat surface (port of vlaser_tpu/serve/engine_chat.py):
VlaserChat's chat / batch_chat API served through the continuous-batching
engine.

Prompt assembly and the decoded text are those of
`inference/chat.VlaserChat`; generation rides
`serve/engine.ContinuousBatchingEngine` (mixed-length batches decode in
flight instead of padding to the longest row, and per-request sampling
parameters pass straight through), or the offline schedule
(`serve/offline.run_offline`, backend "offline", greedy only).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..inference.chat import build_batch_queries
from ..tokenizer.conversation import build_chat_query, get_conv_template
from .engine import ContinuousBatchingEngine, Request


def _host(pixel_values):
    """Tiles as a host array (the engine's requests hold numpy)."""
    if pixel_values is None:
        return None
    if torch.is_tensor(pixel_values):
        return pixel_values.detach().float().cpu().numpy()
    return np.asarray(pixel_values)


class EngineChat:
    """chat() / batch_chat() with the engine as the decode backend."""

    def __init__(self, model, tokenizer, *, max_new_tokens: int = 256,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 num_slots: int = 16, max_len: int = 4096,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 tile_buckets: Optional[Sequence[int]] = (1, 2, 4, 7, 13),
                 system_message: Optional[str] = None,
                 cache_dtype=torch.bfloat16, chunk_size: int = 64,
                 backend: str = "engine", speculative_draft_len: int = 0,
                 mesh=None, pipeline_depth: int = 1,
                 quantize: Optional[str] = None):
        """model: an InternVLChatModel holding its weights. backend "engine"
        (host-driven continuous batching; sampling supported) or "offline"
        (the offline schedule, greedy only; a sampled or streamed call
        falls back to the engine). quantize: None (the model as it is),
        "w8a8" or "int8": `core.quant.quantize_for_serving(model,
        target="vlm", mode=quantize)` in place; a quantized model passes
        through."""
        if backend not in ("engine", "offline"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        if quantize is not None:
            from ..core.quant import quantize_for_serving

            quantize_for_serving(model, target="vlm", mode=quantize)
        self.model = model
        self.tokenizer = tokenizer
        self.cfg = model.cfg
        self.max_new_tokens = max_new_tokens
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.system_message = system_message
        self.sep = get_conv_template(self.cfg.template).sep.strip()
        self.eos_token_id = tokenizer.convert_tokens_to_ids(self.sep)
        self.engine = ContinuousBatchingEngine(
            model, num_slots=num_slots, max_len=max_len,
            eos_token_ids=[self.eos_token_id],
            pad_token_id=self.cfg.pad_token_id,
            prefill_buckets=prefill_buckets, tile_buckets=tile_buckets,
            cache_dtype=cache_dtype, chunk_size=chunk_size,
            speculative_draft_len=speculative_draft_len, mesh=mesh,
            pipeline_depth=pipeline_depth)
        self._uid = 0

    def _run(self, reqs, on_token=None):
        # streaming needs per-chunk host commits, which the offline
        # schedule does not make: a streamed call rides the engine
        if self.backend == "offline" and self.temperature == 0.0 \
                and on_token is None:
            from .offline import run_offline

            e = self.engine
            return run_offline(
                self.model, reqs, num_slots=e.num_slots, max_len=e.max_len,
                eos_token_ids=[self.eos_token_id],
                pad_token_id=self.cfg.pad_token_id,
                chunk_size=e.chunk_size, cache_dtype=e.cache_dtype,
                prefill_buckets=e.prefill_buckets)
        return self.engine.run(reqs, on_token=on_token)

    def _requests(self, queries, pixel_chunks,
                  max_new_list=None) -> List[Request]:
        reqs = []
        for i, (q, px) in enumerate(zip(queries, pixel_chunks)):
            ids = np.asarray(
                self.tokenizer(q, add_special_tokens=False)["input_ids"],
                np.int64)
            mn = self.max_new_tokens
            if max_new_list is not None and max_new_list[i] is not None:
                # a per-request budget (OpenAI max_tokens), clamped to the
                # configured length
                mn = max(1, min(int(max_new_list[i]), mn))
            reqs.append(Request(
                uid=self._uid, input_ids=ids, pixel_values=_host(px),
                max_new_tokens=mn, temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, seed=self._uid))
            self._uid += 1
        return reqs

    def _decode_texts(self, completions, uids) -> List[str]:
        by_uid = {c.uid: c for c in completions}
        texts = []
        for uid in uids:
            text = self.tokenizer.decode(by_uid[uid].token_ids,
                                         skip_special_tokens=True)
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
        if history is None and pixel_values is not None \
                and "<image>" not in question:
            question = "<image>\n" + question
        query = build_chat_query(
            self.cfg.template, question, num_patches_list,
            self.cfg.num_image_token, history=history,
            system_message=self.system_message)
        reqs = self._requests([query], [pixel_values])
        response = self._decode_texts(self._run(reqs), [reqs[0].uid])[0]
        if return_history:
            return response, (history or []) + [(question, response)]
        return response

    def chat_many(self, items: Sequence[tuple], on_token=None) -> List[str]:
        """Independent chat() calls served as ONE engine batch: items are
        (question, pixel_values | None, history | None) triples, or
        5-tuples adding (num_patches_list | None, max_new | None). The
        responses align with `items` and equal per-item chat().

        on_token: optional `(item_index, token_id)` streaming callback (the
        engine's stream keyed by the caller's item positions)."""
        queries, pixel_chunks, max_new_list = [], [], []
        for it in items:
            question, pixel_values, history = it[0], it[1], it[2]
            npl = it[3] if len(it) > 3 and it[3] is not None else None
            max_new_list.append(it[4] if len(it) > 4 else None)
            if npl is None:
                npl = ([pixel_values.shape[0]]
                       if pixel_values is not None else [])
            if history is None and pixel_values is not None \
                    and "<image>" not in question:
                question = "<image>\n" + question
            queries.append(build_chat_query(
                self.cfg.template, question, npl, self.cfg.num_image_token,
                history=history, system_message=self.system_message))
            pixel_chunks.append(pixel_values)
        reqs = self._requests(queries, pixel_chunks, max_new_list)
        cb = None
        if on_token is not None:
            idx_of = {r.uid: i for i, r in enumerate(reqs)}
            cb = lambda uid, tok: on_token(idx_of[uid], tok)
        return self._decode_texts(self._run(reqs, on_token=cb),
                                  [r.uid for r in reqs])

    def batch_chat(self, questions: Sequence[str], pixel_values=None,
                   num_patches_list: Optional[List] = None) -> List[str]:
        """VlaserChat.batch_chat's signature: pixel_values is the tiles of
        every sample concatenated, split per request here so that each
        request prefills only its own tiles."""
        if num_patches_list is None:
            num_patches_list = ([pixel_values.shape[0]]
                                if pixel_values is not None else [])
        queries = build_batch_queries(
            self.cfg.template, questions, num_patches_list,
            self.cfg.num_image_token, system_message=self.system_message)
        pixels = _host(pixel_values)
        chunks: List[Optional[np.ndarray]] = []
        off = 0
        for i in range(len(questions)):
            entry = num_patches_list[i] if i < len(num_patches_list) else 0
            n = sum(entry) if isinstance(entry, (list, tuple)) else int(entry)
            if n and pixels is not None:
                chunks.append(pixels[off:off + n])
                off += n
            else:
                chunks.append(None)
        reqs = self._requests(queries, chunks)
        return self._decode_texts(self._run(reqs), [r.uid for r in reqs])

    def batch_chat_shared_image(self, questions: Sequence[str],
                                pixel_values=None) -> List[str]:
        """N questions about the SAME image: the common prompt head (the
        longest common prefix of the tokenized queries, which must hold the
        whole <IMG_CONTEXT> block) prefills once through
        engine.register_prefix, and each question admits only its tail.
        Token-identical to batch_chat."""
        pixels = _host(pixel_values)
        num_patches = [pixels.shape[0]] if pixels is not None else []
        queries = []
        for q in questions:
            if pixels is not None and "<image>" not in q:
                q = "<image>\n" + q
            queries.append(build_chat_query(
                self.cfg.template, q, num_patches, self.cfg.num_image_token,
                system_message=self.system_message))
        ids = [np.asarray(self.tokenizer(q, add_special_tokens=False)
                          ["input_ids"], np.int64) for q in queries]
        lcp = min(len(a) for a in ids) - 1  # every tail keeps >= 1 token
        for a in ids[1:]:
            n = min(lcp, len(a))
            diff = np.nonzero(a[:n] != ids[0][:n])[0]
            if diff.size:
                lcp = int(diff[0])
        if pixels is not None:
            want = self.cfg.num_image_token * pixels.shape[0]
            got = int((ids[0][:lcp] == self.cfg.img_context_token_id).sum())
            if got != want:
                raise ValueError(
                    f"shared-image prefix covers {got}/{want} image tokens; "
                    "questions must not diverge before the <image> block")
        pid = self.engine.register_prefix(ids[0][:lcp], pixels)
        try:
            reqs = []
            for a in ids:
                reqs.append(Request(
                    uid=self._uid, input_ids=a[lcp:], prefix_id=pid,
                    max_new_tokens=self.max_new_tokens,
                    temperature=self.temperature, top_k=self.top_k,
                    top_p=self.top_p, seed=self._uid))
                self._uid += 1
            return self._decode_texts(self.engine.run(reqs),
                                      [r.uid for r in reqs])
        finally:
            self.engine.release_prefix(pid)
