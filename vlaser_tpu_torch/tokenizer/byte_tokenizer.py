"""Offline byte-level tokenizer (`ByteTokenizer` of
vlaser_tpu/tokenizer/byte_tokenizer.py, copied unchanged): 256 byte ids plus
added special tokens, with the HF tokenizer's interface surface
(__call__ / add_tokens / convert_tokens_to_ids / __len__ / decode), so the
training CLIs run under --tiny, and at full width on a box with no
checkpoint, tokenizer files or `transformers`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union


class ByteTokenizer:
    """256 byte ids + dynamically added special tokens (greedy-matched)."""

    def __init__(self):
        self._specials: Dict[str, int] = {}
        self.pad_token_id = 0

    def __len__(self) -> int:
        return 256 + len(self._specials)

    def add_tokens(self, tokens: Sequence[str], special_tokens: bool = True) -> int:
        n = 0
        for t in tokens:
            if t not in self._specials:
                self._specials[t] = 256 + len(self._specials)
                n += 1
        return n

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        if isinstance(tokens, str):
            return self._specials.get(tokens, -1)
        return [self._specials.get(t, -1) for t in tokens]

    def __call__(self, text: str, add_special_tokens: bool = False, **kw):
        ids: List[int] = []
        i = 0
        # longest-first greedy special-token matching
        specials = sorted(self._specials, key=len, reverse=True)
        while i < len(text):
            for tok in specials:
                if text.startswith(tok, i):
                    ids.append(self._specials[tok])
                    i += len(tok)
                    break
            else:
                ids.extend(text[i].encode("utf-8", errors="replace"))
                i += 1
        return {"input_ids": ids}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        inv = {v: k for k, v in self._specials.items()}
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i in inv:
                flush()
                if not skip_special_tokens:
                    out.append(inv[i])
            elif 0 <= i < 256:
                byte_buf.append(i)
        flush()
        return "".join(out)
