"""Penn-Treebank tokenizer, first-party — the caption-scoring tokenization.

Parity surface: pycocoevalcap's PTBTokenizer wrapper, which the reference's
caption eval uses for BLEU/CIDEr scoring (Vlaser_VLA/Simpler/src/model/
internvl_chat/eval/caption/evaluate_caption.py:13-14,204-206). That wrapper
shells out to Stanford's `stanford-corenlp-3.4.1.jar` PTBTokenizer with
`-preserveLines -lowerCase`, then drops a fixed punctuation-token list from
the result. Neither the jar nor a JVM ships in this image, so the rules are
implemented here from the Penn Treebank tokenizer specification (the
`tokenizer.sed` script the Stanford lexer documents as its baseline):

- punctuation split off as its own tokens; sentence-final periods separated
- directional quote normalization: opening " -> `` and closing " -> ''
- round/curly/square brackets -> -LRB-/-RRB-/-LCB-/-RCB-/-LSB-/-RSB-
- contraction clitics split: n't 's 'm 're 've 'll 'd
- assimilated forms split: cannot gonna gotta lemme gimme wanna
- ellipsis grouped as `...`, em-dash `--` kept as one token

and `ptb_tokenize` applies the same post-filter the pycocoevalcap wrapper
applies (lowercase + drop PUNCTUATIONS). Verified two ways in
tests/test_caption_metrics.py: token-identical to NLTK's
TreebankWordTokenizer (an independent implementation of the same spec)
across a caption-shaped corpus, and against the Stanford PTBTokenizer's own
published example sentence.
"""

from __future__ import annotations

import re
from typing import List

# the exact list pycocoevalcap/tokenizer/ptbtokenizer.py removes
PUNCTUATIONS = [
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]

# --- rule tables (order matters; applied to " "-padded text) ---------------

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ (\[{<])(\"|\'{2})"), r"\1 `` "),
]

_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # final period: split only when it ends the string (modulo trailing
    # closers/quotes) — interior "U.S. flag" style abbreviations stay whole
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

_BRACKETS = [
    (re.compile(r"\("), " -LRB- "),
    (re.compile(r"\)"), " -RRB- "),
    (re.compile(r"\["), " -LSB- "),
    (re.compile(r"\]"), " -RSB- "),
    (re.compile(r"\{"), " -LCB- "),
    (re.compile(r"\}"), " -RCB- "),
    (re.compile(r"--"), r" -- "),
]

_ENDING_QUOTES = [
    (re.compile(r'"'), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

_CONTRACTIONS = [
    re.compile(p, re.IGNORECASE)
    for p in (
        r"\b(can)(?#X)(not)\b",
        r"\b(d)(?#X)('ye)\b",
        r"\b(gim)(?#X)(me)\b",
        r"\b(gon)(?#X)(na)\b",
        r"\b(got)(?#X)(ta)\b",
        r"\b(lem)(?#X)(me)\b",
        r"\b(more)(?#X)('n)\b",
        r"\b(wan)(?#X)(na)(?=\s)",
    )
]
_CONTRACTIONS2 = [
    re.compile(p, re.IGNORECASE)
    for p in (r" ('t)(?#X)(is)\b", r" ('t)(?#X)(was)\b")
]


def ptb_word_tokenize(text: str) -> List[str]:
    """Raw PTB tokenization (no lowercasing, punctuation kept) — NLTK
    TreebankWordTokenizer-equivalent with convert_parentheses=True."""
    for pat, sub in _STARTING_QUOTES:
        text = pat.sub(sub, text)
    for pat, sub in _PUNCTUATION:
        text = pat.sub(sub, text)
    for pat, sub in _BRACKETS:
        text = pat.sub(sub, text)
    text = " " + text + " "
    for pat, sub in _ENDING_QUOTES:
        text = pat.sub(sub, text)
    for pat in _CONTRACTIONS:
        text = pat.sub(r" \1 \2 ", text)
    for pat in _CONTRACTIONS2:
        text = pat.sub(r" \1 \2 ", text)
    return text.split()


def ptb_tokenize(text: str) -> List[str]:
    """What pycocoevalcap feeds the scorers: PTB tokens, lowercased, with
    the PUNCTUATIONS list removed."""
    drop = set(PUNCTUATIONS)
    return [t.lower() for t in ptb_word_tokenize(text) if t not in drop]
