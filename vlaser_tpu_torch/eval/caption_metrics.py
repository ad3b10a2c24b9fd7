"""Image-caption metrics: BLEU-4 and CIDEr-D, native implementations.

Parity surface: Vlaser_VLA/Simpler/src/model/internvl_chat/eval/caption/
evaluate_caption.py — the reference scores with pycocoevalcap's COCOEvalCap
(:13-14, :204-206) over {flickr30k, coco, nocaps} using the prompt
'Provide a one-sentence caption for the provided image.' (:125). That
package (and its bundled Stanford PTBTokenizer jar) is not in this image,
so the two headline metrics are implemented here from their definitions:

- BLEU-4: brevity-penalized geometric mean of clipped n-gram precisions
  (Papineni et al. 2002), corpus-level as pycocoevalcap reports it.
- CIDEr-D: tf-idf-weighted n-gram cosine with length gaussian and count
  clipping (Vedantam et al. 2015), n=1..4, sigma=6, corpus idf.

Tokenization is PTB-exact (eval/ptb_tokenizer.py): the Penn Treebank rules
the reference's Stanford jar implements, plus pycocoevalcap's own
lowercase + punctuation-list removal — verified token-identical to NLTK's
independent implementation and to the Stanford tokenizer's published
example in tests/test_caption_metrics.py.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

from .ptb_tokenizer import ptb_tokenize

CAPTION_PROMPT = "Provide a one-sentence caption for the provided image."


def tokenize(text: str) -> List[str]:
    return ptb_tokenize(text)


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# --------------------------------------------------------------------------
# BLEU
# --------------------------------------------------------------------------


def corpus_bleu(
    predictions: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
) -> float:
    """Corpus-level BLEU-N with closest-reference brevity penalty."""
    assert len(predictions) == len(references)
    clipped = [0] * max_n
    totals = [0] * max_n
    pred_len = ref_len = 0
    for pred, refs in zip(predictions, references):
        p = tokenize(pred)
        rs = [tokenize(r) for r in refs]
        pred_len += len(p)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(p)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            pn = _ngrams(p, n)
            maxref: Counter = Counter()
            for r in rs:
                rn = _ngrams(r, n)
                for g, c in rn.items():
                    maxref[g] = max(maxref[g], c)
            totals[n - 1] += max(len(p) - n + 1, 0)
            clipped[n - 1] += sum(min(c, maxref[g]) for g, c in pn.items())
    if min(totals) == 0 or min(clipped) == 0:
        return 0.0
    log_p = sum(math.log(c / t) for c, t in zip(clipped, totals)) / max_n
    bp = 1.0 if pred_len > ref_len else math.exp(1 - ref_len / max(pred_len, 1))
    return bp * math.exp(log_p)


# --------------------------------------------------------------------------
# CIDEr-D
# --------------------------------------------------------------------------


def cider_d(
    predictions: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
    sigma: float = 6.0,
) -> float:
    """Corpus CIDEr-D: mean over images of 10 * mean_n similarity."""
    assert len(predictions) == len(references)
    n_images = len(predictions)
    pred_toks = [tokenize(p) for p in predictions]
    ref_toks = [[tokenize(r) for r in refs] for refs in references]

    # document frequency over reference sets (a gram counts once per image)
    df: List[Dict] = [defaultdict(float) for _ in range(max_n)]
    for refs in ref_toks:
        for n in range(1, max_n + 1):
            seen = set()
            for r in refs:
                seen.update(_ngrams(r, n).keys())
            for g in seen:
                df[n - 1][g] += 1.0
    log_ref = math.log(max(n_images, 1))

    def tfidf_vec(tokens: List[str], n: int):
        cnt = _ngrams(tokens, n)
        vec = {}
        norm = 0.0
        length = 0.0
        for g, c in cnt.items():
            idf = log_ref - math.log(max(df[n - 1].get(g, 0.0), 1.0))
            v = c * idf
            vec[g] = v
            norm += v * v
            length += c
        return vec, math.sqrt(norm), length

    score_total = 0.0
    for p, refs in zip(pred_toks, ref_toks):
        img_score = 0.0
        for n in range(1, max_n + 1):
            pv, pn, plen = tfidf_vec(p, n)
            sim_sum = 0.0
            for r in refs:
                rv, rn, rlen = tfidf_vec(r, n)
                # clipped dot product (the '-D' count clipping)
                dot = sum(min(v, rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g, v in pv.items())
                if pn > 0 and rn > 0:
                    sim = dot / (pn * rn)
                    delta = plen - rlen
                    sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                    sim_sum += sim
            img_score += sim_sum / max(len(refs), 1)
        score_total += 10.0 * img_score / max_n
    return score_total / max(n_images, 1)


def evaluate_captions(
    results: Sequence[Dict],
) -> Dict[str, float]:
    """results: [{'caption': pred, 'references': [str, ...]}] ->
    {'Bleu_4', 'CIDEr'} (the two numbers the reference's COCOEvalCap table
    is read for)."""
    preds = [r["caption"] for r in results]
    refs = [r["references"] for r in results]
    return {
        "Bleu_4": corpus_bleu(preds, refs, max_n=4),
        "CIDEr": cider_d(preds, refs),
        "num_evaluated": len(results),
    }
