"""VQA-family answer normalization + metrics (protocol-exact).

Parity surface: Vlaser_VLA/Simpler/src/model/internvl_chat/eval/vqa/ —
`evaluate_vqa.py` routes each dataset to one of four metrics
(`ds_collections[...]['metric']`):
  vqa_score          — EvalAI soft score over 10 annotators (textvqa_eval.py
                       TextVQAAccuracyEvaluator; vqav2/okvqa/textvqa/vizwiz)
  anls               — edit-distance ANLS >= 0.5 (STVQAANLSEvaluator;
                       docvqa/infographicsvqa)
  relaxed_accuracy   — 5% numeric tolerance (evaluate_vqa.py:144-196;
                       chartqa)
  accuracy           — exact match over annotation list (:199-211;
                       gqa/ai2d/...)
plus the shared free-form `post_process` (:299-316) that strips articles and
copulas from chat output before scoring.

The normalization tables (contractions, number words, articles, punctuation)
are the public EvalAI/mmf protocol constants — they must match verbatim or
the scores are not comparable to published numbers.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

# --------------------------------------------------------------------------
# EvalAI answer processor (textvqa_eval.py:8-220; upstream facebookresearch/
# mmf pythia/tasks/processors.py). Protocol constants, kept verbatim.
# --------------------------------------------------------------------------

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "parisians": "parisian's", "peoples": "people's", "couldnt'": "couldn't",
    "shant": "shan't", "she'dve": "she'd've", "shed've": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

_ARTICLES = ["a", "an", "the"]

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")

_PUNCTUATIONS = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


class EvalAIAnswerProcessor:
    """Normalizes a free-form answer the way the EvalAI server does."""

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, in_text: str) -> str:
        out_text = in_text
        for p in _PUNCTUATIONS:
            if (p + " " in in_text or " " + p in in_text) or (
                _COMMA_STRIP.search(in_text) is not None
            ):
                out_text = out_text.replace(p, "")
            else:
                out_text = out_text.replace(p, " ")
        out_text = _PERIOD_STRIP.sub("", out_text)
        return out_text

    def process_digit_article(self, in_text: str) -> str:
        out_text = []
        for word in in_text.lower().split():
            word = _NUMBER_MAP.get(word, word)
            if word not in _ARTICLES:
                out_text.append(word)
        for i, word in enumerate(out_text):
            if word in _CONTRACTIONS:
                out_text[i] = _CONTRACTIONS[word]
        return " ".join(out_text)

    def __call__(self, item: str) -> str:
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


# --------------------------------------------------------------------------
# chat-output post-processing (evaluate_vqa.py:299-316)
# --------------------------------------------------------------------------


def post_process_vqa(response: str) -> str:
    """Strip to the head noun phrase before scoring."""
    response = response.strip().split(".")[0].split(",")[0].split("!")[0].lower()
    for lead in ("is ", "are ", "a ", "an ", "the "):
        if lead in response:
            response = response.split(lead)[1]
    if " of" in response:
        response = response.split(" of")[0]
    return response.strip()


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


def vqa_soft_score(pred: str, gt_answers: Sequence[str]) -> float:
    """EvalAI 10-annotator soft score: min(#others-matching / 3, 1), averaged
    leave-one-out (textvqa_eval.py:226-258)."""
    proc = EvalAIAnswerProcessor()
    answers = [proc(a) for a in gt_answers]
    assert len(answers) == 10, "vqa_score expects 10 annotator answers"
    pred = proc(pred)
    gt = list(enumerate(answers))
    scores = []
    for i, _ in gt:
        others = [a for j, a in gt if j != i]
        scores.append(min(1.0, sum(a == pred for a in others) / 3.0))
    return sum(scores) / len(scores)


def stvqa_exact_score(pred: str, gt_answers: Sequence[str]) -> float:
    """Processed exact-match over the annotation list (STVQAAccuracyEvaluator)."""
    proc = EvalAIAnswerProcessor()
    return 1.0 if proc(pred) in [proc(a) for a in gt_answers] else 0.0


def edit_distance(s1: str, s2: str) -> int:
    """Levenshtein distance (replaces the editdistance package)."""
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    prev = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1):
        cur = [i + 1]
        for j, c2 in enumerate(s2):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (c1 != c2)))
        prev = cur
    return prev[-1]


def anls_score(pred: str, gt_answers: Sequence[str]) -> float:
    """ANLS: 1 - NLD if >= 0.5 else 0, max over annotations
    (STVQAANLSEvaluator:277-299)."""

    def one(s1: str, s2: str) -> float:
        s1, s2 = s1.lower().strip(), s2.lower().strip()
        if max(len(s1), len(s2)) == 0:
            return 0.0
        iou = 1 - edit_distance(s1, s2) / max(len(s1), len(s2))
        return iou if iou >= 0.5 else 0.0

    return max(one(pred, gt) for gt in gt_answers)


def relaxed_correctness(
    target: str, prediction: str, max_relative_change: float = 0.05
) -> bool:
    """ChartQA relaxed accuracy: 5% numeric tolerance, exact otherwise
    (evaluate_vqa.py:144-183)."""

    def to_float(text: str) -> Optional[float]:
        try:
            if text.endswith("%"):
                return float(text.rstrip("%")) / 100.0
            return float(text)
        except ValueError:
            return None

    p, t = to_float(prediction), to_float(target)
    if p is not None and t:
        return abs(p - t) / abs(t) <= max_relative_change
    return prediction.lower() == target.lower()


def _as_list(ann) -> List[str]:
    return [ann] if isinstance(ann, str) else list(ann)


def evaluate_relaxed_accuracy(entries: Sequence[Dict]) -> float:
    """entries: [{'answer': pred, 'annotation': str|[str]}] (:186-196)."""
    scores = [
        max(relaxed_correctness(e["answer"].strip(), a)
            for a in _as_list(e["annotation"]))
        for e in entries
    ]
    return sum(scores) / max(len(scores), 1)


def evaluate_exact_match_accuracy(entries: Sequence[Dict]) -> float:
    """Case-insensitive exact match over the annotation list (:199-211)."""
    scores = [
        max(1.0 if e["answer"].strip().lower() == a.strip().lower() else 0.0
            for a in _as_list(e["annotation"]))
        for e in entries
    ]
    return sum(scores) / max(len(scores), 1)


def evaluate_vqa_score(entries: Sequence[Dict]) -> float:
    """entries: [{'answer': pred, 'annotation': [10 strings]}]."""
    scores = [vqa_soft_score(e["answer"], _as_list(e["annotation"]))
              for e in entries]
    return sum(scores) / max(len(scores), 1)


def evaluate_anls(entries: Sequence[Dict]) -> float:
    scores = [anls_score(e["answer"], _as_list(e["annotation"]))
              for e in entries]
    return sum(scores) / max(len(scores), 1)


# dataset name -> (metric fn, prompt) routing, mirroring ds_collections
# (evaluate_vqa.py:20-141, :318-334)
BASE_PROMPT = "Answer the question using a single word or phrase."
VIZWIZ_PROMPT = (
    "When the provided information is insufficient, respond with "
    "'Unanswerable'. " + BASE_PROMPT
)

METRIC_BY_DATASET = {
    "vqav2_val": "vqa_score", "okvqa_val": "vqa_score",
    "textvqa_val": "vqa_score", "vizwiz_val": "vqa_score",
    "docvqa_val": "anls", "infographicsvqa_val": "anls",
    "chartqa_human": "relaxed_accuracy", "chartqa_augmented": "relaxed_accuracy",
    "gqa_testdev": "accuracy", "ai2diagram_test": "accuracy",
}

EVALUATORS = {
    "vqa_score": evaluate_vqa_score,
    "anls": evaluate_anls,
    "relaxed_accuracy": evaluate_relaxed_accuracy,
    "accuracy": evaluate_exact_match_accuracy,
}
