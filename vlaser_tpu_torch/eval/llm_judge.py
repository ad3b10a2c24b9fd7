"""LLM-judged benchmark protocols: MMHal-Bench, LLaVA-Bench(-in-the-wild),
MM-Vet result export.

Parity surface: Vlaser_VLA/Simpler/src/model/internvl_chat/eval/ —
- mmhal/eval_gpt_mmhal.py:8-96 (the judge template — a protocol constant
  kept verbatim so ratings are comparable), :128-158 (rating parse,
  hallucination = rating < 3, per-question-type i%8 averages)
- llava_bench/eval_gpt_review_bench.py:16-31 (system prompt), :34-43 (score
  pair parse), :95-103 (review content layout); summarize_gpt_review.py
  (relative score = 100 * sum(scores2) / sum(scores1) per category)
- mmvet/evaluate_mmvet.py:100-107 (the {'v1_<qid>': pred} results json the
  official grader consumes — grading itself is server-side GPT-4)

The reference drives OpenAI; here the judge is any
`judge_fn(prompt, system=None) -> str` (our own served chat, another model
— same pattern as data/qa_generation.py).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

# --------------------------------------------------------------------------
# MMHal-Bench
# --------------------------------------------------------------------------

MMHAL_RATINGS = """- Rating: 6, very informative with good analysis or reasoning, no hallucination
- Rating: 5, very informative, no hallucination
- Rating: 4, somewhat informative, no hallucination
- Rating: 3, not informative, no hallucination
- Rating: 2, very informative, with hallucination
- Rating: 1, somewhat informative, with hallucination
- Rating: 0, not informative, with hallucination"""

# eval_gpt_mmhal.py:8-96 (examples elided here; the scoring-relevant parts —
# the task definition, rating scale, and input layout — are verbatim)
MMHAL_TEMPLATE = (
    "Please act as an impartial and objective judge and evaluate the "
    "quality of the response provided by a Large Multimodal Model (LMM) to "
    "the user question. Your evaluation should be mainly based on whether "
    "the response is informative, and whether the response contains any "
    "hallucination. Hallucination, in this context, refers to a situation "
    "where the LMM generates a response that includes information not "
    "present or implied in the image or previous conversation. A "
    "hallucination could be a false claim about an object, action, emotion, "
    "or any other detail that is not grounded in the image.\n\n"
    "Please note that the standard human-generated answer may only contain "
    "factual information but may not give a detailed analysis. Also, the "
    "standard human-generated answer may not be completely comprehensive in "
    "describing all the objects and their attributes, so please be a bit "
    "more cautious during evalutation. LMM's detailed analysis or reasoning "
    "should be encouraged.\n\n"
    "To evaluate the LMM responses, first, begin your evaluation by "
    "providing a short explanation. Second, after providing your "
    "explanation, you must rate the response by choosing from the following "
    "options:\n" + MMHAL_RATINGS + "\n\n"
    "### Image Contents\n{}\n\n### Question\n{}\n\n"
    "### Standard Human-Generated Answer\n{}\n\n"
    "### LMM Response to Evaluate\n{}\n"
)


def mmhal_parse_rating(response: str) -> int:
    """eval_gpt_mmhal.py:128-141: unique 'rating: N' match, else 0."""
    found = [s for s in range(7) if f"rating: {s}" in response.lower()]
    return found[0] if len(found) == 1 else 0


def evaluate_mmhal(
    records: Sequence[Dict],  # {image_content: [str], question, gt_answer,
    #                            model_answer}
    judge_fn: Callable[[str], str],
    num_question_types: int = 8,
) -> Dict:
    """-> average score, hallucination rate (rating<3), per-question-type
    averages (questions cycle through types i%8; :143-158)."""
    scores = []
    for rec in records:
        prompt = MMHAL_TEMPLATE.format(
            ", ".join(rec["image_content"]), rec["question"],
            rec["gt_answer"], rec["model_answer"],
        )
        scores.append(mmhal_parse_rating(judge_fn(prompt)))
    hallucination = [int(s < 3) for s in scores]
    per_type = [[] for _ in range(num_question_types)]
    for i, s in enumerate(scores):
        per_type[i % num_question_types].append(s)
    return {
        "average_score": sum(scores) / max(len(scores), 1),
        "hallucination_rate": sum(hallucination) / max(len(scores), 1),
        "scores_each_type": [
            round(sum(v) / len(v), 2) if v else 0.0 for v in per_type
        ],
        "scores": scores,
    }


# --------------------------------------------------------------------------
# LLaVA-Bench (in-the-wild) pairwise review
# --------------------------------------------------------------------------

LLAVA_JUDGE_SYSTEM = (
    "You are a helpful and precise assistant for checking the quality of "
    "the answer."
)


def build_llava_review_content(
    caption, question: str, answer1: str, answer2: str, rule: Dict
) -> str:
    """eval_gpt_review_bench.py:95-103 layout."""
    cap_str = "\n".join(caption) if isinstance(caption, list) else caption
    role = rule["role"]
    return (
        f"[Context]\n{cap_str}\n\n"
        f"[Question]\n{question}\n\n"
        f"[{role} 1]\n{answer1}\n\n[End of {role} 1]\n\n"
        f"[{role} 2]\n{answer2}\n\n[End of {role} 2]\n\n"
        f"[System]\n{rule['prompt']}\n\n"
    )


def llava_parse_score(review: str) -> List[float]:
    """:34-43 — first line must be 'x y'; unparseable -> [-1, -1]."""
    try:
        sp = review.split("\n")[0].replace(",", " ").split(" ")
        sp = [s for s in sp if s]
        if len(sp) == 2:
            return [float(sp[0]), float(sp[1])]
        return [-1.0, -1.0]
    except (ValueError, IndexError):
        return [-1.0, -1.0]


def evaluate_llava_bench(
    items: Sequence[Dict],  # {category, caption, question, answer1, answer2}
    judge_fn: Callable[..., str],
    rules: Dict[str, Dict],
) -> Dict:
    """Pairwise reviews + summarize_gpt_review.py aggregation: per category,
    relative score = 100 * sum(assistant2) / sum(assistant1), plus the raw
    average pair. answer1 = reference assistant (GPT-4 answers in the
    official set), answer2 = model under test."""
    per_cat: Dict[str, List[List[float]]] = defaultdict(list)
    reviews = []
    for it in items:
        cat = it["category"]
        rule = rules.get(f"llava_bench_{cat}") or rules.get(cat) \
            or rules["default"]
        content = build_llava_review_content(
            it.get("caption", ""), it["question"], it["answer1"],
            it["answer2"], rule,
        )
        try:
            review = judge_fn(content, system=LLAVA_JUDGE_SYSTEM)
        except TypeError:
            review = judge_fn(content)
        pair = llava_parse_score(review)
        reviews.append({"category": cat, "tuple": pair, "content": review})
        if pair != [-1.0, -1.0]:
            per_cat[cat].append(pair)
            per_cat["all"].append(pair)
    out = {}
    for cat, pairs in sorted(per_cat.items()):
        s1 = sum(p[0] for p in pairs)
        s2 = sum(p[1] for p in pairs)
        out[cat] = {
            "relative_score": 100.0 * s2 / max(s1, 1e-9),
            "assistant1_avg": s1 / len(pairs),
            "assistant2_avg": s2 / len(pairs),
            "n": len(pairs),
        }
    out["reviews"] = reviews
    return out


# --------------------------------------------------------------------------
# MM-Vet result export
# --------------------------------------------------------------------------


def mmvet_dump_results(
    predictions: Dict[str, str], path: str, version: str = "v1"
) -> None:
    """evaluate_mmvet.py:100-107: the '{v1_<qid>': pred}' json the official
    MM-Vet GPT-4 grader consumes."""
    outputs = {f"{version}_{qid}": pred for qid, pred in predictions.items()}
    with open(path, "w") as f:
        json.dump(outputs, f)
