"""Math answer verification (local sympy-backed `math_verify` equivalent)
and MathVista answer extraction/scoring.

Parity surfaces:
- The reference's reasoning-data pipeline scores rollout correctness with
  the external `math_verify` package (Vlaser_VLM/internvl_chat/tools/
  reasoning_data_pipeline, accuracy-reward modes); this module provides the
  same verdict surface natively: parse both sides (numeric, fraction,
  percentage, simple LaTeX, interval/tuple/set) and test symbolic/numeric
  equivalence with sympy.
- mathvista/extract_answer.py:35-90 (quick_extract regex; the gpt-engine
  extraction mode is replaced by an optional generate_fn, same pattern as
  data/qa_generation.py) and mathvista/calculate_score.py:9-80
  (normalize_extracted_answer, safe_equal, Levenshtein most-similar choice).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

# --------------------------------------------------------------------------
# expression parsing
# --------------------------------------------------------------------------

_LATEX_REPLACEMENTS = [
    (r"\\left", ""), (r"\\right", ""), (r"\\,", ""), (r"\\!", ""),
    (r"\\;", ""), (r"\\ ", " "), (r"\\cdot", "*"), (r"\\times", "*"),
    (r"\\div", "/"), (r"\\pi", "pi"), (r"\\infty", "oo"),
    (r"\\%", "/100"), (r"\\$", ""), (r"\$", ""), (r"°", ""),
    (r"\\circ", ""), (r"\^\{\\circ\}", ""),
]


def _latex_to_expr(s: str) -> str:
    r"""Lower simple LaTeX to a sympy-parsable string: \frac{a}{b} -> (a)/(b),
    \sqrt{a} -> sqrt(a), x^{n} -> x**(n), braces -> parens."""
    s = s.strip()
    s = re.sub(r"\\text\{([^{}]*)\}", r"\1", s)
    s = re.sub(r"\\mathrm\{([^{}]*)\}", r"\1", s)
    s = re.sub(r"\\boxed\{", "(", s)  # closing brace handled by brace pass
    for pat, rep in _LATEX_REPLACEMENTS:
        s = re.sub(pat, rep, s)
    # \frac{a}{b}, \dfrac, \tfrac (may nest one level)
    frac = re.compile(r"\\[dt]?frac\{([^{}]*)\}\{([^{}]*)\}")
    while frac.search(s):
        s = frac.sub(r"((\1)/(\2))", s)
    s = re.sub(r"\\sqrt\{([^{}]*)\}", r"sqrt(\1)", s)
    s = re.sub(r"\\sqrt(\w)", r"sqrt(\1)", s)
    s = re.sub(r"\^\{([^{}]*)\}", r"**(\1)", s)
    s = s.replace("^", "**")
    s = s.replace("{", "(").replace("}", ")")
    s = s.replace("%", "/100")
    # thousands separators: 1,234,567
    s = re.sub(r"(?<=\d),(?=\d\d\d\b)", "", s)
    return s.strip().rstrip(".")


def parse_math(s: str):
    """String -> sympy expression, or None."""
    import sympy
    from sympy.parsing.sympy_parser import (
        implicit_multiplication_application, parse_expr,
        standard_transformations,
    )

    s = _latex_to_expr(str(s))
    if not s:
        return None
    try:
        return parse_expr(
            s,
            transformations=standard_transformations
            + (implicit_multiplication_application,),
            evaluate=True,
        )
    except Exception:
        try:
            return sympy.nsimplify(s)
        except Exception:
            return None


def verify_math(gold: str, pred: str, tol: float = 1e-6) -> bool:
    """Equivalence verdict: exact string (normalized), then sympy symbolic
    difference == 0, then numeric closeness. Tuple/interval answers compare
    element-wise."""
    g, p = str(gold).strip(), str(pred).strip()
    if not g or not p:
        return False
    if g.lower() == p.lower():
        return True

    # element-wise for (a, b) / [a, b] pairs
    tup = re.compile(r"^[\(\[]\s*(.+?)\s*,\s*(.+?)\s*[\)\]]$")
    mg, mp = tup.match(g), tup.match(p)
    if mg and mp:
        return all(
            verify_math(a, b, tol) for a, b in zip(mg.groups(), mp.groups())
        )

    eg, ep = parse_math(g), parse_math(p)
    if eg is None or ep is None:
        return False
    import sympy

    try:
        diff = sympy.simplify(eg - ep)
        if diff == 0:
            return True
    except Exception:
        pass
    try:
        fg, fp = float(eg.evalf()), float(ep.evalf())
        return abs(fg - fp) <= tol * max(1.0, abs(fg))
    except Exception:
        return False


# --------------------------------------------------------------------------
# MathVista extraction + scoring
# --------------------------------------------------------------------------

_ANSWER_PREFIX = re.compile(r"(Final answer:|Answer:)\s*(.*)", re.IGNORECASE)


def mathvista_quick_extract(response: str) -> Optional[str]:
    """quick_extract (extract_answer.py:35-80): 'Answer:'/'Final answer:'
    tail, else 'The answer is "X".'"""
    m = _ANSWER_PREFIX.search(response)
    if m:
        return m.group(2).strip().strip('"').strip("'").strip()
    m2 = re.search(r'The answer is "(.*)"\.', response)
    if m2:
        return m2.group(1).strip()
    return None


def extract_answer(
    response: str,
    problem: Dict,
    generate_fn: Optional[Callable[[str], str]] = None,
) -> str:
    """extract_answer.py:42-90 with the LLM engine swapped for an optional
    generate_fn (our own served chat, data/qa_generation.py pattern).
    Trivial cases short-circuit: empty response, single-letter choice,
    bare integer/float answers."""
    question_type = problem.get("question_type", "free_form")
    answer_type = problem.get("answer_type", "text")
    choices = problem.get("choices") or []
    if not response:
        return ""
    if question_type == "multi_choice" and response in choices:
        return response
    if answer_type == "integer":
        try:
            return str(int(response))
        except ValueError:
            pass
    if answer_type == "float":
        try:
            return str(float(response))
        except ValueError:
            pass
    quick = mathvista_quick_extract(response)
    if quick is not None:
        return quick
    if generate_fn is not None:
        out = generate_fn(
            "Please read the following example. Then extract the answer from "
            "the model response and type it at the end of the prompt.\n\n"
            f"Question: {problem.get('query', problem.get('question', ''))}\n\n"
            f"Model response: {response}\n\nExtracted answer: "
        )
        return out.strip()
    return response


def get_most_similar(prediction: str, choices: Sequence[str]) -> str:
    """Levenshtein nearest choice (calculate_score.py:9-16)."""
    from .vqa_metrics import edit_distance

    dists = [edit_distance(prediction, c) for c in choices]
    return choices[dists.index(min(dists))]


def normalize_extracted_answer(
    extraction,
    choices: Sequence[str],
    question_type: str,
    answer_type: str,
    precision,
) -> Optional[str]:
    """calculate_score.py:19-67."""
    if question_type == "multi_choice":
        extraction = str(extraction).strip() if extraction is not None else ""
        letter = re.findall(r"\(([a-zA-Z])\)", extraction)
        if letter:
            extraction = letter[0].upper()
        options = [chr(ord("A") + i) for i in range(len(choices))]
        if extraction in options:
            return choices[options.index(extraction)]
        return get_most_similar(extraction, list(choices))
    if answer_type == "integer":
        try:
            return str(int(float(extraction)))
        except (ValueError, TypeError):
            return None
    if answer_type == "float":
        try:
            return str(round(float(extraction), int(precision)))
        except (ValueError, TypeError):
            return None
    if answer_type == "list":
        try:
            return str(extraction)
        except Exception:
            return None
    return str(extraction) if extraction is not None else None


def safe_equal(prediction, answer) -> bool:
    """calculate_score.py:70-80 — string equality guarded."""
    try:
        return prediction == answer
    except Exception:
        return False


def mathvista_score(results: Sequence[Dict]) -> Dict[str, float]:
    """results: [{'response', 'question_type', 'answer_type', 'choices',
    'precision', 'answer'}] -> accuracy with the reference's normalize +
    safe_equal pipeline (calculate_score.py:150-170)."""
    correct = 0
    for r in results:
        ext = extract_answer(r.get("response", ""), r)
        pred = normalize_extracted_answer(
            ext, r.get("choices") or [], r.get("question_type", "free_form"),
            r.get("answer_type", "text"), r.get("precision", 2),
        )
        if safe_equal(pred, str(r["answer"])):
            correct += 1
    return {
        "accuracy": correct / max(len(results), 1),
        "num_evaluated": len(results),
    }


def score_rollouts_math(
    gold: str, rollouts: Sequence[str]
) -> List[int]:
    """Reasoning-pipeline hook: verdict per rollout via verify_math on the
    extracted tail answers (data/reasoning_pipeline.py correctness modes)."""
    outs = []
    for r in rollouts:
        ext = mathvista_quick_extract(r)
        outs.append(int(verify_math(gold, ext if ext is not None else r)))
    return outs
