"""VisualPRM process-reward data pipeline (a copy of
vlaser_tpu/data/visualprm_pipeline.py).

Parity surface: Vlaser_VLM/internvl_chat/tools/reasoning_data_pipeline/
- visualprm_data_pieline.py: sample N solutions per (image, question), split
  each into reasoning steps (:116-130), then Monte-Carlo-score every step
  prefix by sampling `num_mc_sequences` continuations and measuring the
  fraction that reach the correct final answer (:174-251); early_stop
  truncates after the first 0-score step.
- visualprm_data_pipeline_postprocess.py: turn scored steps into PRM ('+'/'-'
  per step under the PRM system prompt, :20-45) or ORM (single verdict on the
  whole solution, :48-73) conversation training rows.

Rollouts come from any `generate_fn(prompt, prefix) -> str` (the port's
VlaserChat or EngineChat, data/qa_generation.py pattern; the reference
drives an LMDeploy/vLLM server).
Correctness reuses data/reasoning_pipeline.check_answer (exact / relaxed /
math_verify / vqa_score modes).
"""

from __future__ import annotations

import json
import math
from typing import Callable, Dict, List, Optional, Sequence

from .reasoning_pipeline import check_answer, extract_final_answer

PRM_SYSTEM_PROMPT = """
You are an advanced AI assistant, designed to serve as a process supervision model. In this task, I will provide a problem statement followed by the first step of the solution process. For each subsequent turn, I will give you a new step in the solution. Your role is to assess whether the solution process is correct up to the current step.

- In the **first round**, I will input the problem and the first step of the solution process.
- In **each subsequent round**, I will provide the next step in the solution.

For each step, you should:

- Respond with **"+"** if you believe the solution process is correct up to this step.
- Respond with **"-"** if you detect any issues or errors in the process up to this step.

Please note:
- Only respond with **"+"** or **"-"**. Do not provide any additional explanations, comments, or justifications.

Your task is to verify the accuracy and correctness of each step in the given solution process.
""".strip()

STEP_SEP = "\n\n"


def split_response(
    response: str, sep: str = STEP_SEP, max_steps: Optional[int] = None
) -> List[str]:
    """Paragraph steps, re-grouped to at most max_steps (pipeline :116-126)."""
    steps = response.split(sep)
    if max_steps is not None and len(steps) > max_steps:
        group = math.ceil(len(steps) / max_steps)
        steps = [sep.join(steps[i : i + group])
                 for i in range(0, len(steps), group)]
    return steps


def join_steps(steps: Sequence[str], sep: str = STEP_SEP) -> str:
    return sep.join(steps)


def mc_score_steps(
    item: Dict,  # {image?, question, answer}
    response: str,
    generate_fn: Callable[[Dict, str], str],  # (item, prefix) -> continuation
    *,
    num_mc_sequences: int = 8,
    max_steps: Optional[int] = None,
    mode: str = "exact",
    early_stop: bool = True,
) -> List[Dict]:
    """Per-step Monte-Carlo scores (:174-251): for every step prefix, sample
    continuations and count how many reach the gold answer. After a 0-score
    step (early_stop) the remaining steps score 0 without sampling."""
    steps = split_response(response, max_steps=max_steps)
    out: List[Dict] = []
    dead = False
    for i in range(len(steps)):
        if dead:
            out.append({"step": steps[i], "score": 0,
                        "num_mc_correct": 0, "num_mc_total": 0})
            continue
        prefix = join_steps(steps[: i + 1])
        correct = 0
        for _ in range(num_mc_sequences):
            cont = generate_fn(item, prefix)
            pred = extract_final_answer(cont)
            try:
                correct += check_answer(pred, str(item["answer"]), mode)
            except Exception:
                pass
        score = correct / num_mc_sequences
        out.append({"step": steps[i], "score": score,
                    "num_mc_correct": correct,
                    "num_mc_total": num_mc_sequences})
        if score == 0 and early_stop:
            dead = True
    return out


def build_process_supervision(
    items: Sequence[Dict],
    rollout_fn: Callable[[Dict, int], str],  # (item, sample_idx) -> solution
    continue_fn: Callable[[Dict, str], str],  # (item, prefix) -> continuation
    *,
    num_return_sequences: int = 4,
    num_mc_sequences: int = 8,
    max_steps: Optional[int] = None,
    mode: str = "exact",
    early_stop: bool = True,
) -> List[Dict]:
    """Full pipeline (:254-270): N solutions per item, each step-scored.
    Output rows: {**item, response, steps_with_score}."""
    outputs = []
    for item in items:
        for k in range(num_return_sequences):
            response = rollout_fn(item, k)
            scored = mc_score_steps(
                item, response, continue_fn,
                num_mc_sequences=num_mc_sequences, max_steps=max_steps,
                mode=mode, early_stop=early_stop,
            )
            outputs.append({**item, "response": response,
                            "steps_with_score": scored})
    return outputs


def item_to_prm_conversation(
    item: Dict, mc_threshold: float = 0.0, early_stop: bool = True
) -> Dict:
    """postprocess.py item2conv_prm (:20-45): multi-turn +/- supervision."""
    conversations = [{"from": "system", "value": PRM_SYSTEM_PROMPT}]
    for i, step in enumerate(item["steps_with_score"]):
        query = step["step"]
        if i == 0:
            query = (f"### Question:\n{item['question']}\n\n"
                     f"### Solution Process:\n{query}")
        conversations.append({"from": "human", "value": query})
        conversations.append({
            "from": "gpt",
            "value": "+" if step["score"] > mc_threshold else "-",
        })
        if early_stop and step["score"] <= mc_threshold:
            break
    return {"id": -1, "image": item.get("image", ""),
            "conversations": conversations}


def item_to_orm_conversation(item: Dict, mc_threshold: float = 0.0) -> Dict:
    """postprocess.py item2conv_orm (:48-73): single verdict on the whole
    solution, judged by the LAST step's score."""
    steps = item["steps_with_score"]
    response = item.get("response") or join_steps(
        [s["step"] for s in steps]
    ).strip()
    query = (f"### Question:\n{item['question']}\n\n"
             f"### Solution Process:\n{response}")
    verdict = "+" if steps[-1]["score"] > mc_threshold else "-"
    return {
        "id": -1,
        "image": item.get("image", ""),
        "conversations": [
            {"from": "system", "value": PRM_SYSTEM_PROMPT},
            {"from": "human", "value": query},
            {"from": "gpt", "value": verdict},
        ],
    }


def write_conversations_jsonl(rows: Sequence[Dict], path: str):
    rows = sorted(rows, key=lambda x: str(x.get("image", "")))
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
