"""MMHal-Bench GPT judging: hallucination rate + per-question-type scores.

Rebuilds the reference's MMHal protocol (llava/eval/eval_gpt_mmhal.py:76-154 and
summarize_gpt_mmhal.py): each of the 96 responses is graded by an LLM judge on a
fixed 0-6 rubric, a unique "Rating: N" is parsed from the review, scores < 3
count as hallucinations, and per-question-type averages assume the benchmark's
fixed ordering (type = index % 8).

JUDGE_TEMPLATE loads from mmhal_rubric.txt — the fixed MMHal-Bench judging
rubric (protocol constant from the MMHal-Bench release, mirrored at
eval_gpt_mmhal.py:6-74). Altering its wording would change grades and break
comparability, so it is kept verbatim, as data.
The judge itself is injected (any ``judge_fn(system, user) -> str``, e.g.
``gpt_review.make_openai_judge``) so this module works offline and with any
OpenAI-compatible endpoint.

The port's own copy of ``slime_tpu/eval/mmhal.py``, statement for statement.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Sequence

_RUBRIC_PATH = os.path.join(os.path.dirname(__file__), "mmhal_rubric.txt")
with open(_RUBRIC_PATH) as _f:
    JUDGE_TEMPLATE = _f.read()

N_QUESTION_TYPES = 8  # MMHal's 96 questions cycle through 8 types in order


def build_judge_prompt(record: Dict) -> str:
    """Fill the rubric with one MMHal record (image_content list, question,
    gt_answer, model_answer — the run_mmhal output format)."""
    return JUDGE_TEMPLATE.format(", ".join(record["image_content"]),
                                 record["question"], record["gt_answer"],
                                 record["model_answer"])


def parse_rating(review: str) -> Optional[int]:
    """Extract the unique 'Rating: N' (N in 0..6); None when zero or multiple
    distinct ratings appear (reference eval_gpt_mmhal.py:126-137 treats that as
    a warning and scores 0)."""
    found = sorted(set(int(m) for m in re.findall(r"rating:\s*([0-6])",
                                                  review.lower())))
    return found[0] if len(found) == 1 else None


def judge_responses(records: List[Dict], judge_fn: Callable[[str, str], str], *,
                    max_retries: int = 3, sleep: float = 0.0) -> List[Dict]:
    """Grade every record; returns [{'question_id', 'review', 'rating'}]."""
    out = []
    for i, rec in enumerate(records):
        prompt = build_judge_prompt(rec)
        review = ""
        for attempt in range(max_retries):
            try:
                review = judge_fn("", prompt)
                break
            except Exception:
                time.sleep(2 ** attempt)
        out.append({"question_id": rec.get("question_id", i),
                    "review": review, "rating": parse_rating(review)})
        if sleep:
            time.sleep(sleep)
    return out


def summarize(reviews: Sequence[Dict]) -> Dict:
    """Average score, hallucination rate (rating < 3), and per-question-type
    averages assuming the benchmark's fixed ordering (summarize_gpt_mmhal.py:12-42;
    unparsable reviews score 0, matching the reference)."""
    scores = [r["rating"] if r.get("rating") is not None else 0 for r in reviews]
    halluc = [1 if s < 3 else 0 for s in scores]
    by_type: List[List[int]] = [[] for _ in range(N_QUESTION_TYPES)]
    for i, s in enumerate(scores):
        by_type[i % N_QUESTION_TYPES].append(s)
    return {
        "average_score": sum(scores) / max(len(scores), 1),
        "hallucination_rate": sum(halluc) / max(len(halluc), 1),
        "score_per_type": [round(sum(t) / len(t), 2) if t else None
                           for t in by_type],
        "n": len(scores),
    }


def write_reviews(reviews: List[Dict], path: str) -> str:
    with open(path, "w") as f:
        json.dump(reviews, f, indent=2)
    return path
