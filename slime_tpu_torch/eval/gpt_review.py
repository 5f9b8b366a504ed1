"""GPT-judged review scorers (LLaVA-W / MM-Vet style).

Rebuilds llava/eval/eval_gpt_review{,_bench,_visual}.py + summarize_gpt_review.py:
pairwise answer grading by an OpenAI-compatible judge, rule-based prompts, and the
relative-score summary. The OpenAI client is injected/gated so the module imports
without network access or the openai package.

The port's own copy of ``slime_tpu/eval/gpt_review.py``, statement for statement.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

DEFAULT_JUDGE_SYSTEM = (
    "You are a helpful and precise assistant for checking the quality of the answer.")


def build_review_prompt(question: str, answer1: str, answer2: str, *,
                        rule_prompt: str, context: str = "") -> str:
    """Two-answer comparison prompt (eval_gpt_review_bench.py content layout)."""
    ctx = f"[Context]\n{context}\n\n" if context else ""
    return (f"{ctx}[Question]\n{question}\n\n"
            f"[Assistant 1]\n{answer1}\n\n[End of Assistant 1]\n\n"
            f"[Assistant 2]\n{answer2}\n\n[End of Assistant 2]\n\n"
            f"[System]\n{rule_prompt}\n\n")


def parse_score(review: str) -> List[float]:
    """First line 'x y' -> [x, y]; [-1, -1] on failure (reference parse_score)."""
    try:
        line = review.split("\n")[0].replace(",", " ")
        parts = line.split()
        if len(parts) == 2:
            return [float(parts[0]), float(parts[1])]
        return [-1.0, -1.0]
    except Exception:
        return [-1.0, -1.0]


def review_answers(questions: List[Dict], answers1: List[Dict],
                   answers2: List[Dict], *, judge_fn: Callable[[str, str], str],
                   rule_prompt: str, contexts: Optional[Dict] = None,
                   max_retries: int = 3) -> List[Dict]:
    """judge_fn(system, user) -> review text. Returns review records with scores."""
    out = []
    ctx = contexts or {}
    for q, a1, a2 in zip(questions, answers1, answers2):
        content = build_review_prompt(
            q.get("text", q.get("question", "")), a1["text"], a2["text"],
            rule_prompt=rule_prompt,
            context=ctx.get(str(q.get("question_id", "")), ""))
        review = ""
        for attempt in range(max_retries):
            try:
                review = judge_fn(DEFAULT_JUDGE_SYSTEM, content)
                break
            except Exception:
                time.sleep(2 ** attempt)
        out.append({
            "question_id": q.get("question_id"),
            "content": review,
            "tuple": parse_score(review),
            "category": q.get("category", "all"),
        })
    return out


def make_openai_judge(model: str = "gpt-4-0314", **client_kw) -> Callable:
    """OpenAI-compatible judge; import gated."""
    from openai import OpenAI  # noqa: PLC0415
    client = OpenAI(**client_kw)

    def judge(system: str, user: str) -> str:
        resp = client.chat.completions.create(
            model=model,
            messages=[{"role": "system", "content": system},
                      {"role": "user", "content": user}],
            temperature=0.2, max_tokens=1024)
        return resp.choices[0].message.content

    return judge


def summarize_reviews(reviews: List[Dict]) -> Dict[str, Dict]:
    """Per-category relative score (summarize_gpt_review.py): assistant2/assistant1
    ratio and mean scores, skipping failed parses."""
    by_cat = defaultdict(list)
    for r in reviews:
        s = r.get("tuple", [-1, -1])
        if s[0] >= 0 and s[1] >= 0:
            by_cat[r.get("category", "all")].append(s)
        by_cat["all"].append(s) if r.get("category", "all") != "all" else None
    out = {}
    for cat, scores in by_cat.items():
        valid = [s for s in scores if s[0] >= 0 and s[1] >= 0]
        if not valid:
            out[cat] = {"n": 0}
            continue
        m1 = sum(s[0] for s in valid) / len(valid)
        m2 = sum(s[1] for s in valid) / len(valid)
        out[cat] = {"score1": round(m1, 2), "score2": round(m2, 2),
                    "relative": round(100 * m2 / max(m1, 1e-9), 1),
                    "n": len(valid)}
    return out


def write_reviews(reviews: List[Dict], path: str) -> str:
    with open(path, "w") as f:
        for r in reviews:
            f.write(json.dumps(r) + "\n")
    return path


def generate_openai_answers(questions: List[Dict], *, judge_fn: Callable,
                            max_tokens: int = 1024, model_id: str = "openai",
                            max_retries: int = 3) -> List[Dict]:
    """Baseline answers from an OpenAI-compatible model (reference
    qa_baseline_gpt35.py:16-41): one answer row per question in the standard
    answers-jsonl schema, '#ERROR#' after exhausted retries. judge_fn is the
    same (system, user) -> text callable make_openai_judge returns."""
    import uuid

    out = []
    for q in questions:
        text = "#ERROR#"
        for attempt in range(max_retries):
            try:
                text = judge_fn("You are a helpful assistant.",
                                q.get("text", q.get("question", "")))
                break
            except Exception:
                time.sleep(2 ** attempt)
        out.append({"answer_id": uuid.uuid4().hex[:22],
                    "question_id": q.get("question_id"),
                    "model_id": model_id, "text": text,
                    "metadata": {}})
    return out
