"""Static HTML visualizer for eval answers and GPT reviews.

Equivalent of the reference's llava/eval/webpage/ static viewer: one self-contained
HTML file per run — question, both assistants' answers, judge scores — no server
needed.

The port's own copy of ``slime_tpu/eval/webpage.py``, statement for statement.
"""
from __future__ import annotations

import html
import json
from typing import Dict, List, Optional

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 72rem; }}
table {{ border-collapse: collapse; width: 100%; }}
td, th {{ border: 1px solid #ccc; padding: .5rem .75rem; vertical-align: top; }}
th {{ background: #f3f4f6; text-align: left; }}
.score {{ font-weight: 600; white-space: nowrap; }}
.q {{ background: #fafafa; }}
</style></head><body>
<h1>{title}</h1>
<p>{summary}</p>
<table>
<tr><th>#</th><th>Question</th><th>Assistant 1</th><th>Assistant 2</th><th>Scores</th></tr>
{rows}
</table></body></html>
"""


def render_review_page(questions: List[Dict], answers1: List[Dict],
                       answers2: List[Dict], reviews: Optional[List[Dict]] = None,
                       *, title: str = "SliME-TPU eval review",
                       summary: str = "") -> str:
    rows = []
    reviews = reviews or [{}] * len(questions)
    for i, (q, a1, a2, r) in enumerate(zip(questions, answers1, answers2, reviews)):
        score = r.get("tuple")
        score_txt = f"{score[0]:g} / {score[1]:g}" if score else "—"
        rows.append(
            "<tr><td>{}</td><td class=q>{}</td><td>{}</td><td>{}</td>"
            "<td class=score>{}</td></tr>".format(
                i + 1,
                html.escape(str(q.get("text", q.get("question", "")))),
                html.escape(str(a1.get("text", ""))),
                html.escape(str(a2.get("text", ""))),
                score_txt))
    return _PAGE.format(title=html.escape(title), summary=html.escape(summary),
                        rows="\n".join(rows))


def write_review_page(path: str, questions, answers1, answers2,
                      reviews=None, **kw) -> str:
    with open(path, "w") as f:
        f.write(render_review_page(questions, answers1, answers2, reviews, **kw))
    return path


def render_answers_page(answers_file: str, *, title: str = "answers") -> str:
    """Single-model view of an answers jsonl."""
    rows = []
    for i, line in enumerate(open(answers_file)):
        r = json.loads(line)
        rows.append(
            "<tr><td>{}</td><td class=q>{}</td><td colspan=2>{}</td><td>—</td></tr>"
            .format(i + 1, html.escape(str(r.get("prompt", r.get("question_id")))),
                    html.escape(str(r.get("text", "")))))
    return _PAGE.format(title=html.escape(title), summary="", rows="\n".join(rows))
