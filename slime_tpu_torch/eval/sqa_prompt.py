"""ScienceQA CoT prompt permutations (reference
scripts/convert_sqa_to_llava_base_prompt.py:1-334, which triplicates one
formatter across plain / chatbot / gpt4 emitters; here it is one table-driven
builder covering every input format (CQM, QCM, QCML, QCME, QCMLE, QCLM, QCEM,
QCLEM) and output format (A, AL, AE, ALE, AEL, LA, EA, LEA, ELA, LEPA), with
the reference's quirks preserved: caption folded into context with an "N/A"
default, lecture/solution newline-escaping for GPT-3, double-space cleanup,
and trailing-"BECAUSE:" stripping. Note the reference's own AL/AE swap
(AL emits the solution, AE emits the lecture) is kept as-is for parity.

The port's own copy of ``slime_tpu/eval/sqa_prompt.py``, statement for statement.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

OPTIONS = ("A", "B", "C", "D", "E")

INPUT_FORMATS = ("CQM", "QCM", "QCML", "QCME", "QCMLE", "QCLM", "QCEM", "QCLEM")
OUTPUT_FORMATS = ("A", "AL", "AE", "ALE", "AEL", "LA", "EA", "LEA", "ELA", "LEPA")


def _fields(problem: Dict, *, use_caption: bool = False,
            options: Sequence[str] = OPTIONS, escape_newlines: bool = True):
    context = " ".join([problem.get("hint") or "",
                        (problem.get("caption") or "") if use_caption else ""]
                       ).strip() or "N/A"
    choice = " ".join(f"({options[i]}) {c}"
                      for i, c in enumerate(problem["choices"]))
    lecture = problem.get("lecture") or ""
    solution = problem.get("solution") or ""
    if escape_newlines:  # GPT-3 generates more tokens with literal \n
        lecture = lecture.replace("\n", "\\n")
        solution = solution.replace("\n", "\\n")
    return {"question": problem["question"], "context": context,
            "choice": choice, "answer": options[problem["answer"]],
            "lecture": lecture, "solution": solution}


def _input_text(fmt: str, f: Dict) -> str:
    q, c, m = f["question"], f["context"], f["choice"]
    l, e = f["lecture"], f["solution"]
    table = {
        "CQM": f"Context: {c}\nQuestion: {q}\nOptions: {m}\n",
        "QCM": f"Question: {q}\nContext: {c}\nOptions: {m}\n",
        "QCML": f"Question: {q}\nContext: {c}\nOptions: {m}\nBECAUSE: {l}\n",
        "QCME": f"Question: {q}\nContext: {c}\nOptions: {m}\nBECAUSE: {e}\n",
        "QCMLE": f"Question: {q}\nContext: {c}\nOptions: {m}\nBECAUSE: {l} {e}\n",
        "QCLM": f"Question: {q}\nContext: {c}\nBECAUSE: {l}\nOptions: {m}\n",
        "QCEM": f"Question: {q}\nContext: {c}\nBECAUSE: {e}\nOptions: {m}\n",
        "QCLEM": f"Question: {q}\nContext: {c}\nBECAUSE: {l} {e}\nOptions: {m}\n",
    }
    return table[fmt]


def _output_text(fmt: str, f: Dict, *, test_example: bool) -> str:
    if test_example:
        return "Answer:"
    a, l, e = f["answer"], f["lecture"], f["solution"]
    table = {
        "A": f"Answer: The answer is {a}.",
        # reference swaps these two (AL -> solution, AE -> lecture); kept
        "AL": f"Answer: The answer is {a}. BECAUSE: {e}",
        "AE": f"Answer: The answer is {a}. BECAUSE: {l}",
        "ALE": f"Answer: The answer is {a}. BECAUSE: {l} {e}",
        "AEL": f"Answer: The answer is {a}. BECAUSE: {e} {l}",
        "LA": f"Answer: {l} The answer is {a}.",
        "EA": f"Answer: {e} The answer is {a}.",
        "LEA": f"Answer: {l} {e} The answer is {a}.",
        "ELA": f"Answer: {e} {l} The answer is {a}.",
    }
    if fmt == "LEPA":
        out = ""
        if l.strip():
            out += f"LECTURE: {l}\n"
        if e.strip():
            out += f"SOLUTION: {e}\n"
        return out + "###\n" + f"ANSWER: {a}."
    return table[fmt]


def _clean(s: str) -> str:
    s = s.replace("  ", " ").strip()
    if s.endswith("BECAUSE:"):
        s = s.replace("BECAUSE:", "").strip()
    return s


def one_example(prompt_format: str, problem: Dict, *,
                style: str = "plain", test_example: bool = False,
                use_caption: bool = False,
                options: Sequence[str] = OPTIONS):
    """One formatted example.

    style="plain"   -> a single string (input+output concatenated;
                       reference create_one_example)
    style="chatbot" -> (input, output) pair (create_one_example_chatbot)
    style="gpt4"    -> (user_msg, assistant_msg) role dicts
                       (create_one_example_gpt4)
    """
    in_fmt, out_fmt = prompt_format.split("-")
    # the chatbot path un-escapes right after escaping (reference :229-230),
    # so it effectively formats with raw newlines
    f = _fields(problem, use_caption=use_caption, options=options,
                escape_newlines=(style != "chatbot"))
    inp = _input_text(in_fmt, f)
    out = _output_text(out_fmt, f, test_example=test_example)
    if style == "plain":
        return _clean(inp + out)
    inp, out = _clean(inp), _clean(out)
    if style == "chatbot":
        return inp, out
    if style == "gpt4":
        return ({"role": "user", "content": f"Can you explain {inp}?"},
                {"role": "assistant", "content": out})
    raise ValueError(style)


def build_prompt(problems: Dict, shot_qids: Sequence[str], test_qid: str,
                 prompt_format: str, *, use_caption: bool = False,
                 options: Sequence[str] = OPTIONS) -> str:
    """n-shot plain prompt: shot examples with answers + the test example
    ending in 'Answer:' (reference build_prompt:244-288)."""
    parts = [one_example(prompt_format, problems[q], style="plain",
                         test_example=False, use_caption=use_caption,
                         options=options) for q in shot_qids]
    parts.append(one_example(prompt_format, problems[test_qid], style="plain",
                             test_example=True, use_caption=use_caption,
                             options=options))
    return "\n\n".join(parts)


def build_prompt_chatbot(problems: Dict, shot_qids: Sequence[str],
                         prompt_format: str, *, use_caption: bool = False,
                         options: Sequence[str] = OPTIONS,
                         is_test: bool = False) -> Dict[str, Tuple[str, str]]:
    """qid -> (input, output) pairs (reference build_prompt_chatbot:221-241,
    the entry the LLaVA data converter uses)."""
    return {q: one_example(prompt_format, problems[q], style="chatbot",
                           test_example=is_test, use_caption=use_caption,
                           options=options)
            for q in shot_qids}


def build_prompt_gpt4(problems: Dict, shot_qids: Sequence[str], test_qid: str,
                      prompt_format: str, *, use_caption: bool = False,
                      options: Sequence[str] = OPTIONS) -> List[Dict]:
    """OpenAI chat message array (reference build_prompt_gpt4:291-334)."""
    msgs = [{"role": "system", "content": "You are a helpful assistant."}]
    for q in list(shot_qids) + [test_qid]:
        u, a = one_example(prompt_format, problems[q], style="gpt4",
                           test_example=(q == test_qid),
                           use_caption=use_caption, options=options)
        msgs += [u, a]
    return msgs
