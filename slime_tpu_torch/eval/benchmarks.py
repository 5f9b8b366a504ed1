"""Benchmark-specific drivers and submission converters.

Port of ``slime_tpu/eval/benchmarks.py``, which covers the reference's
per-benchmark drivers beyond the generic loader (SURVEY.md §2.29/§2.33):
MMBench TSV with option permutation (llava/eval/model_vqa_mmbench.py),
ScienceQA with CoT/option prompts (model_vqa_science.py), ChartQA, MMHal and
AMBER through the batched harness, and the submission converters
(scripts/convert_{gqa,vqav2,mmvet,seed,vizwiz,mmbench}_for_*.py). The files
written are the JAX package's; the model runs on its parameters' device.
"""
from __future__ import annotations

import base64
import io
import json
import os
from typing import Dict, List, Optional, Sequence

import torch

from .. import conversation as conv_lib
from ..config import SliMEConfig
from ..constants import DEFAULT_IMAGE_TOKEN
from ..data.image_ops import process_anyres_image_host
from ..data.tokenization import tokenizer_image_token

ALL_OPTIONS = ["A", "B", "C", "D"]


# ----------------------------------------------------------------------------------
# MMBench (TSV rows with base64 images and up to 4 options; circular evaluation
# permutes options per round — model_vqa_mmbench.py semantics)
# ----------------------------------------------------------------------------------

def load_mmbench_tsv(path: str) -> List[Dict]:
    import csv
    rows = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            rows.append(row)
    return rows


def get_options(row: Dict, options: Sequence[str] = ALL_OPTIONS) -> List[str]:
    out = []
    for o in options:
        v = row.get(o)
        if v is None or v != v or v == "nan" or v == "":
            break
        out.append(v)
    return out


def mmbench_prompt(question: str, options: List[str], *, hint: Optional[str],
                   conv_mode: str, single_pred: bool = True,
                   lang: str = "en") -> str:
    if hint and hint == hint and str(hint) != "nan":
        question = hint + "\n" + question
    for i, opt in enumerate(options):
        question += f"\n{ALL_OPTIONS[i]}. {opt}"
    qs = DEFAULT_IMAGE_TOKEN + "\n" + question
    if single_pred:
        qs += ("\n请直接回答选项字母。" if lang == "cn"
               else "\nAnswer with the option's letter from the given choices directly.")
    conv = conv_lib.conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def run_mmbench(params, cfg: SliMEConfig, tokenizer, tsv_path: str, *,
                answers_file: str, conv_mode: str, all_rounds: bool = False,
                max_new_tokens: int = 16, lang: str = "en",
                compute_dtype=None, batch_limit: Optional[int] = None) -> str:
    """MMBench answers jsonl: one greedy answer a row, or with ``all_rounds``
    one a rotation of its options (circular evaluation)."""
    from PIL import Image

    from ..generate import generate
    from .harness import decode_row, padded_batch, params_device

    if compute_dtype is None:
        compute_dtype = torch.bfloat16
    dev = params_device(params)
    rows = load_mmbench_tsv(tsv_path)
    if batch_limit:
        rows = rows[:batch_limit]
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    MC = 1 + cfg.max_local_crops
    with open(answers_file, "w") as out:
        for row in rows:
            options = get_options(row)
            n_rounds = len(options) if all_rounds else 1
            cur = list(options)
            img = Image.open(io.BytesIO(base64.b64decode(row["image"])))
            crops, mask, _ = process_anyres_image_host(
                img, tile=cfg.vision.image_size, max_crops=MC)
            pixels = torch.from_numpy(crops[None]).to(dev)
            crop_mask = torch.from_numpy(mask[None]).to(dev)
            for r in range(n_rounds):
                prompt = mmbench_prompt(row["question"], cur,
                                        hint=row.get("hint"),
                                        conv_mode=conv_mode, lang=lang)
                ids = tokenizer_image_token(prompt, tokenizer, return_tensors="np")
                # the JAX package's bucket: a multiple of 64 positions
                input_ids, attn = padded_batch([ids], 1, ((len(ids) + 63) // 64) * 64, dev)
                toks = generate(params, cfg, input_ids, attn, pixels, crop_mask,
                                max_new_tokens=max_new_tokens, temperature=0.0,
                                compute_dtype=compute_dtype)
                out.write(json.dumps({
                    "question_id": row.get("index"),
                    "round_id": r,
                    "prompt": row["question"],
                    "text": decode_row(tokenizer, toks, 0, cfg.eos_token_id),
                    "options": cur,
                    "option_char": ALL_OPTIONS[:len(cur)],
                    "answer_id": "",
                    "model_id": "slime-tpu",
                    "metadata": {},
                }) + "\n")
                cur = cur[1:] + cur[:1]  # rotate options for circular eval
    return answers_file


# ----------------------------------------------------------------------------------
# ScienceQA prompt construction (model_vqa_science.py + convert_sqa_to_llava
# base-prompt semantics, condensed: context + choices + answer request)
# ----------------------------------------------------------------------------------

def scienceqa_prompt(problem: Dict, *, conv_mode: str,
                     single_pred: bool = True) -> str:
    ctx = ""
    if problem.get("hint"):
        ctx = f"Context: {problem['hint']}\n"
    choices = problem.get("choices", [])
    opts = "".join(f"({ALL_OPTIONS[i] if i < 4 else chr(65 + i)}) {c} "
                   for i, c in enumerate(choices))
    qs = f"{ctx}Question: {problem['question']}\nOptions: {opts}"
    if problem.get("image"):
        qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
    if single_pred:
        qs += "\nAnswer with the option's letter from the given choices directly."
    conv = conv_lib.conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


# ----------------------------------------------------------------------------------
# Submission converters (scripts/convert_*.py semantics)
# ----------------------------------------------------------------------------------

def convert_gqa(answers_file: str, dst: str) -> str:
    """answers jsonl -> GQA testdev 'predictions' json
    (scripts/convert_gqa_for_eval.py)."""
    preds = []
    for line in open(answers_file):
        r = json.loads(line)
        preds.append({"questionId": str(r["question_id"]),
                      "prediction": r["text"].strip().lower()})
    with open(dst, "w") as f:
        json.dump(preds, f)
    return dst


def convert_vqav2(answers_file: str, dst: str) -> str:
    """answers jsonl -> VQAv2 server submission json
    (scripts/convert_vqav2_for_submission.py)."""
    out = []
    for line in open(answers_file):
        r = json.loads(line)
        out.append({"question_id": int(r["question_id"]),
                    "answer": r["text"].strip()})
    with open(dst, "w") as f:
        json.dump(out, f)
    return dst


def convert_mmvet(answers_file: str, dst: str) -> str:
    """answers jsonl -> MM-Vet {qid: answer} json (scripts/convert_mmvet_for_eval.py)."""
    out = {}
    for line in open(answers_file):
        r = json.loads(line)
        out[f"v1_{r['question_id']}"] = r["text"].strip()
    with open(dst, "w") as f:
        json.dump(out, f, indent=2)
    return dst


def convert_vizwiz(answers_file: str, annotation_file: str, dst: str) -> str:
    """answers jsonl + test annotation -> VizWiz submission
    (scripts/convert_vizwiz_for_submission.py)."""
    with open(annotation_file) as f:
        ann = json.load(f)
    answers = {json.loads(l)["question_id"]: json.loads(l)["text"]
               for l in open(answers_file)}
    out = []
    for q in ann:
        qid = q.get("question_id", q.get("image"))
        out.append({"image": q["image"], "answer": answers.get(qid, "").strip()})
    with open(dst, "w") as f:
        json.dump(out, f)
    return dst


def convert_seed(answers_file: str, dst: str) -> str:
    """answers jsonl -> SEED-Bench submission (scripts/convert_seed_for_submission.py)."""
    out = []
    for line in open(answers_file):
        r = json.loads(line)
        out.append({"question_id": r["question_id"],
                    "prediction": r["text"].strip()})
    with open(dst, "w") as f:
        json.dump(out, f)
    return dst


# Columns the reference drops before upload (convert_mmbench_for_submission.py:21).
_MMBENCH_DROP = ("hint", "category", "source", "image", "comment", "l2-category")


def mmbench_to_submission(answers_file: str, tsv_path: str, dst_xlsx: str) -> str:
    """Map raw predictions back onto the MMBench sheet and write the eval
    server's xlsx upload (scripts/convert_mmbench_for_submission.py:15-27):
    all tsv columns minus the drop set, 'prediction' inserted at position 6,
    prediction = the model's raw text keyed by index. Written with the stdlib
    zip/XML writer in eval/xlsx.py (no pandas/openpyxl in this environment).

    Legacy: a dst ending in .json emits the round-2 json artifact instead.
    """
    rows = load_mmbench_tsv(tsv_path)
    preds: Dict[str, str] = {}
    for line in open(answers_file):
        r = json.loads(line)
        if r.get("round_id", 0) == 0:
            preds[str(r["question_id"])] = r["text"]

    if dst_xlsx.endswith(".json"):
        from .scorers import parse_multichoice
        out = [{"index": row.get("index"), "question": row.get("question"),
                "A": row.get("A"), "B": row.get("B"), "C": row.get("C"),
                "D": row.get("D"),
                "prediction": parse_multichoice(preds.get(str(row.get("index")), "")) or ""}
               for row in rows]
        with open(dst_xlsx, "w") as f:
            json.dump(out, f)
        return dst_xlsx

    from .xlsx import write_xlsx
    src_cols = list(rows[0].keys()) if rows else ["index", "question", "A", "B", "C", "D"]
    cols = [c for c in src_cols if c not in _MMBENCH_DROP]
    cols.insert(min(6, len(cols)), "prediction")

    def cell(row: Dict, col: str):
        if col == "prediction":
            return preds.get(str(row.get("index")), None)
        v = row.get(col)
        if col == "index" and v is not None:  # server matches numerically
            try:
                return int(v)
            except ValueError:
                return v
        return v

    return write_xlsx(dst_xlsx, cols, [[cell(row, c) for c in cols] for row in rows])


# ----------------------------------------------------------------------------------
# ChartQA / MMHal / AMBER drivers. Generation goes through the batched harness
# (harness.run_eval — the reference runs bs=1 dataloaders); each driver then
# emits the reference's exact output format so downstream scorers/judges are
# interchangeable.
# ----------------------------------------------------------------------------------

def run_chartqa(params, cfg: SliMEConfig, tokenizer, questions: List[Dict], *,
                image_folder: str, answers_file: str, conv_mode: str,
                batch_size: int = 4, max_new_tokens: int = 100,
                seq_len: int = 0, compute_dtype=None) -> Dict:
    """ChartQA driver (reference model_vqa_chartqa.py:135-186): questions are
    jsonl rows with image/question/answer; output is a json ARRAY of
    {'answer', 'annotation'} pairs and the relaxed accuracy is returned."""
    from . import harness
    from .scorers import score_chartqa

    tmp = answers_file + ".raw.jsonl"
    harness.run_eval(params, cfg, tokenizer, questions,
                     image_folder=image_folder, answers_file=tmp,
                     conv_mode=conv_mode, batch_size=batch_size,
                     max_new_tokens=max_new_tokens, question_key="question",
                     seq_len=seq_len,
                     single_pred_prompt=True, compute_dtype=compute_dtype)
    outputs = []
    with open(tmp) as f:
        for q, line in zip(questions, f):
            outputs.append({"answer": json.loads(line)["text"],
                            "annotation": q["answer"]})
    with open(answers_file, "w") as f:
        json.dump(outputs, f, ensure_ascii=False)
    os.remove(tmp)
    return score_chartqa(outputs)


def run_mmhal(params, cfg: SliMEConfig, tokenizer, records: List[Dict], *,
              answers_file: str, conv_mode: str, image_folder: str = "",
              batch_size: int = 2, max_new_tokens: int = 1024,
              seq_len: int = 0, compute_dtype=None) -> str:
    """MMHal-Bench response driver (reference model_vqa_mmhal.py:40-95):
    records carry question/image_path/image_content/gt_answer; each gains a
    'model_answer' field and the whole record list is dumped as json for the
    GPT judge (eval/mmhal.py)."""
    from . import harness

    tmp = answers_file + ".raw.jsonl"
    harness.run_eval(params, cfg, tokenizer, records, image_folder=image_folder,
                     answers_file=tmp, conv_mode=conv_mode,
                     batch_size=batch_size, max_new_tokens=max_new_tokens,
                     question_key="question", image_key="image_path",
                     seq_len=seq_len, compute_dtype=compute_dtype)
    out = []
    with open(tmp) as f:
        for rec, line in zip(records, f):
            rec = dict(rec)
            rec["model_answer"] = json.loads(line)["text"]
            out.append(rec)
    with open(answers_file, "w") as f:
        json.dump(out, f, indent=2)
    os.remove(tmp)
    return answers_file


def run_amber(params, cfg: SliMEConfig, tokenizer, questions: List[Dict], *,
              image_folder: str, answers_file: str, conv_mode: str,
              batch_size: int = 4, max_new_tokens: int = 128,
              seq_len: int = 0, compute_dtype=None) -> str:
    """AMBER driver (reference model_vqa_amber.py:83-132): questions are a json
    array with id/image/query; answers jsonl rows carry the capitalized
    response in the AMBER evaluator's expected format."""
    from . import harness

    tmp = answers_file + ".raw.jsonl"
    harness.run_eval(params, cfg, tokenizer, questions,
                     image_folder=image_folder, answers_file=tmp,
                     conv_mode=conv_mode, batch_size=batch_size,
                     max_new_tokens=max_new_tokens, question_key="query",
                     seq_len=seq_len, compute_dtype=compute_dtype)
    with open(tmp) as f, open(answers_file, "w") as out:
        for q, line in zip(questions, f):
            r = json.loads(line)
            out.write(json.dumps({"id": q["id"], "prompt": q["query"],
                                  "response": r["text"].capitalize(),
                                  "model_id": r["model_id"],
                                  "metadata": {}}) + "\n")
    os.remove(tmp)
    return answers_file
