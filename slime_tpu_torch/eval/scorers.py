"""Benchmark scorers: TextVQA (EvalAI/m4c protocol), POPE, ScienceQA, MME, ANLS.

Pure-Python ports of the reference scorer semantics (llava/eval/eval_textvqa.py,
m4c_evaluator.py, eval_pope.py, eval_science_qa.py, MME's calculation tool), reading
the same answers-jsonl the harness emits.

The port's own copy of ``slime_tpu/eval/scorers.py``, statement for statement.
"""
from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

# ----------------------------------------------------------------------------------
# EvalAI-style VQA answer normalization (m4c_evaluator.py:7-219 semantics)
# ----------------------------------------------------------------------------------

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whatre": "what're", "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll", "whyre": "why're",
    "whys": "why's", "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've", "yall": "y'all",
    "yall'll": "y'all'll", "y'allll": "y'all'll", "yall'd've": "y'all'd've",
    "y'alld've": "y'all'd've", "y'all'dve": "y'all'd've", "youd": "you'd",
    "youd've": "you'd've", "you'dve": "you'd've", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}
_NUMBER_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
               "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
               "nine": "9", "ten": "10"}
_ARTICLES = {"a", "an", "the"}
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
          ">", "<", "@", "`", ",", "?", "!"]


def _word_tokenize(s: str) -> str:
    s = s.lower().replace("\n", " ").replace("\t", " ").strip()
    return s


def _process_punctuation(s: str) -> str:
    out = s
    for p in _PUNCT:
        if (p + " " in s or " " + p in s) or (re.search(_COMMA_STRIP, s) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def _process_digit_article(s: str) -> str:
    out = []
    for word in s.lower().split():
        word = _NUMBER_MAP.get(word, word)
        if word not in _ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in _CONTRACTIONS:
            out[i] = _CONTRACTIONS[word]
    return " ".join(out)


def normalize_vqa_answer(ans: str) -> str:
    ans = _word_tokenize(ans)
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    ans = _process_punctuation(ans)
    ans = _process_digit_article(ans)
    return ans


def vqa_accuracy(pred: str, gts: Sequence[str]) -> float:
    """EvalAI soft accuracy: min(#matching human answers / 3, 1); leave-one-out
    averaging over the 10 annotators (m4c_evaluator.TextVQAAccuracyEvaluator)."""
    pred = normalize_vqa_answer(pred)
    gts = [normalize_vqa_answer(g) for g in gts]
    if len(gts) <= 1:
        return float(pred == gts[0]) if gts else 0.0
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        accs.append(min(1.0, sum(1 for o in others if o == pred) / 3.0))
    return sum(accs) / len(accs)


def score_textvqa(result_file: str, annotation_file: str,
                  prompt_prefix_strip: bool = True) -> Dict:
    """eval_textvqa.py:34-65: match question_id -> annotation answers."""
    with open(annotation_file) as f:
        ann = json.load(f)
    ann_list = ann["data"] if isinstance(ann, dict) and "data" in ann else ann
    gt = {str(a["question_id"]): a["answers"] for a in ann_list}
    preds = [json.loads(l) for l in open(result_file) if l.strip()]
    accs = []
    for p in preds:
        qid = str(p["question_id"])
        if qid not in gt:
            continue
        accs.append(vqa_accuracy(p["text"], gt[qid]))
    acc = 100.0 * sum(accs) / max(len(accs), 1)
    return {"accuracy": acc, "n": len(accs)}


# ----------------------------------------------------------------------------------
# POPE (eval_pope.py semantics)
# ----------------------------------------------------------------------------------

def _pope_to_binary(text: str) -> str:
    words = text.lower().replace(".", " ").replace(",", " ").split()
    if "no" in words or "not" in words:
        return "no"
    return "yes"


def score_pope(answers: List[Dict], labels: List[Dict]) -> Dict:
    """answers: [{question_id, text}]; labels: [{question_id, label(yes/no)}]."""
    lab = {str(l["question_id"]): l["label"].strip().lower() for l in labels}
    tp = tn = fp = fn = 0
    yes_cnt = 0
    n = 0
    for a in answers:
        qid = str(a["question_id"])
        if qid not in lab:
            continue
        pred = _pope_to_binary(a["text"])
        gt = lab[qid]
        n += 1
        yes_cnt += pred == "yes"
        if pred == "yes" and gt == "yes":
            tp += 1
        elif pred == "no" and gt == "no":
            tn += 1
        elif pred == "yes" and gt == "no":
            fp += 1
        else:
            fn += 1
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    acc = (tp + tn) / max(n, 1)
    return {"accuracy": 100 * acc, "precision": 100 * precision,
            "recall": 100 * recall, "f1": 100 * f1,
            "yes_ratio": yes_cnt / max(n, 1)}


# ----------------------------------------------------------------------------------
# ScienceQA (eval_science_qa.py semantics)
# ----------------------------------------------------------------------------------

def parse_multichoice(text: str, options: Sequence[str] = "ABCDE") -> Optional[str]:
    """Extract the predicted option letter (reference get_pred_idx behavior)."""
    text = text.strip()
    m = re.search(r"The answer is ([A-E])", text)
    if m:
        return m.group(1)
    if len(text) == 1 and text in options:
        return text
    m = re.match(r"^([A-E])[.):]", text)
    if m:
        return m.group(1)
    return None


def score_scienceqa(answers: List[Dict], gt: Dict[str, int]) -> Dict:
    """gt: question_id -> correct option index. Random fallback on parse failure is
    replaced by counting it wrong (deterministic)."""
    correct = total = 0
    for a in answers:
        qid = str(a["question_id"])
        if qid not in gt:
            continue
        total += 1
        letter = parse_multichoice(a["text"])
        if letter is not None and ord(letter) - ord("A") == gt[qid]:
            correct += 1
    return {"accuracy": 100.0 * correct / max(total, 1), "n": total}


# ----------------------------------------------------------------------------------
# MME (acc + acc+ protocol)
# ----------------------------------------------------------------------------------

def score_mme(rows: List[Dict]) -> Dict:
    """rows: [{category, question_id(image), text(pred), label(yes/no)}].
    Per-category score = accuracy + accuracy+ (both questions of an image right),
    each in percent; perception/cognition totals are sums over their categories."""
    by_cat = defaultdict(list)
    for r in rows:
        by_cat[r["category"]].append(r)
    out = {}
    for cat, items in by_cat.items():
        n_right = 0
        by_img = defaultdict(list)
        for r in items:
            pred = _pope_to_binary(r["text"])
            ok = pred == r["label"].strip().lower()
            n_right += ok
            by_img[r["question_id"]].append(ok)
        acc = 100.0 * n_right / max(len(items), 1)
        acc_plus = 100.0 * sum(1 for v in by_img.values() if all(v) and len(v) == 2) \
            / max(len(by_img), 1)
        out[cat] = acc + acc_plus
    return out


# ----------------------------------------------------------------------------------
# ANLS (ST-VQA / DocVQA; m4c_evaluator.py:260-334 semantics)
# ----------------------------------------------------------------------------------

def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(pred: str, gts: Sequence[str], tau: float = 0.5) -> float:
    best = 0.0
    for gt in gts:
        gt_n, pr_n = " ".join(gt.strip().lower().split()), \
            " ".join(pred.strip().lower().split())
        if not gt_n and not pr_n:
            best = max(best, 1.0)
            continue
        dist = _levenshtein(gt_n, pr_n)
        length = max(len(gt_n), len(pr_n))
        value = 0.0 if length == 0 else float(dist) / float(length)
        score = 1 - value if value < tau else 0.0
        best = max(best, score)
    return best


def score_anls(answers: List[Dict], gt: Dict[str, List[str]]) -> Dict:
    scores = [anls(a["text"], gt[str(a["question_id"])])
              for a in answers if str(a["question_id"]) in gt]
    return {"anls": 100.0 * sum(scores) / max(len(scores), 1), "n": len(scores)}


# ---------------------------------------------------------------------------
# ChartQA relaxed accuracy (reference model_vqa_chartqa.py:19-70; protocol from
# the ChartQA paper §5.1: numeric answers within 5% relative error count as
# correct, non-numeric need a case-insensitive exact match)
# ---------------------------------------------------------------------------

def _relaxed_float(text: str) -> Optional[float]:
    try:
        if text.endswith("%"):
            return float(text.rstrip("%")) / 100.0
        return float(text)
    except ValueError:
        return None


def relaxed_correctness(target: str, prediction: str,
                        max_relative_change: float = 0.05) -> bool:
    """True if prediction matches target within 5% relative tolerance (numeric)
    or exactly, case-insensitive (non-numeric). Argument order matches the
    reference's call site — the model answer is passed as `target`, so the
    relative change is normalized by the model's value — keeping scores
    bit-comparable with reference runs."""
    p, t = _relaxed_float(prediction), _relaxed_float(target)
    if p is not None and t:
        return abs(p - t) / abs(t) <= max_relative_change
    return prediction.lower() == target.lower()


def score_chartqa(entries: List[Dict]) -> Dict:
    """entries: [{'answer': model output, 'annotation': gold str or [str]}]
    (the ChartQA driver's output json). Relaxed accuracy, best over
    annotations (reference evaluate_relaxed_accuracy, model_vqa_chartqa.py:60-70)."""
    scores = []
    for e in entries:
        anns = e["annotation"]
        if isinstance(anns, str):
            anns = [anns]
        if not anns:  # empty annotation list scores 0 instead of aborting
            scores.append(False)
            continue
        scores.append(max(relaxed_correctness(e["answer"].strip(), a)
                          for a in anns))
    return {"relaxed_accuracy": sum(scores) / max(len(scores), 1),
            "n": len(scores)}


# ---------------------------------------------------------------------------
# ScienceQA vs GPT-4 comparison (reference eval_science_qa_gpt4.py:28-103):
# both sides parse "The answer is X.", unparsable GPT-4 answers fall back to
# the model's pick, and an agreement upper bound is reported alongside.
# ---------------------------------------------------------------------------

_SQA_ANSWER_RE = re.compile(r"The answer is ([A-Z]).")


def _sqa_pred_idx(letter: str, choices: Sequence, options: Sequence[str],
                  rng) -> int:
    if letter in options[:len(choices)]:
        return options.index(letter)
    return int(rng.integers(0, len(choices)))


def score_scienceqa_gpt4(our_answers: List[Dict], gpt4_answers: Dict[str, str],
                         problems: Dict[str, Dict],
                         split_indices: Sequence[str], *,
                         options: Sequence[str] = ("A", "B", "C", "D", "E"),
                         seed: int = 0) -> Dict:
    import numpy as np
    rng = np.random.default_rng(seed)
    ours = {str(a["question_id"]): a for a in our_answers}
    correct = incorrect = upper = gpt4_failed = 0
    for pid in split_indices:
        if pid not in ours or pid not in gpt4_answers:
            continue
        prob = problems[pid]
        m = _SQA_ANSWER_RE.findall(ours[pid]["text"])
        our_idx = _sqa_pred_idx(m[0] if len(m) == 1 else "FAILED",
                                prob["choices"], options, rng)
        m = _SQA_ANSWER_RE.findall(gpt4_answers[pid])
        gpt4_letter = m[0] if len(m) == 1 else "FAILED"
        if gpt4_letter == "FAILED":
            gpt4_failed += 1
            gpt4_idx = our_idx
        else:
            gpt4_idx = _sqa_pred_idx(gpt4_letter, prob["choices"], options, rng)
        if gpt4_idx == prob["answer"]:
            correct += 1
        else:
            incorrect += 1
        if gpt4_idx == prob["answer"] or our_idx == prob["answer"]:
            upper += 1
    total = max(correct + incorrect, 1)
    return {"total": correct + incorrect, "correct": correct,
            "accuracy": 100.0 * correct / total,
            "accuracy_upperbound": 100.0 * upper / total,
            "gpt4_failed": gpt4_failed}


def score_scienceqa_gpt4_requery(our_answers: List[Dict],
                                 requery_answers: List[Dict],
                                 gpt4_answers: Dict[str, str],
                                 problems: Dict[str, Dict],
                                 split_indices: Sequence[str], *,
                                 options: Sequence[str] = ("A", "B", "C", "D", "E"),
                                 seed: int = 0) -> Dict:
    """Requery ensemble (reference eval_science_qa_gpt4_requery.py:40-148):
    a second "requery" pass re-asks questions the model got wrong; per problem
    the requery answer wins when it parses, else the original answer stands.
    Returns the requery accuracy plus the reference's side stats (our/GPT-4
    accuracies, GPT-4 parse-failure rate, our+GPT-4 upper bound) and the
    per-problem chosen indices under 'results' (the sqa_results payload)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ours = {str(a["question_id"]): a for a in our_answers}
    requery = {str(a["question_id"]): a for a in requery_answers}
    stats = {"total": 0, "our_correct": 0, "gpt4_correct": 0,
             "gpt4_failed": 0, "gpt4_ourvisual_correct": 0,
             "requery_correct": 0, "correct_upperbound": 0,
             "missing_requery": 0}
    chosen: Dict[str, int] = {}
    for pid in split_indices:
        if pid not in ours or pid not in gpt4_answers:
            continue
        prob = problems[pid]

        def parse(text: str) -> str:
            m = _SQA_ANSWER_RE.findall(text)
            return m[0] if len(m) == 1 else "FAILED"

        our_letter = parse(ours[pid]["text"])
        if pid in requery:
            requery_letter = parse(requery[pid]["text"])
        else:
            stats["missing_requery"] += 1
            requery_letter = "FAILED"
        gpt4_letter = parse(gpt4_answers[pid])

        our_idx = _sqa_pred_idx(our_letter, prob["choices"], options, rng)
        gpt4_idx = _sqa_pred_idx(gpt4_letter, prob["choices"], options, rng)
        requery_idx = _sqa_pred_idx(requery_letter, prob["choices"], options, rng)

        stats["total"] += 1
        if gpt4_letter == "FAILED":
            stats["gpt4_failed"] += 1
            if gpt4_idx == prob["answer"]:
                stats["gpt4_correct"] += 1
            if our_idx == prob["answer"]:
                stats["gpt4_ourvisual_correct"] += 1
        elif gpt4_idx == prob["answer"]:
            stats["gpt4_correct"] += 1
            stats["gpt4_ourvisual_correct"] += 1
        if our_idx == prob["answer"]:
            stats["our_correct"] += 1
        pick = our_idx if requery_letter == "FAILED" else requery_idx
        chosen[pid] = pick
        if pick == prob["answer"]:
            stats["requery_correct"] += 1
        if gpt4_idx == prob["answer"] or our_idx == prob["answer"]:
            stats["correct_upperbound"] += 1
    total = max(stats["total"], 1)
    return {"acc": 100.0 * stats["requery_correct"] / total,
            "correct": stats["requery_correct"], "count": stats["total"],
            "results": chosen,
            "our_accuracy": 100.0 * stats["our_correct"] / total,
            "gpt4_accuracy": 100.0 * stats["gpt4_correct"] / total,
            "gpt4_failed": stats["gpt4_failed"],
            "gpt4_ourvisual_accuracy": 100.0 * stats["gpt4_ourvisual_correct"] / total,
            "accuracy_upperbound": 100.0 * stats["correct_upperbound"] / total,
            "missing_requery": stats["missing_requery"]}
