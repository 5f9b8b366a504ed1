"""Convert ScienceQA releases into LLaVA/SliME training-format JSON.

The port's ``scripts/convert_sqa_to_llava.py`` (reference
scripts/convert_sqa_to_llava.py record semantics: strip the
'Question: '/'Answer: ' prefixes, append '\\n<image>' for image problems) on
the port's own copy of the CoT prompt permutation engine
(``eval/sqa_prompt.py``). Every reference format (QCM-A ... QCLEM-ELA,
QCM-LEPA for the jsonl variant); the files are the JAX script's:

    python -m slime_tpu_torch.tools.convert_sqa_to_llava --base-dir SQA --split train
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from ..eval import sqa_prompt


def _load(base_dir, split):
    with open(os.path.join(base_dir, "pid_splits.json")) as f:
        pids = json.load(f)[split]
    with open(os.path.join(base_dir, "problems.json")) as f:
        problems = json.load(f)
    return pids, problems


def convert_to_llava(base_dir, split, prompt_format, output=None):
    pids, problems = _load(base_dir, split)
    pairs = sqa_prompt.build_prompt_chatbot(problems, pids, prompt_format,
                                            use_caption=False, is_test=False)
    out = []
    for pid, (inp, ans) in pairs.items():
        if inp.startswith("Question: "):
            inp = inp.replace("Question: ", "")
        if ans.startswith("Answer: "):
            ans = ans.replace("Answer: ", "")
        rec = {"id": pid,
               "conversations": [{"from": "human", "value": inp},
                                 {"from": "gpt", "value": ans}]}
        img = problems[pid].get("image")
        if img:
            rec["image"] = os.path.join(pid, img)
            rec["conversations"][0]["value"] = f"{inp}\n<image>"
        out.append(rec)

    dst = output or os.path.join(base_dir, f"llava_{split}_{prompt_format}.json")
    with open(dst, "w") as f:
        json.dump(out, f, indent=2)
    print(f"{len(out)} records -> {dst}")
    return dst


def convert_to_jsonl(base_dir, split, prompt_format="QCM-LEPA", output=None):
    """The base-prompt jsonl variant (reference convert_to_jsonl): one
    {"id", "instruction", "output"} line per problem."""
    pids, problems = _load(base_dir, split)
    pairs = sqa_prompt.build_prompt_chatbot(problems, pids, prompt_format,
                                            use_caption=False, is_test=False)
    dst = output or os.path.join(base_dir, f"scienceqa_{split}_{prompt_format}.jsonl")
    with open(dst, "w") as f:
        for pid, (inp, ans) in pairs.items():
            f.write(json.dumps({"id": pid, "instruction": inp,
                                "output": ans}) + "\n")
    print(f"{len(pairs)} records -> {dst}")
    return dst


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-dir", required=True,
                    help="dir containing problems.json and pid_splits.json")
    ap.add_argument("--split", default="train")
    ap.add_argument("--output", default=None)
    ap.add_argument("--prompt-format", default="QCM-LEA",
                    help="input-output format, e.g. QCM-A, QCM-LEA, QCM-LEPA "
                         "(any combination from eval/sqa_prompt.py)")
    ap.add_argument("--jsonl", action="store_true",
                    help="emit the base-prompt jsonl variant instead")
    args = ap.parse_args(argv)
    if args.jsonl:
        return convert_to_jsonl(args.base_dir, args.split, args.prompt_format, args.output)
    return convert_to_llava(args.base_dir, args.split, args.prompt_format, args.output)


if __name__ == "__main__":
    main()
