"""MMHal-Bench judging command line: the port's ``scripts/eval_mmhal.py``
(reference eval_gpt_mmhal.py + summarize_gpt_mmhal.py). It runs no model.

Two modes:
  judge:     --response responses.json [--evaluation reviews.json] --api-key ...
             grades every response with an OpenAI-compatible judge and prints the
             average score / hallucination rate / per-type breakdown
  summarize: --evaluation reviews.json
             re-summarizes previously saved reviews without calling the judge

    python -m slime_tpu_torch.eval.mmhal_cli summarize --evaluation reviews.json
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from . import mmhal


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["judge", "summarize"])
    ap.add_argument("--response", help="run_mmhal output json (records with "
                                       "model_answer)")
    ap.add_argument("--evaluation", help="reviews json to write (judge) or "
                                         "read (summarize)")
    ap.add_argument("--api-key", default=os.environ.get("OPENAI_API_KEY"))
    ap.add_argument("--base-url", default=None)
    ap.add_argument("--gpt-model", default="gpt-4-0314")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.mode == "summarize":
        with open(args.evaluation) as f:
            reviews = json.load(f)
        print(json.dumps(mmhal.summarize(reviews), indent=2))
        return

    from .gpt_review import make_openai_judge
    kw = {"api_key": args.api_key}
    if args.base_url:
        kw["base_url"] = args.base_url
    judge = make_openai_judge(model=args.gpt_model, **kw)
    with open(args.response) as f:
        records = json.load(f)
    reviews = mmhal.judge_responses(records, judge, sleep=1.0)
    if args.evaluation:
        mmhal.write_reviews(reviews, args.evaluation)
    print(json.dumps(mmhal.summarize(reviews), indent=2))


if __name__ == "__main__":
    main()
