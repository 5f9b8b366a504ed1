"""The evaluation command line: the port's ``scripts/eval_benchmark.py``.

Chunk-sharded answer generation and scoring, replacing the reference's
per-benchmark bash fan-out (scripts/llama/eval/*.sh). The chunking flags are
the reference's (``--num-chunks/--chunk-idx``), so several processes or cards
can split a benchmark, and ``--merge`` concatenates the chunks' files and
scores them. The flags, names, defaults, choices and refusals are the JAX
CLI's; ``--device`` (the port's own flag) picks where the model runs: the
current CUDA device unless it says otherwise. The checkpoint loads in bf16
(``checkpoint.load_for_serving``), as the JAX CLI's.

    python -m slime_tpu_torch.eval.cli --model-path DIR --question-file q.jsonl \\
        --image-folder IMAGES --answers-file 'out/ans_{chunk}.jsonl' \\
        --num-chunks 2 --chunk-idx 0
    python -m slime_tpu_torch.eval.cli ... --answers-file 'out/ans_{chunk}.jsonl' \\
        --merge --scorer textvqa --annotation-file ann.json
"""
from __future__ import annotations

import argparse
import glob
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse and apply the JAX CLI's refusals: the chartqa, mmhal and amber
    drivers run the reference's greedy protocol, so sampling, beam and
    single-prediction flags would be ignored there and are refused."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--question-file", required=True)
    ap.add_argument("--image-folder", required=True)
    ap.add_argument("--answers-file", required=True)
    ap.add_argument("--conv-mode", default="llama3")
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=None,
                    help="default: 0.0 (greedy) for VQA benchmarks, 0.7 for "
                         "text-qa (reference model_qa.py); explicit values "
                         "win, including 0")
    ap.add_argument("--num-beams", type=int, default=1)
    ap.add_argument("--single-pred-prompt", action="store_true")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="text prompt cap; 0 = model tokenizer_model_max_length "
                         "(long-prefill benchmarks like MME-RealWorld run "
                         "untruncated)")
    ap.add_argument("--benchmark", default="generic",
                    choices=["generic", "chartqa", "mmhal", "amber", "text-qa"],
                    help="driver/output format (generic = answers jsonl; the "
                         "others emit the reference per-benchmark formats)")
    ap.add_argument("--scorer", default=None,
                    choices=[None, "textvqa", "pope", "scienceqa"])
    ap.add_argument("--annotation-file", default=None)
    ap.add_argument("--merge", action="store_true",
                    help="merge chunk files matching answers-file pattern and score")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    if args.benchmark in ("chartqa", "mmhal", "amber"):
        ignored = []
        if args.temperature not in (None, 0.0):
            ignored.append(f"--temperature={args.temperature}")
        if args.num_beams != 1:
            ignored.append(f"--num-beams={args.num_beams}")
        if args.single_pred_prompt:
            ignored.append("--single-pred-prompt")
        if ignored:
            ap.error(f"{', '.join(ignored)} not supported by the "
                     f"'{args.benchmark}' driver (it runs the reference "
                     "greedy protocol); drop the flag(s) or use "
                     "--benchmark generic")
    return args


def main(argv: Optional[Sequence[str]] = None, tokenizer=None):
    """Run the CLI. ``tokenizer`` replaces ``AutoTokenizer.from_pretrained``
    (imported only when it is None). ``--merge`` loads no model."""
    from . import harness, scorers

    args = parse_args(argv)
    if args.merge:
        files = sorted(glob.glob(args.answers_file.replace("{chunk}", "*")))
        merged = args.answers_file.replace("{chunk}", "merged")
        harness.merge_chunks(files, merged)
        print(f"merged {len(files)} chunks -> {merged}")
        if args.scorer == "textvqa":
            print(scorers.score_textvqa(merged, args.annotation_file))
        return

    import torch

    from .. import checkpoint as ckpt
    from ..config import SliMEConfig
    from ..models.layers import resolve_device

    device = resolve_device(args.device)
    cfg = SliMEConfig.load(args.model_path)
    params = ckpt.load_for_serving(args.model_path, device=device, dtype=torch.bfloat16,
                                   cfg=cfg, model_base=args.model_base)
    if tokenizer is None:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_base or args.model_path)

    questions = harness.load_questions(args.question_file)
    chunk = harness.get_chunk(questions, args.num_chunks, args.chunk_idx)
    out = args.answers_file.replace("{chunk}", str(args.chunk_idx))
    if args.benchmark != "generic":
        from . import benchmarks
        if args.benchmark == "chartqa":
            print(benchmarks.run_chartqa(
                params, cfg, tokenizer, chunk, image_folder=args.image_folder,
                answers_file=out, conv_mode=args.conv_mode,
                batch_size=args.batch_size, seq_len=args.seq_len,
                max_new_tokens=args.max_new_tokens))
        elif args.benchmark == "mmhal":
            benchmarks.run_mmhal(params, cfg, tokenizer, chunk,
                                 answers_file=out, conv_mode=args.conv_mode,
                                 image_folder=args.image_folder,
                                 batch_size=args.batch_size,
                                 seq_len=args.seq_len,
                                 max_new_tokens=args.max_new_tokens)
        elif args.benchmark == "amber":
            benchmarks.run_amber(params, cfg, tokenizer, chunk,
                                 image_folder=args.image_folder,
                                 answers_file=out, conv_mode=args.conv_mode,
                                 batch_size=args.batch_size,
                                 seq_len=args.seq_len,
                                 max_new_tokens=args.max_new_tokens)
        else:  # text-qa
            harness.run_text_qa(params, cfg, tokenizer, chunk,
                                answers_file=out, conv_mode=args.conv_mode,
                                batch_size=args.batch_size,
                                seq_len=args.seq_len,
                                temperature=(0.7 if args.temperature is None
                                             else args.temperature),
                                max_new_tokens=args.max_new_tokens)
        print(f"answers -> {out}")
        return
    harness.run_eval(params, cfg, tokenizer, chunk,
                     image_folder=args.image_folder, answers_file=out,
                     conv_mode=args.conv_mode, batch_size=args.batch_size,
                     max_new_tokens=args.max_new_tokens,
                     temperature=args.temperature or 0.0,
                     num_beams=args.num_beams, seq_len=args.seq_len,
                     single_pred_prompt=args.single_pred_prompt)
    print(f"answers -> {out}")


if __name__ == "__main__":
    main()
