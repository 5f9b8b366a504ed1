"""Single-shot image+prompt inference (reference llava/eval/run_llava.py:50-128).

Port of ``slime_tpu/eval/run_slime.py``: the checkpoint loaded in bf16
(``checkpoint.load_for_serving``), the conversation template of the model's
name unless ``--conv-mode`` names one, host anyres crops, ``generate``, and the
answer printed. ``--device`` (the port's own flag) picks where it runs: the
current CUDA device unless it says otherwise.

  python -m slime_tpu_torch.eval.run_slime --model-path ... --image-file img.jpg \\
      --query "What is this?"
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def eval_model(args, tokenizer=None):
    """Answer ``args.query`` about ``args.image_file`` in bf16; prints and
    returns the text. ``tokenizer`` replaces ``AutoTokenizer.from_pretrained``
    (imported only when it is None)."""
    from PIL import Image

    from .. import checkpoint as ckpt
    from ..config import SliMEConfig
    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_mode_from_model_name, conv_templates
    from ..data.image_ops import process_anyres_image_host
    from ..data.tokenization import get_model_name_from_path, tokenizer_image_token
    from ..generate import generate
    from ..models.layers import resolve_device
    from .harness import decode_row

    device = resolve_device(args.device)
    cfg = SliMEConfig.load(args.model_path)
    params = ckpt.load_for_serving(args.model_path, device=device, dtype=torch.bfloat16,
                                   cfg=cfg, model_base=args.model_base)
    if tokenizer is None:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_base or args.model_path)

    qs = args.query
    if DEFAULT_IMAGE_TOKEN not in qs:
        qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
    conv_mode = args.conv_mode or conv_mode_from_model_name(
        get_model_name_from_path(args.model_path))
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    img = Image.open(args.image_file).convert("RGB")
    crops, mask, _ = process_anyres_image_host(
        img, tile=cfg.vision.image_size, max_crops=1 + cfg.max_local_crops)
    ids = torch.from_numpy(tokenizer_image_token(prompt, tokenizer, return_tensors="np")
                           ).to(device)[None]
    toks = generate(params, cfg, ids, torch.ones(ids.shape, dtype=torch.bool, device=device),
                    torch.from_numpy(crops[None]).to(device),
                    torch.from_numpy(mask[None]).to(device),
                    max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature, top_p=args.top_p,
                    compute_dtype=torch.bfloat16)
    text = decode_row(tokenizer, toks, 0, cfg.eos_token_id)
    print(text)
    return text


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--image-file", required=True)
    ap.add_argument("--query", required=True)
    ap.add_argument("--conv-mode", default=None)
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, tokenizer=None):
    return eval_model(parse_args(argv), tokenizer=tokenizer)


if __name__ == "__main__":
    main()
