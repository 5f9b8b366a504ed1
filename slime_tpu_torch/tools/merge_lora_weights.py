"""Merge LoRA adapters into base weights and save a standalone checkpoint
(reference scripts/merge_lora_weights.py:1-22 + model/builder.py:52-91).

The port's ``scripts/merge_lora_weights.py``; it loads on the host and runs
no model:

    python -m slime_tpu_torch.tools.merge_lora_weights --model-path LORA_DIR \\
        --model-base BASE_DIR --save-model-path OUT
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True, help="LoRA checkpoint dir")
    ap.add_argument("--model-base", required=True)
    ap.add_argument("--save-model-path", required=True)
    args = ap.parse_args(argv)

    from .. import checkpoint as ckpt
    from ..config import SliMEConfig

    cfg = SliMEConfig.load(args.model_path)
    # load_pretrained detects adapter_model.* / inline lora_* keys and merges
    # W <- W + (alpha/r) B @ A against model_base
    merged = ckpt.load_pretrained(args.model_path, model_base=args.model_base, cfg=cfg)
    ckpt.save_checkpoint(args.save_model_path, merged, cfg)
    print(f"merged checkpoint -> {args.save_model_path}")


if __name__ == "__main__":
    main()
