"""Weight management tools: consolidate, delta make/apply.

The port's ``scripts/weight_tools.py``, which rebuilds the reference's weight
utilities (SURVEY.md §2.15); the files hold the same keys and values:

- consolidate: shard set -> single-file checkpoint (llava/model/consolidate.py)
- make-delta / apply-delta: distribute finetuned weights as diffs against a base
  LLM (llava/model/make_delta.py / apply_delta.py)

    python -m slime_tpu_torch.tools.weight_tools make-delta --base B --target T --delta D
    python -m slime_tpu_torch.tools.weight_tools apply-delta --base B --delta D --target T
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence


def save(sd, path, cfg_src=None):
    """numpy state dict -> ``path``/pytorch_model.bin, with ``cfg_src``'s
    config.json beside it when there is one."""
    import numpy as np
    import torch

    os.makedirs(path, exist_ok=True)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               os.path.join(path, "pytorch_model.bin"))
    if cfg_src and os.path.exists(os.path.join(cfg_src, "config.json")):
        shutil.copy(os.path.join(cfg_src, "config.json"), os.path.join(path, "config.json"))


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("consolidate")
    c.add_argument("--src", required=True)
    c.add_argument("--dst", required=True)

    m = sub.add_parser("make-delta")
    m.add_argument("--base", required=True)
    m.add_argument("--target", required=True)
    m.add_argument("--delta", required=True)

    a = sub.add_parser("apply-delta")
    a.add_argument("--base", required=True)
    a.add_argument("--delta", required=True)
    a.add_argument("--target", required=True)

    args = ap.parse_args(argv)

    from .. import checkpoint as ckpt

    if args.cmd == "consolidate":
        sd = ckpt.load_sharded_state_dict(args.src)
        save(sd, args.dst, cfg_src=args.src)
        print(f"consolidated {len(sd)} tensors -> {args.dst}")
    elif args.cmd == "make-delta":
        base = ckpt.load_sharded_state_dict(args.base)
        tgt = ckpt.load_sharded_state_dict(args.target)
        delta = {}
        for k, v in tgt.items():
            delta[k] = v - base[k] if k in base and base[k].shape == v.shape else v
        save(delta, args.delta, cfg_src=args.target)
        print(f"delta ({len(delta)} tensors) -> {args.delta}")
    elif args.cmd == "apply-delta":
        base = ckpt.load_sharded_state_dict(args.base)
        delta = ckpt.load_sharded_state_dict(args.delta)
        out = {}
        for k, v in delta.items():
            out[k] = v + base[k] if k in base and base[k].shape == v.shape else v
        save(out, args.target, cfg_src=args.delta)
        print(f"applied delta -> {args.target}")


if __name__ == "__main__":
    main()
