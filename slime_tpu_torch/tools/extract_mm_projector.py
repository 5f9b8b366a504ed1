"""Extract mm_projector (+ sampler) weights from a full checkpoint into
adapter-only .bin files (reference scripts/extract_mm_projector.py:1-47).

The port's ``scripts/extract_mm_projector.py``; the files hold the same keys
and values:

    python -m slime_tpu_torch.tools.extract_mm_projector --model-path DIR --output OUT
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--output", required=True, help="output dir")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .. import checkpoint as ckpt

    sd = ckpt.load_sharded_state_dict(args.model_path)
    os.makedirs(args.output, exist_ok=True)
    for keyword, fname in (("model.mm_projector", "mm_projector.bin"),
                           ("model.sampler", "sampler.bin")):
        sub = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sd.items() if k.startswith(keyword)}
        if sub:
            torch.save(sub, os.path.join(args.output, fname))
            print(f"wrote {fname}: {len(sub)} tensors")


if __name__ == "__main__":
    main()
