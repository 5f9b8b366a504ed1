"""Train-state checkpoint discovery.

``latest_checkpoint`` is the port's copy of ``slime_tpu/train/state_ckpt.py:76-84``
(HF-style resume discovery of ``state-<step>`` directories). Saving and
restoring the whole train state (Orbax in the JAX package) is not ported yet:
the trainer raises when it would resume (ROADMAP, Queue 1 step 9).
"""
from __future__ import annotations

import os
from typing import Optional


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The most recent 'state-<step>' directory under output_dir, or None."""
    if not os.path.isdir(output_dir):
        return None
    cands = [(int(d[6:]), os.path.join(output_dir, d)) for d in os.listdir(output_dir)
             if d.startswith("state-") and d[6:].isdigit()]
    return max(cands)[1] if cands else None
