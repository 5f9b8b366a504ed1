"""The gradient accumulator's memory check.

Port of ``grad_accum_bytes`` and ``check_grad_accum_fit``
(``slime_tpu/parallel/memory_plan.py:213-260``). Accumulation
(``train.optim.MultiSteps``) holds one fp32 copy of every trainable leaf for
the whole window; the check refuses a run whose accumulator provably cannot
fit next to what the card already holds, before the first step. The budget
comes from ``torch.cuda.mem_get_info`` on the leaves' card; with no card and
no explicit budget the check is skipped, as JAX skips it without device
statistics. The rest of that module (the per-mesh plan over the pipeline's
stacked specs) is not ported yet (ROADMAP Queue 1 item 12b).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..params import named_leaves


def grad_accum_bytes(trainable, n_shards: int = 1) -> int:
    """Bytes of one fp32 copy of every leaf of ``trainable``, divided over
    ``n_shards``."""
    total = 0
    for _, leaf in named_leaves(trainable):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        total += int(torch.Size(shape).numel()) * 4 if shape else 4
    return total // max(int(n_shards), 1)


def _card(trainable) -> Optional[torch.device]:
    for _, leaf in named_leaves(trainable):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return None


def check_grad_accum_fit(trainable, steps: int, *, hbm_bytes: Optional[int] = None,
                         used_bytes: Optional[int] = None, headroom: float = 0.9) -> int:
    """Raise ValueError if the fp32 accumulator of ``steps`` > 1 cannot fit
    in ``hbm_bytes * headroom - used_bytes``; return its bytes (0 when
    ``steps`` <= 1). ``hbm_bytes`` / ``used_bytes`` default to the card's
    total and in-use memory (``torch.cuda.mem_get_info``) when the leaves
    are on one. A lower bound on misfit: activations are not counted."""
    if steps <= 1:
        return 0
    acc = grad_accum_bytes(trainable)
    if hbm_bytes is None:
        card = _card(trainable)
        if card is not None:
            free, total = torch.cuda.mem_get_info(card)
            hbm_bytes = total
            if used_bytes is None:
                used_bytes = total - free
    if not hbm_bytes:
        return acc
    free = hbm_bytes * headroom - (used_bytes or 0)
    if acc > free:
        gb = 2.0 ** 30
        raise ValueError(
            f"gradient_accumulation_steps={steps} needs a persistent fp32 grad "
            f"accumulator of ~{acc / gb:.1f} GB/device (one fp32 copy of every "
            f"trainable leaf for the whole window), but only ~{max(free, 0) / gb:.1f} "
            f"GB of the {hbm_bytes / gb:.1f} GB budget is left. Train LoRA "
            f"(accumulates only the adapter tree) or drop accumulation.")
    return acc
