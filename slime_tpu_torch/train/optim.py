"""Optimizer construction: AdamW per label group, staged freezing, LR schedules.

Port of ``slime_tpu/train/optim.py`` (which imports jax and optax, so it is
not shared): ``TrainConfig`` with the same fields and defaults,
``trainable_label`` / ``label_tree``, the weight-decay mask, the three
schedules and ``make_optimizer``.

Each leaf gets a label: ``"base"``, ``"proj"`` (the projector/sampler LR
group when ``mm_projector_lr`` is set) or ``"frozen"``. JAX computes every
leaf's gradient and zeroes the frozen ones' updates; here a frozen leaf has
``requires_grad=False``, so autograd never computes its gradient and the
optimizer holds no state for it.

Per trainable label group the update is optax's
``chain(clip_by_global_norm(max_grad_norm), adamw(schedule, mask=decay))``:

- clipping uses the group's own global norm: ``g`` is kept when
  ``norm < max_norm`` and becomes ``(g / norm) * max_norm`` otherwise (not
  ``torch.nn.utils.clip_grad_norm_``, which divides by ``norm + 1e-6``);
- AdamW is ``torch.optim.AdamW`` handed the schedule's value at the group's
  step count before each update (so the first update uses ``schedule(0)``,
  0 under warmup): ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, with
  bias correction from count 1 and eps outside the square root, as optax;
- weight decay applies to leaves with ``ndim >= 2`` and no "norm" in their
  path.

A trainable leaf that got no gradient (a branch the stage never runs) takes
a zero gradient, as JAX's would be, so its moments decay in step with optax.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..params import map_leaves, named_leaves

_TODO = "(ROADMAP: the port's training queue)"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    lr_schedule: str = "cosine"
    # staged-freezing flags (reference train.py:1114-1134)
    tune_mm_mlp_adapter: bool = False
    freeze_mm_mlp_adapter: bool = False
    freeze_backbone: bool = False
    unfreeze_mm_vision_tower: bool = False
    mm_learnable_gated: int = -1
    gradient_accumulation_steps: int = 1
    # "adamw" (fp32 moments) or "adamw8bit" (not ported yet)
    optim: str = "adamw"


def trainable_label(path: str, leaf, tc: TrainConfig) -> str:
    """'base' | 'proj' (projector/sampler LR group) | 'frozen'."""
    s = path
    if s.startswith("vision/"):
        return "base" if tc.unfreeze_mm_vision_tower else "frozen"
    if s.startswith(("projector/", "sampler/")):
        if tc.freeze_mm_mlp_adapter and s.startswith("projector/"):
            return "frozen"
        # expert pinning: mm_learnable_gated==0 trains the MLP expert only
        # (attention adapter frozen); ==1 trains the adapter (MLP expert frozen)
        if s.startswith("projector/"):
            if tc.mm_learnable_gated == 0 and s.startswith("projector/attn/"):
                return "frozen"
            if tc.mm_learnable_gated == 1 and s.startswith("projector/projection/"):
                return "frozen"
        return "proj" if tc.mm_projector_lr is not None else "base"
    # LLM body
    if tc.tune_mm_mlp_adapter or tc.freeze_backbone:
        return "frozen"
    return "base"


def label_tree(params, tc: TrainConfig):
    return map_leaves(lambda path, leaf: trainable_label(path, leaf, tc), params)


def _decays(path: str, leaf) -> bool:
    return leaf.dim() >= 2 and "norm" not in path.lower()


def make_schedule(tc: TrainConfig, lr: float) -> Callable[[int], float]:
    """count -> learning rate, as optax's schedules (optim.py:90-100)."""
    warmup = max(int(tc.total_steps * tc.warmup_ratio), 1)

    def linear(init, end, steps, count):
        count = min(max(count, 0), steps)
        return (init - end) * (1 - count / steps) + end

    if tc.lr_schedule == "cosine":
        decay = max(tc.total_steps, warmup + 1) - warmup

        def cosine(count):
            if count < warmup:
                return linear(0.0, lr, warmup, count)
            c = min(count - warmup, decay)
            return lr * 0.5 * (1 + math.cos(math.pi * c / decay))
        return cosine
    if tc.lr_schedule == "linear":     # HF lr_scheduler_type="linear": decay to 0
        rest = max(tc.total_steps - warmup, 1)
        return lambda count: (linear(0.0, lr, warmup, count) if count < warmup
                              else linear(lr, 0.0, rest, count - warmup))
    return lambda count: lr            # "constant"


class GroupedAdamW:
    """AdamW per label group with per-group global-norm clipping (see the
    module docstring). ``step()`` updates the trainable leaves in place,
    clears their gradients, and returns the global norm of the gradients it
    was given (over all trainable leaves, before clipping) as a 0-d tensor."""

    def __init__(self, groups: Dict[str, List[Tuple[str, torch.Tensor]]],
                 tc: TrainConfig):
        self.tc = tc
        self.groups = []
        for label, leaves in groups.items():
            lr = (tc.mm_projector_lr or tc.learning_rate) if label == "proj" \
                else tc.learning_rate
            decay = [p for path, p in leaves if _decays(path, p)]
            no_decay = [p for path, p in leaves if not _decays(path, p)]
            param_groups = [{"params": ps, "weight_decay": wd}
                            for ps, wd in ((decay, tc.weight_decay), (no_decay, 0.0))
                            if ps]
            opt = torch.optim.AdamW(param_groups, lr=0.0,
                                    betas=(tc.adam_b1, tc.adam_b2), eps=tc.adam_eps)
            self.groups.append({"label": label, "params": [p for _, p in leaves],
                                "schedule": make_schedule(tc, lr), "opt": opt,
                                "count": 0})

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        sq = []
        for g in self.groups:
            grads = []
            for p in g["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            norm_sq = sum(gr.to(torch.float32).square().sum() for gr in grads)
            sq.append(norm_sq)
            norm = torch.sqrt(norm_sq)
            keep = norm < self.tc.max_grad_norm
            for gr in grads:
                gr.copy_(torch.where(keep, gr, (gr / norm) * self.tc.max_grad_norm))
            lr = g["schedule"](g["count"])
            for pg in g["opt"].param_groups:
                pg["lr"] = lr
            g["opt"].step()
            g["opt"].zero_grad(set_to_none=True)
            g["count"] += 1
        if not sq:
            return torch.zeros(())
        return torch.sqrt(sum(sq))


def make_optimizer(params, tc: TrainConfig):
    """-> (GroupedAdamW over the trainable leaves of ``params``, labels tree).

    ``params`` must already carry the labels' ``requires_grad`` flags
    (``step.init_train_state`` sets them)."""
    if tc.optim != "adamw":
        raise NotImplementedError(f"optim={tc.optim!r} (train/opt8.py) is not "
                                  f"ported yet {_TODO}")
    if tc.gradient_accumulation_steps > 1:
        raise NotImplementedError("gradient accumulation (optax.MultiSteps) is "
                                  f"not ported yet {_TODO}")
    labels = label_tree(params, tc)
    groups: Dict[str, List[Tuple[str, torch.Tensor]]] = {}
    for (path, leaf), (_, label) in zip(named_leaves(params), named_leaves(labels)):
        if label != "frozen":
            groups.setdefault(label, []).append((path, leaf))
    return GroupedAdamW(groups, tc), labels
