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

``optim="adamw8bit"`` (``optim.py:102-150``) stores both moments as int8
codes with per-256-block scales (``train.opt8``): within each label group the
chain is the same, clipping, then ``scale_by_adam8bit``, then the decayed
weights under the same mask, then the schedule, with optax's arithmetic
(``p + (-lr) * (u + wd * p)`` in the gradient's dtype).

The clip pass never makes a whole-leaf copy: each leaf's sum of squares is
taken in fp32 over slices of 2^26 elements and the clip is written back in
place slice by slice with the same arithmetic. Under an active mesh every
norm is the global one (``parallel.tensor_parallel.global_sq_norm``: each
shard's squares summed over the ranks, each replicated leaf counted once),
so every rank clips by the same factor; Adam then updates the local shards.

``gradient_accumulation_steps`` k > 1 wraps the optimizer in ``MultiSteps``,
``optax.MultiSteps``' semantics: each micro-step folds its gradients into a
running mean (Welford, as optax), the inner update runs on every k-th
micro-step with that mean and leaves the parameters untouched on the others,
and the schedules count inner updates. ``make_lora_optimizer`` builds the
optimizer over a LoRA trainable tree {"adapters", "extras"} (optim.py:131-165):
the adapters at the base LR, the extras (projector, sampler) in the
``mm_projector_lr`` group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..parallel.tensor_parallel import global_sq_norm
from ..params import map_leaves, named_leaves
from . import opt8

_SLICE = 2 ** 26        # elements of a leaf the clip pass touches at a time


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
    # "adamw" (fp32 moments) or "adamw8bit" (blockwise int8 moments,
    # train/opt8.py: ~2.06 bytes a parameter against 8)
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


def _sq_norm(g: torch.Tensor) -> torch.Tensor:
    """fp32 sum of squares of ``g``, over slices of the flattened leaf."""
    flat = g.reshape(-1)
    return sum(c.to(torch.float32).square().sum() for c in flat.split(_SLICE))


def _clip_(g: torch.Tensor, keep: torch.Tensor, norm: torch.Tensor, max_norm: float):
    """``g = g if keep else (g / norm) * max_norm``, in place, slice by slice."""
    for c in g.view(-1).split(_SLICE):
        c.copy_(torch.where(keep, c, (c / norm) * max_norm))


class GroupedAdamW:
    """AdamW per label group with per-group global-norm clipping (see the
    module docstring); 8-bit moments under ``optim="adamw8bit"``. ``step()``
    updates the trainable leaves in place, clears their gradients, and
    returns the global norm of the gradients it was given (over all
    trainable leaves, before clipping) as a 0-d tensor."""

    def __init__(self, groups: Dict[str, List[Tuple[str, torch.Tensor]]],
                 tc: TrainConfig, decays: Callable[[str, torch.Tensor], bool] = _decays):
        self.tc = tc
        self.groups = []
        for label, leaves in groups.items():
            lr = (tc.mm_projector_lr or tc.learning_rate) if label == "proj" \
                else tc.learning_rate
            decay = [p for path, p in leaves if decays(path, p)]
            no_decay = [p for path, p in leaves if not decays(path, p)]
            param_groups = [{"params": ps, "weight_decay": wd}
                            for ps, wd in ((decay, tc.weight_decay), (no_decay, 0.0))
                            if ps]
            if tc.optim == "adamw8bit":
                opt = opt8.AdamW8bit(param_groups, betas=(tc.adam_b1, tc.adam_b2),
                                     eps=tc.adam_eps)
            else:
                opt = torch.optim.AdamW(param_groups, lr=0.0,
                                        betas=(tc.adam_b1, tc.adam_b2), eps=tc.adam_eps)
            self.groups.append({"label": label, "params": [p for _, p in leaves],
                                "schedule": make_schedule(tc, lr), "opt": opt,
                                "count": 0})

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.groups for p in g["params"]]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        sq = []
        for g in self.groups:
            grads = []
            for p in g["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            norm_sq = global_sq_norm(g["params"], [_sq_norm(gr) for gr in grads])
            sq.append(norm_sq)
            norm = torch.sqrt(norm_sq)
            keep = norm < self.tc.max_grad_norm
            for gr in grads:
                _clip_(gr, keep, norm, self.tc.max_grad_norm)
            lr = g["schedule"](g["count"])
            for pg in g["opt"].param_groups:
                pg["lr"] = lr
            g["opt"].step()
            g["opt"].zero_grad(set_to_none=True)
            g["count"] += 1
        if not sq:
            return torch.zeros(())
        return torch.sqrt(sum(sq))

    def state_dict(self) -> Dict:
        return {"counts": [g["count"] for g in self.groups],
                "opts": [g["opt"].state_dict() for g in self.groups]}

    def load_state_dict(self, sd: Dict) -> None:
        for g, count, opt in zip(self.groups, sd["counts"], sd["opts"]):
            g["count"] = count
            g["opt"].load_state_dict(opt)


class MultiSteps:
    """``optax.MultiSteps(inner, k)`` over the inner optimizer's leaves (see
    the module docstring). ``step()`` returns the global norm of this
    micro-step's gradients, as the train step logs it."""

    def __init__(self, inner: GroupedAdamW, k: int):
        self.inner, self.k = inner, k
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = [torch.zeros_like(p) for p in inner.params]

    @property
    def params(self) -> List[torch.Tensor]:
        return self.inner.params

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        params = self.inner.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        gnorm = (torch.sqrt(global_sq_norm(params, [_sq_norm(g) for g in grads]))
                 if grads else torch.zeros(()))
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (self.mini_step + 1))
        if self.mini_step < self.k - 1:
            self.mini_step += 1
            for p in params:
                p.grad = None
            return gnorm
        for p, a in zip(params, self.acc):
            p.grad = a.clone()
        self.inner.step()
        for a in self.acc:
            a.zero_()
        self.mini_step = 0
        self.gradient_step += 1
        return gnorm

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "gradient_step": self.gradient_step, "acc": list(self.acc)}

    def load_state_dict(self, sd: Dict) -> None:
        self.inner.load_state_dict(sd["inner"])
        self.mini_step, self.gradient_step = sd["mini_step"], sd["gradient_step"]
        for a, b in zip(self.acc, sd["acc"]):
            a.copy_(b)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Callable:
    """``optax.adamw(learning_rate)`` with its defaults, as a transform: a
    function of the trainable leaves ``[(path, tensor)]`` that returns their
    optimizer (a ``GroupedAdamW`` of one group: a constant rate, no
    clipping, every leaf decayed, as optax's adamw without a mask). The
    pipeline and composed steps take it where JAX's take an optax
    transform (``init_pp_train_state(params, tx, ...)``)."""
    tc = TrainConfig(learning_rate=learning_rate, weight_decay=weight_decay, adam_b1=b1,
                     adam_b2=b2, adam_eps=eps, warmup_ratio=0.0, lr_schedule="constant",
                     max_grad_norm=math.inf)
    return lambda leaves: GroupedAdamW({"base": list(leaves)}, tc, decays=lambda *_: True)


def _build(groups, tc: TrainConfig):
    if tc.optim not in ("adamw", "adamw8bit"):
        raise ValueError(f"unknown optim {tc.optim!r}: adamw or adamw8bit")
    tx = GroupedAdamW(groups, tc)
    return MultiSteps(tx, tc.gradient_accumulation_steps) \
        if tc.gradient_accumulation_steps > 1 else tx


def make_optimizer(params, tc: TrainConfig):
    """-> (GroupedAdamW over the trainable leaves of ``params``, wrapped in
    ``MultiSteps`` under accumulation; the labels tree).

    ``params`` must already carry the labels' ``requires_grad`` flags
    (``step.init_train_state`` sets them)."""
    labels = label_tree(params, tc)
    groups: Dict[str, List[Tuple[str, torch.Tensor]]] = {}
    for (path, leaf), (_, label) in zip(named_leaves(params), named_leaves(labels)):
        if label != "frozen":
            groups.setdefault(label, []).append((path, leaf))
    return _build(groups, tc), labels


def make_lora_optimizer(trainable, tc: TrainConfig):
    """-> (the optimizer over a LoRA trainable tree {"adapters", "extras"},
    labels tree): the adapters at the base LR, the extras in the "proj"
    group at ``mm_projector_lr`` (or the base LR). Optimizer state exists
    only for this tree; the frozen (possibly quantized) base has none."""
    labels = map_leaves(lambda path, leaf: "proj" if path.startswith("extras/") else "base",
                        trainable)
    groups: Dict[str, List[Tuple[str, torch.Tensor]]] = {"base": [], "proj": []}
    for (path, leaf), (_, label) in zip(named_leaves(trainable), named_leaves(labels)):
        groups[label].append((path, leaf))
    return _build({k: v for k, v in groups.items() if v}, tc), labels
