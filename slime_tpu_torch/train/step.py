"""Training step: loss, gradients of the trainable leaves, optimizer update.

Port of ``slime_tpu/train/step.py`` (``make_train_step`` :26-55,
``init_train_state`` :132-154) as plain functions over the parameter dict.

``init_train_state`` labels the leaves (``optim.label_tree``) and returns a
state whose trainable leaves are fresh copies with ``requires_grad=True``,
while every frozen leaf is the caller's tensor itself (shared, never
written, no gradient). So the caller's tree stays as it was, as JAX's
copy-then-donate leaves it, and the frozen base is not duplicated.

The step pins the precision policy ``generate`` pins: the forward and the
backward run under ``layers.fp32_accumulation`` (no TF32, no reduced-
precision bf16 reductions). ``compute_dtype`` defaults to bf16 as in JAX.
The logged ``grad_norm`` is the global norm over the trainable leaves'
gradients; JAX's also counts the frozen leaves' gradients, which it computes
and then discards.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import SliMEConfig
from ..models import slime
from ..models.layers import fp32_accumulation
from ..params import map_leaves
from .optim import TrainConfig, make_optimizer, trainable_label


def init_train_state(params, tc: TrainConfig):
    """-> (state {"params", "opt_state", "step"}, tx)."""
    def prepare(path, leaf):
        if trainable_label(path, leaf, tc) == "frozen":
            return leaf.detach() if leaf.requires_grad else leaf
        return leaf.detach().clone().requires_grad_(True)

    params = map_leaves(prepare, params)
    tx, _ = make_optimizer(params, tc)
    return {"params": params, "opt_state": tx, "step": 0}, tx


def make_train_step(cfg: SliMEConfig, tc: TrainConfig, tx,
                    use_kernel: Optional[bool] = None,
                    compute_dtype=torch.bfloat16, remat: bool = False,
                    loss_chunk="auto"):
    """Returns step(state, batch, generator=None, noise=None) -> (state,
    metrics): the state's trainable leaves are updated in place and its step
    count advances. ``generator`` / ``noise`` feed the training noise of the
    gate and the selection (``slime.encode_images``). The metrics are 0-d
    device tensors: reading them syncs, so callers read them only when they
    log."""
    del tc      # the optimizer carries its TrainConfig

    def step(state, batch, generator=None, noise=None):
        with fp32_accumulation():
            loss, aux = slime.loss_fn(state["params"], cfg, batch, training=True,
                                      generator=generator, noise=noise,
                                      use_kernel=use_kernel,
                                      compute_dtype=compute_dtype, remat=remat,
                                      loss_chunk=loss_chunk)
            loss.backward()
        gnorm = tx.step()
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm, **aux}

    return step
