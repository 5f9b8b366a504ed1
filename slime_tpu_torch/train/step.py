"""Training step: loss, gradients of the trainable leaves, optimizer update.

Port of ``slime_tpu/train/step.py`` (``make_train_step`` :26-55,
``init_train_state`` :132-154, and the LoRA / QLoRA pair
``make_lora_train_step`` / ``init_lora_train_state`` :58-130) as plain
functions over the parameter dict.

In LoRA mode the trainable tree is ``{"adapters", "extras"}`` (the lora
factors, and fresh copies of the projector and sampler); the base, bf16 or
quantized (int8, NF4: QLoRA), is a frozen input that never requires grad and
never enters the optimizer. The forward attaches the adapters in factored
form (``lora.attach`` -> ``layers.linear``'s ``lora`` branch), so a quantized
base keeps its own path.

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

``mesh=`` (``parallel.mesh``): the parameters (and in LoRA mode the base and
the trainable tree) are sharded by the rule table unless they already are;
each step runs under the mesh on this rank's rows of the global batch
(``mesh.shard_batch``), all-reduces the gradients over the batch axes
(``tensor_parallel.sync_grads``), and the optimizer's norms are the global
ones (``tensor_parallel.global_sq_norm``), so the loss, ``grad_norm``, the
clipping and the update equal the single-card step's on the global batch.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import SliMEConfig
from ..models import slime
from ..models.layers import fp32_accumulation
from ..parallel import tensor_parallel as tp
from ..parallel.mesh import copy_spec, on_mesh, shard_params, use_mesh
from ..params import map_leaves, named_leaves
from . import lora as lora_lib
from .optim import TrainConfig, make_lora_optimizer, make_optimizer, trainable_label


def _on(mesh, tree):
    return tree if mesh is None or on_mesh(tree, mesh) else shard_params(mesh, tree)


def _trainable(tree):
    return [t for _, t in named_leaves(tree) if isinstance(t, torch.Tensor) and t.requires_grad]


def init_train_state(params, tc: TrainConfig, mesh=None):
    """-> (state {"params", "opt_state", "step"}, tx); under ``mesh`` the
    state holds this rank's shards."""
    params = _on(mesh, params)

    def prepare(path, leaf):
        if trainable_label(path, leaf, tc) == "frozen":
            return copy_spec(leaf.detach(), leaf) if leaf.requires_grad else leaf
        return copy_spec(leaf.detach().clone().requires_grad_(True), leaf)

    params = map_leaves(prepare, params)
    tx, _ = make_optimizer(params, tc)
    return {"params": params, "opt_state": tx, "step": 0}, tx


def make_train_step(cfg: SliMEConfig, tc: TrainConfig, tx,
                    use_kernel: Optional[bool] = None,
                    compute_dtype=torch.bfloat16, remat: bool = False,
                    loss_chunk="auto", mesh=None):
    """Returns step(state, batch, generator=None, noise=None) -> (state,
    metrics): the state's trainable leaves are updated in place and its step
    count advances. ``generator`` / ``noise`` feed the training noise of the
    gate and the selection (``slime.encode_images``). The metrics are 0-d
    device tensors: reading them syncs, so callers read them only when they
    log. Under ``mesh`` the batch (and the noise) are this rank's rows."""
    del tc      # the optimizer carries its TrainConfig

    def step(state, batch, generator=None, noise=None):
        with fp32_accumulation(), use_mesh(mesh):
            loss, aux = slime.loss_fn(state["params"], cfg, batch, training=True,
                                      generator=generator, noise=noise,
                                      use_kernel=use_kernel,
                                      compute_dtype=compute_dtype, remat=remat,
                                      loss_chunk=loss_chunk)
            loss.backward()
            tp.sync_grads(_trainable(state["params"]))
            gnorm = tx.step()
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm, **aux}

    return step


def init_lora_train_state(base_params, lora_state, tc: TrainConfig,
                          train_extras=("projector", "sampler"), mesh=None):
    """-> (base, state {"params": {"adapters", "extras"}, "opt_state",
    "step"}, tx). The trainable leaves are fresh copies that require grad;
    ``base`` is the caller's tree (shared, frozen; its projector and sampler
    are shadowed by the extras in the step). Under ``mesh`` the base and the
    trainable tree are this rank's shards."""
    def fresh(path, leaf):
        return copy_spec(leaf.detach().clone().requires_grad_(True), leaf)

    base_params = _on(mesh, base_params)
    trainable = {"adapters": lora_state["adapters"],
                 "extras": {k: base_params[k] for k in train_extras if k in base_params}}
    if mesh is not None:
        trainable = {"adapters": shard_params(mesh, {"adapters": trainable["adapters"]}
                                              )["adapters"],
                     "extras": trainable["extras"]}
    trainable = map_leaves(fresh, trainable)
    base = dict(base_params)
    tx, _ = make_lora_optimizer(trainable, tc)
    return base, {"params": trainable, "opt_state": tx, "step": 0}, tx


def make_lora_train_step(cfg: SliMEConfig, tc: TrainConfig, tx, *, rank: int, alpha: int,
                         use_kernel: Optional[bool] = None,
                         compute_dtype=torch.bfloat16, remat: bool = False,
                         loss_chunk="auto", mesh=None):
    """Returns step(state, base_params, batch, generator=None, noise=None)
    -> (state, metrics), as ``make_train_step``'s step over the LoRA
    trainable tree."""
    del tc

    def step(state, base_params, batch, generator=None, noise=None):
        trainable = state["params"]
        params = {**base_params, **trainable["extras"]}
        params = lora_lib.attach(params, {"rank": rank, "alpha": alpha,
                                          "adapters": trainable["adapters"]})
        with fp32_accumulation(), use_mesh(mesh):
            loss, aux = slime.loss_fn(params, cfg, batch, training=True,
                                      generator=generator, noise=noise,
                                      use_kernel=use_kernel,
                                      compute_dtype=compute_dtype, remat=remat,
                                      loss_chunk=loss_chunk)
            loss.backward()
            tp.sync_grads(_trainable(trainable))
            gnorm = tx.step()
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm, **aux}

    return step
