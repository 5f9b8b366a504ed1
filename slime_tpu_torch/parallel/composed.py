"""Composed parallelism: (data x fsdp x model) x pp in one train step.

Port of ``slime_tpu/parallel/composed.py``. JAX runs the pipeline's
wavefront as a partial-manual ``shard_map`` over ``pp`` and leaves data,
fsdp and model to its partitioner inside each stage. One process per card
composes the same way by hand: the ranks of a ``(data, fsdp, pp, model)``
mesh (``make_composed_mesh``, ``parallel.mesh``'s four-axis order) run
``parallel.pipeline``'s wavefront over their ``pp`` group, and inside each
stage every layer runs on this rank's view of its leaves
(``tensor_parallel.llm_layer``: the Megatron pairs over ``model``, the
gathers of the fsdp shards), as the three-axis mesh's layers do.

Storage follows JAX's specs: a stacked leaf [L, ...] is split
``("pp", *rule)``, its layers over the stages and each layer by the
per-layer rule shifted one dim right, pruned where an axis does not divide
(``stacked_param_pspec``); the head (embedding, final norm, ``lm_head``) and
the tower, projector and sampler keep the per-leaf rule, whole over ``pp``.
A stacked shard's spec travels to the layer view the model code receives
(``pipeline._layer_view``: the spec minus its stage entry).

The multimodal step (``make_composed_mm_train_step``) runs the full SliME
model: each rank encodes its block of its (data, fsdp) rows (the crop batch
split over (data, fsdp, pp), JAX's ``P(("data", "fsdp", "pp"))``), the
fused embeds are all-gathered over ``pp`` for the wavefront (the backward a
reduce-scatter: each stage gets its rows' gradient), and the tower's
gradients are summed over the batch ranks. Its noise comes from
``generator`` or ``noise`` (this rank's (data, fsdp) rows, as the batch).

``check_composed`` stands where JAX lowers the step shape-only
(``lower_composed_abstract``): there is no compiler to ask, so it builds
every leaf on the ``meta`` device, takes rank 0's shard of each by the
composed specs, raises where JAX's trace would, and returns rank 0's
parameter bytes (``memory_plan.plan``'s ``params``).
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from ..models import layers as L
from ..models import llama, slime
from ..models.layers import fp32_accumulation
from ..ops.loss import DEFAULT_LOSS_CHUNK
from ..params import named_leaves
from . import mesh as mesh_lib
from .tensor_parallel import _all_gather
from .pipeline import (_GatherRows, _check_layers, _finish, _fresh, _hidden_rows,
                       _named_trainable, _token, _token_loss, make_pp_train_step, stack_layers)

AXES = mesh_lib.COMPOSED_AXES


def make_composed_mesh(n_data: int = 1, n_fsdp: int = 1, n_model: int = 1, n_pp: int = 1,
                       device=None) -> mesh_lib.Mesh:
    """The four-axis mesh over the default group (``composed.py:38-52``):
    ``model`` innermost, ``pp`` just outside it, then fsdp and data."""
    return mesh_lib.make_mesh(n_data, n_fsdp, n_model, device=device, n_pp=n_pp)


def _rule_spec(path_str: str, dims, mesh) -> tuple:
    """The per-layer rule of ``path_str`` for a layer shape ``dims``, pruned
    where an axis does not divide (``composed.py:70-92``)."""
    if len(dims) < 2:
        return ()
    sizes = mesh_lib._sizes(mesh)
    for pat, spec in mesh_lib._RULES:
        if re.search(pat, path_str):
            if len(spec) > len(dims):
                return ()
            fixed = []
            for d, ax in enumerate(spec):
                if ax is None:
                    fixed.append(None)
                    continue
                axes = (ax,) if isinstance(ax, str) else tuple(ax)
                keep = tuple(a for a in axes if dims[d] % sizes[a] == 0 and sizes[a] > 1)
                fixed.append(keep[0] if len(keep) == 1 else (keep or None))
            return tuple(fixed)
    return ()


def stacked_param_pspec(path: str, shape, mesh=None, axis: str = "pp") -> tuple:
    """The spec of a ``stack_layers`` leaf [L, ...] at ``path`` ("q_proj/
    weight"): ``axis`` on dim 0, then the per-layer rule (``composed.py:
    55-67``). ``mesh`` a Mesh or a dict of axis sizes."""
    return (axis,) + _rule_spec("llm/layers/0/" + path, tuple(shape)[1:], mesh)


def head_param_pspec(path: str, shape, mesh=None) -> tuple:
    """embed_tokens / norm / lm_head: the LLM rule over fsdp and model,
    whole over pp (``head_param_shardings``, ``composed.py:101-106``)."""
    return mesh_lib.param_pspec("llm/" + path, shape, mesh)


def shard_stacked(mesh, stacked, axis: str = "pp"):
    """This rank's shard of every stacked leaf by ``stacked_param_pspec``,
    its spec recorded (JAX's ``stacked_param_shardings`` placement)."""
    _check_layers(stacked, mesh, axis)
    return mesh_lib.shard_params(mesh, stacked,
                                 lambda p, s: stacked_param_pspec(p, s, mesh, axis))


def shard_head(mesh, head):
    return mesh_lib.shard_params(mesh, head, lambda p, s: head_param_pspec(p, s, mesh))


def init_composed_train_state(params, tx, *, mesh, axis: str = "pp"):
    """``init_pp_train_state`` with the stages' layers also split over fsdp
    and model, and the head by its rule (``composed.py:109-125``)."""
    state = {"stacked": _fresh(shard_stacked(mesh, stack_layers(params), axis)),
             "head": _fresh(shard_head(mesh, {k: v for k, v in params.items()
                                              if k != "layers"})),
             "step": 0}
    state["opt_state"] = tx(_named_trainable(state))
    return state


def make_composed_train_step(cfg, *, mesh, axis: str = "pp", n_micro: Optional[int] = None,
                             loss_chunk: Optional[int] = None):
    """The text train step on the four-axis mesh: the pipeline's step, whose
    layers run on each rank's shards (``composed.py:128-135``)."""
    return make_pp_train_step(cfg, mesh=mesh, axis=axis, n_micro=n_micro,
                              loss_chunk=loss_chunk)


def composed_batch(mesh, batch):
    """This rank's rows of a global batch: dim 0 over data x fsdp, whole over
    model and pp (``composed.py:204-207``)."""
    return mesh_lib.shard_batch(mesh, batch)


# ----------------------------------------------------------------------------
# The multimodal step
# ----------------------------------------------------------------------------

def init_composed_mm_train_state(params, tx, *, mesh, axis: str = "pp"):
    """The composed state of the full SliME tree (``composed.py:236-258``):
    the decoder's layers stacked and split ``("pp", *rule)``, the LLM head
    and the vision stack (tower, projector, sampler) by their rules, whole
    over pp; ``tx`` over all of them."""
    llm = params["llm"]
    vis = {k: v for k, v in params.items() if k != "llm"}
    state = {"stacked": _fresh(shard_stacked(mesh, stack_layers(llm), axis)),
             "head": _fresh(shard_head(mesh, {k: v for k, v in llm.items()
                                              if k != "layers"})),
             "vision": _fresh(mesh_lib.shard_params(mesh, vis)),
             "step": 0}
    state["opt_state"] = tx(_named_trainable(state))
    return state


def _my_rows(mesh, axis: str, rows: int) -> slice:
    """This stage's block of the rank's rows for the encode (all of them
    where the stages do not divide them)."""
    n, p = mesh.axis_size(axis), mesh.index(axis)
    if rows % n:
        return slice(0, rows)
    per = rows // n
    return slice(p * per, (p + 1) * per)


def make_composed_mm_train_step(cfg, *, mesh, axis: str = "pp",
                                n_micro: Optional[int] = None,
                                loss_chunk: Optional[int] = None,
                                compute_dtype=torch.bfloat16, remat: bool = False):
    """Multimodal composed train step (``composed.py:261-320``): pixels ->
    the tower (checkpointed per block, as JAX) -> gated projector and local
    compression -> text-guided selection -> the splice -> the wavefront ->
    chunked CE. Returns step(state, batch, generator=None, noise=None) ->
    (state, metrics); ``batch`` is this rank's (data, fsdp) rows of
    ``input_ids``, ``attention_mask``, ``pixel_values`` [B, MC, 3, t, t],
    ``crop_mask`` and ``labels`` (``composed_batch``), ``noise`` the same
    rows of the training noise. The fused length is
    ``cfg.tokenizer_model_max_length``; ``remat`` checkpoints each decoder
    layer. The optimizer is the state's (``init_composed_mm_train_state``)."""
    chunk = DEFAULT_LOSS_CHUNK if loss_chunk is None else loss_chunk
    llm = cfg.llm

    def step(state, batch, generator=None, noise=None):
        head = state["head"]
        params = {**state["vision"], "llm": head}
        B, n = batch["input_ids"].shape[0], mesh.axis_size(axis)
        mine = _my_rows(mesh, axis, B)
        sub = {k: v[mine] for k, v in batch.items()}
        sub_noise = None if noise is None else {k: v[mine] for k, v in noise.items()}
        with fp32_accumulation(), mesh_lib.use_mesh(mesh):
            fused = slime.prepare_multimodal(
                params, cfg, sub["input_ids"], sub["attention_mask"], sub["pixel_values"],
                sub["crop_mask"], sub["labels"], training=True, generator=generator,
                noise=sub_noise, compute_dtype=compute_dtype, remat=True)
            token = _token(fused.embeds.device)
            embeds, labels = fused.embeds, fused.labels
            if n > 1 and B % n == 0:       # each stage encoded its block
                group = mesh.group(axis)
                embeds, token = _GatherRows.apply(embeds, token, group)
                labels = _all_gather(labels.contiguous(), 0, group)
            x, rows = _hidden_rows(state["stacked"], embeds, llm, mesh=mesh, axis=axis,
                                   n_micro=n_micro, positions=None, remat=remat, scatter=True,
                                   token=token)
            x = L.rms_norm(head["norm"], x, eps=llm.rms_norm_eps)
            loss = _token_loss(x, head["lm_head"], labels[rows], chunk)
            loss.backward()
            return _finish(state, mesh, loss)

    return step


# ----------------------------------------------------------------------------
# The shape-only check
# ----------------------------------------------------------------------------

def abstract_params(cfg, mm: bool = False):
    """Every leaf of ``llama.init`` (``slime.init`` with ``mm``) on the meta
    device: shapes, no storage (JAX's ``jax.eval_shape`` of the init)."""
    init = slime.init if mm else llama.init
    return init(cfg, generator=None, device="meta")


def check_composed(cfg, *, n_data: int = 1, n_fsdp: int = 8, n_model: int = 4,
                   n_pp: int = 4, batch: int = 32, seq: int = 2048,
                   n_micro: Optional[int] = None, mm: bool = False) -> int:
    """Shape-only check of the composed train step of ``cfg`` (an LLMConfig,
    or a SliMEConfig with ``mm``) on an (n_data, n_fsdp, n_model, n_pp)
    mesh, in the role of JAX's ``lower_composed_abstract`` /
    ``lower_composed_mm_abstract`` (``composed.py:138``, ``:323``): every
    leaf is built on the ``meta`` device (nothing allocated, no process
    group), rank 0's shard of each is taken by the composed specs, and it
    raises where JAX's trace would: layers that the stages do not divide, a
    batch that data x fsdp or n_micro (default min(batch, 2 n_pp)) do not
    divide. Returns rank 0's parameter bytes in bf16, which equal
    ``memory_plan.plan(...).params`` (``plan_mm`` with ``mm``). ``seq`` is
    the text length (the fused length of the multimodal step is
    ``cfg.tokenizer_model_max_length``)."""
    llm = cfg.llm if mm else cfg
    if llm.num_layers % n_pp:
        raise ValueError(f"composed: {llm.num_layers} layers do not split over {n_pp} stages")
    if batch % (n_data * n_fsdp):
        raise ValueError(f"composed: a batch of {batch} rows does not split over data x "
                         f"fsdp = {n_data * n_fsdp}")
    n_micro = min(batch, 2 * n_pp) if n_micro is None else n_micro
    if batch % n_micro:
        raise ValueError(f"composed: a batch of {batch} rows does not split into "
                         f"{n_micro} micro-batches")
    del seq
    mesh = mesh_lib.Mesh(n_data, n_fsdp, n_model, rank=0, device="meta", n_pp=n_pp)
    params = abstract_params(cfg, mm)
    tree = params["llm"] if mm else params
    parts = [(stack_layers(tree), lambda p, s: stacked_param_pspec(p, s, mesh)),
             ({k: v for k, v in tree.items() if k != "layers"},
              lambda p, s: head_param_pspec(p, s, mesh))]
    if mm:
        parts.append(({k: v for k, v in params.items() if k != "llm"},
                      lambda p, s: mesh_lib.param_pspec(p, s, mesh)))
    held = 0
    for sub, spec_fn in parts:
        for path, leaf in named_leaves(sub):
            spec = spec_fn(path, leaf.shape)
            for d, ax in enumerate(spec):
                for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                    if leaf.shape[d] % mesh.axis_size(a):
                        raise ValueError(f"composed: {path} {tuple(leaf.shape)}: dim {d} "
                                         f"does not split over {a} = {mesh.axis_size(a)}")
            held += mesh_lib.local_shard(leaf, spec, mesh).numel() * 2    # bf16
    return held
