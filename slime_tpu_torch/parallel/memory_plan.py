"""Per-rank memory accounting for composed-parallel training, and the
gradient accumulator's memory check.

Port of ``slime_tpu/parallel/memory_plan.py``: ``plan`` / ``plan_mm`` /
``fit_table`` answer which (data, fsdp, model, pp) mesh fits a full-parameter
step of a config, and ``grad_accum_bytes`` / ``check_grad_accum_fit`` refuse
an accumulation window that provably cannot fit.

Parameter, gradient and optimizer bytes are exact: the param tree is built
on the ``meta`` device (``llama.init`` / ``slime.init`` with no storage, in
the role of ``jax.eval_shape``), every leaf gets its spec from the port's
rule table (``parallel.mesh``) and ``composed.stacked_param_pspec``, and
local bytes are summed with the divisibility rule (a dim an axis does not
divide stays whole on it, as at run time). The byte arithmetic is JAX's,
integers included, so every field equals JAX's plan.

Activation bytes are JAX's documented model of its GPipe wavefront with
per-layer remat, kept as it is (the port's wavefront skips the inactive
steps and keeps no ``outs`` accumulator on the other stages, so the model
is an upper bound for it):
  - each in-flight microbatch stashes its stage-INPUT per layer for backward
    (full per-layer remat: only layer boundaries are saved),
  - the wavefront holds <= n_stages microbatches in flight,
  - the wavefront's ``outs`` accumulator ([n_micro, Bm, S, H] per stage) and
    its ppermute double buffer are counted explicitly,
  - attention internals are recomputed (flash attention), so the per-layer
    working set is O(Bm*S*H) not O(Bm*S^2),
  - the loss is the CHUNKED cross entropy the step actually runs
    (ops/loss.py, default DEFAULT_LOSS_CHUNK — the same constant this plan
    defaults to): peak logits are one [B, chunk, V/model] fp32 block, counted
    2x for the softmax/backward temporary that lives alongside it.

There is no default budget: ``MemoryPlan.fits`` reads the card's total
memory (``torch.cuda.mem_get_info``) or takes ``hbm_bytes``. Accumulation
(``train.optim.MultiSteps``) holds one fp32 copy of every trainable leaf
for the whole window; ``check_grad_accum_fit`` refuses a run whose
accumulator cannot fit next to what the card already holds, before the first
step (with no card and no explicit budget it is skipped, as JAX skips it
without device statistics).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.loss import DEFAULT_LOSS_CHUNK
from ..params import named_leaves
from . import composed
from .mesh import param_pspec


def _local_bytes(shape, spec, axis_sizes: Dict[str, int], itemsize: int) -> int:
    n = int(np.prod(shape)) if shape else 1
    denom = 1
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        for a in axes:
            size = axis_sizes.get(a, 1)
            if size > 1 and shape[d] % size == 0:
                denom *= size
    return n * itemsize // denom


@dataclass
class MemoryPlan:
    params: int
    grads: int
    opt_moments: int
    master_params: int
    activations: int
    logits: int
    total: int
    n_params: int
    per_category_gb: Dict[str, float]
    # the accumulator of MultiSteps (params-shaped fp32, sharded like the
    # grads); 0 unless grad_accum_steps > 1
    grad_accum: int = 0

    def fits(self, hbm_bytes: Optional[int] = None, headroom: float = 0.9) -> bool:
        """``total`` within ``headroom`` of ``hbm_bytes``, by default the
        current card's total memory; raises without a card and a budget."""
        if hbm_bytes is None:
            if not torch.cuda.is_available():
                raise RuntimeError("MemoryPlan.fits: no card to read the memory of; pass "
                                   "hbm_bytes")
            hbm_bytes = torch.cuda.mem_get_info()[1]
        return self.total <= hbm_bytes * headroom


def _abstract(cfg, mm: bool = False):
    """The param tree on the meta device with one decoder layer: the plan
    reads layer 0's shapes only (every layer has them)."""
    if mm:
        return composed.abstract_params(
            dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=1)), mm)
    return composed.abstract_params(dataclasses.replace(cfg, num_layers=1))


def plan(cfg, *, n_data: int = 1, n_fsdp: int = 1, n_model: int = 1,
         n_pp: int = 1, batch: int = 8, seq: int = 2048,
         param_bytes: int = 2, opt_bytes: int = 4, master_fp32: bool = True,
         n_micro: Optional[int] = None, loss_chunk: Optional[int] = "default",
         grad_accum_steps: int = 1) -> MemoryPlan:
    """Bytes a rank holds for one training step of ``cfg`` (an LLMConfig) on
    the given mesh (``memory_plan.py:74-191``).

    param_bytes=2 (bf16 weights), opt_bytes=4 (fp32 Adam m+v), master_fp32
    adds an fp32 weight copy; grads at param precision, sharded as the
    params. grad_accum_steps > 1 adds the accumulator (one params-shaped
    fp32 tree, not amortized by the window). loss_chunk defaults to
    ``ops.loss.DEFAULT_LOSS_CHUNK``, the pipeline step's own; None models a
    dense loss."""
    if loss_chunk == "default":
        loss_chunk = DEFAULT_LOSS_CHUNK

    axis_sizes = {"data": n_data, "fsdp": n_fsdp, "model": n_model, "pp": n_pp}
    abstract = _abstract(cfg)

    # stacked layers: [L, ...] leaves with ("pp", <rule dims>)
    L = cfg.num_layers
    stacked_bytes = 0
    n_layer_params = 0
    for path, leaf in named_leaves(abstract["layers"][0]):
        shape = (L,) + tuple(leaf.shape)
        inner = composed._rule_spec("llm/layers/0/" + path, shape[1:], axis_sizes)
        spec = ("pp",) + tuple(inner)
        stacked_bytes += _local_bytes(shape, spec, axis_sizes, param_bytes)
        n_layer_params += int(np.prod(shape))

    head_bytes = 0
    n_head_params = 0
    head = {"llm": {k: v for k, v in abstract.items() if k != "layers"}}
    for path, leaf in named_leaves(head):
        shape = tuple(leaf.shape)
        spec = param_pspec(path, shape, axis_sizes)
        head_bytes += _local_bytes(shape, spec, axis_sizes, param_bytes)
        n_head_params += int(np.prod(shape))

    params_local = stacked_bytes + head_bytes
    n_params = n_layer_params + n_head_params
    grads_local = params_local
    # Adam m+v at opt precision: same sharding, scaled byte width
    opt_local = 2 * params_local * opt_bytes // param_bytes
    master_local = params_local * 4 // param_bytes if master_fp32 else 0
    # the fp32 accumulator: grads sharding, fp32 width
    accum_local = (params_local * 4 // param_bytes
                   if grad_accum_steps > 1 else 0)

    # --- activations (GPipe + per-layer remat) ---
    H = cfg.hidden_size
    n_micro = n_micro or 2 * n_pp
    Bm = max(batch // n_micro, 1)
    S_local = seq  # sequence not sharded in the pp train step
    B_local = max(Bm // (n_data * n_fsdp), 1)
    layers_per_stage = cfg.num_layers // max(n_pp, 1)
    in_flight = min(n_micro, n_pp) if n_pp > 1 else 1
    act_dtype = 2  # bf16 activations
    # stashed layer inputs for backward + one layer's recompute working set
    # (~4x the layer input for attention qkv + mlp intermediates, sharded
    # over model)
    stash = in_flight * layers_per_stage * B_local * S_local * H * act_dtype
    working = 8 * B_local * S_local * max(H, cfg.intermediate_size // max(n_model, 1)) * act_dtype
    # the wavefront's outs accumulator [n_micro, Bm, S, H] per stage + the
    # ppermute in/out double buffer [Bm, S, H]
    outs_buf = n_micro * B_local * S_local * H * act_dtype
    ppermute_buf = 2 * B_local * S_local * H * act_dtype
    act_local = stash + working + outs_buf + ppermute_buf

    # --- loss head (chunked CE, ops/loss.py) ---
    # one [B_loss, chunk, V/model] fp32 logits block live at a time; 2x for
    # the logsumexp/softmax-grad temporary next to it during backward remat
    S_loss = loss_chunk or seq
    logits_local = 2 * (max(batch // (n_data * n_fsdp), 1) * S_loss
                        * cfg.vocab_size // max(n_model, 1) * 4)

    total = (params_local + grads_local + opt_local + master_local
             + accum_local + act_local + logits_local)
    gb = 2.0 ** 30
    cats = {
        "params": round(params_local / gb, 2),
        "grads": round(grads_local / gb, 2),
        "opt_moments": round(opt_local / gb, 2),
        "master_params": round(master_local / gb, 2),
        "activations": round(act_local / gb, 2),
        "logits": round(logits_local / gb, 2),
        "total": round(total / gb, 2),
    }
    if accum_local:
        cats["grad_accum"] = round(accum_local / gb, 2)
    return MemoryPlan(
        params=params_local, grads=grads_local, opt_moments=opt_local,
        master_params=master_local, activations=act_local,
        logits=logits_local, total=total, n_params=n_params,
        per_category_gb=cats, grad_accum=accum_local)


def fit_table(cfg, meshes, **kw):
    """[(mesh_dict, MemoryPlan)] for candidate meshes (``memory_plan.py:266``)."""
    return [(m, plan(cfg, **m, **kw)) for m in meshes]


def plan_mm(cfg, *, n_data: int = 1, n_fsdp: int = 1, n_model: int = 1,
            n_pp: int = 1, batch: int = 8, seq: Optional[int] = None,
            param_bytes: int = 2, opt_bytes: int = 4, master_fp32: bool = True,
            n_micro: Optional[int] = None, loss_chunk: Optional[int] = "default",
            grad_accum_steps: int = 1) -> MemoryPlan:
    """MemoryPlan of the full SliME model (tower, projector, sampler, the
    splice, the pipelined decoder) under ``composed.make_composed_mm_train_
    step`` (``memory_plan.py:274-361``). cfg is a SliMEConfig. On top of
    ``plan`` over cfg.llm at the fused length (seq defaults to
    ``cfg.tokenizer_model_max_length``): the vision stack's state with its
    rule specs over fsdp and model, whole over pp, and its activations as
    JAX models them: the crop batch over data x fsdp x pp, one block input a
    layer stashed (per-block remat) plus one block's recompute working set
    (attention probabilities included), plus the splice buffers."""
    fused_seq = seq if seq is not None else cfg.tokenizer_model_max_length
    base = plan(cfg.llm, n_data=n_data, n_fsdp=n_fsdp, n_model=n_model,
                n_pp=n_pp, batch=batch, seq=fused_seq, param_bytes=param_bytes,
                opt_bytes=opt_bytes, master_fp32=master_fp32, n_micro=n_micro,
                loss_chunk=loss_chunk, grad_accum_steps=grad_accum_steps)

    axis_sizes = {"data": n_data, "fsdp": n_fsdp, "model": n_model, "pp": n_pp}
    abstract = _abstract(cfg, mm=True)
    vis = {k: v for k, v in abstract.items() if k != "llm"}

    vis_bytes = 0
    n_vis_params = 0
    for path, leaf in named_leaves(vis):
        spec = param_pspec(path, leaf.shape, axis_sizes)
        vis_bytes += _local_bytes(tuple(leaf.shape), spec, axis_sizes, param_bytes)
        n_vis_params += int(np.prod(leaf.shape)) if leaf.dim() else 1

    vis_grads = vis_bytes
    vis_opt = 2 * vis_bytes * opt_bytes // param_bytes
    vis_master = vis_bytes * 4 // param_bytes if master_fp32 else 0
    vis_accum = (vis_bytes * 4 // param_bytes if grad_accum_steps > 1 else 0)

    # --- vision activations ---
    vc = cfg.vision
    MC = 1 + cfg.max_local_crops
    crops_local = max(batch * MC // (n_data * n_fsdp * n_pp), 1)
    S_vis = vc.num_patches + 1                       # +CLS
    E = vc.hidden_size
    n_blocks = (vc.num_layers + vc.select_layer + 1 if vc.select_layer < 0
                else vc.select_layer)
    act = 2  # bf16
    stash = n_blocks * crops_local * S_vis * E * act
    heads_local = max(vc.num_heads // max(n_model, 1), 1)
    working = crops_local * S_vis * (
        4 * E + max(E, vc.intermediate_size // max(n_model, 1))) * act \
        + crops_local * heads_local * S_vis * S_vis * act
    # splice buffers: text+image embeds and the fused output, batch over
    # data x fsdp (the fused sequence is whole over pp for the wavefront)
    B_loc = max(batch // (n_data * n_fsdp), 1)
    fused_buf = 3 * B_loc * fused_seq * cfg.llm.hidden_size * act
    vis_acts = stash + working + fused_buf

    gb = 2.0 ** 30
    total = (base.total + vis_bytes + vis_grads + vis_opt + vis_master
             + vis_accum + vis_acts)
    cats = dict(base.per_category_gb)
    cats["vision_state"] = round(
        (vis_bytes + vis_grads + vis_opt + vis_master + vis_accum) / gb, 2)
    cats["vision_acts"] = round(vis_acts / gb, 2)
    cats["total"] = round(total / gb, 2)
    return MemoryPlan(
        params=base.params + vis_bytes, grads=base.grads + vis_grads,
        opt_moments=base.opt_moments + vis_opt,
        master_params=base.master_params + vis_master,
        activations=base.activations + vis_acts, logits=base.logits,
        total=total, n_params=base.n_params + n_vis_params,
        per_category_gb=cats, grad_accum=base.grad_accum + vis_accum)


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
