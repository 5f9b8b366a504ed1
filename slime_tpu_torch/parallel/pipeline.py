"""Pipeline parallelism: the GPipe wavefront over the ``pp`` axis as
point-to-point sends.

Port of ``slime_tpu/parallel/pipeline.py``. The decoder's layers are stacked
(``stack_layers``) and split over the ``pp`` axis of a ``parallel.mesh``
mesh: stage d holds layers [d L/n, (d + 1) L/n). Micro-batches flow from
stage to stage. JAX writes the schedule as a ``lax.scan`` of n_micro + n - 1
steps with a ``ppermute`` rotation and lets ``jax.grad`` transpose it; one
process per card writes the same wavefront with sends:

- at step t stage d runs micro-batch t - d through its layers (each one
  ``llama._layer_prefill``, so the flash kernels and the Megatron pairs of
  an active mesh run as in ``llama.forward``; ``remat`` checkpoints each
  layer) and sends the result to stage d + 1 (``dist.isend`` / ``irecv`` on
  the ``pp`` group). The steps where a stage has no micro-batch are skipped,
  where JAX computes and discards them: the values are the same;
- the sends are ``torch.autograd.Function`` s whose backward is the reverse
  send (ppermute's transpose), so the backward is the reverse wavefront. A
  0-d token threads every send and receive of a rank, in the order they
  were posted, into the output: the backward runs them in exactly the
  reverse order on every stage, so the two sides of each pair always meet;
- the last stage's rows are then spread over the stages (JAX pins them to
  the batch axes (data, fsdp, pp) before the final norm, ``:119-126``):
  ``pipeline_forward`` gives every stage all of them (its return is JAX's
  for this rank's rows), the train step gives each stage its own block of
  rows, whose norm, head and loss it computes.

``embeds`` are this rank's rows of the batch (all of them on a mesh without
data or fsdp ranks, ``mesh.shard_batch``'s otherwise). Its micro-batches
are the largest split of those rows into at most ``n_micro`` equal parts
(all n_micro where they divide): JAX's micro-batches cut the global batch,
which GSPMD then lays over the batch axes; each row's values are the same.

The train step (``make_pp_train_step``) takes the place of JAX's optax
transform with ``tx``, a function of the trainable leaves that returns
their optimizer (``train.optim.adamw``). Its loss is the mean over every
valid token of the global batch (each rank's sum and count reduced over
(data, fsdp, pp)); the head (embedding, final norm, ``lm_head``) is held by
every stage and its gradients are summed over ``pp``
(``tensor_parallel.sync_grads``): only stage 0 uses the embedding, each
stage the head on its rows.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..models import layers as L
from ..models import llama
from ..models.layers import fp32_accumulation
from ..ops.loss import DEFAULT_LOSS_CHUNK, chunked_cross_entropy
from ..params import map_leaves, named_leaves
from . import tensor_parallel as tp
from .mesh import SPEC_ATTR, copy_spec, shard_params, spec_of, use_mesh


def stack_layers(params):
    """[L, ...] stacked layer tree from ``params["layers"]`` (a list of
    per-layer trees, or already stacked): the layout the pipeline splits
    over ``pp`` (``llama.stack_layers``'s)."""
    layers = params["layers"]
    return layers if isinstance(layers, dict) else llama.stack_layers(layers)


def unstack_layers(stacked, num_layers: int):
    """Inverse of ``stack_layers`` (``llama.unstack_layers``)."""
    return llama.unstack_layers(stacked, num_layers)


# ----------------------------------------------------------------------------
# The sends, with their gradients
# ----------------------------------------------------------------------------

def _send(t: torch.Tensor, dst: int, group) -> None:
    dist.isend(t.contiguous(), dst, group=group).wait()


def _recv(shape, dtype, device, src: int, group) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.irecv(out, src, group=group).wait()
    return out


class _Send(torch.autograd.Function):
    """Send ``x`` to global rank ``dst``; backward: receive its gradient
    from ``dst``. Returns the next token."""

    @staticmethod
    def forward(ctx, x, token, dst, group):
        ctx.meta = (x.shape, x.dtype, x.device, dst, group)
        _send(x, dst, group)
        return token.clone()

    @staticmethod
    def backward(ctx, gtoken):
        shape, dtype, device, dst, group = ctx.meta
        return _recv(shape, dtype, device, dst, group), gtoken, None, None


class _Recv(torch.autograd.Function):
    """Receive a tensor of ``shape`` from global rank ``src``; backward: send
    its gradient back. Returns (the tensor, the next token)."""

    @staticmethod
    def forward(ctx, token, shape, dtype, src, group):
        ctx.meta = (src, group)
        return _recv(shape, dtype, token.device, src, group), token.clone()

    @staticmethod
    def backward(ctx, g, gtoken):
        src, group = ctx.meta
        _send(g, src, group)
        return gtoken, None, None, None, None


class _Spread(torch.autograd.Function):
    """The last stage's rows ``x`` [B, ...] to every stage of the group:
    stage i gets rows ``parts[i]`` (a slice). Backward: each stage's
    gradient back to the last stage, which adds them into place."""

    @staticmethod
    def forward(ctx, x, token, parts, me, ranks, shape, dtype, group):
        last = len(ranks) - 1
        ctx.meta = (parts, me, ranks, shape, dtype, token.device, group)
        if me != last:
            rows = (parts[me].stop - parts[me].start,) + tuple(shape[1:])
            out = (_recv(rows, dtype, token.device, ranks[last], group) if rows[0]
                   else torch.empty(rows, dtype=dtype, device=token.device))
            return out, token.clone()
        for i, part in enumerate(parts[:last]):
            if part.stop > part.start:
                _send(x[part], ranks[i], group)
        return x[parts[last]].clone(), token.clone()

    @staticmethod
    def backward(ctx, g, gtoken):
        parts, me, ranks, shape, dtype, device, group = ctx.meta
        last = len(ranks) - 1
        if me != last:
            if g.shape[0]:
                _send(g, ranks[last], group)
            return None, gtoken, None, None, None, None, None, None
        full = torch.zeros(shape, dtype=dtype, device=device)
        for i, part in enumerate(parts[:last]):
            if part.stop > part.start:
                full[part] += _recv(full[part].shape, dtype, device, ranks[i], group)
        full[parts[last]] += g
        return full, gtoken, None, None, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over ``group``; backward: reduce-scatter (the
    composed multimodal step's fused embeds, each stage encoding its rows).
    In the token chain so that every stage runs the backward's collective,
    also the stages that do not use the gathered rows."""

    @staticmethod
    def forward(ctx, x, token, group):
        ctx.group = group
        return tp._all_gather(x, 0, group), token.clone()

    @staticmethod
    def backward(ctx, g, gtoken):
        return tp._reduce_scatter(g, 0, ctx.group), gtoken, None


class _Join(torch.autograd.Function):
    """``x`` with the token folded in, so the backward reaches every send."""

    @staticmethod
    def forward(ctx, x, token):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), device=g.device)


def _token(device) -> torch.Tensor:
    return torch.zeros((), device=device, requires_grad=torch.is_grad_enabled())


# ----------------------------------------------------------------------------
# The wavefront
# ----------------------------------------------------------------------------

def _stage_layers(stacked, mesh, axis: str):
    """This stage's [L/n, ...] slice of every stacked leaf: the leaf itself
    where it is stored split over ``axis`` (spec ``(axis, ...)``), else a
    view of its block of a whole [L, ...] leaf."""
    n, d = mesh.axis_size(axis), mesh.index(axis)

    def mine(_, t):
        if not isinstance(t, torch.Tensor) or spec_of(t)[:1] == (axis,):
            return t
        per = t.shape[0] // n
        return t[d * per:(d + 1) * per]
    return map_leaves(mine, stacked)


def _layer_view(stage, i: int):
    """Layer ``i`` of a stage's stacked tree, each leaf a view carrying its
    spec minus the leading stage entry, so ``tensor_parallel.llm_layer``
    splits its pairs as it splits a list layer's."""
    def pick(node):
        if isinstance(node, dict):
            return {k: pick(v) for k, v in node.items()}
        v = node[i]
        spec = spec_of(node)
        if spec:
            setattr(v, SPEC_ATTR, tuple(spec[1:]))
        return v
    return pick(stage)


def _check(mesh, axis: str, rows: int, cfg, n_micro: Optional[int]) -> int:
    """JAX's asserts (``pipeline.py:67``, ``:70``) on the global batch ->
    n_micro (default min(B, 2 n))."""
    n = mesh.axis_size(axis)
    B = rows * mesh.axis_size("dp")
    if n_micro is None:
        n_micro = min(B, 2 * n)
    if n_micro < 1 or B % n_micro:
        raise ValueError(f"pipeline: the batch of {B} rows does not split into "
                         f"{n_micro} micro-batches")
    if cfg.num_layers % n:
        raise ValueError(f"pipeline: {cfg.num_layers} layers do not split over "
                         f"{n} stages")
    return n_micro


def _wavefront(stacked, embeds, cfg, *, mesh, axis, n_micro, positions, remat, token):
    """The wavefront on this stage -> (the last stage's output rows [B, S,
    H], None on the other stages; the token). ``embeds`` are read on stage 0
    only."""
    n, d = mesh.axis_size(axis), mesh.index(axis)
    group = mesh.group(axis)
    B, S, H = embeds.shape
    dtype, dev = embeds.dtype, embeds.device
    M = math.gcd(B, n_micro)      # the most micro-batches <= n_micro that split B
    Bm = B // M
    stage = _stage_layers(stacked, mesh, axis)
    per = cfg.num_layers // n
    cos, sin = llama.rope_table(cfg, cfg.max_position_embeddings, dev)
    if positions is None:
        cos_s, sin_s = cos[:S], sin[:S]
    else:
        cos_s, sin_s = cos[positions.long()], sin[positions.long()]
    remat = remat and torch.is_grad_enabled()

    def run_stage(x, rows):
        c, s = (cos_s, sin_s) if cos_s.dim() == 2 else (cos_s[rows], sin_s[rows])
        for i in range(per):
            args = (_layer_view(stage, i), x, c, s, cfg)
            if remat:
                x, _, _ = checkpoint(llama._layer_prefill, *args, use_reentrant=False)
            else:
                x, _, _ = llama._layer_prefill(*args)
        return x

    outs = []
    for t in range(M + n - 1):
        mb = t - d
        if not 0 <= mb < M:
            continue                       # JAX computes and discards this step
        rows = slice(mb * Bm, (mb + 1) * Bm)
        if d == 0:
            x = embeds[rows]
        else:
            x, token = _Recv.apply(token, (Bm, S, H), dtype, mesh.rank_at(axis, d - 1), group)
        x = run_stage(x, rows)
        if d < n - 1:
            token = _Send.apply(x, token, mesh.rank_at(axis, d + 1), group)
        else:
            outs.append(x)
    return (torch.cat(outs) if outs else None), token


def _spread(x, token, mesh, axis, shape, dtype, parts):
    """The last stage's rows over the stages (``_Spread``); one stage: x."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x[parts[0]], token
    ranks = [mesh.rank_at(axis, i) for i in range(n)]
    return _Spread.apply(x, token, parts, mesh.index(axis), ranks, tuple(shape), dtype,
                         mesh.group(axis))


def _row_blocks(rows: int, n: int):
    """Stage i's block of ``rows`` rows (equal blocks where n divides them,
    else as near equal as they go, the first ones a row longer)."""
    base, extra = divmod(rows, n)
    starts = [i * base + min(i, extra) for i in range(n + 1)]
    return [slice(starts[i], starts[i + 1]) for i in range(n)]


def _hidden_rows(stacked, embeds, cfg, *, mesh, axis, n_micro, positions, remat,
                 scatter: bool, token=None):
    """The wavefront, then the last stage's rows spread -> (this stage's
    rows of the decoder's output (all of them unless ``scatter``), their
    slice of the batch)."""
    B, S, H = embeds.shape
    n_micro = _check(mesh, axis, B, cfg, n_micro)
    if token is None:
        token = _token(embeds.device)
    x, token = _wavefront(stacked, embeds, cfg, mesh=mesh, axis=axis, n_micro=n_micro,
                          positions=positions, remat=remat, token=token)
    n = mesh.axis_size(axis)
    parts = _row_blocks(B, n) if scatter else [slice(0, B)] * n
    x, token = _spread(x, token, mesh, axis, (B, S, H), embeds.dtype, parts)
    mine = parts[mesh.index(axis)]
    return _Join.apply(x, token), mine


def pipeline_forward(params, embeds, cfg, *, mesh, axis: str = "pp",
                     n_micro: Optional[int] = None, positions=None, stacked=None,
                     return_hidden: bool = False):
    """Decoder forward with the layers pipelined over ``axis`` of ``mesh``
    (``pipeline.py:50-133``). ``embeds`` [B, S, H]: this rank's rows (read
    on stage 0). Returns on every stage, for those rows, fp32 logits [B, S,
    V] equal up to fp reordering to ``llama.forward``'s, or with
    ``return_hidden`` the final normed hidden states [B, S, H].
    ``stacked`` overrides the stacked layer tree (this stage's [L/n, ...]
    shards, as ``init_pp_train_state`` holds them, or whole [L, ...]
    leaves); ``positions`` [S] or [B, S] (arange when None). Raises where
    JAX asserts: B % n_micro, L % n."""
    if stacked is None:
        stacked = stack_layers(params)
    with use_mesh(mesh):
        x, _ = _hidden_rows(stacked, embeds, cfg, mesh=mesh, axis=axis, n_micro=n_micro,
                            positions=positions, remat=False, scatter=False)
        x = L.rms_norm(params["norm"], x, eps=cfg.rms_norm_eps)
        return x if return_hidden else llama._lm_head(params, x)


# ----------------------------------------------------------------------------
# The train step
# ----------------------------------------------------------------------------

def _fresh(tree):
    """Trainable copies: each leaf detached, cloned, requiring grad, its spec
    kept."""
    return map_leaves(lambda _, t: copy_spec(t.detach().clone().requires_grad_(True), t), tree)


def init_pp_train_state(params, tx, *, mesh, axis: str = "pp"):
    """-> {"stacked", "head", "opt_state", "step"} (``pipeline.py:186-199``):
    this stage's block of the stacked layers (spec ``(axis,)``), the head
    (embedding, norm, lm_head) whole on every stage, and ``tx`` over both
    (the optimizer, holding its moments beside each leaf)."""
    stacked = stack_layers(params)
    _check_layers(stacked, mesh, axis)
    stacked = shard_params(mesh, stacked, lambda path, shape: (axis,))
    head = shard_params(mesh, {k: v for k, v in params.items() if k != "layers"},
                        lambda path, shape: ())
    state = {"stacked": _fresh(stacked), "head": _fresh(head), "step": 0}
    state["opt_state"] = tx(_named_trainable(state))
    return state


def _check_layers(stacked, mesh, axis: str) -> None:
    n_layers = next(t for _, t in named_leaves(stacked) if isinstance(t, torch.Tensor)).shape[0]
    if n_layers % mesh.axis_size(axis):
        raise ValueError(f"pipeline: {n_layers} layers do not split over "
                         f"{mesh.axis_size(axis)} stages")


def _named_trainable(state, keys=("stacked", "head", "vision")):
    return [(f"{k}/{p}", t) for k in keys if k in state
            for p, t in named_leaves(state[k]) if isinstance(t, torch.Tensor)]


def _finish(state, mesh, loss):
    """The backward's end: every trainable leaf a gradient (zeros where this
    stage used none, so every rank joins the same reductions), the sums over
    the batch axes and ``pp``, the optimizer step."""
    leaves = [t for _, t in _named_trainable(state)]
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    tp.sync_grads(leaves)
    gnorm = state["opt_state"].step()
    state["step"] += 1
    return state, {"loss": loss.detach(), "grad_norm": gnorm}


def _token_loss(x, head, labels, chunk):
    """Mean next-token NLL over every valid token of the global batch: this
    rank's sum and count over its rows, reduced over (data, fsdp, pp)."""
    total, count = chunked_cross_entropy(x, head, labels, chunk=chunk)
    total, count = tp.reduce_batch(total), tp.reduce_batch(count)
    return total / torch.clamp(count, min=1)


def make_pp_train_step(cfg, *, mesh, axis: str = "pp", n_micro: Optional[int] = None,
                       loss_chunk: Optional[int] = None):
    """Pipeline-parallel LLM train step, text only (``pipeline.py:136-183``):
    next-token cross entropy through the wavefront, the vocab projection
    chunked over ``loss_chunk`` positions (None: ``DEFAULT_LOSS_CHUNK``, as
    JAX). Returns step(state, batch) -> (state, metrics {"loss",
    "grad_norm"}); ``batch`` holds this rank's rows of ``input_ids`` and
    ``labels``; the state comes from ``init_pp_train_state`` and holds the
    optimizer ``tx`` built there (JAX passes ``tx`` to both). The forward
    and backward run under ``layers.fp32_accumulation``, as the port's other
    steps."""
    chunk = DEFAULT_LOSS_CHUNK if loss_chunk is None else loss_chunk

    def step(state, batch):
        head = state["head"]
        ids, labels = batch["input_ids"], batch["labels"]
        with fp32_accumulation(), use_mesh(mesh):
            if mesh.index(axis) == 0:
                embeds = llama.embed(head, ids)
            else:                          # read on stage 0 only
                embeds = torch.empty(ids.shape + (cfg.hidden_size,),
                                     dtype=head["embed_tokens"].dtype, device=ids.device)
            x, rows = _hidden_rows(state["stacked"], embeds, cfg, mesh=mesh, axis=axis,
                                   n_micro=n_micro, positions=None, remat=False, scatter=True)
            x = L.rms_norm(head["norm"], x, eps=cfg.rms_norm_eps)
            loss = _token_loss(x, head["lm_head"], labels[rows], chunk)
            loss.backward()
            return _finish(state, mesh, loss)

    return step

