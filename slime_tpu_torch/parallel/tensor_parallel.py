"""The collectives a mesh needs, with their gradients, and the per-layer
views of sharded parameters.

JAX writes a sharding and lets XLA insert the collectives; one process per
card writes them itself. Under an active mesh (``parallel.mesh.active``):

- a leaf split over ``fsdp`` is all-gathered where it is used
  (``whole`` / ``fsdp_whole``); the gather's backward is a reduce-scatter,
  so each rank's gradient is the sum over the fsdp ranks of its shard;
- the Megatron pairs (q/k/v -> o, gate/up -> down, the experts' w1/w3 ->
  w2, the tower's q/k/v -> out_proj and fc1 -> fc2) run on this rank's
  heads and neurons: the column side takes its rows of the weight
  (``linear_view(p, "col")``), the row side its columns
  (``linear_view(p, "row")``), and one ``all_reduce`` over ``model`` ends
  the pair (``project_out``). The input of the column side passes through
  ``enter`` (identity forward, all-reduce backward), the pair's output
  through the all-reduce (identity backward), Megatron's f and g;
- a pair whose row side cannot be split (a q4g / grouped scale whose groups
  do not divide, or the W8A8 tower's K8, which quantizes each activation
  row by its max over the whole input) gathers its input over ``model``
  and runs the whole row-side weight instead (``project_out(..., "gather")``);
- a pair whose heads or neurons the model axis does not divide runs whole
  on every rank ("none"): its leaves are gathered;
- the embedding and ``lm_head`` are vocab-parallel: a masked lookup of the
  local rows then an all-reduce; the local vocab slice of the logits then
  an all-gather (``head_view`` / ``gather_model``), or, in the loss, the
  log-sum-exp and the target's logit reduced over ``model``
  (``vocab_nll``) with no gather at all;
- every other sharded leaf is gathered whole where it is used.

A leaf that is stored whole (stacked layers, pruned specs) is sliced where a
shard of it is used; the slice's backward all-gathers, so every model rank
holds the whole gradient of a whole leaf. Gradients of leaves not split over
``fsdp`` are all-reduced over ``dp`` after the backward (``sync_grads``), of
fsdp-split ones over ``data``; ``global_sq_norm`` sums squares with each
leaf counted once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import active, spec_of

# ----------------------------------------------------------------------------
# Raw collectives (a None group is a mesh of one process: identity)
# ----------------------------------------------------------------------------


def _n(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group is None:
        return t
    n = _n(group)
    dim = dim % t.dim()
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group is None:
        return t
    n = _n(group)
    dim = dim % t.dim()
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if group is None:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _own(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    if group is None:
        return t
    n = _n(group)
    size = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _GatherSum(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter (the ranks hold
    different data, so their gradients of the whole tensor add)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _GatherOwn(torch.autograd.Function):
    """All-gather along ``dim``; backward: this rank's block (every rank
    computed the same gradient of the whole tensor)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.group), None, None


class _SliceGather(torch.autograd.Function):
    """This rank's block along ``dim``; backward: all-gather (so each rank
    holds the whole gradient of the whole tensor)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


class _CopyIn(torch.autograd.Function):
    """Identity; backward: all-reduce (Megatron's f)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """All-reduce; backward: identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _group(axis: str):
    mesh = active()
    return None if mesh is None else mesh.group(axis)


def gather_whole(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor of a shard (no gradient): all-gathered along every
    dim its spec splits."""
    for d, ax in enumerate(spec):
        if ax is not None:
            t = _all_gather(t, d, mesh.group(ax))
    return t


def reduce_model(t):
    """All-reduce over ``model`` (identity backward)."""
    g = _group("model")
    return t if g is None else _ReduceOut.apply(t, g)


def reduce_dp(t):
    """All-reduce over the batch axes (identity backward): a loss term each
    rank computed from its rows becomes the global one, and each rank's
    backward carries its own rows' share."""
    g = _group("dp")
    return t if g is None else _ReduceOut.apply(t, g)


def reduce_batch(t):
    """``reduce_dp`` over (data, fsdp, pp): the composed steps spread their
    rows over the pipeline stages too."""
    g = _group("batch")
    return t if g is None else _ReduceOut.apply(t, g)


def max_model(t):
    """All-reduce max over ``model``, no gradient."""
    return _all_reduce(t.detach(), _group("model"), dist.ReduceOp.MAX)


def enter(t, tp: bool = True):
    """The input of a column-parallel projection (all-reduce backward)."""
    g = _group("model")
    return t if (g is None or not tp) else _CopyIn.apply(t, g)


def gather_model(t, dim: int = -1):
    """All-gather over ``model`` along ``dim``; backward: this rank's block."""
    g = _group("model")
    return t if g is None else _GatherOwn.apply(t, dim, g)


# ----------------------------------------------------------------------------
# Leaf views
# ----------------------------------------------------------------------------

def fsdp_whole(t):
    """``t`` gathered along the dims its spec puts on ``fsdp``."""
    mesh = active()
    if mesh is None or not isinstance(t, torch.Tensor):
        return t
    for d, ax in enumerate(spec_of(t)):
        if ax == "fsdp":
            t = _GatherSum.apply(t, d, mesh.group("fsdp"))
    return t


def whole(t):
    """The whole tensor of a leaf: gathered over every axis its spec splits
    (fsdp: reduce-scatter backward; model: own-block backward)."""
    mesh = active()
    if mesh is None or not isinstance(t, torch.Tensor):
        return t
    spec = spec_of(t)
    for d, ax in enumerate(spec):
        if ax == "fsdp":
            t = _GatherSum.apply(t, d, mesh.group("fsdp"))
        elif ax is not None:
            t = _GatherOwn.apply(t, d, mesh.group(ax))
    return t


def whole_tree(tree):
    if isinstance(tree, dict):
        return {k: whole_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(whole_tree(v) for v in tree)
    return whole(tree)


def model_part(t, dim: int, parts: int = 1):
    """This rank's block along ``dim`` of a leaf (fsdp gathered first): the
    stored shard where the spec puts ``model`` on ``dim``, else a slice of
    the whole leaf (all-gather backward). ``parts`` > 1 splits ``dim`` into
    that many equal blocks first and takes this rank's block of each (the
    packed [3E, E] q/k/v of the tower)."""
    mesh = active()
    if mesh is None:
        return t
    spec = spec_of(t)
    nd = t.dim()
    dim = dim % nd
    if len(spec) > dim and spec[dim] == "model":
        return fsdp_whole(t)
    t = whole(t)
    g = mesh.group("model")
    if g is None or mesh.shape["model"] == 1:
        return t
    if parts == 1:
        return _SliceGather.apply(t, dim, g)
    shape = list(t.shape)
    blocks = t.reshape(shape[:dim] + [parts, shape[dim] // parts] + shape[dim + 1:])
    mine = _SliceGather.apply(blocks, dim + 1, g)
    return mine.reshape(shape[:dim] + [-1] + shape[dim + 1:])


def _weight_view(w, mode: str, parts: int):
    if not isinstance(w, dict):
        return model_part(w, -2 if mode == "col" else -1, parts)
    out = {}
    for k, v in w.items():
        if mode == "col":
            out[k] = model_part(v, -2, parts)
        elif k == "scale" and v.shape[-1] == 1:
            out[k] = whole(v)                       # per-row scales: every column
        else:
            out[k] = model_part(v, -1)
    return out


def linear_view(p, mode: Optional[str], parts: int = 1):
    """A linear's parameters as this rank uses them: ``None`` the whole
    layer; ``"col"`` its rows of the output (weight, scales, bias, the
    adapters' B); ``"row"`` its columns of the input (weight, grouped
    scales, the adapters' A), the bias kept aside as ``"reduce_bias"`` to
    add once after the all-reduce."""
    if mode is None:
        return whole_tree(p)
    out = {"weight": _weight_view(p["weight"], mode, parts)}
    if "bias" in p:
        if mode == "col":
            out["bias"] = model_part(p["bias"], -1, parts)
        else:
            out["reduce_bias"] = whole(p["bias"])
    for key in ("lora", "lora_b"):
        if key in p:
            a, b = whole(p[key]["A"]), whole(p[key]["B"])
            # the factor kept whole meets only this rank's rows of B (col) or
            # columns of x A^T (row): its gradient is summed over ``model``
            if mode == "col":
                a, b = enter(a), model_part(b, -2, parts)
            else:
                a, b = model_part(a, -1), enter(b)
            out[key] = {"A": a, "B": b}
    return out


def row_splits(p, in_dim: int, n: int, w8a8: bool = False) -> bool:
    """True if the row side of a pair can run on 1/n of its input columns:
    the in dim divides, a grouped scale's groups divide, a packed int4
    split falls on a byte (q4g: on a 256-column block of two groups), and
    the weight is not the W8A8 tower's per-row int8 (K8 quantizes each
    activation row over the whole input)."""
    if in_dim % n:
        return False
    w = p["weight"]
    if not isinstance(w, dict):
        return True
    if w8a8 and "q" in w and w["scale"].shape[-1] == 1:
        return False
    local = in_dim // n
    groups = w["scale"].shape[-1]
    if groups > 1 and groups % n:
        return False
    if "q4g" in w and local % 256:
        return False
    if any(k in w for k in ("q4", "nf4", "q4g")) and local % 2:
        return False
    return True


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a layer's two pairs run on this rank: ``attn`` / ``mlp`` True
    when their column side is split; ``attn_out`` / ``mlp_out`` how the row
    side ends: "reduce", "gather" or "none" (not split)."""
    attn: bool
    attn_out: str
    mlp: bool
    mlp_out: str


_ROW_MODE = {"reduce": "row", "gather": None, "none": None}


def project_out(linear, p, x, how: str):
    """The row side of a pair: ``linear(p, x)`` then the all-reduce and the
    bias ("reduce"); or ``x`` gathered over ``model`` first, through the
    whole weight ("gather"); or plain ("none")."""
    if how == "gather":
        return linear(p, gather_model(x, -1))
    y = linear(p, x)
    if how == "reduce":
        y = reduce_model(y)
        if "reduce_bias" in p:
            y = y + p["reduce_bias"].to(y.dtype)
    return y


def llm_layer(lp, cfg):
    """-> (this rank's view of decoder layer ``lp``, the config with its
    local head / kv-head / neuron counts, the ``Plan``); (lp, cfg, None)
    without an active mesh. Attention splits when ``model`` divides both the
    heads and the kv heads (the KV cache then holds the local kv heads,
    ``mesh.kv_heads_local``), the MLP (and the experts) when it divides the
    intermediate size."""
    mesh = active()
    if mesh is None:
        return lp, cfg, None
    M = mesh.shape["model"]
    nh, nkv, hd, inter = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.intermediate_size
    attn = nh % M == 0 and nkv % M == 0
    attn_out = ("reduce" if row_splits(lp["o_proj"], nh * hd, M) else "gather") \
        if attn else "none"
    mlp = inter % M == 0
    if "experts" in lp:
        mlp_out = "reduce" if mlp else "none"
    else:
        mlp_out = ("reduce" if row_splits(lp["down_proj"], inter, M) else "gather") \
            if mlp else "none"
    view = {}
    for k, v in lp.items():
        if k in ("q_proj", "k_proj", "v_proj"):
            view[k] = linear_view(v, "col" if attn else None)
        elif k == "o_proj":
            view[k] = linear_view(v, _ROW_MODE[attn_out])
        elif k in ("gate_proj", "up_proj"):
            view[k] = linear_view(v, "col" if mlp else None)
        elif k == "down_proj":
            view[k] = linear_view(v, _ROW_MODE[mlp_out])
        elif k == "experts" and mlp:
            view[k] = {"w1": model_part(v["w1"], -2), "w3": model_part(v["w3"], -2),
                       "w2": model_part(v["w2"], -1)}
        else:
            view[k] = whole_tree(v)
    local = dataclasses.replace(cfg, num_heads=nh // M if attn else nh,
                                num_kv_heads=nkv // M if attn else nkv,
                                intermediate_size=inter // M if mlp else inter)
    return view, local, Plan(attn, attn_out, mlp, mlp_out)


def vit_layer(p, cfg):
    """-> (this rank's view of tower layer ``p``, its local head count, the
    ``Plan``); (p, cfg.num_heads, None) without an active mesh. The packed
    ``qkv`` linear splits per third. Under the W8A8 tower the row sides
    (out_proj, fc2) gather their input: K8 needs the whole input row."""
    mesh = active()
    if mesh is None:
        return p, cfg.num_heads, None
    M = mesh.shape["model"]
    E, nh, inter = cfg.hidden_size, cfg.num_heads, cfg.intermediate_size
    attn, mlp = nh % M == 0, inter % M == 0
    attn_out = ("reduce" if row_splits(p["out_proj"], E, M, w8a8=True) else "gather") \
        if attn else "none"
    mlp_out = ("reduce" if row_splits(p["fc2"], inter, M, w8a8=True) else "gather") \
        if mlp else "none"
    view = {}
    for k, v in p.items():
        if k == "qkv":
            view[k] = linear_view(v, "col", parts=3) if attn else whole_tree(v)
        elif k in ("q_proj", "k_proj", "v_proj"):
            view[k] = linear_view(v, "col" if attn else None)
        elif k == "out_proj":
            view[k] = linear_view(v, _ROW_MODE[attn_out])
        elif k == "fc1":
            view[k] = linear_view(v, "col" if mlp else None)
        elif k == "fc2":
            view[k] = linear_view(v, _ROW_MODE[mlp_out])
        else:
            view[k] = whole_tree(v)
    return view, nh // M if attn else nh, Plan(attn, attn_out, mlp, mlp_out)


# ----------------------------------------------------------------------------
# Vocab-parallel embedding, head and loss
# ----------------------------------------------------------------------------

def _vocab_split(vocab: int) -> bool:
    """The vocabulary splits over ``model`` when the axis has more than one
    rank and divides it (at one rank the whole-vocab path is the same
    function, and the same arithmetic as without a mesh)."""
    mesh = active()
    return (mesh is not None and mesh.group("model") is not None
            and mesh.shape["model"] > 1 and vocab % mesh.shape["model"] == 0)


def _vocab_offset(local_rows: int) -> int:
    return active().coords["model"] * local_rows


def embed(table, ids):
    """``table[ids]`` with the table's rows split over ``model``: each rank
    looks up the ids it holds (zeros for the others) and the all-reduce adds
    the one non-zero row of each id."""
    if active() is None:
        return table[ids.long()]
    if not _vocab_split(_global_rows(table)):
        return whole(table)[ids.long()]
    part = model_part(table, 0)
    local = ids.long() - _vocab_offset(part.shape[0])
    inside = (local >= 0) & (local < part.shape[0])
    rows = part[torch.where(inside, local, 0)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_model(rows)


def _row_tensor(w):
    """The tensor holding a weight's output rows (a quantized dict's codes)."""
    if isinstance(w, dict):
        return w[next(k for k in ("q", "q4", "q4g", "nf4") if k in w)]
    return w


def _global_rows(t) -> int:
    """Dim 0's length in the whole leaf that ``t`` is this rank's part of."""
    return t.shape[0] * (active().shape["model"] if spec_of(t)[:1] == ("model",) else 1)


def head_view(head):
    """-> (the lm_head as this rank uses it, the first vocab id of its
    logits or None when the logits are whole). The vocab splits over
    ``model`` when the axis has several ranks and divides it."""
    mesh = active()
    if mesh is None:
        return head, None
    if not isinstance(head, dict):
        head = {"weight": head}
    if not _vocab_split(_global_rows(_row_tensor(head["weight"]))):
        return whole_tree(head), None
    view = linear_view(head, "col")
    return view, _vocab_offset(_row_tensor(view["weight"]).shape[0])


def vocab_nll(logits, safe, offset: int):
    """(log-sum-exp, target logit) of vocab-split fp32 logits [..., V/n]
    whose first id is ``offset``; ``safe`` the target ids [...]."""
    m = max_model(logits.amax(dim=-1))
    s = reduce_model(torch.exp(logits - m[..., None]).sum(dim=-1))
    lse = m + torch.log(s)
    local = safe - offset
    inside = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    gold = reduce_model(torch.where(inside, gold, torch.zeros_like(gold)))
    return lse, gold


# ----------------------------------------------------------------------------
# Gradients
# ----------------------------------------------------------------------------

def sync_grads(leaves) -> None:
    """After the backward: sum each trainable leaf's gradient over the
    batch axes its reduce-scatter has not summed (``dp``, or ``data`` for a
    leaf split over fsdp). Model ranks need nothing: a split leaf's gradient
    is its shard's, a whole leaf's is the same on every model rank (a whole
    leaf that meets only this rank's part of a pair, an adapter factor,
    passes through ``enter``, whose backward sums it over ``model``). On a
    mesh with pipeline stages a leaf that is not split over ``pp`` (the
    head, the tower) is summed over ``pp`` too: each stage computed its own
    part of its gradient (the embedding on stage 0, the head on its rows)."""
    mesh = active()
    if mesh is None:
        return
    for p in leaves:
        if p.grad is None:
            continue
        spec = spec_of(p)
        axis = "data" if "fsdp" in spec else "dp"
        g = mesh.group(axis)
        if g is not None and mesh.axis_size(axis) > 1:
            dist.all_reduce(p.grad, group=g)
        g = mesh.group("pp")
        if g is not None and mesh.axis_size("pp") > 1 and "pp" not in spec:
            dist.all_reduce(p.grad, group=g)


def replicas(p) -> int:
    """How many ranks hold the same copy of leaf ``p`` (after ``sync_grads``
    their gradients are equal too)."""
    mesh = active()
    if mesh is None:
        return 1
    split = 1
    for ax in spec_of(p):
        if ax is not None:
            split *= mesh.axis_size(ax)
    return mesh.size // split


def global_sq_norm(params, sq_parts):
    """Sum over the whole mesh of per-leaf squared norms ``sq_parts`` (one
    0-d tensor a leaf of ``params``), each leaf counted once: a shard's part
    is summed over the ranks that split the leaf, a copy's divided by its
    replicas. Without a mesh the plain sum."""
    total = sum(sq_parts) if sq_parts else torch.zeros(())
    mesh = active()
    if mesh is None or mesh.group("world") is None:
        return total
    dev = sq_parts[0].device if sq_parts else mesh.device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for p, s in zip(params, sq_parts):
        total = total + s.to(torch.float32) / replicas(p)
    return _all_reduce(total, mesh.group("world"))
