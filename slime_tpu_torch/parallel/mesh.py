"""The ``(data, fsdp, model)`` mesh over ``torch.distributed``, and its rule table.

Port of ``slime_tpu/parallel/mesh.py``. JAX runs one controller over every
device: it writes a sharding and XLA inserts the collectives. The port runs
one process per card (NCCL; gloo on the CPU when the caller asks), so a
``Mesh`` is this rank's view of the grid: the three axis sizes, this rank's
coordinates (data-major: rank = (data * n_fsdp + fsdp) * n_model + model, the
order of JAX's ``np.asarray(devices).reshape(n_data, n_fsdp, n_model)``), and
one process group per axis (and ``dp``, data x fsdp, the batch axes).

An optional fourth axis, ``pp`` (``n_pp`` > 1: the pipeline stages of
``parallel.pipeline`` and ``parallel.composed``), sits between ``fsdp`` and
``model`` in JAX's composed order ``(data, fsdp, pp, model)``
(``slime_tpu/parallel/composed.py:35``): rank = ((data * n_fsdp + fsdp) *
n_pp + pp) * n_model + model, which at ``n_pp`` = 1 is the order above. It
brings a ``pp`` group and a ``batch`` group over (data, fsdp, pp), over which
the composed multimodal step splits its encode; at ``n_pp`` = 1 neither is
created (``pp`` is None, ``batch`` is ``dp``), so the groups of a
three-axis mesh are made in the same order as before.

- ``data`` x ``fsdp`` split the batch; leaves whose rule names ``fsdp`` are
  stored in shards along that dimension and gathered where they are used
  (``parallel.tensor_parallel``), their gradients reduce-scattered back;
- ``model`` is Megatron tensor parallelism: attention heads, MLP neurons and
  the vocabulary.

Storage follows JAX's rule table exactly (``_RULES``, the quantized-leaf rule
and the divisibility prune are copies, not imports): ``shard_params`` keeps
this rank's shard of every leaf that ``param_pspec`` splits and records the
spec on the tensor (``spec_of``), so the bytes a card holds are what JAX's
plan counts. The rule table names each LLM layer (``llm/layers/3/...``): a
stacked ``[L, ...]`` leaf matches no rule and stays whole, as in JAX. The
serving entry points therefore shard ``layer_list(params)``, the layers as a
list (JAX's serving path does not stack them under a mesh), so each layer is
split.

A mesh is entered as a context (``with mesh:`` or ``use_mesh``) by the entry
points that take one (``generate``, the engine, the trainer); the model code
reads ``active()`` and runs its Megatron pairs on the local heads and
neurons. Without an active mesh every function of the model is the
single-card one.
"""
from __future__ import annotations

import contextlib
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..params import map_leaves, named_leaves
from . import distributed

AXES = ("data", "fsdp", "model")
# the composed order (composed.py:35): pp just outside model
COMPOSED_AXES = ("data", "fsdp", "pp", "model")
SPEC_ATTR = "_mesh_spec"
MESH_ATTR = "_mesh_id"

# path-regex -> spec. First match wins. Weight layout is torch-style
# [out, in]; "model" shards the output or the contracting dim per Megatron
# convention (slime_tpu/parallel/mesh.py:42-68).
_RULES: Tuple[Tuple[str, tuple], ...] = (
    # LLM
    (r"llm/embed_tokens$",                    ("model", "fsdp")),
    (r"llm/lm_head/weight$",                  ("model", "fsdp")),
    (r"llm/layers/\d+/(q|k|v)_proj/weight$",  ("model", "fsdp")),
    (r"llm/layers/\d+/o_proj/weight$",        ("fsdp", "model")),
    (r"llm/layers/\d+/(gate|up)_proj/weight$", ("model", "fsdp")),
    (r"llm/layers/\d+/down_proj/weight$",     ("fsdp", "model")),
    (r"llm/layers/\d+/experts/w[13]$",        (None, "model", "fsdp")),
    (r"llm/layers/\d+/experts/w2$",           (None, "fsdp", "model")),
    (r"llm/layers/\d+/gate/weight$",          (None, "fsdp")),
    # ViT
    (r"vision/layers/\d+/(q|k|v)_proj/weight$", ("model", "fsdp")),
    (r"vision/layers/\d+/out_proj/weight$",     ("fsdp", "model")),
    (r"vision/layers/\d+/fc1/weight$",          ("model", "fsdp")),
    (r"vision/layers/\d+/fc2/weight$",          ("fsdp", "model")),
    (r"vision/patch_embedding$",                ("model", None)),
    (r"vision/position_embedding$",             (None, "model")),
    # projector / sampler: small matmuls
    (r"(projector|sampler)/.*/(in_proj_weight)$", ("model", None)),
    (r"(projector|sampler)/.*weight$",            ("fsdp", None)),
    # LoRA adapter factors: the full-width dim over fsdp, the rank replicated
    (r"adapters/.+/A$", (None, "fsdp")),
    (r"adapters/.+/B$", ("fsdp", None)),
    # biases, norms, queries, pos embeds, gates: replicated
)

# quantized weight dicts: the packed int tensor takes the base weight's spec,
# the scale only its out-dim axis (mesh.py:70-76, :130-135)
_QUANT_LEAVES = ("q", "q4", "q4g", "nf4")


class Mesh:
    """This rank's view of a ``(data, fsdp, model)`` grid of processes, or
    of a ``(data, fsdp, pp, model)`` one with ``n_pp`` > 1.

    ``shape`` maps each axis to its size (``pp`` only when ``n_pp`` > 1:
    ``axis_size`` and ``index`` read it as 1 and 0 otherwise), ``coords``
    to this rank's index on it; ``group(axis)``
    is the process group of the ranks that differ from this one only along
    ``axis`` (``"dp"``: along data and fsdp; ``"batch"``: along data, fsdp
    and pp; ``"world"``: every rank). Without an initialized default group
    the mesh must be of one process and has no groups: ``group`` returns
    None and the collectives of ``parallel.tensor_parallel`` skip."""

    def __init__(self, n_data: int, n_fsdp: int, n_model: int, rank: int = 0,
                 groups: Optional[Dict] = None, device=None, n_pp: int = 1):
        self.rank = rank
        self.coords = grid_coords(rank, n_data, n_fsdp, n_pp, n_model)
        if n_pp > 1:
            self.shape = {"data": n_data, "fsdp": n_fsdp, "pp": n_pp, "model": n_model}
        else:                           # a three-axis mesh, as before the pp axis
            self.shape = {"data": n_data, "fsdp": n_fsdp, "model": n_model}
            del self.coords["pp"]
        self._groups = groups or {}
        self.device = torch.device(device) if device is not None else _default_device()

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def group(self, axis: str):
        if axis == "batch" and "pp" not in self.shape:
            axis = "dp"
        return self._groups.get(axis)

    def axis_size(self, axis: str) -> int:
        """The size of ``axis`` (1 for ``pp`` on a three-axis mesh), or of
        ``dp``, ``batch`` or ``world``."""
        if axis == "dp":
            return self.shape["data"] * self.shape["fsdp"]
        if axis == "batch":
            return self.axis_size("dp") * self.axis_size("pp")
        if axis == "world":
            return self.size
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 on an axis the mesh lacks)."""
        return self.coords.get(axis, 0)

    def rank_at(self, axis: str, index: int) -> int:
        """The global rank of the process at ``index`` on ``axis`` and at this
        rank's coordinates on the other axes."""
        stride = 1
        for a in reversed(COMPOSED_AXES):
            if a == axis:
                return self.rank + (index - self.index(a)) * stride
            stride *= self.axis_size(a)
        raise ValueError(f"no axis {axis!r}")

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        _STACK.pop()
        return False

    def __repr__(self):
        pp = f"pp={self.shape['pp']}, " if "pp" in self.shape else ""
        return (f"Mesh(data={self.shape['data']}, fsdp={self.shape['fsdp']}, {pp}"
                f"model={self.shape['model']}, rank={self.rank})")


_STACK = []


def active() -> Optional[Mesh]:
    """The mesh the innermost ``with mesh:`` entered (any thread), or None."""
    return _STACK[-1] if _STACK else None


def use_mesh(mesh: Optional[Mesh]):
    """``with use_mesh(m):`` enters ``m``; a no-op context for None."""
    return mesh if mesh is not None else contextlib.nullcontext()


def _default_device() -> torch.device:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized() and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rank_coords(rank: int, n_data: int, n_fsdp: int, n_model: int) -> Tuple[int, int, int]:
    """(data, fsdp, model) of a rank: data-major, as JAX's device reshape."""
    return rank // (n_fsdp * n_model), (rank // n_model) % n_fsdp, rank % n_model


def grid_coords(rank: int, n_data: int, n_fsdp: int, n_pp: int, n_model: int) -> Dict[str, int]:
    """{axis: index} of a rank on the (data, fsdp, pp, model) grid, data-major
    (``composed.make_composed_mesh``'s device reshape); ``rank_coords`` at
    ``n_pp`` = 1."""
    idx = np.unravel_index(rank, (n_data, n_fsdp, n_pp, n_model))
    return {a: int(i) for a, i in zip(COMPOSED_AXES, idx)}


def _lines(grid: np.ndarray, axes: Tuple[int, ...]) -> np.ndarray:
    """The groups of ranks that differ only along ``axes`` of ``grid``, one a
    row, the other axes' order kept."""
    moved = np.moveaxis(grid, axes, tuple(range(-len(axes), 0)))
    return moved.reshape(-1, int(np.prod([grid.shape[a] for a in axes])))


def make_mesh(n_data: int = 1, n_fsdp: Optional[int] = None, n_model: int = 1,
              device=None, n_pp: int = 1) -> Mesh:
    """The mesh over the default process group's ranks (one process and no
    groups when none is initialized). ``n_fsdp`` None takes what is left of
    the world after data x model (x pp), as JAX. The product must equal the
    world size. Every rank must call it, in the same order as its other group
    creations: it creates the axis groups with ``dist.new_group`` (``pp`` and
    ``batch`` only when ``n_pp`` > 1)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_fsdp is None:
        n_fsdp = world // (n_data * n_model * n_pp)
    if n_data * n_fsdp * n_model * n_pp != world:
        pp = f", pp={n_pp}" if n_pp > 1 else ""
        raise ValueError(f"mesh (data={n_data}, fsdp={n_fsdp}, model={n_model}{pp}) has "
                         f"{n_data * n_fsdp * n_model * n_pp} ranks, the world has {world}")
    if not dist.is_initialized():
        return Mesh(n_data, n_fsdp, n_model, 0, None, device, n_pp=n_pp)
    rank = dist.get_rank()
    grid = np.arange(world).reshape(n_data, n_fsdp, n_pp, n_model)
    named = [("data", (0,)), ("fsdp", (1,)), ("model", (3,)), ("dp", (0, 1))]
    if n_pp > 1:
        named += [("pp", (2,)), ("batch", (0, 1, 2))]
    groups = {}
    # every rank creates every group, in one order
    for axis, axes in named:
        for ranks in _lines(grid, axes):
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[axis] = g
    groups["world"] = dist.group.WORLD
    return Mesh(n_data, n_fsdp, n_model, rank, groups, device, n_pp=n_pp)


def tp_mesh(n: int, device=None) -> Optional[Mesh]:
    """The ``(1, 1, n)`` mesh of a tensor-parallel server, or None for one
    card. The process group comes from the launcher's environment
    (``distributed.initialize``: gloo when ``device`` is the CPU, else
    NCCL); its size must be ``n``."""
    if n <= 1 and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    cpu = device is not None and torch.device(device).type == "cpu"
    distributed.initialize(backend="gloo" if cpu else "nccl")
    if distributed.process_count() != n:
        raise ValueError(f"--tensor-parallel {n} under a launch of "
                         f"{distributed.process_count()} processes")
    return make_mesh(1, 1, n, device="cpu" if cpu else None)


# ----------------------------------------------------------------------------
# Specs
# ----------------------------------------------------------------------------

def _sizes(mesh) -> Dict[str, int]:
    if mesh is None:
        return {a: 1 for a in AXES}
    return dict(mesh.shape) if not isinstance(mesh, dict) else mesh


def _rule_spec(s: str) -> tuple:
    """First matching rule's raw spec for a path string (un-pruned)."""
    for pat, spec in _RULES:
        if re.search(pat, s):
            return spec
    return ()


def _prune(spec: tuple, dims, mesh) -> tuple:
    """Drop axes that don't divide the corresponding dim (mesh.py:99-118):
    tiny configs and uneven shapes fall back to replication on that dim."""
    if len(spec) > len(dims):
        return ()
    sizes = _sizes(mesh)
    fixed = []
    for d, ax in enumerate(spec):
        if ax is None:
            fixed.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        keep = tuple(a for a in axes
                     if d < len(dims) and dims[d] % sizes[a] == 0 and sizes[a] > 1)
        fixed.append(keep[0] if len(keep) == 1 else (keep or None))
    return tuple(fixed)


def param_pspec(path: str, shape, mesh=None) -> tuple:
    """The spec JAX's ``param_pspec`` gives a leaf at ``path`` ("llm/layers/0/
    q_proj/weight") of ``shape``, as a tuple: one entry a dim, an axis name
    or None (``tuple(jax_spec)`` compares equal). ``mesh`` is a ``Mesh`` or a
    dict of axis sizes."""
    dims = tuple(shape)
    if len(dims) < 2:
        return ()
    head, _, tail = path.rpartition("/")
    if tail in _QUANT_LEAVES:
        path = head
    elif tail == "scale" and head.endswith("weight"):
        base = _rule_spec(head)
        return _prune((base[0] if len(base) >= 1 else None, None), dims, mesh)
    return _prune(_rule_spec(path), dims, mesh)


def spec_of(t) -> tuple:
    """The spec ``shard_params`` recorded on a leaf (() for a whole one)."""
    return getattr(t, SPEC_ATTR, ())


def copy_spec(dst: torch.Tensor, src) -> torch.Tensor:
    """Carry ``src``'s recorded spec and mesh over to ``dst`` (a copy of it)."""
    for attr in (SPEC_ATTR, MESH_ATTR):
        if hasattr(src, attr):
            setattr(dst, attr, getattr(src, attr))
    return dst


def _chunk(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def local_shard(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole tensor under ``spec``."""
    for d, ax in enumerate(spec):
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            t = _chunk(t, d, mesh.axis_size(a), mesh.index(a))
    return t


def layer_list(params):
    """``params`` with a stacked LLM layer dict as the list of its layers
    (views), which ``shard_params`` splits layer by layer; any other tree
    as it is."""
    llm = params.get("llm") if isinstance(params, dict) else None
    layers = llm.get("layers") if isinstance(llm, dict) else None
    if not isinstance(layers, dict):
        return params
    n = next(t for _, t in named_leaves(layers) if isinstance(t, torch.Tensor)).shape[0]
    listed = [map_leaves(lambda _, t, i=i: t[i] if isinstance(t, torch.Tensor) else t, layers)
              for i in range(n)]
    return {**params, "llm": {**llm, "layers": listed}}


def shard_params(mesh: Mesh, params, spec_fn=None):
    """Each rank keeps its shard of every leaf (``param_pspec``, or
    ``spec_fn(path, shape)``: the composed steps' stacked specs), a fresh
    contiguous copy on the mesh's device with its spec recorded. Always
    copies, as JAX's ``shard_params``."""
    def put(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = (spec_fn or (lambda p, shape: param_pspec(p, shape, mesh)))(path, leaf.shape)
        out = local_shard(leaf.detach(), spec, mesh).to(mesh.device).contiguous().clone()
        setattr(out, SPEC_ATTR, spec)
        setattr(out, MESH_ATTR, id(mesh))
        return out
    return map_leaves(put, params)


def unshard_params(mesh: Mesh, params):
    """The whole tensors on every rank (for checkpoints and tests): each
    sharded leaf all-gathered along its split dims. A collective: every
    rank calls it."""
    from .tensor_parallel import gather_whole

    def whole(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        with torch.no_grad():
            return gather_whole(leaf.detach(), spec_of(leaf), mesh).clone()
    return map_leaves(whole, params)


def local_bytes(params) -> int:
    """Bytes of the tensors this rank holds."""
    return sum(t.numel() * t.element_size() for _, t in named_leaves(params)
               if isinstance(t, torch.Tensor))


def on_mesh(params, mesh: Mesh) -> bool:
    """True if the first tensor leaf was sharded onto ``mesh``."""
    for _, leaf in named_leaves(params):
        if isinstance(leaf, torch.Tensor):
            return getattr(leaf, MESH_ATTR, None) == id(mesh)
    return False


def batch_rows(mesh: Mesh, dim0: int) -> slice:
    """This rank's rows of a global batch of ``dim0`` rows: dim 0 split over
    the longest prefix of (data, fsdp) whose sizes divide it, in mesh order
    (JAX's ``shard_batch``: rank block d * n_fsdp + f), else all rows. An
    axis of size 1 is passed over (JAX's prefix stops there and leaves the
    batch to its partitioner; one process per card has to split it)."""
    n, idx = 1, 0
    for a in ("data", "fsdp"):
        if mesh.shape[a] == 1:
            continue
        if dim0 % (n * mesh.shape[a]):
            break
        idx = idx * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    per = dim0 // n
    return slice(idx * per, (idx + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every leaf of a global batch (numpy arrays or
    tensors, dict or list), by ``batch_rows``; 0-d leaves are kept whole."""
    def take(_, x):
        if x is None or np.ndim(x) == 0:
            return x
        return x[batch_rows(mesh, np.shape(x)[0])]
    return map_leaves(take, batch)


def constrain_batch_act(x, mesh: Optional[Mesh] = None,
                        batch_axes: Tuple[str, ...] = ("data", "fsdp")):
    """The identity. JAX pins activations to batch-over-DP so GSPMD does not
    propagate weight shardings into them; here each rank already holds only
    its rows of every activation and the weights it needs are gathered
    explicitly, so there is nothing to pin."""
    del mesh, batch_axes
    return x


def kv_heads_local(num_kv_heads: int, mesh: Optional[Mesh]) -> int:
    """kv heads a rank's cache holds: split over ``model`` when it divides
    them, else all of them (mesh.py:249-253)."""
    if mesh is None or num_kv_heads % mesh.shape["model"]:
        return num_kv_heads
    return num_kv_heads // mesh.shape["model"]


def shard_kv_cache(mesh: Mesh, cache):
    """This rank's part of a decode cache [L, B, S, KVH, hd] (and its scales
    [L, B, S, KVH]): kv heads over ``model``, or the whole cache when the
    model axis does not divide them (GQA heads fewer than the TP degree).
    ``length`` stays whole."""
    M = mesh.shape["model"]
    if cache["k"].shape[3] % M:
        return dict(cache)
    return {k: (v if k == "length" else
                _chunk(v, 3, M, mesh.coords["model"]).contiguous())
            for k, v in cache.items()}
