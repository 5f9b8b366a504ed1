"""Parameter bridge between the JAX package and the port.

Both packages hold parameters as the same nested dicts in torch layout
(Linear [out, in], stacked [L, ...] layers, ``{"q", "scale"}`` int8 dicts),
so converting is a leaf-by-leaf copy. bf16 crosses through a 16-bit integer
view, so it is bit-exact; int8 stays int8 and fp32 stays fp32.

Python numbers and strings cross unchanged, so a lora state (``{"rank",
"alpha", "adapters": {path: {"A", "B"}}}``, ``train.lora``) crosses both ways
like a parameter tree.

``named_leaves`` / ``map_leaves`` walk such a tree with the leaf paths JAX's
``optim._path_str`` writes ("llm/layers/0/q_proj/weight").
"""
from __future__ import annotations

import numpy as np
import torch

from .models.layers import resolve_device
from .ops.quantization import is_quantized


def _leaf_to_torch(a, device, dtype):
    a = np.array(a)                          # a writable contiguous copy
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16, as JAX exports it
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_numpy(tree, device=None, dtype=None):
    """Nested dict/list of numpy arrays (``jax.device_get`` of JAX params) ->
    the same tree of tensors on ``device`` (the current CUDA device when
    None). ``dtype`` casts floating leaves, except the fp32 scales of
    quantized weights."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        if is_quantized(tree):
            return {k: _leaf_to_torch(v, device, None) for k, v in tree.items()}
        return {k: from_jax_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_numpy(v, device, dtype) for v in tree)
    if isinstance(tree, (bool, int, float, str)):
        return tree
    return _leaf_to_torch(tree, device, dtype)


def to_jax_numpy(tree):
    """Inverse of ``from_jax_numpy``: tensors -> numpy arrays on the host, bf16
    as ``ml_dtypes.bfloat16`` (imported here: only the JAX side needs it)."""
    if isinstance(tree, dict):
        return {k: to_jax_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax_numpy(v) for v in tree)
    if isinstance(tree, (bool, int, float, str)):
        return tree
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def named_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k))


def map_leaves(fn, tree, prefix: str = ""):
    """The same tree with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
