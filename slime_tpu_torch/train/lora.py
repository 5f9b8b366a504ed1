"""LoRA: low-rank adapters as explicit factored parameters beside the tree.

Port of ``slime_tpu/train/lora.py`` (PEFT's role; the reference wires LoRA
at llava/train/train.py:1036-1052 and merges at load, builder.py:52-91).
A lora state is ``{"rank": r, "alpha": a, "adapters": {path: {"A": [r, in],
"B": [out, r]}}}``, the paths in the parameter tree's layout
("llm/layers/3/q_proj", or "llm/layers/q_proj" with leading [L] factors
when stacked). The base weight stays frozen; the effective weight is
W + (alpha / r) B A, applied three ways:

- ``attach``: each target linear gains ``{"lora": {"A", "B": B * alpha / r}}``
  and ``layers.linear`` adds ``(x A^T) B^T`` after the base product, so a
  quantized base (int8, NF4: QLoRA) keeps its own path;
- ``apply_to_params``: W + s B A materialized (differentiable in A and B);
- ``merge``: the same folded into a new tree (a quantized base merges into
  its bf16 dequantization), the reference's merge_and_unload.

``export_peft`` / ``import_peft`` use PEFT's key names
(``base_model.model.<hf module>.lora_{A,B}.weight``);
``stack_adapter_state`` turns per-layer paths into the stacked [L, ...]
layout the serving engine's ``register_adapter`` takes. ``init_lora`` draws
A from a ``torch.Generator`` (JAX draws from its own keys; the tests carry
JAX's values across with ``params.from_jax_numpy``).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import torch

from ..ops.quantization import dequantize_weight
from ..parallel.mesh import copy_spec

DEFAULT_TARGETS = (r"llm/layers/\d+/(q|k|v|o)_proj$",
                   r"llm/layers/\d+/(gate|up|down)_proj$")


def weight_shape(w) -> Optional[tuple]:
    """(out, in) of a linear weight: a 2-D tensor, or a quantized dict whose
    packed 4-bit storage halves the in-dim. None if it is not a linear
    weight."""
    if isinstance(w, dict):
        for key, mult in (("q", 1), ("q4", 2), ("q4g", 2), ("nf4", 2)):
            if key in w and w[key].dim() == 2:
                o, i = w[key].shape
                return (o, i * mult)
        return None
    return tuple(w.shape) if isinstance(w, torch.Tensor) and w.dim() == 2 else None


def find_linear_targets(params, patterns: Sequence[str] = DEFAULT_TARGETS) -> List[str]:
    """Sorted paths of linear dicts (a 2-D or quantized "weight") matching
    any of the patterns."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            if "weight" in node and weight_shape(node["weight"]) is not None:
                s = "/".join(path)
                if any(re.search(p, s) for p in patterns):
                    out.append(s)
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])

    walk(params, [])
    return sorted(out)


def _get(params, path: str):
    node = params
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def _device(w) -> torch.device:
    return next(iter(w.values())).device if isinstance(w, dict) else w.device


def init_lora(params, *, generator: torch.Generator, r: int = 128, alpha: int = 256,
              targets: Sequence[str] = DEFAULT_TARGETS) -> Dict:
    """Adapters on every target: A ~ N(0, 1) / r [r, in] fp32 from
    ``generator`` (on the weight's device), B zeros [out, r]."""
    adapters = {}
    for p in find_linear_targets(params, targets):
        w = _get(params, p)["weight"]
        out_dim, in_dim = weight_shape(w)
        dev = _device(w)
        a = torch.randn((r, in_dim), generator=generator, dtype=torch.float32,
                        device=generator.device).to(dev)
        adapters[p] = {"A": a * (1.0 / r),
                       "B": torch.zeros((out_dim, r), dtype=torch.float32, device=dev)}
    return {"rank": r, "alpha": alpha, "adapters": adapters}


def _rebuild(params, lora_state, swap):
    """A copy of the tree's dicts and lists (leaves shared) in which each
    adapted linear dict is ``swap(node, factors)``."""
    def walk(node, path):
        if isinstance(node, dict):
            s = "/".join(path)
            if s in lora_state["adapters"] and "weight" in node:
                return swap(node, lora_state["adapters"][s], s)
            return {k: walk(v, path + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + [str(i)]) for i, v in enumerate(node))
        return node
    return walk(params, [])


def merge(params, lora_state: Dict):
    """A new tree with W <- W + (alpha / r) B A (fp32 sum, rounded to W's
    dtype); a quantized base weight merges into its bf16 dequantization.
    ``params`` is left as it was."""
    scale = lora_state["alpha"] / lora_state["rank"]

    def swap(node, ab, _):
        w = node["weight"]
        if isinstance(w, dict):
            w = dequantize_weight(w).to(torch.bfloat16)
        with torch.no_grad():
            delta = (ab["B"].to(torch.float32) @ ab["A"].to(torch.float32)) * scale
            new = (w.to(torch.float32) + delta.to(w.device)).to(w.dtype)
        return {**node, "weight": new}
    return _rebuild(params, lora_state, swap)


def apply_to_params(params, lora_state: Optional[Dict]):
    """W + s B A computed on the fly (differentiable in A and B). A quantized
    base raises: use ``attach`` for QLoRA."""
    if lora_state is None:
        return params
    scale = lora_state["alpha"] / lora_state["rank"]

    def swap(node, ab, path):
        if isinstance(node["weight"], dict):
            raise TypeError(f"{path}: quantized base weight; use lora.attach() "
                            "(factored application) for QLoRA forwards")
        delta = (ab["B"] @ ab["A"]) * scale
        return {**node, "weight": node["weight"] + delta.to(node["weight"].dtype)}
    return _rebuild(params, lora_state, swap)


def attach(params, lora_state: Optional[Dict]):
    """Each target linear dict gains ``{"lora": {"A", "B": B * alpha / r}}``
    (the scale folded into B keeps a stacked [L, ...] adapter's layout);
    ``layers.linear`` adds ``(x A^T) B^T``. The base weight is never read
    here, so it may be quantized."""
    if lora_state is None:
        return params
    scale = lora_state["alpha"] / lora_state["rank"]
    return _rebuild(params, lora_state,
                    lambda node, ab, _: {**node, "lora": {
                        "A": ab["A"], "B": copy_spec(ab["B"] * scale, ab["B"])}})


_ATTN_LEAVES = ("q_proj", "k_proj", "v_proj", "o_proj")


def _ours_to_hf(path: str) -> str:
    """'llm/layers/3/q_proj' -> 'model.layers.3.self_attn.q_proj' (PEFT's
    module names)."""
    m = re.fullmatch(r"llm/layers/(\d+)/(\w+)", path)
    if m:
        mod = "self_attn" if m.group(2) in _ATTN_LEAVES else "mlp"
        return f"model.layers.{m.group(1)}.{mod}.{m.group(2)}"
    if path == "llm/lm_head":
        return "lm_head"
    return path.replace("/", ".")


def _hf_to_ours(name: str) -> str:
    m = re.fullmatch(r"model\.layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)", name)
    if m:
        return f"llm/layers/{m.group(1)}/{m.group(2)}"
    if name == "lm_head":
        return "llm/lm_head"
    return name.replace(".", "/")


def _host(t) -> torch.Tensor:
    """A compact, detached CPU copy of a tensor."""
    return torch.as_tensor(t).detach().to("cpu").clone(memory_format=torch.contiguous_format)


def export_peft(lora_state: Dict) -> Dict[str, torch.Tensor]:
    """PEFT state dict (``base_model.model.<hf module>.lora_{A,B}.weight``),
    CPU tensors, so PEFT tooling reads the adapters unchanged."""
    out = {}
    for path, ab in lora_state["adapters"].items():
        key = "base_model.model." + _ours_to_hf(path)
        out[f"{key}.lora_A.weight"] = _host(ab["A"])
        out[f"{key}.lora_B.weight"] = _host(ab["B"])
    return out


def import_peft(sd: Dict, *, r: int, alpha: int) -> Dict:
    """A PEFT adapter state dict (tensors or arrays) -> a lora state with
    paths in the parameter tree's layout, CPU tensors."""
    adapters: Dict = {}
    for k, v in sd.items():
        m = re.match(r"(?:base_model\.model\.)?(.+)\.lora_([AB])(?:\.default)?\.weight$", k)
        if not m:
            continue
        adapters.setdefault(_hf_to_ours(m.group(1)), {})[m.group(2)] = torch.as_tensor(v)
    return {"rank": r, "alpha": alpha, "adapters": adapters}


def stack_adapter_state(lora_state: Dict, num_layers: int) -> Dict:
    """Per-layer paths ('llm/layers/3/q_proj') -> stacked paths
    ('llm/layers/q_proj') with leading-[L] fp32 factors, zeros where a
    layer was not targeted. Stacked entries pass through."""
    per_proj: Dict[str, Dict[int, Dict]] = {}
    out: Dict = {}
    for path, ab in lora_state["adapters"].items():
        m = re.match(r"(.*/layers)/(\d+)/(.+)$", path)
        if m is None:
            out[path] = ab
            continue
        per_proj.setdefault(f"{m.group(1)}/{m.group(3)}", {})[int(m.group(2))] = ab
    for spath, by_layer in per_proj.items():
        ex = next(iter(by_layer.values()))
        dev = ex["A"].device
        A = torch.zeros((num_layers,) + tuple(ex["A"].shape), dtype=torch.float32, device=dev)
        B = torch.zeros((num_layers,) + tuple(ex["B"].shape), dtype=torch.float32, device=dev)
        for li, ab in by_layer.items():
            A[li] = ab["A"].detach()
            B[li] = ab["B"].detach()
        out[spath] = {"A": A, "B": B}
    return {**lora_state, "adapters": out}
