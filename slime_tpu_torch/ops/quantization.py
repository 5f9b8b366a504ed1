"""Weight-only quantization: every storage format of the JAX package, byte for byte.

Port of ``slime_tpu/ops/quantization.py``. A quantized weight is a dict whose
key names the format, with fp32 scales along the last (input) dimension:

- ``{"q", "scale"}``: int8, one absmax scale per output row (``scale
  [..., out, 1]``) or per ``group`` input columns (``[..., out, in/group]``);
- ``{"q4", "scale"}``: int4 with the same scales, two nibbles per int8, the
  even column in the low nibble and the odd column in the high one;
- ``{"q4g", "scale"}``: group-128 int4 in the fused kernels' packing:
  packed block b (128 bytes of a row) holds group 2b in its low nibbles and
  group 2b+1 in its high nibbles, so a group is 128 contiguous packed bytes;
- ``{"nf4", "scale"}``: the NF4 codebook index (bitsandbytes' 16 quantiles
  of N(0, 1)) with group-64 absmax scales, packed as ``q4``.

Rounding is ``torch.round`` (half to even, as ``jnp.round``). The functions
work on stacked ``[L, out, in]`` weights too.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# bitsandbytes' NF4 data type (QLoRA, Dettmers et al. 2023, Appendix E)
NF4_CODEBOOK = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], np.float32)
_NF4_MIDPOINTS = (NF4_CODEBOOK[1:] + NF4_CODEBOOK[:-1]) / 2


def _pack_pairs(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int8 nibble tensors -> one int8 per pair (lo in bits 0-3)."""
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.int8)


def _nibbles(p: torch.Tensor):
    """Packed int8 -> (low, high) signed 4-bit values as int8."""
    u = p.to(torch.int32) & 0xFF
    return (((u & 0xF) ^ 8) - 8).to(torch.int8), ((((u >> 4) & 0xF) ^ 8) - 8).to(torch.int8)


def _absmax_scale(a: torch.Tensor, qmax: float, dim: int, keepdim: bool):
    absmax = a.abs().amax(dim=dim, keepdim=keepdim)
    return torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))


def quantize_weight(w: torch.Tensor, bits: int = 8,
                    group: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """w [..., out, in] -> {"q" (bits 8) | "q4" (bits 4): int8 [..., out,
    in (/2 for int4)], "scale": fp32 [..., out, n_groups]}: one absmax scale
    per row (``group=None``) or per ``group`` input columns."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    wf = w.to(torch.float32)
    qmax = 127.0 if bits == 8 else 7.0
    if group is not None:
        IN = wf.shape[-1]
        if IN % group:
            raise ValueError(f"in dim {IN} is not a multiple of the group {group}")
        g = wf.reshape(*wf.shape[:-1], IN // group, group)
        scale = _absmax_scale(g, qmax, -1, False)                 # [..., out, n_g]
        q = torch.clamp(torch.round(g / scale[..., None]), -qmax, qmax)
        q = q.reshape(wf.shape).to(torch.int8)
    else:
        scale = _absmax_scale(wf, qmax, -1, True)
        q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        return {"q4": _pack_pairs(q[..., 0::2], q[..., 1::2]), "scale": scale}
    return {"q": q, "scale": scale}


def quantize_weight_q4g(w: torch.Tensor, group: int = 128) -> Dict[str, torch.Tensor]:
    """Group-wise absmax int4 in the fused kernels' packing: {"q4g": int8
    [..., out, in/2], "scale": fp32 [..., out, in/group]}. Values equal
    ``quantize_weight(bits=4, group=group)``'s; only the byte layout differs."""
    wf = w.to(torch.float32)
    IN = wf.shape[-1]
    if IN % (2 * group):
        raise ValueError(f"in dim {IN} is not a multiple of 2 x group {group}")
    g = wf.reshape(*wf.shape[:-1], IN // group, group)
    scale = _absmax_scale(g, 7.0, -1, False)
    q = torch.clamp(torch.round(g / scale[..., None]), -7, 7).to(torch.int8)
    pairs = q.reshape(*wf.shape[:-1], IN // (2 * group), 2, group)
    packed = _pack_pairs(pairs[..., 0, :], pairs[..., 1, :])
    return {"q4g": packed.reshape(*wf.shape[:-1], IN // 2), "scale": scale}


def quantize_weight_nf4(w: torch.Tensor, group: int = 64) -> Dict[str, torch.Tensor]:
    """w [..., out, in] -> {"nf4": packed codebook indices int8 [..., out,
    in/2], "scale": fp32 [..., out, in/group]} (group absmax, the nearest
    NF4 quantile; packed as ``q4``)."""
    wf = w.to(torch.float32)
    IN = wf.shape[-1]
    if IN % group:
        raise ValueError(f"in dim {IN} is not a multiple of the group {group}")
    g = wf.reshape(*wf.shape[:-1], IN // group, group)
    absmax = g.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    norm = (g / scale[..., None]).reshape(wf.shape)
    idx = torch.searchsorted(torch.from_numpy(_NF4_MIDPOINTS).to(norm.device),
                             norm.contiguous()).to(torch.int8)
    return {"nf4": _pack_pairs(idx[..., 0::2], idx[..., 1::2]), "scale": scale}


def is_quantized(leaf) -> bool:
    return (isinstance(leaf, dict) and "scale" in leaf
            and any(k in leaf for k in ("q", "q4", "q4g", "nf4")))


def _apply_scale(vals: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 values [..., out, in] times per-row or per-group scales."""
    if scale.shape[-1] == 1:
        return vals * scale
    IN, n_g = vals.shape[-1], scale.shape[-1]
    g = vals.reshape(*vals.shape[:-1], n_g, IN // n_g)
    return (g * scale[..., None]).reshape(vals.shape)


def int_values(qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The unscaled integer weights of a ``q``, ``q4`` or ``q4g`` dict: int8
    [..., out, in] in natural column order."""
    if "q4g" in qw:
        p = qw["q4g"]
        n_g = qw["scale"].shape[-1]
        lo, hi = _nibbles(p.reshape(*p.shape[:-1], n_g // 2, 2 * p.shape[-1] // n_g))
        return torch.stack([lo, hi], dim=-2).reshape(*p.shape[:-1], 2 * p.shape[-1])
    if "q4" in qw:
        lo, hi = _nibbles(qw["q4"])
        return torch.stack([lo, hi], dim=-1).reshape(*lo.shape[:-1], -1)
    return qw["q"]


def dequantize_weight(qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Any quantized weight dict -> fp32 weights [..., out, in]."""
    scale = qw["scale"].to(torch.float32)
    if "nf4" in qw:
        u = qw["nf4"].to(torch.int64) & 0xFF
        idx = torch.stack([u & 0xF, (u >> 4) & 0xF], dim=-1).reshape(*u.shape[:-1], -1)
        vals = torch.from_numpy(NF4_CODEBOOK).to(idx.device)[idx]
        return _apply_scale(vals, scale)
    return _apply_scale(int_values(qw).to(torch.float32), scale)


def quantize_params(params, bits: int = 8, *, min_size: int = 1 << 16,
                    scheme: str = "default"):
    """Quantize every 2-D floating weight leaf of at least ``min_size``
    elements; other leaves pass through. ``scheme`` (int4 only): "default"
    NF4 group-64 (where in % 64 == 0), "absmax" per-row q4, "group" q4g
    group-128 (where in % 256 == 0); the rest fall back to per-row
    ``quantize_weight``. Quantize before ``stack_layers``: stacked leaves are
    3-D and pass through, as in the JAX package."""
    use_nf4 = bits == 4 and scheme == "default"
    use_q4g = bits == 4 and scheme == "group"

    def conv(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() == 2
                and leaf.numel() >= min_size and leaf.is_floating_point()):
            if use_nf4 and leaf.shape[-1] % 64 == 0:
                return quantize_weight_nf4(leaf, group=64)
            if use_q4g and leaf.shape[-1] % 256 == 0:
                return quantize_weight_q4g(leaf, group=128)
            return quantize_weight(leaf, bits)
        return leaf

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return conv(node)

    return walk(params)


def dequantize_params(params):
    """Inverse of ``quantize_params`` (fp32 weights)."""

    def walk(node):
        if isinstance(node, dict):
            if is_quantized(node):
                return dequantize_weight(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)
