"""Weight-only int8 quantization with per-row absmax scales.

Mirrors ``slime_tpu/ops/quantization.py`` for the ``{"q", "scale"}`` storage
(``quantize_weight`` bits=8 at :39-75, ``dequantize_weight`` at :127-170):
int8 weights with one fp32 scale per output row, the same bytes the JAX
package writes. The int4 formats (``q4``, ``q4g``, ``nf4``) are not ported
yet (ROADMAP, Queue 2: q4/q4g/NF4 with K6/K7).
"""
from __future__ import annotations

from typing import Dict

import torch

_INT4_TODO = ("int4 weight formats (q4/q4g/nf4) are not ported yet "
              "(ROADMAP: q4/q4g/NF4 formats with K6/K7)")


def quantize_weight(w: torch.Tensor, bits: int = 8) -> Dict[str, torch.Tensor]:
    """w [..., out, in] -> {"q": int8 [..., out, in], "scale": fp32
    [..., out, 1]}, one absmax scale per row."""
    if bits != 8:
        raise NotImplementedError(_INT4_TODO)
    wf = w.to(torch.float32)
    absmax = wf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def is_quantized(leaf) -> bool:
    return (isinstance(leaf, dict) and "scale" in leaf
            and any(k in leaf for k in ("q", "q4", "q4g", "nf4")))


def dequantize_weight(qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """{"q", "scale"} with per-row scales -> fp32 weights [..., out, in]."""
    if "q" not in qw:
        raise NotImplementedError(_INT4_TODO)
    if qw["scale"].shape[-1] != 1:
        raise NotImplementedError("group-scaled int8 weights are not ported "
                                  "(the JAX package quantizes int8 per row)")
    return qw["q"].to(torch.float32) * qw["scale"].to(torch.float32)
