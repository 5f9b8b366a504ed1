"""Causal prefill attention: the plain version only.

Port of ``slime_tpu/ops/flash_attention.py:reference_attention`` (:469-500),
the path JAX's ``generate(..., use_pallas=False)`` takes for prefill. The TPU
flash kernel (K5: ``_fwd``/``_fwd_kernel``, with the backward pair
``_bwd_dkdv_kernel``/``_bwd_dq_kernel``) is still to be ported (ROADMAP,
Queue 2), so the port has no ``flash_attention`` function yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """q [B, H, S, D]; k, v [B, KVH, S, D] (KVH divides H) -> [B, H, S, D].

    GQA by repeating k/v heads; fp32 scores; for bf16 inputs the stabilized
    low-precision softmax of the JAX oracle (fp32 max-subtract, bf16 exp and
    normalize)."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if KVH != H:
        k = k.repeat_interleave(H // KVH, dim=1)
        v = v.repeat_interleave(H // KVH, dim=1)
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    if q.dtype == torch.bfloat16:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m).to(q.dtype)
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.to(torch.float32), v.to(torch.float32)).to(q.dtype)
