"""Chunked next-token cross entropy: the [B, S, V] logits never exist at once.

Port of ``slime_tpu/ops/loss.py`` (``_head_logits``, ``_dense_nll``,
``chunked_cross_entropy``, ``chunked_ce_mean``; :32-109, :185). The vocab
projection and the NLL run one sequence chunk at a time; each chunk is a
``torch.utils.checkpoint`` region (JAX checkpoints the scan body), so its
logits are freed after the forward and recomputed in the backward. At
V = 128256, S = 2048 and B = 4 that keeps one [4, 256, V] fp32 block live
instead of a 4.2 GB [4, 2048, V] one.

Logits are fp32: the head weight is cast to the activations' dtype and the
product accumulates in fp32 (JAX's ``preferred_element_type=float32``); the
port runs it as an fp32 matmul of the two rounded operands, which is exact
in the products and sums in fp32. As in JAX, the head is dequantized and
cast inside each chunk, so no full copy of it outlives its chunk.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import IGNORE_INDEX
from .quantization import dequantize_weight

DEFAULT_LOSS_CHUNK = 256


def _head_logits(x, head):
    """fp32 logits [..., V] of x [..., H] through the lm_head dict (or raw
    [V, H] array): its weight, dequantized if int8, rounded to x's dtype."""
    w = head["weight"] if isinstance(head, dict) else head
    if isinstance(w, dict):
        w = dequantize_weight(w)
    w32 = w.to(x.dtype).to(torch.float32)
    return torch.matmul(x.to(torch.float32), w32.T)


def _dense_nll(x, head, targets, valid):
    """(sum of -log p(target) over valid positions, valid count)."""
    logits = _head_logits(x, head)
    safe = torch.where(valid, targets, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - gold
    return (torch.where(valid, nll, 0.0).sum(),
            valid.sum().to(torch.int32))


def chunked_cross_entropy(x, lm_head_weight, labels, *,
                          chunk: Optional[int] = DEFAULT_LOSS_CHUNK,
                          ignore_index: int = IGNORE_INDEX,
                          shift: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_nll fp32 scalar, n_valid int32) for next-token prediction.

    x [B, S, H]: final (normed) hidden states; lm_head_weight: [V, H] or an
    lm_head dict; labels [B, S]. shift=True (HF semantics): position i
    predicts labels[:, i+1], the last position predicts nothing. chunk=None
    or chunk >= S is one dense projection."""
    B, S, H = x.shape
    if shift:
        targets = torch.cat([labels[:, 1:],
                             torch.full((B, 1), ignore_index, dtype=labels.dtype,
                                        device=labels.device)], dim=1)
    else:
        targets = labels
    valid = targets != ignore_index
    if isinstance(lm_head_weight, dict) and "lora" in lm_head_weight:
        raise NotImplementedError("LoRA adapters are not ported yet "
                                  "(ROADMAP Queue 1 step 9: lora.py)")

    if chunk is None or chunk >= S:
        return _dense_nll(x, lm_head_weight, targets, valid)

    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad), value=ignore_index)
        valid = targets != ignore_index
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int32, device=x.device)
    for c in range(0, x.shape[1], chunk):
        xc, tc, vc = x[:, c:c + chunk], targets[:, c:c + chunk], valid[:, c:c + chunk]
        if torch.is_grad_enabled():
            s, n = checkpoint(_dense_nll, xc, lm_head_weight, tc, vc,
                              use_reentrant=False)
        else:
            s, n = _dense_nll(xc, lm_head_weight, tc, vc)
        total = total + s
        count = count + n
    return total, count


def chunked_ce_mean(x, lm_head_weight, labels, *,
                    chunk: Optional[int] = DEFAULT_LOSS_CHUNK,
                    ignore_index: int = IGNORE_INDEX, shift: bool = True):
    """Mean NLL over the valid targets (the training objective)."""
    total, count = chunked_cross_entropy(x, lm_head_weight, labels, chunk=chunk,
                                         ignore_index=ignore_index, shift=shift)
    return total / torch.clamp(count, min=1)
