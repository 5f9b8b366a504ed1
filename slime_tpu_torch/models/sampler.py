"""Local-token compression and text-guided top-p selection ("sampler").

Port of ``slime_tpu/models/sampler.py`` (:57-124), batched over samples where
the JAX package vmaps:

- ``compress``: a Resampler squeezing each crop's ViT tokens to
  ``mm_resampler_dim`` queries.
- ``select``: summed cosine similarity of each compressed local token against
  the valid text tokens, temperature softmax, then a static keep mask for the
  top-p prefix (rank < k). In training the scores get N(0, 1) * 0.1 noise
  (:110-111), drawn from an explicit ``torch.Generator`` or passed in as
  ``noise``. The ``qformer`` router is not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..config import SliMEConfig
from . import resampler


def init(cfg: SliMEConfig, *, generator, device=None,
         dtype=torch.float32) -> Dict:
    """Random parameters with the JAX ``sampler.init`` key set and shapes,
    on ``device`` (the current CUDA device when None)."""
    if cfg.mm_resampler_type != "cosine":
        raise NotImplementedError(f"selector {cfg.mm_resampler_type!r} is not "
                                  "ported yet (cosine only)")
    return {"post_qformer": resampler.init(
        grid_size=math.isqrt(cfg.mm_resampler_dim), embed_dim=cfg.mm_hidden_size,
        kv_dim=cfg.mm_hidden_size, llm_hidden_size=cfg.hidden_size,
        generator=generator, device=device, dtype=dtype)}


def compress(params, crop_feats, *, cfg: SliMEConfig) -> torch.Tensor:
    """[N, 576, mm_hidden] ViT features -> [N, mm_resampler_dim, mm_hidden]."""
    return resampler.apply(params["post_qformer"], crop_feats,
                           num_heads=cfg.mm_num_heads)


def _cosine_scores(local_f, text_emb, text_mask) -> torch.Tensor:
    """[B,M,D], [B,L,D], [B,L] -> [B,M]: summed cosine similarity against the
    valid text tokens."""
    eps = 1e-8
    a = local_f.to(torch.float32)
    b = text_emb.to(torch.float32)
    an = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=eps)
    bn = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=eps)
    sim = torch.einsum("bmd,bld->bml", an, bn)
    sim = torch.where(text_mask[:, None, :].to(torch.bool), sim, 0.0)
    return sim.sum(dim=-1)


def select(params, local_f, text_emb, text_mask, token_valid, *,
           cfg: SliMEConfig, training: bool = False, generator=None,
           noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-p token selection as a static keep mask, per sample.

    local_f [B, M, llm_hidden]; text_emb [B, L, llm_hidden]; text_mask [B, L];
    token_valid [B, M]. Returns (keep [B, M] bool, probs [B, M] fp32): sort
    descending (stable), k = #(cumsum <= topp) + 1 clamped to the valid count,
    keep that prefix in original order. In training (with a ``generator``,
    or ``noise`` [B, M]) the scores first get ``noise * 0.1``."""
    del params      # the cosine selector has no parameters
    if cfg.mm_resampler_type != "cosine":
        raise NotImplementedError(f"selector {cfg.mm_resampler_type!r} is not "
                                  "ported yet (cosine only)")
    scores = _cosine_scores(local_f, text_emb, text_mask)
    if training and (noise is not None or generator is not None):
        if noise is None:
            noise = torch.randn(scores.shape, generator=generator,
                                device=scores.device)
        scores = scores + noise.to(torch.float32) * 0.1
    valid = token_valid.to(torch.bool)
    scores = torch.where(valid, scores, float("-inf"))
    probs = torch.softmax(scores.to(torch.float32) / cfg.mm_resampler_temp, dim=-1)

    order = torch.argsort(-probs, dim=-1, stable=True)      # descending, stable
    cum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    count = (cum <= cfg.mm_resampler_topp).sum(dim=-1)
    n_valid = valid.sum(dim=-1)
    k = torch.minimum(count + 1, n_valid)
    rank = torch.argsort(order, dim=-1, stable=True)         # rank of each index
    keep = (rank < k[:, None]) & valid
    return keep, probs
