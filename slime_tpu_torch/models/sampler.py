"""Local-token compression and text-guided top-p selection ("sampler").

Port of ``slime_tpu/models/sampler.py`` (:57-124), batched over samples where
the JAX package vmaps:

- ``compress``: a Resampler squeezing each crop's ViT tokens to
  ``mm_resampler_dim`` queries.
- ``select``: a score per compressed local token, temperature softmax, then
  a static keep mask for the top-p prefix (rank < k). In training the
  scores get N(0, 1) * 0.1 noise (:110-111), drawn from an explicit
  ``torch.Generator`` or passed in as ``noise``.

Two selectors score the tokens: ``cosine``, the summed cosine similarity
against the valid text tokens (no parameters), and ``qformer``
(TextGuidedRouterAttention, :76-86): layer norms at eps 1e-6, cross-attention
of the tokens over the text with key padding over ``cfg.llm_num_heads_128``
heads, a post norm, ``prob_proj`` (E -> E/4, ReLU, -> 1) and a softmax over
``mm_resampler_temp``. ``select`` then applies its own softmax over the same
temperature, so the qformer scores pass the temperature twice, as in JAX.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..config import SliMEConfig
from . import layers as L
from . import resampler


def init(cfg: SliMEConfig, *, generator, device=None,
         dtype=torch.float32) -> Dict:
    """Random parameters with the JAX ``sampler.init`` key set and shapes,
    on ``device`` (the current CUDA device when None)."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    params: Dict = {"post_qformer": resampler.init(
        grid_size=math.isqrt(cfg.mm_resampler_dim), embed_dim=cfg.mm_hidden_size,
        kv_dim=cfg.mm_hidden_size, llm_hidden_size=cfg.hidden_size, **kw)}
    if cfg.mm_resampler_type == "qformer":
        E = cfg.hidden_size
        dev = L.resolve_device(device)
        params["selector"] = {
            "query": L.trunc_normal((1, E), 0.02, generator, dev, dtype),
            "self_attn": L.mha_init(E, **kw),
            "cross_attn": L.mha_init(E, **kw),
            "ln_q": L.layer_norm_init(E, device=device, dtype=dtype),
            "ln_kv": L.layer_norm_init(E, device=device, dtype=dtype),
            "ln_post": L.layer_norm_init(E, device=device, dtype=dtype),
            "prob_proj": {"fc1": L.linear_init(E, E // 4, **kw),
                          "fc2": L.linear_init(E // 4, 1, **kw)},
        }
    return params


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


def _qformer_scores(p, local_f, text_emb, text_mask, *, num_heads: int,
                    temp: float) -> torch.Tensor:
    """[B,M,E], [B,L,E], [B,L] -> [B,M]: the cross-attention router's
    probabilities (TextGuidedRouterAttention.forward)."""
    x = L.layer_norm(p["ln_q"], local_f, eps=1e-6)
    t = L.layer_norm(p["ln_kv"], text_emb, eps=1e-6)
    pad = ~text_mask.to(torch.bool)
    out = L.mha(p["cross_attn"], x, t, t, num_heads, key_padding_mask=pad)
    out = L.layer_norm(p["ln_post"], out, eps=1e-6)
    h = torch.relu(L.linear(p["prob_proj"]["fc1"], out))
    logits = L.linear(p["prob_proj"]["fc2"], h)[..., 0]
    return torch.softmax(logits.to(torch.float32) / temp, dim=-1)


def select(params, local_f, text_emb, text_mask, token_valid, *,
           cfg: SliMEConfig, training: bool = False, generator=None,
           noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-p token selection as a static keep mask, per sample.

    local_f [B, M, llm_hidden]; text_emb [B, L, llm_hidden]; text_mask [B, L];
    token_valid [B, M]. Returns (keep [B, M] bool, probs [B, M] fp32): sort
    descending (stable), k = #(cumsum <= topp) + 1 clamped to the valid count,
    keep that prefix in original order. In training (with a ``generator``,
    or ``noise`` [B, M]) the scores first get ``noise * 0.1``."""
    if cfg.mm_resampler_type == "cosine":
        scores = _cosine_scores(local_f, text_emb, text_mask)
    else:
        scores = _qformer_scores(params["selector"], local_f, text_emb, text_mask,
                                 num_heads=cfg.llm_num_heads_128,
                                 temp=cfg.mm_resampler_temp)
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
