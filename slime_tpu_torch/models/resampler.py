"""Perceiver resampler: learnable-query cross-attention compressor.

Port of ``slime_tpu/models/resampler.py`` (:22-112): grid_size^2 learnable
queries, a fixed 2-D sincos position table (bicubic-interpolated to the
source grid), one cross-attention layer, LayerNorms at eps=1e-6.
``apply_with_text`` is the text-conditioned variant the ``qformer_text``
projector uses (ResamplerWithText): the queries first self-attend over
[queries; text] with the text padding masked, then cross-attend the image.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import layers as L

LN_EPS = 1e-6


def init(*, grid_size: int, embed_dim: int, kv_dim: Optional[int] = None,
         llm_hidden_size: int = 4096, use_post_proj: bool = False,
         with_text: bool = False, text_dim: Optional[int] = None, generator,
         device=None, dtype=torch.float32) -> Dict:
    """Random parameters with the JAX ``resampler.init`` key set and shapes,
    on ``device`` (the current CUDA device when None). ``with_text`` adds
    the text path: ``self_attn``, and ``kv_proj`` from ``text_dim`` (default
    the LLM width) where that is not ``embed_dim``. The head count only
    shapes ``apply``."""
    device = L.resolve_device(device)
    params: Dict = {
        "pos_embed": torch.from_numpy(L.sincos_2d(embed_dim, grid_size)).to(
            device=device, dtype=dtype),
        "query": L.trunc_normal((grid_size * grid_size, embed_dim), 0.02,
                                generator, device, dtype),
        "attn": L.mha_init(embed_dim, generator=generator, device=device,
                           dtype=dtype),
        "ln_q": L.layer_norm_init(embed_dim, device=device, dtype=dtype),
        "ln_kv": L.layer_norm_init(embed_dim, device=device, dtype=dtype),
        "ln_post": L.layer_norm_init(embed_dim, device=device, dtype=dtype),
    }
    kw = dict(generator=generator, device=device, dtype=dtype)
    if with_text:
        proj_in = text_dim if text_dim is not None else llm_hidden_size
        if proj_in != embed_dim:
            params["kv_proj"] = L.linear_init(proj_in, embed_dim, bias=False, **kw)
        params["self_attn"] = L.mha_init(embed_dim, **kw)
    elif kv_dim is not None and kv_dim != embed_dim:
        params["kv_proj"] = L.linear_init(kv_dim, embed_dim, bias=False, **kw)
    if use_post_proj:
        params["proj"] = L.linear_init(embed_dim, llm_hidden_size,
                                       generator=generator, device=device,
                                       dtype=dtype)
    return params


def _src_grid(seq_len: int, tgt=(24, 24)):
    if seq_len != tgt[0] * tgt[1]:
        s = math.isqrt(seq_len)
        return (s, s)
    return tgt


def apply(params, x, *, num_heads: int, tgt_size=(24, 24)) -> torch.Tensor:
    """x [N, L, D] -> [N, n_queries, embed_dim]."""
    n_q = params["query"].shape[0]
    tgt = _src_grid(x.shape[1], tgt_size)
    pos_src = L.interp_pos_embed(params["pos_embed"], tgt).to(x.dtype)

    if "kv_proj" in params:
        x = L.linear(params["kv_proj"], x)
    kv = L.layer_norm(params["ln_kv"], x, eps=LN_EPS)

    q = L.layer_norm(params["ln_q"], params["query"][None].to(x.dtype), eps=LN_EPS)
    q = q.expand(x.shape[0], n_q, q.shape[-1])
    # query positions use the native table; key positions the interpolated one
    q_pos = q + params["pos_embed"].to(x.dtype)[None]
    k_pos = kv + pos_src[None]

    out = L.mha(params["attn"], q_pos, k_pos, kv, num_heads)
    out = L.layer_norm(params["ln_post"], out, eps=LN_EPS)
    if "proj" in params:
        out = L.linear(params["proj"], out)
    return out


def apply_with_text(params, x, text, text_mask, *, num_heads: int,
                    tgt_size=(24, 24)) -> torch.Tensor:
    """x [N, L, D] image features; text [N, Lt, llm_hidden]; text_mask
    [N, Lt] True where valid -> [N, n_queries, embed_dim] (resampler.py:83-112)."""
    n_q = params["query"].shape[0]
    N = x.shape[0]
    tgt = _src_grid(x.shape[1], tgt_size)
    pos_src = L.interp_pos_embed(params["pos_embed"], tgt).to(x.dtype)

    t = text
    if "kv_proj" in params:
        t = L.linear(params["kv_proj"], t)
    t = L.layer_norm(params["ln_kv"], t, eps=LN_EPS)

    q = params["query"][None].to(x.dtype).expand(N, n_q, x.shape[-1])
    qt = torch.cat([q, t], dim=1)
    pad = torch.cat([torch.zeros((N, n_q), dtype=torch.bool, device=x.device),
                     ~text_mask.to(torch.bool)], dim=1)
    qt = L.mha(params["self_attn"], qt, qt, qt, num_heads, key_padding_mask=pad)

    q = L.layer_norm(params["ln_q"], qt[:, :n_q], eps=LN_EPS)
    q_pos = q + params["pos_embed"].to(x.dtype)[None]
    k_pos = x + pos_src[None]
    out = L.mha(params["attn"], q_pos, k_pos, x, num_heads)
    out = L.layer_norm(params["ln_post"], out, eps=LN_EPS)
    if "proj" in params:
        out = L.linear(params["proj"], out)
    return out
