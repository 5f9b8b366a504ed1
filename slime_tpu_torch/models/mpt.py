"""MPT decoder (alibi attention, fused QKV, LayerNorm), the reference's fourth
LLM family (``llava/model/language_model/llava_mpt.py`` wraps HF MPT).

Port of ``slime_tpu/models/mpt.py``: no RoPE, the attention scores carry
per-head alibi slopes times the key's distance and a causal mask of -1e30;
pre-LayerNorm blocks with a fused ``Wqkv`` projection and an exact-GELU MLP;
the LM head is tied to ``wte``. The attention is the explicit one JAX
computes (fp32 scores and softmax, p rounded to the activation dtype before
P.V): K5 takes no alibi bias and JAX runs no flash kernel here.

``init`` and ``forward`` run on the card unless a device is given;
``convert_hf`` maps a HF ``MptForCausalLM`` state dict to the same numpy
tree as JAX's (move it with ``params.from_jax_numpy``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from . import layers as L


@dataclass(frozen=True)
class MPTConfig:
    vocab_size: int = 50432
    d_model: int = 4096
    n_heads: int = 32
    n_layers: int = 32
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    layer_norm_eps: float = 1e-5
    no_bias: bool = True

    @classmethod
    def tiny(cls) -> "MPTConfig":
        return cls(vocab_size=256, d_model=64, n_heads=4, n_layers=2, max_seq_len=128)


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """The alibi head slopes [n_heads] fp32: powers of 2^(-8/n) for n the next
    power of two, interleaved and cut when n_heads is not one (``mpt.py:37``:
    a Python float raised to fp32 exponents)."""
    device = L.resolve_device(device)
    n = 2 ** math.ceil(math.log2(n_heads))
    base = torch.tensor(2.0 ** (-8.0 / n), dtype=torch.float32, device=device)
    slopes = base ** torch.arange(1, n + 1, dtype=torch.float32, device=device)
    if n != n_heads:
        slopes = torch.cat([slopes[0::2], slopes[1::2]])[:n_heads]
    return slopes


def init(cfg: MPTConfig, *, generator, device=None, dtype=torch.float32) -> Dict:
    """Random parameters with JAX's ``mpt.init`` keys and shapes, on
    ``device`` (the current CUDA device when None)."""
    device = L.resolve_device(device)
    D = cfg.d_model
    kw = dict(generator=generator, device=device, dtype=dtype, bias=not cfg.no_bias)
    params: Dict = {
        "wte": (torch.randn((cfg.vocab_size, D), generator=generator, device=device)
                * 0.02).to(dtype),
        "norm_f": L.layer_norm_init(D, device=device, dtype=dtype),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "norm_1": L.layer_norm_init(D, device=device, dtype=dtype),
            "Wqkv": L.linear_init(D, 3 * D, **kw),
            "out_proj": L.linear_init(D, D, **kw),
            "norm_2": L.layer_norm_init(D, device=device, dtype=dtype),
            "up_proj": L.linear_init(D, cfg.expansion_ratio * D, **kw),
            "down_proj": L.linear_init(cfg.expansion_ratio * D, D, **kw),
        })
    return params


def attention_bias(cfg: MPTConfig, S: int, offset: int = 0, device=None) -> torch.Tensor:
    """[1, H, S, offset + S] fp32: slope * (key position - query position) where
    the key is visible, -1e30 where it is not (``mpt.py:87``; HF MPT's
    slope * (position - max) differs by a per-row constant, which the softmax
    drops)."""
    device = L.resolve_device(device)
    slopes = alibi_slopes(cfg.n_heads, device)
    q_pos = torch.arange(offset, offset + S, device=device)
    k_pos = torch.arange(offset + S, device=device)
    rel = k_pos[None, :] - q_pos[:, None]                    # <= 0 where visible
    bias = slopes[:, None, None] * rel[None]
    causal = q_pos[:, None] >= k_pos[None, :]
    return torch.where(causal[None], bias, -1e30)[None]


def _attn(lp, x, cfg: MPTConfig, bias):
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    q, k, v = L.linear(lp["Wqkv"], x).chunk(3, dim=-1)
    q, k, v = (t.reshape(B, S, H, hd).to(torch.float32) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    p = torch.softmax(s + bias, dim=-1).to(x.dtype).to(torch.float32)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).to(x.dtype)
    return L.linear(lp["out_proj"], o.reshape(B, S, D))


def forward(params, input_ids, cfg: MPTConfig, *, compute_dtype=torch.float32):
    """input_ids [B, S] -> logits fp32 [B, S, V] (the head tied to ``wte``,
    fp32 accumulation)."""
    x = params["wte"][input_ids.long()].to(compute_dtype)
    bias = attention_bias(cfg, x.shape[1], device=x.device)
    eps = cfg.layer_norm_eps
    for lp in params["layers"]:
        h = L.layer_norm(lp["norm_1"], x, eps=eps)
        x = x + _attn(lp, h, cfg, bias)
        h = L.layer_norm(lp["norm_2"], x, eps=eps)
        h = L.linear(lp["down_proj"], torch.nn.functional.gelu(
            L.linear(lp["up_proj"], h), approximate="none"))
        x = x + h
    x = L.layer_norm(params["norm_f"], x, eps=eps)
    return torch.matmul(x.to(torch.float32),
                        params["wte"].to(x.dtype).to(torch.float32).T)


def convert_hf(sd: Dict, cfg: MPTConfig, prefix: str = "transformer.") -> Dict:
    """HF MptForCausalLM state dict (numpy arrays) -> this layout, as numpy
    (``mpt.py:116``); absent LayerNorm biases become zeros."""
    def g(k):
        return np.asarray(sd[prefix + k])

    zero = np.zeros(cfg.d_model, np.float32)
    params: Dict = {
        "wte": g("wte.weight"),
        "norm_f": {"weight": g("norm_f.weight"),
                   "bias": sd.get(prefix + "norm_f.bias", zero)},
        "layers": [],
    }
    for i in range(cfg.n_layers):
        b = f"blocks.{i}."
        params["layers"].append({
            "norm_1": {"weight": g(b + "norm_1.weight"),
                       "bias": sd.get(prefix + b + "norm_1.bias", zero)},
            "Wqkv": {"weight": g(b + "attn.Wqkv.weight")},
            "out_proj": {"weight": g(b + "attn.out_proj.weight")},
            "norm_2": {"weight": g(b + "norm_2.weight"),
                       "bias": sd.get(prefix + b + "norm_2.bias", zero)},
            "up_proj": {"weight": g(b + "ffn.up_proj.weight")},
            "down_proj": {"weight": g(b + "ffn.down_proj.weight")},
        })
    return params
