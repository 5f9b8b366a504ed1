"""CLIP ViT vision tower (CLIP-L/336) in PyTorch.

Port of ``slime_tpu/models/vit.py``. The patch embedding is the conv written
as a reshape plus one matmul (``vit.py:171-172``), not ``nn.Conv2d``: cuDNN
would run an fp32 conv in TF32. Attention goes through
``ops.encoder_attention`` (the CUDA kernel on the card).

Feature selection as in the reference: tap hidden state ``select_layer``
(-2: run 23 of 24 layers) and drop the CLS token.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..config import VisionConfig
from ..ops.encoder_attention import encoder_attention
from . import layers as L


def quick_gelu(x):
    """x * sigmoid(1.702 x), as vit.quick_gelu."""
    return x * torch.sigmoid(1.702 * x)


def init(cfg: VisionConfig, *, generator, device="cpu",
         dtype=torch.float32) -> Dict:
    """Random parameters with the JAX ``vit.init`` key set and shapes."""
    E = cfg.hidden_size
    n_pos = cfg.num_patches + 1
    patch_dim = 3 * cfg.patch_size * cfg.patch_size

    def normal(*shape):
        t = torch.randn(shape, generator=generator, device=device) * 0.02
        return t.to(dtype)

    lin = lambda i, o: L.linear_init(i, o, generator=generator,   # noqa: E731
                                     device=device, dtype=dtype)
    params = {
        "class_embedding": normal(E),
        "patch_embedding": normal(E, patch_dim),
        "position_embedding": normal(n_pos, E),
        "pre_layernorm": L.layer_norm_init(E, device=device, dtype=dtype),
        "post_layernorm": L.layer_norm_init(E, device=device, dtype=dtype),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "layer_norm1": L.layer_norm_init(E, device=device, dtype=dtype),
            "q_proj": lin(E, E),
            "k_proj": lin(E, E),
            "v_proj": lin(E, E),
            "out_proj": lin(E, E),
            "layer_norm2": L.layer_norm_init(E, device=device, dtype=dtype),
            "fc1": lin(E, cfg.intermediate_size),
            "fc2": lin(cfg.intermediate_size, E),
        })
    return params


def _attention(p, x, num_heads: int):
    B, S, E = x.shape
    hd = E // num_heads
    if "qkv" in p:
        raise NotImplementedError("packed/W8A8 vision towers are not ported yet "
                                  "(ROADMAP: K8 w8a8_matmul)")
    q = L.linear(p["q_proj"], x).reshape(B, S, num_heads, hd)
    k = L.linear(p["k_proj"], x).reshape(B, S, num_heads, hd)
    v = L.linear(p["v_proj"], x).reshape(B, S, num_heads, hd)
    out = encoder_attention(q, k, v, scale=1.0 / math.sqrt(hd))
    return L.linear(p["out_proj"], out.reshape(B, S, E))


def _block(p, x, cfg: VisionConfig):
    h = L.layer_norm(p["layer_norm1"], x, eps=cfg.layer_norm_eps)
    x = x + _attention(p, h, cfg.num_heads)
    h = L.layer_norm(p["layer_norm2"], x, eps=cfg.layer_norm_eps)
    h = L.linear(p["fc2"], quick_gelu(L.linear(p["fc1"], h)))
    return x + h


def embed_patches(params, pixel_values, cfg: VisionConfig):
    """[B, 3, H, W] -> [B, 1+P, E]: conv-as-matmul patch embed + CLS + positions."""
    B = pixel_values.shape[0]
    ps, n = cfg.patch_size, cfg.num_patches_per_side
    x = pixel_values.reshape(B, 3, n, ps, n, ps)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, n * n, 3 * ps * ps)
    x = torch.matmul(x, params["patch_embedding"].to(x.dtype).T)
    cls = params["class_embedding"].to(x.dtype).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    return x + params["position_embedding"].to(x.dtype)


def apply(params, pixel_values, cfg: VisionConfig):
    """[B, 3, H, W] -> patch features [B, P, E] (CLS dropped, layer
    ``select_layer``)."""
    x = embed_patches(params, pixel_values, cfg)
    x = L.layer_norm(params["pre_layernorm"], x, eps=cfg.layer_norm_eps)
    n_run = (cfg.num_layers + cfg.select_layer + 1 if cfg.select_layer < 0
             else cfg.select_layer)
    for i in range(n_run):
        x = _block(params["layers"][i], x, cfg)
    if cfg.select_feature == "patch":
        x = x[:, 1:]
    return x
