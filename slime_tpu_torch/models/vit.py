"""CLIP ViT vision tower (CLIP-L/336) in PyTorch.

Port of ``slime_tpu/models/vit.py``. The patch embedding is the conv written
as a reshape plus one matmul (``vit.py:171-172``), not ``nn.Conv2d``: cuDNN
would run an fp32 conv in TF32. Attention goes through
``ops.encoder_attention`` (the CUDA kernel on the card).

Feature selection as in the reference: tap hidden state ``select_layer``
(-2: run 23 of 24 layers) and drop the CLS token.

``quantize_tower`` builds the W8A8 tower of the CLI's ``--quantize-vision``
(per-row int8 weights, q/k/v packed into one ``qkv`` linear); ``_linear``
sends such weights through ``ops.w8a8_matmul`` (the K8 kernel on the card)
and everything else through ``layers.linear``, as ``vit.py:60-70`` does.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..config import VisionConfig
from ..ops.encoder_attention import encoder_attention
from ..ops.quantization import quantize_weight
from ..ops.w8a8_matmul import w8a8_linear
from . import layers as L


def quick_gelu(x):
    """x * sigmoid(1.702 x), as vit.quick_gelu."""
    return x * torch.sigmoid(1.702 * x)


def init(cfg: VisionConfig, *, generator, device=None,
         dtype=torch.float32) -> Dict:
    """Random parameters with the JAX ``vit.init`` key set and shapes, on
    ``device`` (the current CUDA device when None)."""
    device = L.resolve_device(device)
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


def _linear(p, x):
    """Per-row int8 weights (a ``quantize_tower`` tree) take the W8A8 path;
    any other weight, quantized or not, takes ``layers.linear``."""
    w = p["weight"]
    if isinstance(w, dict) and "q" in w and w["scale"].shape[-1] == 1:
        return w8a8_linear(p, x)
    return L.linear(p, x)


def _attention(p, x, num_heads: int):
    B, S, E = x.shape
    hd = E // num_heads
    if "qkv" in p:
        # one packed [3E, E] projection: x is read (and quantized) once
        q, k, v = (t.reshape(B, S, num_heads, hd)
                   for t in _linear(p["qkv"], x).split(E, dim=-1))
    else:
        q, k, v = (_linear(p[n], x).reshape(B, S, num_heads, hd)
                   for n in ("q_proj", "k_proj", "v_proj"))
    out = encoder_attention(q, k, v, scale=1.0 / math.sqrt(hd))
    return _linear(p["out_proj"], out.reshape(B, S, E))


def _block(p, x, cfg: VisionConfig):
    h = L.layer_norm(p["layer_norm1"], x, eps=cfg.layer_norm_eps)
    x = x + _attention(p, h, cfg.num_heads)
    h = L.layer_norm(p["layer_norm2"], x, eps=cfg.layer_norm_eps)
    h = _linear(p["fc2"], quick_gelu(_linear(p["fc1"], h)))
    return x + h


def _layers_run(cfg: VisionConfig) -> int:
    return cfg.num_layers + cfg.select_layer + 1 if cfg.select_layer < 0 else cfg.select_layer


def pack_qkv_tower(params, cfg: VisionConfig):
    """Pack each running layer's q/k/v projections into one [3E, E] ``qkv``
    linear (``vit.py:105-130``). An inference-time transform: the export
    keeps q/k/v separate."""
    out = {k: v for k, v in params.items() if k != "layers"}
    names = ("q_proj", "k_proj", "v_proj")
    layers = []
    for i, lp in enumerate(params["layers"]):
        if i >= _layers_run(cfg) or "qkv" in lp:
            layers.append(lp)
            continue
        nl = {k: v for k, v in lp.items() if k not in names}
        nl["qkv"] = {"weight": torch.cat([lp[k]["weight"] for k in names], dim=0),
                     "bias": torch.cat([lp[k]["bias"] for k in names], dim=0)}
        layers.append(nl)
    out["layers"] = layers
    return out


def quantize_tower(params, cfg: VisionConfig):
    """The W8A8 tower (``vit.py:133-164``): every running layer's linear
    weights to per-row int8, q/k/v packed into one ``qkv`` weight, biases
    fp32. Embeddings, layer norms and the unused post-layernorm stay as
    they are."""
    out = {k: v for k, v in params.items() if k != "layers"}
    names = ("q_proj", "k_proj", "v_proj")
    layers = []
    for i, lp in enumerate(params["layers"]):
        if i >= _layers_run(cfg):
            layers.append(lp)
            continue
        nl = {"layer_norm1": lp["layer_norm1"], "layer_norm2": lp["layer_norm2"]}
        nl["qkv"] = {
            "weight": quantize_weight(torch.cat(
                [lp[k]["weight"].to(torch.float32) for k in names], dim=0), 8),
            "bias": torch.cat([lp[k]["bias"].to(torch.float32) for k in names], dim=0)}
        for k in ("out_proj", "fc1", "fc2"):
            nl[k] = {"weight": quantize_weight(lp[k]["weight"].to(torch.float32), 8),
                     "bias": lp[k]["bias"].to(torch.float32)}
        layers.append(nl)
    out["layers"] = layers
    return out


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


def apply(params, pixel_values, cfg: VisionConfig, *, remat: bool = False):
    """[B, 3, H, W] -> patch features [B, P, E] (CLS dropped, layer
    ``select_layer``). ``remat`` recomputes each encoder block in the
    backward (``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` around
    ``_block``, vit.py:180-192) when autograd records: the stash drops to each
    block's input, and the numbers stay the same."""
    x = embed_patches(params, pixel_values, cfg)
    x = L.layer_norm(params["pre_layernorm"], x, eps=cfg.layer_norm_eps)
    remat = remat and torch.is_grad_enabled()
    for i in range(_layers_run(cfg)):
        if remat:
            x = checkpoint(_block, params["layers"][i], x, cfg, use_reentrant=False)
        else:
            x = _block(params["layers"][i], x, cfg)
    if cfg.select_feature == "patch":
        x = x[:, 1:]
    return x
