"""Common functional layers (PyTorch mirror of ``slime_tpu/models/layers.py``).

Parameters are the JAX package's nested dicts, in its torch-compatible layout
(Linear weight [out, in], packed [3E, E] attention in-projection), so one
parameter tree moves between the packages through ``slime_tpu_torch.params``.

Compute policy, as in the JAX package: matmuls accumulate in fp32 and round
the result to the activation dtype. On the card cuBLAS does so only with
TF32 and reduced-precision bf16/fp16 reductions off; ``fp32_accumulation``
pins that, and the entry points of ``generate.py`` run under it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import numpy as np
import torch

from ..ops.quant_matmul import quant_matmul, quant_matmul_q4g
from ..ops.quantization import dequantize_weight


@contextlib.contextmanager
def fp32_accumulation():
    """Matmuls (and cuDNN) accumulate in fp32 inside the block: TF32 and
    cuBLAS's reduced-precision bf16/fp16 reductions are off, and the previous
    settings come back on exit. Also a decorator."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction, cudnn.allow_tf32)
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_fp16_reduced_precision_reduction = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction, cudnn.allow_tf32) = saved


def resolve_device(device=None) -> torch.device:
    """``device``, or the current CUDA device when it is None. Without a card
    that raises: the port's entry points run on the card unless the caller
    asks for the CPU (``device="cpu"``), and never fall back to it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by default; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def trunc_normal(shape, std, generator, device, dtype):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def linear_init(in_dim: int, out_dim: int, *, generator, device=None,
                dtype=torch.float32, bias: bool = True, std: float = 0.02):
    device = resolve_device(device)
    p = {"weight": trunc_normal((out_dim, in_dim), std, generator, device, dtype)}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ W.T [in, out] (+ b). Torch layout: weight [out, in].

    Quantized weights route as in ``layers.py:46-64``, with "on the TPU"
    read as "a CUDA tensor": per-row ``q4`` goes to the K6 kernel and ``q4g``
    to K7 (``ops.quant_matmul``); every other format (int8, NF4, grouped
    ``q4``), and every format on the CPU, dequantizes to fp32 and is cast to
    ``x.dtype`` before the matmul, as XLA does."""
    if "lora" in p or "lora_b" in p:
        raise NotImplementedError("LoRA adapters are not ported yet "
                                  "(ROADMAP Queue 1 step 9: lora.py)")
    w = p["weight"]
    if isinstance(w, dict) and x.device.type == "cuda" and (
            ("q4" in w and w["scale"].shape[-1] == 1) or "q4g" in w):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = quant_matmul_q4g(x2, w) if "q4g" in w else quant_matmul(x2, w)
        y = y.reshape(*x.shape[:-1], -1)
    else:
        if isinstance(w, dict):
            w = dequantize_weight(w)
        y = torch.matmul(x, w.to(x.dtype).transpose(-1, -2))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def layer_norm_init(dim: int, *, device=None, dtype=torch.float32):
    device = resolve_device(device)
    return {"weight": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(p, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["weight"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


def rms_norm_init(dim: int, *, device=None, dtype=torch.float32):
    return {"weight": torch.ones((dim,), dtype=dtype, device=resolve_device(device))}


def rms_norm(p, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * p["weight"].to(torch.float32)).to(x.dtype)


# ----------------------------------------------------------------------------
# torch-style MultiheadAttention (packed in-projection), as the JAX package's
# resampler and router use it.
# ----------------------------------------------------------------------------

def mha_init(embed_dim: int, *, generator, device=None, dtype=torch.float32,
             std: float = 0.02):
    device = resolve_device(device)
    return {
        "in_proj_weight": trunc_normal((3 * embed_dim, embed_dim), std,
                                       generator, device, dtype),
        "in_proj_bias": torch.zeros((3 * embed_dim,), dtype=dtype, device=device),
        "out_proj": linear_init(embed_dim, embed_dim, generator=generator,
                                device=device, dtype=dtype, std=std),
    }


def mha(p, q, k, v, num_heads: int, *, key_padding_mask=None):
    """Batch-first MHA: q [B,Lq,E], k/v [B,Lk,E]; key_padding_mask [B,Lk]
    True = masked. Mirrors ``layers.mha`` (``layers.py:128-155``)."""
    E = q.shape[-1]
    hd = E // num_heads
    wq, wk, wv = p["in_proj_weight"].chunk(3, dim=0)
    bq, bk, bv = p["in_proj_bias"].chunk(3, dim=0)
    dt = q.dtype

    def proj(x, w, b):
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32).T)
        return (y + b.to(torch.float32)).to(dt)

    qh = proj(q, wq, bq).reshape(*q.shape[:2], num_heads, hd)
    kh = proj(k, wk, bk).reshape(*k.shape[:2], num_heads, hd)
    vh = proj(v, wv, bv).reshape(*v.shape[:2], num_heads, hd)

    scores = torch.einsum("bqhd,bkhd->bhqk", qh.to(torch.float32),
                          kh.to(torch.float32)) / math.sqrt(hd)
    if key_padding_mask is not None:
        scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                    float("-inf"))
    attn = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.to(torch.float32),
                       vh.to(torch.float32)).to(dt)
    return linear(p["out_proj"], out.reshape(*q.shape[:2], E))


# ----------------------------------------------------------------------------
# 2-D sincos position tables and bicubic resize weights (host numpy, as in
# layers.py:162-224), and the position-table interpolation built on them.
# ----------------------------------------------------------------------------

def sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    """[grid_size**2, embed_dim] table; h-coords fill the first half."""
    coords = np.arange(grid_size, dtype=np.float64)
    gw, gh = np.meshgrid(coords, coords)
    emb_h = sincos_1d(embed_dim // 2, gh)
    emb_w = sincos_1d(embed_dim // 2, gw)
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def _cubic_kernel(d: np.ndarray, a: float = -0.75) -> np.ndarray:
    d = np.abs(d)
    return np.where(d <= 1, (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1,
                    np.where(d < 2, a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a,
                             0.0))


def bicubic_weight_matrix(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    """[dst, src] 1-D bicubic resize matrix, align_corners=False (torch)."""
    W = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = math.floor(x)
        t = x - x0
        for k in range(-1, 3):
            idx = min(max(x0 + k, 0), src - 1)
            W[i, idx] += _cubic_kernel(np.asarray(t - k), a)
    return W.astype(np.float32)


def pil_resize_matrix(src: int, dst: int, a: float = -0.5) -> np.ndarray:
    """[dst, src] weights of PIL's antialiased bicubic resize."""
    W = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    for i in range(dst):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src)
        d = (np.arange(xmin, xmax) - center + 0.5) / fscale
        w = _cubic_kernel(d, a)
        s = w.sum()
        if s != 0:
            W[i, xmin:xmax] = w / s
    return W.astype(np.float32)


def interp_pos_embed(pos: torch.Tensor, tgt: Tuple[int, int]) -> torch.Tensor:
    """Bicubic-resample a [S*S, C] position table to [th*tw, C]."""
    s = math.isqrt(pos.shape[0])
    th, tw = tgt
    if (th, tw) == (s, s):
        return pos
    grid = pos.reshape(s, s, -1).to(torch.float32)
    wy = torch.from_numpy(bicubic_weight_matrix(s, th)).to(pos.device)
    wx = torch.from_numpy(bicubic_weight_matrix(s, tw)).to(pos.device)
    out = torch.einsum("ys,sxc->yxc", wy, grid)
    out = torch.einsum("xs,ysc->yxc", wx, out)
    return out.reshape(th * tw, -1).to(pos.dtype)

