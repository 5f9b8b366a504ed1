"""Minimal Mamba (S6) block, the reference's dormant Mamba projector
(``llava/model/multimodal_projector/mamba.py``, which its projector factory never
selects).

Port of ``slime_tpu/models/mamba.py``. The selective scan is the affine
recurrence h_t = a_t * h_{t-1} + b_t per (channel, state); JAX computes it
with ``jax.lax.associative_scan``. Here it is a log-depth doubling scan over
the sequence with JAX's ``combine`` ((a1, b1), (a2, b2)) -> (a1 a2, a2 b1 +
b2): ceil(log2 S) steps, each over the whole [B, S, C, N] state. It sums in
another order than XLA's tree, so it agrees with JAX and with a sequential
loop to rounding (1e-4 at fp32), not bit for bit. The causal depthwise
convolution is an explicit sum over its taps, as JAX's.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from . import layers as L


def init(*, d_model: int, d_state: int = 16, d_conv: int = 4, expand: int = 2,
         generator, device=None, dtype=torch.float32) -> Dict:
    """Random block parameters with JAX's ``mamba.init`` keys and shapes, on
    ``device`` (the current CUDA device when None)."""
    device = L.resolve_device(device)
    d_inner = expand * d_model
    dt_rank = math.ceil(d_model / 16)
    kw = dict(generator=generator, device=device, dtype=dtype)
    conv_w = torch.randn((d_inner, d_conv), generator=generator, device=device)
    A = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": L.linear_init(d_model, 2 * d_inner, bias=False, **kw),
        "conv_w": (conv_w * (1.0 / math.sqrt(d_conv))).to(dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": L.linear_init(d_inner, dt_rank + 2 * d_state, bias=False, **kw),
        "dt_proj": L.linear_init(dt_rank, d_inner, **kw),
        "A_log": torch.log(A).expand(d_inner, d_state).to(dtype).contiguous(),
        "D": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": L.linear_init(d_inner, d_model, bias=False, **kw),
        "norm": L.rms_norm_init(d_model, device=device, dtype=dtype),
    }


def _depthwise_conv(x, w, b, d_conv: int):
    """Causal depthwise conv1d: x [B, S, C], w [C, K] -> [B, S, C]:
    y_t = sum_k w[:, k] * x_{t - (K - 1) + k}, zero before the start."""
    S = x.shape[1]
    y = sum(torch.nn.functional.pad(x, (0, 0, d_conv - 1 - k, 0))[:, :S] * w[None, None, :, k]
            for k in range(d_conv))
    return y + b


def scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1 by
    doubling: after the step of offset d, position t holds the composition
    of the (up to) 2d steps ending at t, so its b is h_t once 2d >= S."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a_cur, b_cur = a[:, d:], b[:, d:]
        a = torch.cat([a[:, :d], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :d], a_cur * b_prev + b_cur], dim=1)
        d *= 2
    return b


def selective_scan(u, delta, A, B, C, D):
    """u [B, S, C]; delta [B, S, C]; A [C, N]; B, C [B, S, N]; D [C] -> y
    [B, S, C]: h = exp(delta A) h + delta B u per (channel, state), read out
    through C, plus the skip u D."""
    dA = torch.exp(delta[..., None] * A)                           # [B, S, C, N]
    dBu = (delta * u)[..., None] * B[:, :, None, :]                # [B, S, C, N]
    h = scan(dA, dBu)
    y = torch.einsum("bscn,bsn->bsc", h, C)
    return y + u * D[None, None]


def apply(p: Dict, x: torch.Tensor, *, d_state: int = 16, d_conv: int = 4) -> torch.Tensor:
    """The block with its pre-norm residual: x [B, S, d_model] -> same shape."""
    res = x
    x = L.rms_norm(p["norm"], x)
    xin, z = L.linear(p["in_proj"], x).chunk(2, dim=-1)
    xin = L.silu(_depthwise_conv(xin, p["conv_w"], p["conv_b"], d_conv))
    dt_rank = p["dt_proj"]["weight"].shape[1]
    dt, Bm, Cm = L.linear(p["x_proj"], xin).split(
        [dt_rank, d_state, p["x_proj"]["weight"].shape[0] - dt_rank - d_state], dim=-1)
    delta = torch.nn.functional.softplus(L.linear(p["dt_proj"], dt))
    A = -torch.exp(p["A_log"])
    y = selective_scan(xin, delta, A, Bm, Cm, p["D"])
    y = y * L.silu(z)
    return res + L.linear(p["out_proj"], y)
