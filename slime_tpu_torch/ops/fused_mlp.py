"""Decode-step SwiGLU block: CUDA kernels and their plain version.

Port of ``slime_tpu/ops/fused_mlp.py``: ``x + down(silu(gate(h)) * up(h))``
with ``h = rms_norm(x)``, for one layer of the pre-stacked weights. The TPU
kernel (K1) streams gate/up rows and the matching down columns chunk by chunk
and keeps ``a = silu(g) * u`` in VMEM. On the card it takes two launches in
one wrapper (``csrc/fused_decode.cu``): gate/up into an ``a [B, I]`` scratch,
a few tens of KB that stays in L2, then down plus the residual.

Rounding kept from the TPU kernel (fused_mlp.py:227-292): h rounds to the
working dtype; dots accumulate in fp32 over exactly converted int8; per-row
scales multiply the fp32 results; a = silu(g*gs) * (u*us) rounds to the
working dtype; down accumulates in fp32, takes its scale, and x is added in
fp32 before the final cast.
"""
from __future__ import annotations

import torch

from . import _cuda
from .fused_qkvo import (check_operands, layer_mats, proj_ref, rms_h,
                         rms_norm_launch, split_weight)


def silu(x):
    """x * sigmoid(x), written as jax.nn.silu."""
    return x * torch.sigmoid(x)


def fused_mlp_decode_ref(x, layers, layer_idx, *, eps: float = 1e-5):
    """Plain version of ``fused_mlp_decode``."""
    h = rms_h(x, layers["post_attention_layernorm"]["weight"][layer_idx], eps)
    (wg, sg, _), (wu, su, _), (wd, sd, _) = [
        split_weight(layers[n]) for n in ("gate_proj", "up_proj", "down_proj")]
    at = lambda s: None if s is None else s[layer_idx]     # noqa: E731
    g = proj_ref(h, wg[layer_idx], at(sg))
    u = proj_ref(h, wu[layer_idx], at(su))
    a = (silu(g) * u).to(x.dtype)
    y = proj_ref(a, wd[layer_idx], at(sd))
    return (x.to(torch.float32) + y).to(x.dtype)


def fused_mlp_decode(x, layers, layer_idx, *, eps: float = 1e-5):
    """x [B, H] -> x + SwiGLU(rms_norm(x)) for layer ``layer_idx``; reads
    post_attention_layernorm / gate_proj / up_proj / down_proj of the stacked
    dict. CPU tensors take the plain version; CUDA tensors launch the kernels
    or raise."""
    if x.device.type == "cpu":
        return fused_mlp_decode_ref(x, layers, layer_idx, eps=eps)
    gate_up = layer_mats(layers, ("gate_proj", "up_proj"), layer_idx)
    down = layer_mats(layers, ("down_proj",), layer_idx)
    check_operands(x, gate_up)
    (wg, sg, fmt), (wu, su, _) = gate_up
    (wd, sd, fmt_d), = down
    B, H = x.shape
    I = wg.shape[0]
    if wu.shape != wg.shape or wd.shape != (H, I) or fmt_d != fmt:
        raise ValueError(f"MLP weights gate {tuple(wg.shape)} up {tuple(wu.shape)} "
                         f"down {tuple(wd.shape)} do not form one SwiGLU block")
    lib = _cuda.library()
    p = _cuda.ptr
    h = rms_norm_launch(x, layers["post_attention_layernorm"]["weight"][layer_idx],
                        eps, lib)
    a = torch.empty((B, I), dtype=x.dtype, device=x.device)
    _cuda.check(lib.slime_gate_up_gemv(
        fmt, h.data_ptr(), B, H, p(wg), p(sg), p(wu), p(su), I, a.data_ptr(),
        _cuda.stream()), "fused_mlp_decode gate/up")
    check_operands(a, down)
    y = torch.empty_like(x)
    _cuda.check(lib.slime_resid_gemv(
        fmt, a.data_ptr(), B, I, p(wd), p(sd), H, x.data_ptr(), y.data_ptr(),
        _cuda.stream()), "fused_mlp_decode down")
    fused_mlp_decode.launches += 1
    return y


fused_mlp_decode.launches = 0
