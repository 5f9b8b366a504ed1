"""Decode-step SwiGLU block: CUDA kernels and their plain version.

Port of ``slime_tpu/ops/fused_mlp.py``: ``x + down(silu(gate(h)) * up(h))``
with ``h = rms_norm(x)``, for one layer of the pre-stacked weights. The TPU
kernel (K1) streams gate/up rows and the matching down columns chunk by chunk
and keeps ``a = silu(g) * u`` in VMEM. On the card it takes two launches in
one wrapper (``csrc/fused_decode.cu``): gate/up into an ``a [B, I]`` scratch,
a few tens of KB that stays in L2, then down plus the residual.

bf16 activations with int8 or q4g weights at B <= 8 (``ring_instance``: the
decode steps of the int8 and 4-bit serving paths) take the weight ring
(``weight_ring_kernel``, ``ops/weight_ring.py``) where both projections
have a launch plan (``ring_route``): one C call launches the row norm,
gate/up and down, the last two as programmatic dependents of the launch
before them, each a persistent grid that streams bands of whole weight rows
into shared memory by 1-D bulk copies, with the launch plans of
``ring_plan``. Every other input, a layer too wide for the ring's shared
memory included, takes the row-per-warp kernels. Launch counts:
``.ring_launches`` counts the calls that took the ring
(``.q4g_ring_launches`` those on q4g weights), beside the counts every call
adds.

Rounding kept from the TPU kernel (fused_mlp.py:227-292), with the working
dtype bf16 or fp32 (the activations'): h rounds to the working dtype; dots
accumulate in fp32 over exactly converted int8 or int4;
per-row int8 scales multiply the fp32 results, q4g scales each 128-column
group's fp32 partial sum; a = silu(g) * u rounds to the working dtype; down
accumulates in fp32 with its scales, and x is added in fp32 before the final
cast. Weight formats and their codes are ``fused_qkvo``'s.

``auto_block_ok`` (fused_mlp.py:330-363) is the JAX package's rule for when
the fused decode is the automatic choice: the intermediate dim must tile
cleanly at the TPU kernel's preferred chunk. The port keeps the rule so
``decode_step(fused=None)`` picks the same path on both packages.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda
from . import weight_ring as wr
from .fused_qkvo import (Q4G, _at, act_f32, check_operands, count, count_ring, kernel_fmt,
                         layer_mats, norm_weight, proj_ref, rms_h, rms_norm_launch,
                         split_weight)
from .quantization import int_values
from .weight_ring import ring_instance

# the TPU kernel's preferred intermediate chunk per format (fused_mlp.py:323)
_PREFERRED_BLOCK = {"dense": 512, "int8": 1024, "q4g": 1024}


def _block_divisor(I: int, want: int, *, step: int = 128) -> int:
    """Largest multiple of ``step`` that divides I, at most ``want``; I
    itself when none does (fused_mlp.py:352-363)."""
    bi = min(want, I)
    bi -= bi % step
    while bi >= step and I % bi:
        bi -= step
    return bi if bi >= step and I % bi == 0 else I


def auto_block_ok(layers) -> bool:
    """True when the MLP's intermediate dim tiles at the preferred chunk:
    the condition for the fused kernels to be the automatic choice."""
    gw = layers["gate_proj"]["weight"]
    if not isinstance(gw, dict):
        fmt, I = "dense", gw.shape[1]
    else:
        fmt = "q4g" if "q4g" in gw else "int8"
        I = gw.get("q4g", gw.get("q")).shape[1]
    want = _PREFERRED_BLOCK[fmt]
    step = 1024 if fmt == "q4g" else 128
    return _block_divisor(I, want, step=step) >= min(I, want) // 2


@functools.lru_cache(maxsize=None)
def ring_plan(B: int, H: int, I: int, fmt: int, sms: int):
    """(gate/up, down) launch plans of ``fused_mlp_decode`` on the ring, and
    the C array of both that the launch takes; None where either projection
    has no plan."""
    gu = wr.launch_or_none(B, H, I, fmt, 2, sms)
    dn = wr.launch_or_none(B, I, H, fmt, 1, sms)
    return None if gu is None or dn is None else (gu, dn, wr.c_plan(gu, dn))


def ring_route(B: int, dtype, fmt: int, H: int, I: int, sms: int):
    """The routing rule of ``fused_mlp_decode``: ``ring_plan``'s plans where
    the call takes the weight ring (``ring_instance`` holds and both
    projections have a plan), None where it takes the row-per-warp
    kernels."""
    return ring_plan(B, H, I, fmt, sms) if ring_instance(B, dtype, fmt) else None


def silu(x):
    """x * sigmoid(x), written as jax.nn.silu."""
    return x * torch.sigmoid(x)


def fused_mlp_decode_ref(x, layers, layer_idx, *, eps: float = 1e-5):
    """Plain version of ``fused_mlp_decode``."""
    h = rms_h(x, layers["post_attention_layernorm"]["weight"][layer_idx], eps)
    (wg, sg, fg), (wu, su, fu), (wd, sd, fd) = [
        split_weight(layers[n]) for n in ("gate_proj", "up_proj", "down_proj")]
    g = proj_ref(h, wg[layer_idx], _at(sg, layer_idx), fg)
    u = proj_ref(h, wu[layer_idx], _at(su, layer_idx), fu)
    a = (silu(g) * u).to(x.dtype)
    y = proj_ref(a, wd[layer_idx], _at(sd, layer_idx), fd)
    return (x.to(torch.float32) + y).to(x.dtype)


def intermediate_ulp_bound(x, layers, layer_idx, *, eps: float = 1e-5):
    """[B, H] fp32: sum_i ulp(a_i) |w_down[o, i]| for the intermediate a =
    bf16(silu(g) u) of the plain version (ulp: the spacing of bf16 at |a_i|,
    2^(floor(log2 |a_i|) - 7)), w_down dequantized. Where the kernel and the
    plain version, summing g and u in other orders, round an element of a to
    neighbouring bf16 values, the output moves by that element's ulp times
    its weight: this is the floor a comparison of the two needs. fp32
    activations do not round a: zeros."""
    B, H = x.shape
    if x.dtype != torch.bfloat16:
        return torch.zeros((B, H), dtype=torch.float32, device=x.device)
    h = rms_h(x, layers["post_attention_layernorm"]["weight"][layer_idx], eps)
    (wg, sg, fg), (wu, su, fu), (wd, sd, fd) = [
        split_weight(layers[n]) for n in ("gate_proj", "up_proj", "down_proj")]
    g = proj_ref(h, wg[layer_idx], _at(sg, layer_idx), fg)
    u = proj_ref(h, wu[layer_idx], _at(su, layer_idx), fu)
    a = (silu(g) * u).to(x.dtype).to(torch.float32).abs()
    ulp = torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7), 0.0)
    # |w_down| dequantized to fp32, [H, I]
    w, sc = wd[layer_idx], _at(sd, layer_idx)
    if fd == Q4G:
        w = int_values({"q4g": w, "scale": sc}).to(torch.float32).abs()
        w = w * sc.to(torch.float32).abs().repeat_interleave(128, dim=-1)
    elif sc is not None:
        w = w.to(torch.float32).abs() * sc.to(torch.float32).abs()
    else:
        w = w.to(torch.float32).abs()
    return torch.matmul(ulp, w.T)


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
    if fmt == Q4G and I % 256:
        raise ValueError(f"q4g decode kernels take I a multiple of 256, got {I}")
    if (wu.shape != wg.shape or wd.shape[0] != H or fmt_d != fmt
            or len({wg.dtype, wu.dtype, wd.dtype}) != 1
            or wd.shape[1] != (I // 2 if fmt == Q4G else I)):
        raise ValueError(f"MLP weights gate {tuple(wg.shape)} up {tuple(wu.shape)} "
                         f"down {tuple(wd.shape)} do not form one SwiGLU block")
    lib = _cuda.library()
    p = _cuda.ptr
    norm_w = layers["post_attention_layernorm"]["weight"][layer_idx]
    a = torch.empty((B, I), dtype=x.dtype, device=x.device)
    check_operands(a, down)
    y = torch.empty_like(x)
    route = ring_route(B, x.dtype, fmt, H, I, wr.sm_count(x.device))
    if route is not None:
        nw = norm_weight(x, norm_w)
        *_, plan = route
        h = torch.empty_like(x)
        _cuda.check(lib.slime_mlp_ring(
            fmt, int(wr.PDL), x.data_ptr(), nw.data_ptr(), eps, h.data_ptr(), a.data_ptr(),
            y.data_ptr(), B, H, I, p(wg), p(sg), p(wu), p(su), p(wd), p(sd),
            ctypes.addressof(plan), _cuda.stream()), "fused_mlp_decode (weight ring)")
        count_ring(fused_mlp_decode, fmt)
    else:
        h = rms_norm_launch(x, norm_w, eps, lib)
        wfmt, f32 = kernel_fmt(wg, fmt), act_f32(x)
        _cuda.check(lib.slime_gate_up_gemv(
            f32, wfmt, h.data_ptr(), B, H, p(wg), p(sg), p(wu), p(su), I, a.data_ptr(),
            _cuda.stream()), "fused_mlp_decode gate/up")
        _cuda.check(lib.slime_resid_gemv(
            f32, wfmt, a.data_ptr(), B, I, p(wd), p(sd), H, x.data_ptr(), y.data_ptr(),
            _cuda.stream()), "fused_mlp_decode down")
    count(fused_mlp_decode, x, fmt)
    return y


fused_mlp_decode.launches = fused_mlp_decode.q4g_launches = 0
fused_mlp_decode.f32_launches = fused_mlp_decode.f32_q4g_launches = 0
fused_mlp_decode.ring_launches = fused_mlp_decode.q4g_ring_launches = 0
