"""Decode-step SwiGLU block: CUDA kernels and their plain version.

Port of ``slime_tpu/ops/fused_mlp.py``: ``x + down(silu(gate(h)) * up(h))``
with ``h = rms_norm(x)``, for one layer of the pre-stacked weights. The TPU
kernel (K1) streams gate/up rows and the matching down columns chunk by chunk
and keeps ``a = silu(g) * u`` in VMEM. On the card it takes two launches in
one wrapper (``csrc/fused_decode.cu``): gate/up into an ``a [B, I]`` scratch,
a few tens of KB that stays in L2, then down plus the residual.

The routing rule (``k1_route``, a pure function of the shapes and the
dtype) picks one of three instances:

- "ring": bf16 activations with int8 or q4g weights at B <= 8, or dense
  bf16 weights at B <= DENSE_RING_ROWS (4), or fp32 activations with int8
  or q4g weights at B <= F32_RING_ROWS (``ring_instance``: the decode
  steps of the int8 and 4-bit serving paths, of a bf16 checkpoint, and of
  the entry points' default fp32 compute dtype), where both projections
  have a launch plan (``ring_route``; fp32 activations take 4 bytes each
  in the plans, so fewer rows a launch): one C call
  launches the row norm, gate/up and down on the weight ring
  (``weight_ring_kernel``, ``ops/weight_ring.py``), the last two as
  programmatic dependents of the launch before them, each a persistent grid
  that streams bands of whole weight rows into shared memory by 1-D bulk
  copies, with the launch plans of ``ring_plan``;
- "wgmma": bf16 activations with int8 weights at B >= K1_WGMMA_MIN_ROWS (9:
  the engine's fused chunks, the speculative verify chunk), or dense bf16
  weights at B >= DENSE_WGMMA_MIN_ROWS (a bf16 checkpoint's chunks and
  decode steps above the ring's rows), where TMA reads the rows
  (``fused_qkvo.wgmma_strides``): the row norm, then K6's wgmma main loop
  over [W_gate; W_up] with a SwiGLU epilogue into ``a``, then over W_down
  split over I into an fp32 workspace (``fused_qkvo.wgmma_plan``) that a
  reduction sums, scales and adds x to: K3's tensor-core launch with ``a``
  as its activations. int8 weights become bf16 A fragments in registers;
  dense ones are the A operand straight from shared memory, 64 columns a
  stage, with no scales;
- "rows": every other input (fp32 activations past F32_RING_ROWS or on
  dense weights, q4g at B > 8, a layer too wide for the ring or whose rows
  TMA cannot read) takes the row-per-warp kernels.

Launch counts: ``.ring_launches`` counts the calls that took the ring
(``.q4g_ring_launches`` those on q4g weights, ``.dense_ring_launches`` those
on dense bf16 weights, ``.f32_ring_launches`` those with fp32 activations,
``.f32_q4g_ring_launches`` those with both), ``.wgmma_launches`` those on
tensor cores (``.dense_wgmma_launches`` those on dense bf16 weights), beside
the counts every call adds (``fused_qkvo.count``: ``.dense_launches`` the
bf16 calls on dense bf16 weights among them, on any instance).

Rounding kept from the TPU kernel (fused_mlp.py:227-292), with the working
dtype bf16 or fp32 (the activations'): h rounds to the working dtype; dots
accumulate in fp32 over exactly converted bf16, int8 or int4 (on the ring
and row per warp alike, in other orders);
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

from ..models.layers import silu
from . import _cuda
from . import weight_ring as wr
from .fused_qkvo import (DENSE, DENSE_WGMMA_MIN_ROWS, K1_WGMMA_MIN_ROWS, Q4G, _at, act_f32,
                         check_operands, count, count_route, kernel_fmt, layer_mats,
                         norm_weight, proj_ref, rms_h, rms_norm_launch, split_weight,
                         wgmma_plan, wgmma_strides)
from .quantization import int_values
from .weight_ring import ring_instance

# the TPU kernel's preferred intermediate chunk per format (fused_mlp.py:323)
_PREFERRED_BLOCK = {"dense": 512, "int8": 1024, "q4g": 1024}
# dense bf16 weights take the ring at B <= 4 only: on an H100 at SliME-8B's
# width the ring beat the row-per-warp kernels at 1 and 4 rows and lost at
# 6 and 8, where its consumers' FFMAs and shared-memory reads set the pace
# and down's [B, 14336] activations take two launches (PERF.md, K1 dense).
# Measured at that width (H 4096, I 14336) only: other dense widths with
# ring plans take the same limit unmeasured
DENSE_RING_ROWS = 4
# fp32 activations (the entry points' default compute dtype) with int8 or
# q4g weights take the ring at B <= this many rows (all the ring takes), the
# row-per-warp kernels above: on an H100 at SliME-8B's width the ring beat
# row per warp at every B from 1 to 8, int8 0.0890-0.2763 ms against
# 0.1634-0.8630, q4g 0.0705-0.2388 against 0.1509-0.7586 (PERF.md, K1 fp32
# ring). Measured at that width only
F32_RING_ROWS = 8


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
def ring_plan(B: int, H: int, I: int, fmt: int, sms: int, act_bytes: int = 2):
    """(gate/up, down) launch plans of ``fused_mlp_decode`` on the ring for
    activations of ``act_bytes`` bytes (bf16 2, fp32 4), and the C array of
    both that the launch takes; None where either projection has no plan."""
    gu = wr.launch_or_none(B, H, I, fmt, 2, sms, act_bytes=act_bytes)
    dn = wr.launch_or_none(B, I, H, fmt, 1, sms, act_bytes=act_bytes)
    return None if gu is None or dn is None else (gu, dn, wr.c_plan(gu, dn))


def ring_route(B: int, dtype, fmt: int, H: int, I: int, sms: int):
    """The routing rule of ``fused_mlp_decode``: ``ring_plan``'s plans where
    the call takes the weight ring (``ring_instance`` holds with fp32
    admitted up to F32_RING_ROWS, dense weights at B <= DENSE_RING_ROWS
    only, and both projections have a plan), None where it takes the
    row-per-warp kernels."""
    if (not ring_instance(B, dtype, fmt, f32_rows=F32_RING_ROWS)
            or (fmt == DENSE and B > DENSE_RING_ROWS)):
        return None
    return ring_plan(B, H, I, fmt, sms, wr.act_bytes(dtype))


def wgmma_instance(dtype, fmt: int, H: int, I: int) -> bool:
    """Whether the tensor-core instance takes the operands: bf16 x, int8 or
    dense bf16 weights whose rows TMA reads (H and I as
    ``fused_qkvo.wgmma_strides`` asks: int8 multiples of 16, dense of 8, at
    least 256)."""
    return dtype == torch.bfloat16 and wgmma_strides(H, fmt) and wgmma_strides(I, fmt)


def k1_route(B: int, dtype, fmt: int, H: int, I: int, sms: int) -> str:
    """The routing rule of ``fused_mlp_decode``: "ring" where ``ring_route``
    has plans, "wgmma" where ``wgmma_instance`` holds at B >=
    K1_WGMMA_MIN_ROWS (int8) or DENSE_WGMMA_MIN_ROWS (dense), "rows" (the
    row-per-warp kernels) for everything else. A pure function, so CPU
    tests can pin it."""
    if ring_route(B, dtype, fmt, H, I, sms) is not None:
        return "ring"
    least = DENSE_WGMMA_MIN_ROWS if fmt == DENSE else K1_WGMMA_MIN_ROWS
    if B >= least and wgmma_instance(dtype, fmt, H, I):
        return "wgmma"
    return "rows"


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
    y, fmt, route = mlp_launch(x, layers, layer_idx, eps)
    count_route(fused_mlp_decode, fmt, route)
    count(fused_mlp_decode, x, fmt)
    f32_ring = int(route == "ring" and act_f32(x) == 1)
    fused_mlp_decode.f32_ring_launches += f32_ring
    fused_mlp_decode.f32_q4g_ring_launches += f32_ring * (fmt == Q4G)
    return y


def mlp_launch(x, layers, layer_idx, eps, route=None):
    """K1's launches on CUDA x -> (y, weight format, the instance that ran:
    "ring", "wgmma" or "rows"): with ``route`` None the routing rule's
    choice (``k1_route``); "rows" the row-per-warp kernels; "ring" the ring
    wherever it has plans (``ring_plan``, the rule's row limit aside; the
    row-per-warp kernels elsewhere); "wgmma" the tensor-core instance
    wherever ``wgmma_instance`` holds (the rule's row limit aside), else a
    ValueError. Counts nothing:
    ``fused_mlp_decode`` counts its calls; chip_smoke.py's phase 1 times the
    instance the rule does not take on the same inputs."""
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
    sms = wr.sm_count(x.device)
    if route is None:
        route = k1_route(B, x.dtype, fmt, H, I, sms)
    plans = (ring_plan(B, H, I, fmt, sms, wr.act_bytes(x.dtype))
             if route == "ring" and ring_instance(B, x.dtype, fmt, f32_rows=wr.RING_MAX_ROWS)
             else None)
    if route == "ring" and plans is None:
        route = "rows"
    if route == "wgmma" and not wgmma_instance(x.dtype, fmt, H, I):
        raise ValueError(f"K1's wgmma instance takes bf16 x with int8 or dense bf16 weights "
                         f"whose rows TMA reads, got {x.dtype} format {fmt}, H {H}, I {I}")
    if route == "ring":
        nw = norm_weight(x, norm_w)
        *_, plan = plans
        h = torch.empty_like(x)
        _cuda.check(lib.slime_mlp_ring(
            fmt, act_f32(x), int(wr.PDL), x.data_ptr(), nw.data_ptr(), eps, h.data_ptr(),
            a.data_ptr(), y.data_ptr(), B, H, I, p(wg), p(sg), p(wu), p(su), p(wd), p(sd),
            ctypes.addressof(plan), _cuda.stream()), "fused_mlp_decode (weight ring)")
    elif route == "wgmma":
        nw = norm_weight(x, norm_w)
        splits, per_split = wgmma_plan(B, H, I, sms, fmt=fmt)
        h = torch.empty_like(x)
        ws = torch.empty((splits, B, H), dtype=torch.float32, device=x.device)
        _cuda.check(lib.slime_mlp_wgmma(
            fmt, x.data_ptr(), nw.data_ptr(), eps, h.data_ptr(), a.data_ptr(), ws.data_ptr(),
            y.data_ptr(), B, H, I, p(wg), p(sg), p(wu), p(su), p(wd), p(sd), splits,
            per_split, _cuda.stream()), "fused_mlp_decode (wgmma)")
    else:
        h = rms_norm_launch(x, norm_w, eps, lib)
        wfmt, f32 = kernel_fmt(wg, fmt), act_f32(x)
        _cuda.check(lib.slime_gate_up_gemv(
            f32, wfmt, h.data_ptr(), B, H, p(wg), p(sg), p(wu), p(su), I, a.data_ptr(),
            _cuda.stream()), "fused_mlp_decode gate/up")
        _cuda.check(lib.slime_resid_gemv(
            f32, wfmt, a.data_ptr(), B, I, p(wd), p(sd), H, x.data_ptr(), y.data_ptr(),
            _cuda.stream()), "fused_mlp_decode down")
    return y, fmt, route


fused_mlp_decode.launches = fused_mlp_decode.q4g_launches = 0
fused_mlp_decode.f32_launches = fused_mlp_decode.f32_q4g_launches = 0
fused_mlp_decode.ring_launches = fused_mlp_decode.q4g_ring_launches = 0
fused_mlp_decode.dense_launches = fused_mlp_decode.dense_ring_launches = 0
fused_mlp_decode.wgmma_launches = fused_mlp_decode.dense_wgmma_launches = 0
fused_mlp_decode.f32_ring_launches = fused_mlp_decode.f32_q4g_ring_launches = 0
