"""Decode-step attention projections: CUDA kernels and their plain versions.

Port of ``slime_tpu/ops/fused_qkvo.py``:

  fused_qkv_decode   x [B,H] -> rms_norm -> (q [B,NQ], k [B,NKV], v [B,NKV])
  fused_o_residual   (attn [B,NQ], x [B,H]) -> x + attn @ Wo.T

for one layer ``layer_idx`` of the pre-stacked ``[L, out, in]`` weights. On
the TPU the layer is picked by scalar prefetch so XLA never copies a sliced
operand; in PyTorch ``w[layer_idx]`` of a contiguous stack is already a view,
so the wrappers index it directly. The kernels are in ``csrc/fused_decode.cu``.

Activations are bf16 or fp32, the caller's compute dtype (JAX's kernels
compute in the dtype of their input); outputs come back in it. Any number of
rows B runs in one launch (the kernels loop over row tiles), as JAX's fused
decode takes any B.

Weight formats (format codes of the kernels): 0 dense (bf16 on the card,
any float on the CPU; fp32 too with fp32 activations, code 3), 1 int8
per-row ``{"q", "scale"}``, 2 group-128 q4g
``{"q4g", "scale"}`` with the canonical scales ``[L, out, in/128]``. The
JAX package's ``prepare_fused_layers`` stores the down projection's q4g
scales transposed, ``[L, in/128, out]`` (a Mosaic tiling device); that
layout is accepted by its shape and read transposed. NF4 and grouped int8
have no fused kernel (``llama._fused_fmt``) and raise here.

bf16 activations with int8 or q4g weights at B <= 8 (``ring_instance``: the
decode steps of the int8 and 4-bit serving paths) take the weight ring
(``weight_ring_kernel``, ``ops/weight_ring.py``) where a launch plan exists
(``qkv_ring_route``, ``o_ring_route``): K2 as one ring launch over the row
space of W_q, W_k and W_v whose blocks each normalise x as they stage it
(no row-norm launch), K3 as one ring launch; each a programmatic dependent
of the caller's last kernel. Every other input, a layer too wide for the
ring's shared memory included, takes the row-per-warp kernels.

Launch counts (one per wrapper call that launches, nowhere else):
``.launches`` every call, ``.q4g_launches`` those on q4g weights,
``.f32_launches`` those with fp32 activations, ``.f32_q4g_launches`` both;
``.ring_launches`` the calls that took the weight ring,
``.q4g_ring_launches`` those on q4g weights.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from . import weight_ring as wr
from .quantization import int_values
from .weight_ring import DENSE, DENSE_F32, INT8, Q4G, ring_instance

_FMT_NAMES = {DENSE: "dense", INT8: "int8", Q4G: "q4g"}
ACT_DTYPES = (torch.bfloat16, torch.float32)


def split_weight(p):
    """Projection param dict -> (weight [L, out, in] or packed q4g [L, out,
    in/2], scale [L, out, 1] / [L, out, in/128] or None, format code)."""
    w = p["weight"]
    if not isinstance(w, dict):
        return w, None, DENSE
    if "q" in w and w["scale"].shape[-1] == 1:
        return w["q"], w["scale"], INT8
    if "q4g" in w:
        q, s = w["q4g"], w["scale"]
        out, n_g = q.shape[-2], 2 * q.shape[-1] // 128
        if s.shape[-2:] != (out, n_g) and s.shape[-2:] == (n_g, out):
            s = s.transpose(-1, -2)          # prepare_fused_layers' layout
        return q, s, Q4G
    raise NotImplementedError("the fused decode kernels take dense, per-row int8 or "
                              "q4g weights; NF4, grouped int8 and per-row q4 take "
                              "the non-fused decode path (llama._fused_fmt)")


def rms_h(x, norm_w, eps):
    """h = rms_norm(x) * w rounded to x.dtype, as the kernels' prologue."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * norm_w.to(torch.float32)).to(x.dtype)


def proj_ref(h, w, s, fmt):
    """h [B, K] @ W.T in fp32 over the exact products of h and W cast to
    h.dtype -> [B, out] fp32. int8: the per-row scale multiplies the fp32
    result; q4g: one fp32 partial sum per 128-column group, times the
    group's scale, groups added in order (``_q4g_contract``)."""
    hf = h.to(torch.float32)
    if fmt == Q4G:
        wf = int_values({"q4g": w, "scale": s}).to(torch.float32)
        sf = s.to(torch.float32)
        y = None
        for g in range(sf.shape[-1]):
            part = torch.matmul(hf[:, g * 128:(g + 1) * 128],
                                wf[:, g * 128:(g + 1) * 128].T) * sf[:, g][None, :]
            y = part if y is None else y + part
        return y
    y = torch.matmul(hf, w.to(h.dtype).to(torch.float32).T)
    if fmt == INT8:
        y = y * s[:, 0].to(torch.float32)[None, :]
    return y


def _at(s, layer_idx):
    return None if s is None else s[layer_idx]


def fused_qkv_decode_ref(x, layers, layer_idx, *, eps: float = 1e-5):
    """Plain version of ``fused_qkv_decode`` (fused_qkvo.py:64-97)."""
    h = rms_h(x, layers["input_layernorm"]["weight"][layer_idx], eps)
    outs = []
    for name in ("q_proj", "k_proj", "v_proj"):
        w, s, fmt = split_weight(layers[name])
        outs.append(proj_ref(h, w[layer_idx], _at(s, layer_idx), fmt).to(x.dtype))
    return tuple(outs)


def fused_o_residual_ref(attn, x, layers, layer_idx):
    """Plain version of ``fused_o_residual`` (fused_qkvo.py:100-106)."""
    w, s, fmt = split_weight(layers["o_proj"])
    y = proj_ref(attn, w[layer_idx], _at(s, layer_idx), fmt)
    return (x.to(torch.float32) + y).to(x.dtype)


def check_operands(x, mats):
    """Validate a kernel call: x [B, K] bf16 or fp32, contiguous and 16-byte
    aligned, B >= 1; each (w, s, fmt) on x's device and contiguous: dense
    [out, K] (bf16, or fp32 with fp32 x), int8 [out, K] with fp32 scales
    [out, 1], or q4g int8 [out, K/2] with fp32 scales [out, K/128]; K a
    whole number of 16-byte weight vectors, and a multiple of 256 for q4g."""
    _cuda.require_cuda(x, *[t for w, s, _ in mats for t in (w, s) if t is not None])
    if (x.dtype not in ACT_DTYPES or x.dim() != 2 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f"decode kernels take contiguous, 16-byte aligned bf16 or fp32 "
                         f"[B, K] activations, got {x.dtype} {tuple(x.shape)}")
    B, K = x.shape
    if B < 1:
        raise ValueError(f"decode kernels take at least one row, got {B}")
    for w, s, fmt in mats:
        want = (torch.int8,) if fmt != DENSE else (
            ACT_DTYPES if x.dtype == torch.float32 else (torch.bfloat16,))
        width = K // 2 if fmt == Q4G else K
        if (w.dtype not in want or w.dim() != 2 or w.shape[-1] != width
                or not w.is_contiguous()):
            raise ValueError(f"{_FMT_NAMES[fmt]} weight {w.dtype} {tuple(w.shape)}: "
                             f"expected contiguous {' or '.join(map(str, want))} "
                             f"[out, {width}] with {x.dtype} activations")
        if (K * w.element_size()) % 16 or (fmt == Q4G and K % 256):
            raise ValueError(f"contraction {K} does not fit the {_FMT_NAMES[fmt]} "
                             f"kernel (16-byte vectors; q4g: a multiple of 256)")
        n_s = K // 128 if fmt == Q4G else 1
        if s is not None and (s.dtype != torch.float32 or not s.is_contiguous()
                              or s.shape != (w.shape[0], n_s)):
            raise ValueError(f"scale {s.dtype} {tuple(s.shape)}: expected "
                             f"contiguous fp32 [{w.shape[0]}, {n_s}]")


def layer_mats(layers, names, layer_idx):
    """[(w[li], s[li] or None, fmt)] for the named projections; all one
    format. A transposed q4g scale is copied into the canonical layout for
    this layer only."""
    mats = []
    for name in names:
        w, s, fmt = split_weight(layers[name])
        s = _at(s, layer_idx)
        mats.append((w[layer_idx], None if s is None else s.contiguous(), fmt))
    if len({m[2] for m in mats}) != 1:
        raise ValueError(f"mixed weight formats across {names}")
    return mats


def act_f32(x) -> int:
    """The kernels' activation flag: 1 for fp32 activations, 0 for bf16."""
    return int(x.dtype == torch.float32)


def kernel_fmt(w, fmt) -> int:
    """The format code a launch passes: dense fp32 weights are code 3."""
    return DENSE_F32 if fmt == DENSE and w.dtype == torch.float32 else fmt


def count(fn, x, fmt) -> None:
    """One launch of ``fn`` on ``x``'s dtype and weight format ``fmt``."""
    f32, q4g = act_f32(x), int(fmt == Q4G)
    fn.launches += 1
    fn.q4g_launches += q4g
    fn.f32_launches += f32
    fn.f32_q4g_launches += f32 * q4g


def count_ring(fn, fmt) -> None:
    """One call of ``fn`` that took the weight ring, on weight format ``fmt``."""
    fn.ring_launches += 1
    fn.q4g_ring_launches += fmt == Q4G


def norm_weight(x, norm_w):
    """The row norm's weight as the kernels take it: fp32 [H] on x's device."""
    nw = norm_w.to(torch.float32).contiguous()
    if nw.device != x.device or nw.shape != (x.shape[1],):
        raise ValueError(f"norm weight {tuple(nw.shape)} on {nw.device} for x "
                         f"{tuple(x.shape)} on {x.device}")
    return nw


def rms_norm_launch(x, norm_w, eps, lib):
    """Launch the row-norm pass; returns h [B, H] in x.dtype."""
    B, H = x.shape
    nw = norm_weight(x, norm_w)
    h = torch.empty_like(x)
    _cuda.check(lib.slime_rms_norm(act_f32(x), x.data_ptr(), nw.data_ptr(), h.data_ptr(),
                                   B, H, eps, _cuda.stream()), "rms_norm")
    return h


def qkv_ring_route(B: int, dtype, fmt: int, H: int, NQ: int, NKV: int, sms: int):
    """The routing rule of ``fused_qkv_decode``: (plan, its C array) of the
    ring launch over the row space [W_q; W_k; W_v] where the call takes the
    weight ring (``ring_instance`` holds and the plan exists), None where it
    takes the row-per-warp kernels."""
    if not ring_instance(B, dtype, fmt):
        return None
    return wr.projection_plan(B, H, NQ + 2 * NKV, fmt, sms, (NQ, NKV, NKV))


def o_ring_route(B: int, dtype, fmt: int, NQ: int, H: int, sms: int):
    """The routing rule of ``fused_o_residual``: (plan, its C array) of the
    o projection's ring launch, or None where the call takes the
    row-per-warp kernel."""
    if not ring_instance(B, dtype, fmt):
        return None
    return wr.projection_plan(B, NQ, H, fmt, sms)


def fused_qkv_decode(x, layers, layer_idx, *, eps: float = 1e-5):
    """x [B, H] -> (q [B, NQ], k [B, NKV], v [B, NKV]) for layer ``layer_idx``
    of the stacked dict, h = rms_norm(x, input_layernorm) computed first.
    RoPE stays outside (it needs positions). CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return fused_qkv_decode_ref(x, layers, layer_idx, eps=eps)
    mats = layer_mats(layers, ("q_proj", "k_proj", "v_proj"), layer_idx)
    check_operands(x, mats)
    (wq, sq, fmt), (wk, sk, _), (wv, sv, _) = mats
    if wk.shape != wv.shape or len({wq.dtype, wk.dtype, wv.dtype}) != 1:
        raise ValueError(f"k/v projections differ: {wk.dtype} {wk.shape} vs {wv.dtype} "
                         f"{wv.shape} (q {wq.dtype})")
    B, H = x.shape
    NQ, NKV = wq.shape[0], wk.shape[0]
    if fmt == Q4G and NQ % 256:
        raise ValueError(f"q4g decode kernels take NQ a multiple of 256, got {NQ}")
    lib = _cuda.library()
    norm_w = layers["input_layernorm"]["weight"][layer_idx]
    q = torch.empty((B, NQ), dtype=x.dtype, device=x.device)
    k = torch.empty((B, NKV), dtype=x.dtype, device=x.device)
    v = torch.empty((B, NKV), dtype=x.dtype, device=x.device)
    p = _cuda.ptr
    route = qkv_ring_route(B, x.dtype, fmt, H, NQ, NKV, wr.sm_count(x.device))
    if route is not None:
        nw = norm_weight(x, norm_w)
        _cuda.check(lib.slime_qkv_ring(
            fmt, int(wr.PDL), x.data_ptr(), nw.data_ptr(), eps, B, H, NQ, NKV, p(wq), p(sq),
            p(wk), p(sk), p(wv), p(sv), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ctypes.addressof(route[1]), _cuda.stream()), "fused_qkv_decode (weight ring)")
        count_ring(fused_qkv_decode, fmt)
    else:
        h = rms_norm_launch(x, norm_w, eps, lib)
        _cuda.check(lib.slime_qkv_gemv(
            act_f32(x), kernel_fmt(wq, fmt), h.data_ptr(), B, H, p(wq), p(sq), NQ, p(wk),
            p(sk), p(wv), p(sv), NKV, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _cuda.stream()), "fused_qkv_decode")
    count(fused_qkv_decode, x, fmt)
    return q, k, v


def fused_o_residual(attn, x, layers, layer_idx):
    """(attn [B, NQ], x [B, H]) -> x + attn @ dequant(Wo[layer_idx]).T.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_o_residual_ref(attn, x, layers, layer_idx)
    mats = layer_mats(layers, ("o_proj",), layer_idx)
    check_operands(attn, mats)
    (wo, so, fmt), = mats
    B, H = x.shape
    if (x.dtype != attn.dtype or x.device != attn.device or not x.is_contiguous()
            or attn.shape[0] != B or wo.shape[0] != H or (fmt == Q4G and H % 256)):
        raise ValueError(f"residual x {x.dtype} {tuple(x.shape)} does not match "
                         f"attn {tuple(attn.shape)} and Wo {tuple(wo.shape)}")
    lib = _cuda.library()
    y = torch.empty_like(x)
    NQ = attn.shape[1]
    route = o_ring_route(B, x.dtype, fmt, NQ, H, wr.sm_count(x.device))
    if route is not None:
        _cuda.check(lib.slime_o_ring(
            fmt, int(wr.PDL), attn.data_ptr(), x.data_ptr(), y.data_ptr(), B, NQ, H,
            wo.data_ptr(), _cuda.ptr(so), ctypes.addressof(route[1]), _cuda.stream()),
            "fused_o_residual (weight ring)")
        count_ring(fused_o_residual, fmt)
    else:
        _cuda.check(lib.slime_resid_gemv(
            act_f32(x), kernel_fmt(wo, fmt), attn.data_ptr(), B, NQ, wo.data_ptr(),
            _cuda.ptr(so), H, x.data_ptr(), y.data_ptr(), _cuda.stream()), "fused_o_residual")
    count(fused_o_residual, x, fmt)
    return y


for _fn in (fused_qkv_decode, fused_o_residual):
    _fn.launches = _fn.q4g_launches = _fn.f32_launches = _fn.f32_q4g_launches = 0
    _fn.ring_launches = _fn.q4g_ring_launches = 0
