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

bf16 activations with int8 weights at B >= K1_WGMMA_MIN_ROWS (9: the
engine's fused chunks, the speculative verify chunk), and K2's with dense
bf16 weights at B >= DENSE_WGMMA_MIN_ROWS (5: a bf16 checkpoint's chunks,
its verify chunk and its decode steps past 4 rows), take the tensor-core
instance where TMA reads the rows (``qkv_wgmma_instance``,
``o_wgmma_instance``): K1's down launch (``slime_o_wgmma``: K6's int8
wgmma main loop split over the contraction into an fp32 workspace, then a
reduction that adds the splits in order, scales and adds x), for K2 after
the row norm over the row space [W_q; W_k; W_v] (``slime_qkv_wgmma``: NQ
and NQ + NKV on 128-row blocks, one tensor map a matrix; the reduction
writes q, k and v apart; dense weights are the main loop's A operand from
shared memory, 64 columns a stage, no scales). Short of those rows, bf16
activations with int8, q4g or dense bf16 weights at B <= 8
(``ring_instance``: the decode steps of the int8 and 4-bit serving paths
and of a bf16 checkpoint; dense K3 at B <= DENSE_O_RING_ROWS, 4) take the
weight ring (``weight_ring_kernel``, ``ops/weight_ring.py``) where a launch
plan exists (``qkv_ring_route``, ``o_ring_route``): K2 as one ring launch
over the row space of W_q, W_k and W_v whose blocks each normalise x as
they stage it (no row-norm launch), K3 as one ring launch; each a
programmatic dependent of the caller's last kernel. Every other input, fp32
activations, dense K3 past 4 rows and a layer too wide for the ring's
shared memory included, takes the row-per-warp kernels. The routing rules
``k2_route`` and ``k3_route`` name the instance: "ring", "wgmma" or
"rows". Sums on every instance are fp32 over the exact products (bf16 x
bf16, int8 or int4), in other orders than the plain version's; the
per-row scale multiplies the fp32 sum; q, k, v and y round to bf16 once.

Launch counts (one per wrapper call that launches, nowhere else):
``.launches`` every call, ``.q4g_launches`` those on q4g weights,
``.f32_launches`` those with fp32 activations, ``.f32_q4g_launches`` both;
``.ring_launches`` the calls that took the weight ring,
``.q4g_ring_launches`` those on q4g weights, ``.dense_ring_launches``
those on dense bf16 weights; ``.wgmma_launches`` those on the tensor-core
instance, ``.dense_wgmma_launches`` those on dense bf16 weights among
them; ``.dense_launches`` the calls with bf16 activations on
dense bf16 weights (the bf16 checkpoints of the eval path and the
engine), on any instance (``chip_smoke.launch_counts`` takes these subsets
apart).
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from . import weight_ring as wr
from .quant_matmul import k6_wgmma_strides
from .quantization import int_values
from .weight_ring import DENSE, DENSE_F32, INT8, Q4G, ring_instance

_FMT_NAMES = {DENSE: "dense", INT8: "int8", Q4G: "q4g"}
ACT_DTYPES = (torch.bfloat16, torch.float32)
# dense bf16 K3 takes the ring at these many rows at most: on an H100 at
# SliME-8B's width (W_o [4096, 4096]) the ring beat the row-per-warp kernel
# at 1 and 4 rows and lost at 6 (PERF.md, K3 dense). Measured at that width
# only
DENSE_O_RING_ROWS = 4
# int8 weights in bf16 take the tensor-core instances of K1-K3 from this many
# rows (the ring takes 1-8): on an H100 at SliME-8B's width K1's beat the
# row-per-warp kernels at every B from 9 to 128 (PERF.md, K1 wgmma), and
# K2's and K3's run the same main loop
K1_WGMMA_MIN_ROWS = 9
# dense bf16 weights in bf16 take the tensor-core instances of K1 and K2
# from this many rows (the ring below): on an H100 at SliME-8B's width K1's
# beat the row-per-warp kernels at 5, 6 and 8 rows (0.1486, 0.1483, 0.1482
# ms against 0.2224, 0.2342, 0.2672; its ring takes 1-4), where one pass
# over the weights costs the same at any tile fill, and K2's beat the ring
# there (0.0389, 0.0392, 0.0388 against 0.0429, 0.0460, 0.0520) and lost
# at 4 (0.0390 against 0.0339; PERF.md, K1 and K2 dense wgmma). Measured at
# that width only
DENSE_WGMMA_MIN_ROWS = 5
WGMMA_TOK = 64          # tokens a tile of the tensor-core instances (wgmma n64)
_WG_ROWS = 128          # rows of the row space a block


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


# the relative distance from a bf16 rounding midpoint within which a
# kernel's row norm may round h = bf16(x r w) the other way than the plain
# version: four times the largest relative difference (about 2^-19) of two
# fp32 scales r whose sums of 4096 squares are taken in other tree orders,
# their own roundings included
NORM_FLIP_RTOL = 2.0 ** -17


def norm_flips(h, x, norm_w, eps):
    """(elements where h, a kernel's row-norm output [B, H] in bf16, differs
    from the plain version's ``rms_h``; those among them that are more than
    one bf16 ulp away, or whose fp32 value lies farther than NORM_FLIP_RTOL
    (relative) from a bf16 rounding midpoint). The kernels take the fp32 sum
    of squares in another order, so where x r w lies that close to a
    midpoint h may round the other way, and with it every element of the row
    that holds the same bf16 x: the second count, which must be 0, tells
    such flips from a wrong norm."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    hf = xf * torch.rsqrt(var + eps) * norm_w.to(torch.float32)
    want = hf.to(h.dtype).to(torch.float32)
    mag = hf.abs()
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7), 0.0)
    near = (ulp / 2 - (hf - want).abs()) <= NORM_FLIP_RTOL * mag
    diff = h.to(torch.float32) != want
    bad = diff & (((h.to(torch.float32) - want).abs() > ulp) | ~near)
    return int(diff.sum()), int(bad.sum())


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
    return qkv_proj_ref(rms_h(x, layers["input_layernorm"]["weight"][layer_idx], eps),
                        layers, layer_idx)


def qkv_proj_ref(h, layers, layer_idx):
    """(q, k, v) in h.dtype: the plain version's projections of a given row
    norm h [B, H] (``fused_qkv_decode_ref`` after its ``rms_h``)."""
    outs = []
    for name in ("q_proj", "k_proj", "v_proj"):
        w, s, fmt = split_weight(layers[name])
        outs.append(proj_ref(h, w[layer_idx], _at(s, layer_idx), fmt).to(h.dtype))
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
    fn.dense_launches += int(fmt == DENSE and not f32)
    fn.q4g_launches += q4g
    fn.f32_launches += f32
    fn.f32_q4g_launches += f32 * q4g


def count_ring(fn, fmt) -> None:
    """One call of ``fn`` that took the weight ring, on weight format ``fmt``."""
    fn.ring_launches += 1
    fn.q4g_ring_launches += fmt == Q4G
    fn.dense_ring_launches += fmt == DENSE


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
    o projection's ring launch where the call takes the weight ring
    (``ring_instance`` holds, dense weights at B <= DENSE_O_RING_ROWS only,
    and the plan exists), None where it takes the row-per-warp kernel."""
    if not ring_instance(B, dtype, fmt) or (fmt == DENSE and B > DENSE_O_RING_ROWS):
        return None
    return wr.projection_plan(B, NQ, H, fmt, sms)


def wgmma_stage_cols(fmt: int) -> int:
    """Columns of K a stage of the tensor-core instances holds: 128 bytes
    of a weight row, 128 int8 or 64 dense bf16 columns."""
    return 64 if fmt == DENSE else 128


def wgmma_strides(K: int, fmt: int) -> bool:
    """Whether TMA reads the tensor-core instances' weight rows of K
    columns: int8 as ``quant_matmul.k6_wgmma_strides`` asks (multiples of
    16), dense bf16 rows of 2K bytes a multiple of 16 (K a multiple of 8);
    at least 256 columns either way."""
    if fmt == DENSE:
        return K >= 256 and K % 8 == 0
    return fmt == INT8 and k6_wgmma_strides(K, INT8)


def wgmma_plan(B: int, N: int, K: int, sms: int, splits=None, fmt: int = INT8):
    """(splits, stages per split) of the tensor-core instances' split
    launch (K1's down, K2, K3): blocks of 128 rows of the row space [0, N)
    for each 64-token tile, split over K's stages (``wgmma_stage_cols(fmt)``
    columns) into as many ranges as one wave of blocks (one an SM) holds, or
    into about ``splits`` where given; none empty. At SliME-8B's width on
    132 SMs up to 64 rows, int8: K1's down (N 4096, K 14336) 4 splits of 28
    stages, K2 (N 6144, K 4096) 2 of 16, K3 (N 4096, K 4096) 4 of 8; dense:
    K1's down 4 of 56, K2 2 of 32."""
    blocks = -(-N // _WG_ROWS) * -(-B // WGMMA_TOK)
    n_kb = -(-K // wgmma_stage_cols(fmt))
    want = max(1, min(n_kb, sms // blocks if splits is None else splits))
    per = -(-n_kb // want)
    return -(-n_kb // per), per


def qkv_wgmma_instance(dtype, fmt: int, H: int, NQ: int, NKV: int) -> bool:
    """Whether K2's tensor-core instance takes the operands: bf16 x, int8
    or dense bf16 weights whose rows TMA reads (``wgmma_strides``) and NQ
    and NQ + NKV on 128-row block boundaries (a block's rows lie in one
    matrix)."""
    return (dtype == torch.bfloat16 and wgmma_strides(H, fmt)
            and NQ % _WG_ROWS == 0 and (NQ + NKV) % _WG_ROWS == 0)


def o_wgmma_instance(dtype, fmt: int, NQ: int) -> bool:
    """Whether K3's tensor-core instance takes the operands: bf16 attn and
    x, int8 W_o whose rows of NQ bytes TMA reads."""
    return dtype == torch.bfloat16 and fmt == INT8 and k6_wgmma_strides(NQ, INT8)


def k2_route(B: int, dtype, fmt: int, H: int, NQ: int, NKV: int, sms: int) -> str:
    """The routing rule of ``fused_qkv_decode``: "wgmma" where
    ``qkv_wgmma_instance`` holds at B >= K1_WGMMA_MIN_ROWS (int8) or
    DENSE_WGMMA_MIN_ROWS (dense), else "ring" where ``qkv_ring_route`` has a
    plan, "rows" (the row-per-warp kernels) for everything else. A pure
    function, so CPU tests can pin it."""
    least = DENSE_WGMMA_MIN_ROWS if fmt == DENSE else K1_WGMMA_MIN_ROWS
    if B >= least and qkv_wgmma_instance(dtype, fmt, H, NQ, NKV):
        return "wgmma"
    if qkv_ring_route(B, dtype, fmt, H, NQ, NKV, sms) is not None:
        return "ring"
    return "rows"


def k3_route(B: int, dtype, fmt: int, NQ: int, H: int, sms: int) -> str:
    """The routing rule of ``fused_o_residual``: "ring" where
    ``o_ring_route`` has a plan, "wgmma" where ``o_wgmma_instance`` holds at
    B >= K1_WGMMA_MIN_ROWS, "rows" for everything else."""
    if o_ring_route(B, dtype, fmt, NQ, H, sms) is not None:
        return "ring"
    if B >= K1_WGMMA_MIN_ROWS and o_wgmma_instance(dtype, fmt, NQ):
        return "wgmma"
    return "rows"


def count_route(fn, fmt, route: str) -> None:
    """One call of ``fn`` that took ``route`` ("ring", "wgmma" or "rows"),
    beside ``count``."""
    if route == "ring":
        count_ring(fn, fmt)
    fn.wgmma_launches += route == "wgmma"
    fn.dense_wgmma_launches += route == "wgmma" and fmt == DENSE


def fused_qkv_decode(x, layers, layer_idx, *, eps: float = 1e-5):
    """x [B, H] -> (q [B, NQ], k [B, NKV], v [B, NKV]) for layer ``layer_idx``
    of the stacked dict, h = rms_norm(x, input_layernorm) computed first.
    RoPE stays outside (it needs positions). CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return fused_qkv_decode_ref(x, layers, layer_idx, eps=eps)
    q, k, v, fmt, route, _ = qkv_launch(x, layers, layer_idx, eps)
    count_route(fused_qkv_decode, fmt, route)
    count(fused_qkv_decode, x, fmt)
    return q, k, v


def qkv_launch(x, layers, layer_idx, eps, route=None, splits=None):
    """K2's launches on CUDA x -> (q, k, v, weight format, the instance that
    ran: "ring", "wgmma" or "rows", the row norm h [B, H] where the instance
    writes it to memory ("wgmma", "rows"; the ring's blocks keep theirs in
    shared memory: None)): with ``route`` None the routing rule's choice
    (``k2_route``); "rows" the row-per-warp kernels; "ring" the ring
    wherever it has a plan (the row-per-warp kernels elsewhere); "wgmma" the
    tensor-core instance wherever ``qkv_wgmma_instance`` holds (the rule's
    row limit aside), else a ValueError; ``splits`` overrides its split
    count (``wgmma_plan``). Counts nothing: ``fused_qkv_decode`` counts its
    calls; chip_smoke.py's phase 1 times the instances the rule does not
    take on the same inputs."""
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
    h = None
    sms = wr.sm_count(x.device)
    if route is None:
        route = k2_route(B, x.dtype, fmt, H, NQ, NKV, sms)
    plan = qkv_ring_route(B, x.dtype, fmt, H, NQ, NKV, sms) if route == "ring" else None
    if route == "ring" and plan is None:
        route = "rows"
    if route == "wgmma" and not qkv_wgmma_instance(x.dtype, fmt, H, NQ, NKV):
        raise ValueError(f"K2's wgmma instance takes bf16 x with int8 or dense bf16 weights "
                         f"whose rows TMA reads and NQ, NQ + NKV on 128-row blocks, got "
                         f"{x.dtype} format {fmt}, H {H}, NQ {NQ}, NKV {NKV}")
    if route == "ring":
        nw = norm_weight(x, norm_w)
        _cuda.check(lib.slime_qkv_ring(
            fmt, int(wr.PDL), x.data_ptr(), nw.data_ptr(), eps, B, H, NQ, NKV, p(wq), p(sq),
            p(wk), p(sk), p(wv), p(sv), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ctypes.addressof(plan[1]), _cuda.stream()), "fused_qkv_decode (weight ring)")
    elif route == "wgmma":
        nw = norm_weight(x, norm_w)
        n_split, per = wgmma_plan(B, NQ + 2 * NKV, H, sms, splits, fmt)
        h = torch.empty_like(x)
        ws = torch.empty((n_split, B, NQ + 2 * NKV), dtype=torch.float32, device=x.device)
        _cuda.check(lib.slime_qkv_wgmma(
            fmt, x.data_ptr(), nw.data_ptr(), eps, h.data_ptr(), ws.data_ptr(), B, H, NQ, NKV,
            p(wq), p(sq), p(wk), p(sk), p(wv), p(sv), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), n_split, per, _cuda.stream()), "fused_qkv_decode (wgmma)")
    else:
        h = rms_norm_launch(x, norm_w, eps, lib)
        _cuda.check(lib.slime_qkv_gemv(
            act_f32(x), kernel_fmt(wq, fmt), h.data_ptr(), B, H, p(wq), p(sq), NQ, p(wk),
            p(sk), p(wv), p(sv), NKV, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _cuda.stream()), "fused_qkv_decode")
    return q, k, v, fmt, route, h


def fused_o_residual(attn, x, layers, layer_idx):
    """(attn [B, NQ], x [B, H]) -> x + attn @ dequant(Wo[layer_idx]).T.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_o_residual_ref(attn, x, layers, layer_idx)
    y, fmt, route = o_launch(attn, x, layers, layer_idx)
    count_route(fused_o_residual, fmt, route)
    count(fused_o_residual, x, fmt)
    return y


def o_launch(attn, x, layers, layer_idx, route=None, splits=None):
    """K3's launch on CUDA tensors -> (y, weight format, the instance that
    ran): with ``route`` None the routing rule's choice (``k3_route``);
    "rows" the row-per-warp kernel; "ring" the ring wherever it has a plan
    (the rule's dense row limit aside; the row-per-warp kernel elsewhere);
    "wgmma" the tensor-core instance wherever ``o_wgmma_instance`` holds
    (the rule's row limit aside), else a ValueError; ``splits`` overrides
    its split count. Counts nothing: ``fused_o_residual`` counts its calls;
    chip_smoke.py's phase 1 times the instances the rule does not take on
    the same inputs."""
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
    sms = wr.sm_count(x.device)
    if route is None:
        route = k3_route(B, x.dtype, fmt, NQ, H, sms)
    plan = (wr.projection_plan(B, NQ, H, fmt, sms)
            if route == "ring" and ring_instance(B, x.dtype, fmt) else None)
    if route == "ring" and plan is None:
        route = "rows"
    if route == "wgmma" and not o_wgmma_instance(x.dtype, fmt, NQ):
        raise ValueError(f"K3's wgmma instance takes bf16 attn with int8 weights whose rows "
                         f"TMA reads, got {x.dtype} format {fmt}, NQ {NQ}")
    if route == "ring":
        _cuda.check(lib.slime_o_ring(
            fmt, int(wr.PDL), attn.data_ptr(), x.data_ptr(), y.data_ptr(), B, NQ, H,
            wo.data_ptr(), _cuda.ptr(so), ctypes.addressof(plan[1]), _cuda.stream()),
            "fused_o_residual (weight ring)")
    elif route == "wgmma":
        n_split, per = wgmma_plan(B, H, NQ, sms, splits)
        ws = torch.empty((n_split, B, H), dtype=torch.float32, device=x.device)
        _cuda.check(lib.slime_o_wgmma(
            attn.data_ptr(), x.data_ptr(), ws.data_ptr(), y.data_ptr(), B, NQ, H,
            wo.data_ptr(), _cuda.ptr(so), n_split, per, _cuda.stream()),
            "fused_o_residual (wgmma)")
    else:
        _cuda.check(lib.slime_resid_gemv(
            act_f32(x), kernel_fmt(wo, fmt), attn.data_ptr(), B, NQ, wo.data_ptr(),
            _cuda.ptr(so), H, x.data_ptr(), y.data_ptr(), _cuda.stream()), "fused_o_residual")
    return y, fmt, route


for _fn in (fused_qkv_decode, fused_o_residual):
    _fn.launches = _fn.q4g_launches = _fn.f32_launches = _fn.f32_q4g_launches = 0
    _fn.ring_launches = _fn.q4g_ring_launches = _fn.dense_launches = 0
    _fn.dense_ring_launches = _fn.wgmma_launches = _fn.dense_wgmma_launches = 0
