"""Causal attention for prefill and training: the K5 CUDA kernels and their
plain versions.

Port of ``slime_tpu/ops/flash_attention.py``. The TPU kernels are three
``pallas_call``s: the online-softmax forward ``_fwd`` (:133) that also saves
the per-row logsumexp, and the FlashAttention-2 backward pair of
``_bwd_impl``, dK/dV over query tiles (:347) and dQ over key tiles (:389).
Their Hopper counterparts are in ``csrc/flash_attention.cu``:

- ``flash_fwd`` -> (out, lse), ``flash_bwd_dkdv`` -> (dk, dv) and
  ``flash_bwd_dq`` -> dq launch the kernels on CUDA tensors and take the plain
  versions ``flash_fwd_ref``, ``flash_bwd_dkdv_ref`` and ``flash_bwd_dq_ref``
  on CPU tensors (``flash_bwd_ref`` computes both backward results at once);
- ``_Flash`` is the ``torch.autograd.Function`` around them: the forward
  saves ``out`` and ``lse``; the backward computes ``delta = sum(do * out)``
  in plain torch (as JAX does, :325-326), then dK/dV, then dQ;
- ``reference_attention`` is the plain attention (``:469-500``), the CPU path
  and the numerics oracle;
- ``flash_attention`` picks between them with JAX's rule (below).

Layout: q [B, H, S, D]; k, v [B, KVH, S, D] with KVH dividing H (GQA: query
head h reads kv head h // (H // KVH)); lse and delta [B, H, S] fp32 (JAX
keeps lse as [B, S, H], a TPU tiling artefact). The kernels read q/k/v/do
through their strides, so the [B, S, H, D] projections of ``llama`` need no
transpose copy; outputs come back in [B, S, H, D] storage, seen as
[B, H, S, D].

Numerics kept from the TPU kernels: masked scores are ``NEG_INF = -1e30``,
not -inf; the backward's ``p = where(ok, exp(s - lse), 0)``; ``l == 0 -> 1``
before the divide and the log; p is rounded to v's dtype before P.V (and to
do's before P^T.dO) while l sums the unrounded fp32 p; ds is rounded to q's /
k's dtype before dK / dQ; all products accumulate in fp32. A query attends a
key only under causality (when ``causal``) and, with ``segment_ids`` [B, S],
only when both carry the same id (sequence packing).

The kernels take q/k/v/do all bf16 (p and ds rounded to bf16 as above) or
all fp32 (no TF32 and no rounding: what JAX's interpret-mode kernels compute
for fp32, and what ``llama.forward``'s default fp32 compute dtype sends
them), at any D that is a multiple of 128, as JAX's rule sends every such D
to its kernels. bf16 at D = 128 and 256 takes the Hopper ``wgmma`` kernels
fed by TMA through an mbarrier ring (forward, dK/dV and dQ alike); fp32, and
bf16 at D > 256 (no model in the repo has such a head), take FFMA tiles over
128- or 256-column chunks of D. Outputs come back in the inputs' dtype.
``kernel_input_error`` states what they take.

Launch counts (one per kernel launch, nowhere else):
``flash_attention.fwd_launches``, ``.dkdv_launches`` and ``.dq_launches``
count every launch; ``.fwd_f32_launches``, ``.dkdv_f32_launches`` and
``.dq_f32_launches`` those of them with fp32 inputs; ``.fwd_d256_launches``,
``.dkdv_d256_launches`` and ``.dq_d256_launches`` those at D = 256, and
``.fwd_f32_d256_launches`` etc. those at D = 256 in fp32;
``.fwd_wide_launches`` etc. those at D > 256, ``.fwd_f32_wide_launches``
etc. those at D > 256 in fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _cuda

NEG_INF = -1e30
KERNEL_D_STEP = 128         # the kernels take every D that is a multiple of this
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MIN_AUTO_SEQ = 2048


def _repeat_kv(k, H):
    KVH = k.shape[1]
    return k if KVH == H else k.repeat_interleave(H // KVH, dim=1)


def _mask(S, device, causal: bool, segment_ids):
    """[B or 1, 1, S, S] bool: which (query, key) pairs may attend, or None."""
    ok = None
    if causal:
        ok = torch.ones((S, S), dtype=torch.bool, device=device).tril()[None, None]
    if segment_ids is not None:
        same = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        ok = same if ok is None else ok & same
    return ok


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None, segment_ids=None):
    """q [B, H, S, D]; k, v [B, KVH, S, D] (KVH divides H) -> [B, H, S, D].

    GQA by repeating k/v heads; fp32 scores; for bf16 inputs the stabilized
    low-precision softmax of the JAX oracle (fp32 max-subtract, bf16 exp and
    normalize). ``segment_ids`` [B, S]: block-diagonal attention per segment."""
    B, H, S, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    ok = _mask(S, q.device, causal, segment_ids)
    if ok is not None:
        s = s.masked_fill(~ok, NEG_INF)
    if q.dtype == torch.bfloat16:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m).to(q.dtype)
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.to(torch.float32), v.to(torch.float32)).to(q.dtype)


# ----------------------------------------------------------------------------
# Plain versions of what the kernels compute
# ----------------------------------------------------------------------------

def _scores(q, k, scale, causal, segment_ids):
    """fp32 scaled scores [B, H, S, S] with NEG_INF where masked, and the
    mask (None: nothing masked)."""
    H, S = q.shape[1], q.shape[2]
    s = torch.matmul(q.to(torch.float32),
                     _repeat_kv(k, H).to(torch.float32).transpose(-1, -2)) * scale
    ok = _mask(S, q.device, causal, segment_ids)
    if ok is not None:
        s = s.masked_fill(~ok, NEG_INF)
    return s, ok


def flash_fwd_ref(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                  segment_ids=None):
    """Plain version of the K5 forward -> (out [B, H, S, D] in q's dtype,
    lse [B, H, S] fp32), in fp32 from the same inputs: the softmax of the
    whole row at once (the kernel's online softmax over key tiles gives the
    same up to rounding), p rounded to v's dtype before P.V."""
    H, D = q.shape[1], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s, _ = _scores(q, k, scale, causal, segment_ids)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.matmul(p.to(v.dtype).to(torch.float32),
                     _repeat_kv(v, H).to(torch.float32))
    return (o / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, segment_ids):
    """fp32 [B, H, S, S] p = where(ok, exp(s - lse), 0) and
    ds = p (do v^T - delta) scale."""
    f32 = torch.float32
    s, ok = _scores(q, k, scale, causal, segment_ids)
    p = torch.exp(s - lse[..., None].to(f32))
    if ok is not None:
        p = torch.where(ok, p, 0.0)
    dp = torch.matmul(do.to(f32), _repeat_kv(v, q.shape[1]).to(f32).transpose(-1, -2))
    return p, p * (dp - delta[..., None].to(f32)) * scale


def _dkdv(q, k, v, do, p, ds):
    B, H, S, D = q.shape
    f32, group = torch.float32, H // k.shape[1]
    dv = torch.matmul(p.to(do.dtype).to(f32).transpose(-1, -2), do.to(f32))
    dk = torch.matmul(ds.to(q.dtype).to(f32).transpose(-1, -2), q.to(f32))
    dk = dk.reshape(B, -1, group, S, D).sum(dim=2)
    dv = dv.reshape(B, -1, group, S, D).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def _dq(q, k, ds):
    f32 = torch.float32
    return torch.matmul(ds.to(k.dtype).to(f32),
                        _repeat_kv(k, q.shape[1]).to(f32)).to(q.dtype)


def flash_bwd_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                  scale: Optional[float] = None, segment_ids=None):
    """Plain version of the K5 backward -> (dq, dk, dv) in q's, k's and v's
    dtypes, from the saved lse [B, H, S] and delta = sum(do * out, -1)
    [B, H, S]: p = where(ok, exp(s - lse), 0); dv = p^T do; dp = do v^T;
    ds = p (dp - delta) scale; dk = ds^T q; dq = ds k. dk and dv are summed
    over each kv head's group in fp32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, segment_ids)
    return (_dq(q, k, ds),) + _dkdv(q, k, v, do, p, ds)


def flash_bwd_dkdv_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                       scale: Optional[float] = None, segment_ids=None):
    """Plain version of K5b alone -> (dk, dv), as in ``flash_bwd_ref``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, segment_ids)
    return _dkdv(q, k, v, do, p, ds)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                     scale: Optional[float] = None, segment_ids=None):
    """Plain version of K5c alone -> dq, as in ``flash_bwd_ref``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, causal, scale, segment_ids)
    return _dq(q, k, ds)


# ----------------------------------------------------------------------------
# Kernel wrappers: the kernel on CUDA tensors, the plain version on CPU ones
# ----------------------------------------------------------------------------

def kernel_input_error(q, k, v, *extra) -> Optional[str]:
    """Why the kernels cannot take q [B, H, S, D], k/v [B, KVH, S, D] and
    ``extra`` (do) (None if they can): KVH dividing H, D a multiple of 128,
    all bf16 or all fp32. Any layout: an operand TMA cannot read
    (``_cuda.tma_ready``) is copied first (``_check_kernel_inputs``). Devices are not
    checked: a pure function of shapes and dtypes."""
    B, H, S, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        return (f"flash kernels: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                f"v {tuple(v.shape)} do not fit [B,H,S,D] / [B,KVH,S,D]")
    if H % k.shape[1]:
        return f"flash kernels: KVH={k.shape[1]} does not divide H={H}"
    if D < KERNEL_D_STEP or D % KERNEL_D_STEP:
        return f"flash kernels take D a multiple of {KERNEL_D_STEP}, got {D}"
    dtypes = {t.dtype for t in (q, k, v) + extra}
    if len(dtypes) != 1 or q.dtype not in KERNEL_DTYPES:
        return (f"flash kernels take q/k/v/do all bf16 or all fp32, got "
                f"{sorted(str(d) for d in dtypes)}")
    return None


def _check_kernel_inputs(q, k, v, *extra):
    """Raise unless the kernels take these tensors on the current card;
    return them as the kernels read them (``_cuda.tma_operand``: a view
    that is not 16-byte aligned, or has no unit stride over D, becomes a
    fresh contiguous copy, and the same kernel runs on it)."""
    _cuda.require_cuda(q, k, v, *extra)
    err = kernel_input_error(q, k, v, *extra)
    if err is not None:
        raise ValueError(err)
    return tuple(_cuda.tma_operand(t) for t in (q, k, v) + extra)


def _bhs(t):
    """Element strides of a [B, H, S, D] tensor over batch, head and sequence
    (those of length-1 dims made 16-byte multiples for the tensor maps)."""
    return _cuda.tma_strides(t, (0, 1, 2))


def _bshd_like(q):
    """An empty [B, H, S, D] tensor in [B, S, H, D] storage (llama's layout)."""
    B, H, S, D = q.shape
    return torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)


def _seg_arg(segment_ids, q):
    if segment_ids is None:
        return None
    if segment_ids.shape != (q.shape[0], q.shape[2]):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} != [B, S]")
    return segment_ids.to(device=q.device, dtype=torch.int32).contiguous()


def _fp32(q) -> int:
    """The kernels' dtype flag: 1 for fp32 inputs (the FFMA kernels), 0 for bf16."""
    return int(q.dtype == torch.float32)


def _f32_bhs(t, q):
    B, H, S, _ = q.shape
    if t.shape != (B, H, S):
        raise ValueError(f"lse/delta {tuple(t.shape)} != [B, H, S] = {(B, H, S)}")
    return t.to(torch.float32).contiguous()


def _count(q, kernel: str) -> None:
    """One launch of ``kernel`` (fwd, dkdv or dq) with q's dtype and head dim."""
    f32, d256, wide = _fp32(q), int(q.shape[-1] == 256), int(q.shape[-1] > 256)
    for suffix, n in (("", 1), ("_f32", f32), ("_d256", d256), ("_f32_d256", f32 * d256),
                      ("_wide", wide), ("_f32_wide", f32 * wide)):
        name = f"{kernel}{suffix}_launches"
        setattr(flash_attention, name, getattr(flash_attention, name) + n)


def flash_fwd(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              segment_ids=None):
    """K5 forward -> (out [B, H, S, D], lse [B, H, S] fp32)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, scale=scale,
                             segment_ids=segment_ids)
    q, k, v = _check_kernel_inputs(q, k, v)
    B, H, S, D = q.shape
    seg = _seg_arg(segment_ids, q)
    out = _bshd_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = _cuda.longs(_bhs(q) + _bhs(k) + _bhs(v) + _bhs(out))
    _cuda.check(_cuda.library().slime_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _cuda.ptr(seg), strides, B, H, k.shape[1], S, D, _fp32(q), int(causal), scale,
        _cuda.stream()), "flash_fwd")
    _count(q, "fwd")
    return out, lse


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool = True,
                   scale: Optional[float] = None, segment_ids=None):
    """K5b: (dk, dv) [B, KVH, S, D] in k's / v's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_bwd_dkdv_ref(q, k, v, do, lse, delta, causal=causal,
                                  scale=scale, segment_ids=segment_ids)
    q, k, v, do = _check_kernel_inputs(q, k, v, do)
    B, H, S, D = q.shape
    seg = _seg_arg(segment_ids, q)
    lse, delta = _f32_bhs(lse, q), _f32_bhs(delta, q)
    dk, dv = _bshd_like(k), _bshd_like(v)
    strides = _cuda.longs(_bhs(q) + _bhs(k) + _bhs(v) + _bhs(do) + _bhs(dk) + _bhs(dv))
    _cuda.check(_cuda.library().slime_flash_bwd_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _cuda.ptr(seg), dk.data_ptr(), dv.data_ptr(), strides,
        B, H, k.shape[1], S, D, _fp32(q), int(causal), scale, _cuda.stream()),
        "flash_bwd_dkdv")
    _count(q, "dkdv")
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 scale: Optional[float] = None, segment_ids=None):
    """K5c: dq [B, H, S, D] in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal, scale=scale,
                                segment_ids=segment_ids)
    q, k, v, do = _check_kernel_inputs(q, k, v, do)
    B, H, S, D = q.shape
    seg = _seg_arg(segment_ids, q)
    lse, delta = _f32_bhs(lse, q), _f32_bhs(delta, q)
    dq = _bshd_like(q)
    strides = _cuda.longs(_bhs(q) + _bhs(k) + _bhs(v) + _bhs(do) + _bhs(dq))
    _cuda.check(_cuda.library().slime_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _cuda.ptr(seg), dq.data_ptr(), strides,
        B, H, k.shape[1], S, D, _fp32(q), int(causal), scale, _cuda.stream()),
        "flash_bwd_dq")
    _count(q, "dq")
    return dq


class _Flash(torch.autograd.Function):
    """K5 with its backward: forward -> out (saves out and lse); backward ->
    delta in plain torch, then K5b (dk, dv), then K5c (dq). On CPU tensors
    each step takes its plain version."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale,
                             segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seg = ctx.saved_tensors
        delta = (do.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
        kw = dict(causal=ctx.causal, scale=ctx.scale, segment_ids=seg)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def _auto_kernel(q, causal: bool) -> bool:
    """JAX's rule (flash_attention.py:523-525) with "on a TPU" read as "on
    the card": causal, S >= 2048, S and D multiples of 128. Nothing more:
    a tensor the rule picks that the kernels cannot take (a dtype other than
    bf16 and fp32) raises in them instead of quietly taking the plain
    path."""
    S, D = q.shape[2], q.shape[3]
    return (q.is_cuda and causal and S >= MIN_AUTO_SEQ and S % 128 == 0
            and D % 128 == 0)


def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
                    use_kernel: Optional[bool] = None, segment_ids=None):
    """q [B, H, S, D]; k, v [B, KVH, S, D] (KVH divides H) -> [B, H, S, D].

    ``use_kernel`` is JAX's ``use_pallas``. None picks the K5 kernels for
    causal CUDA tensors at S >= 2048 with S and D multiples of 128 (JAX's
    conditions) and ``reference_attention`` otherwise. True runs the kernels
    (with their backward under autograd). Either raises on a CUDA tensor
    the kernels cannot take (they take bf16 or fp32 with D a multiple of
    128), and True raises on a CPU tensor; False is the plain path."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if use_kernel is None:
        use_kernel = _auto_kernel(q, causal)
    if not use_kernel:
        return reference_attention(q, k, v, causal=causal, scale=scale,
                                   segment_ids=segment_ids)
    if q.device.type == "cpu":
        raise ValueError("flash_attention(use_kernel=True) needs CUDA tensors: "
                         "the K5 kernels have no CPU mode")
    return _Flash.apply(q, k, v, segment_ids, causal, scale)


for _kernel in ("fwd", "dkdv", "dq"):
    for _suffix in ("", "_f32", "_d256", "_f32_d256", "_wide", "_f32_wide"):
        setattr(flash_attention, f"{_kernel}{_suffix}_launches", 0)
