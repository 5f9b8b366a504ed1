"""Non-causal encoder (ViT) attention: the CUDA kernel and its plain version.

Port of ``slime_tpu/ops/encoder_attention.py``. The TPU kernel (K4,
``_pallas_fwd``/``_kernel``) keeps a whole score row of a head in VMEM and
replaces the softmax's row-max subtract with a clamp, ``exp(min(s, 80))``: the
result equals the stabilized softmax unless a score exceeds 80, and fp32 cannot
overflow (1024 * e^80 < fp32 max). The Hopper kernel
(``csrc/encoder_attention.cu``; in bf16 TMA tiles in an mbarrier ring, both
products as ``wgmma``) keeps those semantics; ``encoder_attention_ref`` is
the same math in plain PyTorch.

The kernel takes bf16 (``wgmma``) or fp32 q/k/v and returns their dtype.
fp32 (the tower's default compute dtype) runs an FFMA kernel designed for
Hopper's FFMA units: 8 x 4 register tiles of S and O (8 x 8 of O at D > 64)
fed by float4 shared-memory reads, k/v tiles of 64 keys in a two-stage
``cp.async`` ring, 128 query rows a block (64 at D > 64). Which CUDA inputs
launch it is JAX's rule (``takes_kernel``, a pure function of the shape);
the others take ``stable_attention``, JAX's ``_xla_attention``.

The gradient is JAX's (``_enc_bwd``, :133-138): the backward recomputes the
attention through the plain stabilized softmax (``stable_attention``, JAX's
``_xla_attention`` :108-120, not the clamped form) and differentiates that.
The vision tower is frozen in the staged pretraining, so no path of the port
runs it yet.

Layout: q/k/v [B, S, H, D], the ViT's own layout, on both paths.
Launch counts: ``encoder_attention.launches`` every launch,
``.f32_launches`` those with fp32 inputs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _cuda

MAX_SEQ = 1024          # the TPU kernel's single-tile gate (encoder_attention.py:164-171)
MAX_HEAD_DIM = 128
VMEM_LIMIT = 12 * 2 ** 20   # the same gate's VMEM budget (bytes)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
CLAMP = 80.0
# the kernel's designs (csrc/encoder_attention.cu): 0 is the production one;
# 1-3 are the P2 probe's others (slime_tpu_torch/probes/encoder_attention.py)
VARIANTS = {0: "128 query rows (2 warpgroups), 64-key tiles, 2 stages",
            1: "64 query rows (1 warpgroup), 64-key tiles, 2 stages",
            2: "128 query rows, 128-key tiles, 2 stages",
            3: "128 query rows, 64-key tiles, 3 stages"}


def encoder_attention_ref(q, k, v, *, scale: Optional[float] = None):
    """Plain PyTorch version of the kernel's math (encoder_attention.py:57-75),
    as the JAX kernel evaluates it: q scaled in fp32 and rounded to its dtype;
    fp32 scores; p = exp(bf16(min(s, 80))) in fp32; l = the fp32 sum of p,
    rounded to bf16; o = (p in v's dtype) @ v, accumulated in fp32, over l."""
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qs = (q.to(torch.float32) * scale).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.to(torch.float32), k.to(torch.float32))
    p = torch.exp(torch.clamp(s, max=CLAMP).to(torch.bfloat16).to(torch.float32))
    l = p.sum(dim=-1, keepdim=True).to(torch.bfloat16)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return (o / l.to(torch.float32).transpose(1, 2)).to(q.dtype)


def stable_attention(q, k, v, *, scale: float):
    """Plain attention with the stabilized softmax (fp32 scores; for bf16 the
    max-subtract in fp32, exp and normalize in bf16), JAX's _xla_attention."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    if q.dtype == torch.bfloat16:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(q.dtype)
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(torch.float32),
                        v.to(torch.float32)).to(q.dtype)


class _Enc(torch.autograd.Function):
    """K4 forward; backward by recomputing ``stable_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = stable_attention(q, k, v, scale=ctx.scale)
        return (*torch.autograd.grad(out, (q, k, v), g), None)


def _heads_per(H: int) -> int:
    """Heads per TPU program (encoder_attention.py:78-86): 4, 2 or 1."""
    for hp in (4, 2):
        if H % hp == 0:
            return hp
    return 1


def takes_kernel(shape) -> bool:
    """JAX's rule (encoder_attention.py:159-171) for q [B, S, H, D], with "on
    a TPU" read as "on the card": the kernel when S <= 1024, D <= 128, D % 8
    == 0 and the TPU kernel's VMEM estimate (four double-buffered q/k/v/o
    blocks of its heads, one fp32 score tile and its bf16 exp) stays under
    12 MiB; ``stable_attention`` (JAX's ``_xla_attention``) otherwise. A pure
    function of the shape: the dtype does not enter it (CLIP-L's [8, 577, 16,
    64] takes the kernel; S = 1024 at any H and D does not)."""
    _, S, H, D = shape
    block_s = -(-S // 128) * 128
    vmem = 8 * block_s * _heads_per(H) * D * 2 + 2 * block_s * block_s * 6
    return S <= MAX_SEQ and D <= MAX_HEAD_DIM and D % 8 == 0 and vmem < VMEM_LIMIT


def encoder_attention(q, k, v, *, scale: Optional[float] = None):
    """Bidirectional attention, q/k/v [B, S, H, D] -> [B, S, H, D].

    CPU tensors take ``encoder_attention_ref``. CUDA tensors follow JAX's
    rule (``takes_kernel``): the kernel (``kernel_input_error`` says what it
    takes; it raises on what it cannot) or ``stable_attention``.
    Under autograd the gradient is that of ``stable_attention``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Enc.apply(q, k, v, scale)


def kernel_input_error(q, k, v) -> Optional[str]:
    """Why the kernel cannot take q/k/v (None if it can): all bf16 or all
    fp32 [B, S, H, D] of one shape, S <= 1024, D <= 128, D % 8 == 0. Any
    layout: a view TMA cannot read (``_cuda.tma_ready``: unit stride over D,
    16-byte aligned data and strides) is copied into a fresh contiguous
    tensor and the kernel runs on the copy. Devices are not checked: a pure
    function of shapes and dtypes."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        return f"q/k/v shapes differ or are not [B, S, H, D]: {q.shape}, {k.shape}, {v.shape}"
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != q.dtype for t in (k, v)):
        return (f"encoder_attention kernel takes q/k/v all bf16 or all fp32, got "
                f"{[str(t.dtype) for t in (q, k, v)]}")
    S, D = q.shape[1], q.shape[3]
    if S > MAX_SEQ or D > MAX_HEAD_DIM or D % 8:
        return (f"encoder_attention kernel takes S <= {MAX_SEQ}, D <= {MAX_HEAD_DIM}, "
                f"D % 8 == 0; got S={S}, D={D}")
    return None


def encoder_attention_kernel(q, k, v, *, scale: float, variant: int = 0):
    """Launch K4 (design ``variant``, see ``VARIANTS``) on CUDA q/k/v or
    raise; counts ``encoder_attention.launches``. A view TMA cannot read is
    copied first (``_cuda.tma_operand``); the output is a new tensor."""
    _cuda.require_cuda(q, k, v)
    err = kernel_input_error(q, k, v)
    if err is not None:
        raise ValueError(err)
    q, k, v = (_cuda.tma_operand(t) for t in (q, k, v))
    B, S, H, D = q.shape
    f32 = int(q.dtype == torch.float32)
    if variant not in VARIANTS or (variant and (D > 64 or f32)):
        raise ValueError(f"encoder_attention variant {variant}: 0 takes D <= 128 in bf16 "
                         f"or fp32, 1-3 D <= 64 in bf16")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v) for st in _cuda.tma_strides(t, (0, 1, 2))]
    _cuda.check(_cuda.library().slime_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, D, *strides, scale, variant, f32, _cuda.stream()), "encoder_attention")
    encoder_attention.launches += 1
    encoder_attention.f32_launches += f32
    return out


def _forward(q, k, v, scale: float):
    if q.device.type == "cpu":
        return encoder_attention_ref(q, k, v, scale=scale)
    if not takes_kernel(q.shape):
        return stable_attention(q, k, v, scale=scale)
    return encoder_attention_kernel(q, k, v, scale=scale)


encoder_attention.launches = encoder_attention.f32_launches = 0
