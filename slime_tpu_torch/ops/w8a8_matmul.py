"""W8A8 matmul (K8): per-token int8 activations times per-row int8 weights.

Port of ``slime_tpu/ops/w8a8_matmul.py``: x [M, K] is quantized per row
(token) with absmax scales, multiplied with the int8 weights in int32, and
the fp32 epilogue ``acc * xs * ws + bias`` rounds to x.dtype. It serves the
W8A8 vision tower (``vit.quantize_tower``, the CLI's ``--quantize-vision``).
CPU tensors take the plain version ``w8a8_matmul_ref``; CUDA tensors launch
the kernels of ``csrc/w8a8_matmul.cu`` (a row-quant pass and the int8 GEMM)
or raise. x is bf16 or fp32 (the tower's compute dtype); the int8 dot is the
same for both. ``w8a8_matmul.launches`` counts every launch,
``.f32_launches`` those with fp32 x.
"""
from __future__ import annotations

import torch

from . import _cuda


def w8a8_matmul_ref(x: torch.Tensor, qw, bias=None) -> torch.Tensor:
    """The JAX package's ``w8a8_matmul_ref`` (w8a8_matmul.py:101-115): the
    same per-token round-to-nearest-even quant, an exact integer dot (fp64
    holds every partial sum of int8 products at these K exactly), and the
    fp32 epilogue -> x.dtype."""
    q, scale = qw["q"], qw["scale"]
    xf = x.to(torch.float32)
    am = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.where(am > 0, am * (1.0 / 127.0), torch.ones_like(am))
    xq = torch.round(xf / xs).to(torch.int8)
    acc = torch.matmul(xq.to(torch.float64), q.to(torch.float64).T)
    y = acc.to(torch.float32) * xs * scale[:, 0].to(torch.float32)[None, :]
    if bias is not None:
        y = y + bias.to(torch.float32)[None, :]
    return y.to(x.dtype)


def w8a8_matmul(x: torch.Tensor, qw, bias=None) -> torch.Tensor:
    """x [M, K] @ dequant(qw).T with int8 activations -> [M, OUT] in x.dtype.
    qw: {"q": int8 [OUT, K], "scale": fp32 [OUT, 1]}; bias [OUT] or None."""
    if x.device.type == "cpu":
        return w8a8_matmul_ref(x, qw, bias)
    q, scale = qw["q"], qw["scale"]
    b = None if bias is None else bias.to(torch.float32).contiguous()
    _cuda.require_cuda(x, q, scale, *([] if b is None else [b]))
    if (x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 2
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"w8a8_matmul takes contiguous, 16-byte aligned bf16 or fp32 "
                         f"[M, K] activations, got {x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    N = q.shape[0]
    if (K % 128 or q.dtype != torch.int8 or tuple(q.shape) != (N, K)
            or not q.is_contiguous() or scale.dtype != torch.float32
            or tuple(scale.shape) != (N, 1) or not scale.is_contiguous()
            or (b is not None and tuple(b.shape) != (N,))):
        raise ValueError(f"weight {q.dtype} {tuple(q.shape)} / scale {tuple(scale.shape)}"
                         f" do not fit x [{M}, {K}]: expected int8 [N, K], fp32 [N, 1], "
                         f"bias [N], K a multiple of 128")
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    _cuda.check(_cuda.library().slime_w8a8_matmul(
        int(x.dtype == torch.float32), x.data_ptr(), M, K, xq.data_ptr(), xs.data_ptr(),
        q.data_ptr(), scale.data_ptr(), _cuda.ptr(b), N, y.data_ptr(), _cuda.stream()),
        "w8a8_matmul")
    w8a8_matmul.launches += 1
    w8a8_matmul.f32_launches += x.dtype == torch.float32
    return y


def w8a8_linear(p, x: torch.Tensor) -> torch.Tensor:
    """Linear layer over ``{"weight": {"q", "scale"}, "bias"?}`` with int8
    activations; leading batch dims kept (``w8a8_matmul.py:118-130``)."""
    lead = x.shape[:-1]
    y = w8a8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), p["weight"], p.get("bias"))
    return y.reshape(*lead, -1)


w8a8_matmul.launches = w8a8_matmul.f32_launches = 0
