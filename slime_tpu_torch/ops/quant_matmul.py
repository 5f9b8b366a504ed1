"""Weight-only quantized matmul: the K6 and K7 CUDA kernels and their plain versions.

Port of ``slime_tpu/ops/quant_matmul.py``:

  quant_matmul      (K6)  x [B, IN] @ dequant(W).T for per-row ``q4`` or
                          ``q`` (int8) weights: the products of x and the
                          exact integer weights summed in fp32, then the
                          per-row scale, rounded to x.dtype;
  quant_matmul_q4g  (K7)  the same for group-128 ``q4g`` weights: one fp32
                          partial sum per 128-column group, times that
                          group's scale, summed over the groups in fp32.

``layers.linear`` routes per-row ``q4`` to K6 and ``q4g`` to K7 on the card
(JAX's ``layers.py:52-53`` on the TPU); int8 has no caller in the JAX
package's routing, so K6's int8 loader is off the serving path. CPU tensors
take the plain versions; CUDA tensors launch the kernel
(``csrc/quant_matmul.cu``) or raise. x is bf16 (an ``mma.sync`` GEMM) or fp32
(the default compute dtype: an FFMA GEMM over the weights dequantized to
fp32, as JAX's ``astype(x.dtype)``); y comes back in x's dtype.

Launch counts: ``quant_matmul.q4_launches`` / ``.int8_launches`` and
``quant_matmul_q4g.launches`` count every launch, ``.q4_f32_launches``,
``.int8_f32_launches`` and ``quant_matmul_q4g.f32_launches`` those with fp32
x.
"""
from __future__ import annotations

import torch

from . import _cuda
from .quantization import int_values

_Q4, _INT8, _Q4G = 0, 1, 2
_TILE = 64                  # output tile of the kernel (rows and columns)


def quant_matmul_ref(x: torch.Tensor, qw) -> torch.Tensor:
    """Plain version of K6: (x @ w_int.T) * scale[o] in fp32 -> x.dtype."""
    scale = qw["scale"]
    if scale.shape[-1] != 1:
        raise ValueError("quant_matmul takes per-row scales (scale [out, 1])")
    w = int_values(qw).to(torch.float32)
    y = torch.matmul(x.to(torch.float32), w.T) * scale[:, 0].to(torch.float32)[None, :]
    return y.to(x.dtype)


def quant_matmul_q4g_ref(x: torch.Tensor, qw) -> torch.Tensor:
    """Plain version of K7: sum over groups g of (x_g @ w_g.T) * scale[:, g],
    each group's partial sum in fp32, groups added in order -> x.dtype."""
    w = int_values(qw).to(torch.float32)
    s = qw["scale"].to(torch.float32)
    gs = w.shape[-1] // s.shape[-1]
    xf = x.to(torch.float32)
    y = None
    for g in range(s.shape[-1]):
        part = torch.matmul(xf[:, g * gs:(g + 1) * gs], w[:, g * gs:(g + 1) * gs].T)
        part = part * s[:, g][None, :]
        y = part if y is None else y + part
    return y.to(x.dtype)


def _launch(fmt: int, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Check the operands and launch the kernel (with a split over K when the
    output tiles alone would leave SMs idle); returns y [M, N] in x's dtype."""
    _cuda.require_cuda(x, w, s)
    if (x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 2
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"quantized matmul takes contiguous, 16-byte aligned bf16 or "
                         f"fp32 [M, K] activations, got {x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    N = w.shape[0]
    step = 256 if fmt == _Q4G else 128
    want_w = (N, K if fmt == _INT8 else K // 2)
    want_s = (N, K // 128 if fmt == _Q4G else 1)
    if (K % step or w.dtype != torch.int8 or tuple(w.shape) != want_w
            or not w.is_contiguous() or s.dtype != torch.float32
            or tuple(s.shape) != want_s or not s.is_contiguous()):
        raise ValueError(f"weight {w.dtype} {tuple(w.shape)} / scale {s.dtype} "
                         f"{tuple(s.shape)} do not fit K = {K}: expected int8 {want_w}, "
                         f"fp32 {want_s}, K a multiple of {step}")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    n_k = K // step
    blocks = -(-N // _TILE) * -(-M // _TILE)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = min(n_k, -(-2 * sms // blocks)) if blocks < sms else 1
    per_split = -(-n_k // splits)
    splits = -(-n_k // per_split)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    _cuda.check(_cuda.library().slime_quant_matmul(
        fmt, int(x.dtype == torch.float32), x.data_ptr(), M, K, w.data_ptr(), s.data_ptr(),
        N, y.data_ptr(), _cuda.ptr(ws), splits, per_split, _cuda.stream()), "quant_matmul")
    return y


def quant_matmul(x: torch.Tensor, qw) -> torch.Tensor:
    """x [B, IN] @ dequant(qw).T -> [B, OUT] in x.dtype, for per-row ``q4``
    or int8 ``q`` weights (K6)."""
    if x.device.type == "cpu":
        return quant_matmul_ref(x, qw)
    int4 = "q4" in qw
    y = _launch(_Q4 if int4 else _INT8, x, qw["q4"] if int4 else qw["q"], qw["scale"])
    name = "q4" if int4 else "int8"
    for suffix, n in (("", 1), ("_f32", int(x.dtype == torch.float32))):
        attr = f"{name}{suffix}_launches"
        setattr(quant_matmul, attr, getattr(quant_matmul, attr) + n)
    return y


def quant_matmul_q4g(x: torch.Tensor, qw) -> torch.Tensor:
    """x [B, IN] @ dequant(qw).T -> [B, OUT] in x.dtype for group-128
    ``q4g`` weights (K7)."""
    if x.device.type == "cpu":
        return quant_matmul_q4g_ref(x, qw)
    y = _launch(_Q4G, x, qw["q4g"], qw["scale"])
    quant_matmul_q4g.launches += 1
    quant_matmul_q4g.f32_launches += x.dtype == torch.float32
    return y


quant_matmul.q4_launches = quant_matmul.q4_f32_launches = 0
quant_matmul.int8_launches = quant_matmul.int8_f32_launches = 0
quant_matmul_q4g.launches = quant_matmul_q4g.f32_launches = 0
