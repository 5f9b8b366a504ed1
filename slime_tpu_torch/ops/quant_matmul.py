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
take the plain versions; CUDA tensors launch a kernel
(``csrc/quant_matmul.cu``) or raise. Which one is a pure function of x's
rows and dtype (``q4g_route``): K7 with bf16 x of at least 64 rows (the
prefill) runs the Hopper design, ``wgmma`` with the int4 weights dequantized
in registers as the A operand of y^T = W.x^T and the group scales applied to
fp32 partial sums; bf16 x below 64 rows (decode) and K6 with bf16 x run the
``mma.sync`` GEMM; fp32 x (the default compute dtype) runs an FFMA GEMM over
the weights dequantized to fp32, as JAX's ``astype(x.dtype)``. y comes back
in x's dtype. K6 takes any K with int8 weights and any even K with q4 (its
kernels mask the last k-tile and read x in place); q4g takes multiples of
256 (``k_multiple``).

Launch counts: ``quant_matmul.q4_launches`` / ``.int8_launches`` and
``quant_matmul_q4g.launches`` count every launch, ``.q4_f32_launches``,
``.int8_f32_launches`` and ``quant_matmul_q4g.f32_launches`` those with fp32
x, ``quant_matmul_q4g.wgmma_launches`` those of the ``wgmma`` instance.
"""
from __future__ import annotations

import torch

from . import _cuda
from .quantization import int_values

_Q4, _INT8, _Q4G = 0, 1, 2
_TILE = 64                  # output tile of the mma.sync / FFMA kernels (rows and columns)
WGMMA_MIN_ROWS = 64         # K7's wgmma instance takes bf16 x from this many rows
_WG_TILE = 128              # its output tile: 128 weight rows x 128 tokens


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


def q4g_route(rows: int, dtype: torch.dtype) -> str:
    """K7's kernel for x of ``rows`` rows and ``dtype``: "wgmma" for bf16 at
    rows >= WGMMA_MIN_ROWS, "mma" (the ``mma.sync`` GEMM) for bf16 below,
    "ffma" for fp32. A pure function, so CPU tests can pin it."""
    if dtype == torch.float32:
        return "ffma"
    return "wgmma" if rows >= WGMMA_MIN_ROWS else "mma"


def k_multiple(fmt: int) -> int:
    """What K must be a multiple of: 1 for int8 and 2 for q4 (the kernels
    mask their last k-tile, as JAX's kernels take the whole row), 256 for
    q4g (two groups a packed block; JAX asserts it too)."""
    return {_INT8: 1, _Q4: 2, _Q4G: 256}[fmt]


def _operands(fmt: int, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor):
    """Check the operands -> (M, K, N, w), w 16-byte aligned (a copy of a
    view that is not), or raise."""
    _cuda.require_cuda(x, w, s)
    if (x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 2
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"quantized matmul takes contiguous, 16-byte aligned bf16 or "
                         f"fp32 [M, K] activations, got {x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    N = w.shape[0]
    step = k_multiple(fmt)
    want_w = (N, K if fmt == _INT8 else K // 2)
    want_s = (N, K // 128 if fmt == _Q4G else 1)
    if (K < 1 or K % step or w.dtype != torch.int8 or tuple(w.shape) != want_w
            or not w.is_contiguous() or s.dtype != torch.float32
            or tuple(s.shape) != want_s or not s.is_contiguous()):
        raise ValueError(f"weight {w.dtype} {tuple(w.shape)} / scale {s.dtype} "
                         f"{tuple(s.shape)} do not fit K = {K}: expected int8 {want_w}, "
                         f"fp32 {want_s}, K a positive multiple of {step}")
    return M, K, N, (w if w.data_ptr() % 16 == 0 else w.clone())


def _sms(x: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _launch(fmt: int, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The mma.sync or FFMA kernel (with a split over K when the output tiles
    alone would leave SMs idle); returns y [M, N] in x's dtype."""
    M, K, N, w = _operands(fmt, x, w, s)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    n_k = -(-K // (256 if fmt == _Q4G else 128))     # k-tiles, the last masked past K
    blocks = -(-N // _TILE) * -(-M // _TILE)
    sms = _sms(x)
    splits = min(n_k, -(-2 * sms // blocks)) if blocks < sms else 1
    per_split = -(-n_k // splits)
    splits = -(-n_k // per_split)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    _cuda.check(_cuda.library().slime_quant_matmul(
        fmt, int(x.dtype == torch.float32), x.data_ptr(), M, K, w.data_ptr(), s.data_ptr(),
        N, y.data_ptr(), _cuda.ptr(ws), splits, per_split, _cuda.stream()), "quant_matmul")
    return y


def wgmma_splits(M: int, N: int, K: int, sms: int):
    """(splits, packed blocks per split) of K7's wgmma instance: a split
    over K only where its 128 x 128 tiles fill at most half the SMs (one
    block an SM: a split of a grid that already fills them adds a wave)."""
    blocks = -(-N // _WG_TILE) * -(-M // _WG_TILE)
    n_kb = K // 256
    splits = max(1, min(n_kb, sms // blocks)) if 2 * blocks <= sms else 1
    per_split = -(-n_kb // splits)
    return -(-n_kb // per_split), per_split


def _launch_q4g_wgmma(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    M, K, N, w = _operands(_Q4G, x, w, s)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    splits, per_split = wgmma_splits(M, N, K, _sms(x))
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    _cuda.check(_cuda.library().slime_quant_matmul_q4g_wgmma(
        x.data_ptr(), M, K, w.data_ptr(), s.data_ptr(), N, y.data_ptr(), _cuda.ptr(ws), splits,
        per_split, _cuda.stream()), "quant_matmul_q4g_wgmma")
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
    ``q4g`` weights (K7), on the kernel ``q4g_route`` names."""
    if x.device.type == "cpu":
        return quant_matmul_q4g_ref(x, qw)
    route = q4g_route(x.shape[0] if x.dim() == 2 else 0, x.dtype)
    if route == "wgmma":
        y = _launch_q4g_wgmma(x, qw["q4g"], qw["scale"])
    else:
        y = _launch(_Q4G, x, qw["q4g"], qw["scale"])
    quant_matmul_q4g.launches += 1
    quant_matmul_q4g.f32_launches += route == "ffma"
    quant_matmul_q4g.wgmma_launches += route == "wgmma"
    return y


quant_matmul.q4_launches = quant_matmul.q4_f32_launches = 0
quant_matmul.int8_launches = quant_matmul.int8_f32_launches = 0
quant_matmul_q4g.launches = quant_matmul_q4g.f32_launches = 0
quant_matmul_q4g.wgmma_launches = 0
