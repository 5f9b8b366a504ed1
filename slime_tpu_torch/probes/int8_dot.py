"""P3: the int8 dot probe on the card.

Counterpart of the TPU probe ``pallas_dot`` in
``scripts/bench_int8_dot_probe.py`` (:59, the kernels ``_k_nt`` / ``_k_nn``
/ ``_k_nn_bf16`` :42-57), which timed the int8 x int8 -> int32 product that
K8 is built on, at M, K, N = 32768, 1024, 4096, in three operand forms
(``FORMS``): ``nt`` (``wq [N, K]``, the layout ``quantize_weight`` stores),
``nn`` (its transposed copy ``[K, N]``) and ``nn_bf16`` (``nn`` rounded to
bf16). Here each form is one hand-written kernel on K8's main loop
(``csrc/int8_dot.cu`` over ``csrc/int8_gemm.cuh``: TMA, s8 ``wgmma``, a
persistent grid; ``nn`` transposes its weight tiles in the producer
warpgroup, since s8 ``wgmma`` reads only K-major operands), held to the
exact integer product (``plain``: equal, bit for bit) and timed as
``chip_smoke.py`` phase 1 times kernels: the median of CUDA-event timings
with L2 flushed between runs. The TPU's (bm, bn) sweep has no meaning here;
each form runs at the main loop's two output tiles (``TILES``: 128 x 128,
K8's, and 128 x 256). One JSON line per form and tile, named after the
script's lines (``int8_dot_<form>_128x<tile>``, TOP/s and ms), then the
library lines: the
script's "XLA int8 dot" as ``torch._int_mm`` and its "XLA bf16 dot" as bf16
``torch.matmul`` on the same values.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 -m slime_tpu_torch.probes.int8_dot
"""
from __future__ import annotations

import json

import torch

from . import cuda_ms
from ..ops import _cuda
from ..ops import w8a8_matmul as w8

M, K, N = 32768, 1024, 4096
FORMS = {"nt": 0, "nn": 1, "nn_bf16": 2}
TILES = (128, 256)          # output columns of a 128-row tile


def make_inputs(device, seed: int = 0, shape=(M, K, N)):
    """xq int8 [M, K], wq int8 [N, K] uniform over -127..127 (the script's
    draw) and wt = wq^T contiguous [K, N], from a seeded generator."""
    m, k, n = shape
    g = torch.Generator(device=device).manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=device, generator=g)
    wq = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=device, generator=g)
    return xq, wq, wq.T.contiguous()


def plain(form: str, xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact product in ``form`` (w [N, K] for nt, [K, N] for nn):
    int32, or rounded to bf16 through fp32 for nn_bf16. fp64 holds every
    partial sum exactly (K * 127^2 < 2^53), so the order does not matter."""
    wt = w.T if form == "nt" else w
    c = torch.matmul(xq.to(torch.float64), wt.to(torch.float64)).to(torch.int32)
    return c.to(torch.bfloat16) if form == "nn_bf16" else c


def dot(form: str, xq: torch.Tensor, w: torch.Tensor, tile_n: int = 256) -> torch.Tensor:
    """One launch of the probe kernel in ``form`` on 128 x ``tile_n`` output
    tiles -> [M, N] int32 (bf16 for nn_bf16). The kernel has no CPU mode:
    CPU tensors raise."""
    if xq.device.type != "cuda":
        raise ValueError("P3's kernel runs on a CUDA card; plain() computes on the CPU")
    _cuda.require_cuda(xq, w)
    m, k = xq.shape
    n = w.shape[0] if form == "nt" else w.shape[1]
    want_w = (n, k) if form == "nt" else (k, n)
    if (form not in FORMS or tile_n not in TILES or xq.dtype != torch.int8
            or w.dtype != torch.int8 or tuple(w.shape) != want_w or k % 16
            or (form != "nt" and n % 16) or not xq.is_contiguous() or not w.is_contiguous()
            or xq.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"P3 takes contiguous, aligned int8 xq [M, K] and w {want_w} "
                         f"(K and, for nn, N multiples of 16), form in {list(FORMS)}, "
                         f"tile_n in {TILES}; got {tuple(xq.shape)}, {tuple(w.shape)}")
    out = torch.empty((m, n), dtype=torch.bfloat16 if form == "nn_bf16" else torch.int32,
                      device=xq.device)
    sms = torch.cuda.get_device_properties(xq.device).multi_processor_count
    _cuda.check(_cuda.library().slime_int8_dot(
        FORMS[form], tile_n, xq.data_ptr(), m, k, w.data_ptr(), n, out.data_ptr(),
        w8.persistent_grid(m, n, tile_n, sms), _cuda.stream()), "int8_dot")
    dot.launches += 1
    return out


dot.launches = 0


def int_mm(xq: torch.Tensor, wq: torch.Tensor):
    """``torch._int_mm(xq, wq.T)`` as a callable, or None where the installed
    torch does not run it on this card (the library line, not the port)."""
    try:
        fn = lambda: torch._int_mm(xq, wq.T)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        return fn
    except (RuntimeError, NotImplementedError, AttributeError):
        return None


def run(device=None, *, runs: int = 25, seed: int = 0, log=print):
    """Check every (form, tile) against the plain version (equal), time them,
    and print one JSON line each plus the library lines. Returns the records
    ({metric, form, tile_n, ms, tops, equal}), the plain versions' times by
    form, and the library times (``int_mm``: None where it does not run;
    ``bf16``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the P3 probe runs on a CUDA card")
    dev = torch.device(device) if device is not None else torch.device("cuda")
    xq, wq, wt = make_inputs(dev, seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB > L2
    ops = 2 * M * K * N
    records, plain_ms = [], {}
    for form in FORMS:
        w = wq if form == "nt" else wt
        want = plain(form, xq, w)
        plain_ms[form] = cuda_ms(lambda: plain(form, xq, w), runs, flush)
        for tile_n in TILES:
            got = dot(form, xq, w, tile_n)
            if not torch.equal(got, want):
                bad = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"P3 {form} 128x{tile_n}: differs from the exact "
                                     f"product by up to {bad:g}")
            ms = cuda_ms(lambda: dot(form, xq, w, tile_n), runs, flush)
            rec = {"metric": f"int8_dot_{form}_128x{tile_n}", "form": form, "tile_n": tile_n,
                   "ms": ms, "tops": ops / ms / 1e9, "equal": True}
            records.append(rec)
            log(json.dumps({"metric": rec["metric"], "value": rec["tops"],
                            "unit": f"TOP/s ({ms:.4f} ms; int8 peak 1979)",
                            "vs_baseline": None}))
        del want
    lib = {"int_mm": None, "bf16": None}
    fn = int_mm(xq, wq)
    if fn is not None:
        lib["int_mm"] = cuda_ms(fn, runs, flush)
    xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
    lib["bf16"] = cuda_ms(lambda: torch.matmul(xb, wb.T), runs, flush)
    for name, what in (("int_mm", "torch._int_mm (the script's XLA int8 dot)"),
                       ("bf16", "bf16 torch.matmul (the script's XLA bf16 dot)")):
        t = lib[name]
        log(json.dumps({"metric": f"int8_dot_library_{name}",
                        "value": None if t is None else ops / t / 1e9,
                        "unit": f"TOP/s ({'does not run here' if t is None else f'{t:.4f} ms'}"
                                f"; {what})", "vs_baseline": None}))
    return records, plain_ms, lib


if __name__ == "__main__":
    run()
