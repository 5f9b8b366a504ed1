"""P1: the int4 matvec unpack probe on the card.

Counterpart of the TPU probe ``build`` in ``bench_quant_kernel.py`` (:75, the
kernels ``kern_i32`` / ``kern_twodot_i16`` :26-73), which swept int4 unpack
formulations of K6's per-row ``q4`` matvec at Llama-3-8B's gate_proj decode
shape. Here each variant of one hand-written kernel
(``csrc/int4_probes.cu`` ``p1_matvec_kernel``; ``VARIANTS``) computes K6's
function, x [1, 4096] bf16 @ W [14336, 4096 / 2] packed, and is held to
K6's plain version (``quant_matmul_ref``) at K6's tolerance, then timed as
``chip_smoke.py`` phase 1 times kernels: the median of CUDA-event timings
with L2 flushed between runs. Each variant runs at three output-row blocks a
block of 256 threads (``ROWS``: 16, 64, 256, that is 896, 224 and 56 blocks
for 14336 rows; the TPU's ``bo`` of 512-2048 rows has no meaning here). One
JSON line per variant and block, named as the JAX script names them
(``int4_matvec_<variant>_bo<rows>``, packed GB/s and microseconds), then
``int4_matvec_ring``: K6 itself at this shape, on the instance its routing
takes at one row (the weight ring, ``csrc/fused_decode.cu``), held to the
same plain version; then the int8 reference line (K6 on the [14336, 4096]
int8 weight, also on the ring).

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 -m slime_tpu_torch.probes.quant_matmul
"""
from __future__ import annotations

import json

import torch

from ..models.layers import fp32_accumulation
from . import cuda_ms
from ..ops import _cuda
from ..ops import quant_matmul as qm
from ..ops import weight_ring as wr

IN, OUT = 4096, 14336
VARIANTS = {"i32": 0, "magic": 1, "twodot": 2}
ROWS = (16, 64, 256)
RTOL, ATOL = 2 ** -7, 2e-3       # chip_smoke.py's tolerance for K6


def make_inputs(device, seed: int = 0, out: int = OUT):
    """x [1, IN] bf16 and a q4 weight dict {"q4": int8 [out, IN / 2], "scale":
    fp32 [out, 1]}, from a seeded generator on ``device``: packed bytes
    uniform over all 256 values, scale 0.01 (the JAX script's)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((1, IN), device=device, generator=g).to(torch.bfloat16)
    q4 = torch.randint(-128, 128, (out, IN // 2), dtype=torch.int8, device=device, generator=g)
    return x, {"q4": q4, "scale": torch.full((out, 1), 0.01, device=device)}


def permute_even_odd(x: torch.Tensor) -> torch.Tensor:
    """x [1, K] -> [x[:, 0::2] | x[:, 1::2]]: the twodot variant's input (the
    TPU kernel's column permutation of x)."""
    return torch.cat([x[:, 0::2], x[:, 1::2]], dim=1).contiguous()


def plain(x: torch.Tensor, qw) -> torch.Tensor:
    """P1's plain version: K6's (``quant_matmul_ref``)."""
    return qm.quant_matmul_ref(x, qw)


def matvec(x: torch.Tensor, qw, variant: str, rows: int) -> torch.Tensor:
    """One launch of the probe kernel: y [1, OUT] bf16 (x natural; the
    twodot variant permutes it first, as its caller would)."""
    _cuda.require_cuda(x, qw["q4"], qw["scale"])
    q4, s = qw["q4"], qw["scale"]
    if (x.shape != (1, IN) or x.dtype != torch.bfloat16 or q4.shape[1] != IN // 2
            or q4.dtype != torch.int8 or rows not in ROWS or variant not in VARIANTS):
        raise ValueError(f"P1 takes x [1, {IN}] bf16, q4 [N, {IN // 2}], rows in {ROWS}, "
                         f"variant in {list(VARIANTS)}")
    xin = permute_even_odd(x) if variant == "twodot" else x.contiguous()
    y = torch.empty((1, q4.shape[0]), dtype=torch.bfloat16, device=x.device)
    _cuda.check(_cuda.library().slime_p1_matvec(
        VARIANTS[variant], rows, xin.data_ptr(), q4.contiguous().data_ptr(),
        s.reshape(-1).contiguous().data_ptr(), y.data_ptr(), q4.shape[0], _cuda.stream()),
        "p1_matvec")
    matvec.launches += 1
    return y


matvec.launches = 0


def run(device=None, *, runs: int = 25, seed: int = 0, log=print):
    """Check every (variant, rows) and K6's ring instance against the plain
    version, time them, and print one JSON line each plus the int8
    reference line; returns the records ({metric, variant, rows, us, gbps,
    max_abs_err}; K6's ring: variant "ring", rows 0) and the plain version's
    and K6's int8 times."""
    if not torch.cuda.is_available():
        raise RuntimeError("the P1 probe runs on a CUDA card")
    dev = torch.device(device) if device is not None else torch.device("cuda")
    x, qw = make_inputs(dev, seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB > L2
    packed = qw["q4"].numel()
    records = []
    with fp32_accumulation():
        want = plain(x, qw).float()
        for variant in VARIANTS:
            for rows in ROWS:
                got = matvec(x, qw, variant, rows).float()
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                           msg=lambda m: f"P1 {variant} rows {rows}: {m}")
                ms = cuda_ms(lambda: matvec(x, qw, variant, rows), runs, flush)
                rec = {"metric": f"int4_matvec_{variant}_bo{rows}", "variant": variant,
                       "rows": rows, "us": ms * 1e3, "gbps": packed / ms / 1e6,
                       "max_abs_err": (got - want).abs().max().item()}
                records.append(rec)
                log(json.dumps({"metric": rec["metric"], "value": rec["gbps"],
                                "unit": f"GB/s effective ({rec['us']:.2f} us; packed bytes; "
                                        f"H100 HBM 3350)", "vs_baseline": None}))
        if qm.k6_route(1, IN, x.dtype, qm._Q4, OUT, wr.sm_count(x.device)) != "ring":
            raise AssertionError("K6 at P1's shape does not take the weight ring")
        got = qm.quant_matmul(x, qw).float()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"P1 ring (K6): {m}")
        ms = cuda_ms(lambda: qm.quant_matmul(x, qw), runs, flush)
        rec = {"metric": "int4_matvec_ring", "variant": "ring", "rows": 0, "us": ms * 1e3,
               "gbps": packed / ms / 1e6, "max_abs_err": (got - want).abs().max().item()}
        records.append(rec)
        log(json.dumps({"metric": rec["metric"], "value": rec["gbps"],
                        "unit": f"GB/s effective ({rec['us']:.2f} us; packed bytes; "
                                f"H100 HBM 3350; K6's weight ring)", "vs_baseline": None}))
        plain_ms = cuda_ms(lambda: plain(x, qw), runs, flush)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        q8 = {"q": torch.randint(-128, 128, (OUT, IN), dtype=torch.int8, device=dev,
                                 generator=g),
              "scale": qw["scale"]}
        int8_ms = cuda_ms(lambda: qm.quant_matmul(x, q8), runs, flush)
    log(json.dumps({"metric": "int8_matvec_reference", "value": OUT * IN / int8_ms / 1e6,
                    "unit": f"GB/s effective ({int8_ms * 1e3:.2f} us; K6's int8 instance)",
                    "vs_baseline": None}))
    return records, plain_ms, int8_ms


if __name__ == "__main__":
    run()
