"""K8 (``w8a8_matmul``) at the W8A8 CLIP-L tower's four linears, on the card.

One 8-crop encode runs 23 layers of four int8 linears at M = 8 x 577 = 4616
tokens: the packed qkv [3072, 1024], out_proj [1024, 1024], fc1 [4096,
1024] and fc2 [1024, 4096] (92 launches). For each shape (``SHAPES``), in
bf16 and, at the qkv shape, fp32, this prints one JSON line with K8's time
on the device (the median of CUDA-event timings with L2 flushed and the
launches queued behind a device sleep, so the events time the device and
not the host's enqueue), its host dispatch cost and its bound (x, W and y
bytes over 3.35 TB/s against the products over 1979 TOP/s int8, H100 SXM).

It imports only ``slime_tpu_torch.ops.w8a8_matmul`` and ``.quantization``,
by absolute name, so the same file times the K8 of another checkout of the
port (any that has ``ops/w8a8_matmul.py``) put first on the path, for a
before/after in one call:

    python3 -m slime_tpu_torch.probes.w8a8_shapes
    cd <other checkout> && PYTHONPATH=. python3 <this checkout>/slime_tpu_torch/probes/w8a8_shapes.py
"""
import json
import statistics
import time

import torch

from slime_tpu_torch.ops import quantization as quant
from slime_tpu_torch.ops import w8a8_matmul as w8

TOKENS = 8 * 577
SHAPES = {"qkv": (3072, 1024), "out_proj": (1024, 1024), "fc1": (4096, 1024),
          "fc2": (1024, 4096)}
HBM_BPS, INT8_OPS = 3.35e12, 1979e12
SLEEP_CYCLES = 2_000_000          # ~1 ms at the H100's clock: longer than a wrapper's enqueue


def device_ms(fn, runs: int, flush) -> float:
    """Median ms of fn() on the device: L2 flushed, then a device sleep that
    the host's enqueue of fn() hides behind, then the timed events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds a call, issued back to back without a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bound_ms(M: int, N: int, K: int, x_bytes: int) -> tuple:
    moved = M * K * x_bytes + N * K + 4 * N + 4 * N + M * N * x_bytes
    t_bytes, t_ops = moved / HBM_BPS, 2 * M * N * K / INT8_OPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def run(runs: int = 25, seed: int = 0, log=print):
    """Time K8 at every shape (bf16, and fp32 at qkv); returns the records."""
    if not torch.cuda.is_available():
        raise RuntimeError("K8's shapes are timed on a CUDA card")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB > L2
    records = []
    cases = [(n, torch.bfloat16) for n in SHAPES] + [("qkv", torch.float32)]
    for name, dtype in cases:
        N, K = SHAPES[name]
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((TOKENS, K), device=dev, generator=g).to(dtype)
        qw = quant.quantize_weight(torch.randn((N, K), device=dev, generator=g) * 0.02, 8)
        bias = torch.randn((N,), device=dev, generator=g) * 0.02
        fn = lambda: w8.w8a8_matmul(x, qw, bias)  # noqa: E731
        ms = device_ms(fn, runs, flush)
        b_ms, b_by = bound_ms(TOKENS, N, K, x.element_size())
        rec = {"metric": f"w8a8_{name}_{'fp32' if dtype == torch.float32 else 'bf16'}",
               "x": [TOKENS, K], "w": [N, K], "ms": ms, "host_us": host_us(fn),
               "bound_ms": b_ms, "bound_by": b_by, "card": torch.cuda.get_device_name(0)}
        records.append(rec)
        log(json.dumps(rec))
    return records


if __name__ == "__main__":
    run()
