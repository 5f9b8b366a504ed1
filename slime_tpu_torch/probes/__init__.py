"""Design probes of the TPU package, as hand-written kernels on the card:
P1 (``quant_matmul``), P2 (``encoder_attention``) and P4 (``q4g_unpack``)."""
from __future__ import annotations

import statistics

import torch


def cuda_ms(fn, runs: int, flush=None) -> float:
    """Median milliseconds of fn() over ``runs`` CUDA-event timings after
    warm-up; ``flush`` (zeroed outside the timed region) evicts L2 between
    runs."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
