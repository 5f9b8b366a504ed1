"""Design probes of the TPU package, as hand-written kernels on the card:
P1 (``quant_matmul``), P2 (``encoder_attention``), P3 (``int8_dot``) and P4
(``q4g_unpack``); K8 at the CLIP-L tower's shapes (``w8a8_shapes``), K1 at
SliME-8B's width (``mlp_decode``), K2 and K3 (``qkvo_decode``), K4 in fp32
at CLIP-L's shape (``encoder_attention_f32``), and config B's TTFT and
decode step traced, K6's share in them (``config_b``)."""
from __future__ import annotations

import statistics

import torch

SLEEP_CYCLES = 2_000_000    # a device sleep longer than a wrapper's enqueue


def cuda_ms(fn, runs: int, flush=None) -> float:
    """Median milliseconds of fn() over ``runs`` CUDA-event timings after
    warm-up; ``flush`` (zeroed outside the timed region) evicts L2 between
    runs. fn()'s launches are queued behind a device sleep (~1 ms), so the
    events time the device and not the host's enqueue."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
