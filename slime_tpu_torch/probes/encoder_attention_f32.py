"""K4's fp32 instance (``encoder_attention`` on fp32 q/k/v) at CLIP-L's shape, on the card.

The tower's default compute dtype is fp32, so every encode of the entry
points runs K4 in fp32 23 times at [8 crops, 577, 16 heads, 64]. This holds
the kernel to ``encoder_attention_ref`` there (RTOL 2^-7, ATOL 1e-4:
``chip_smoke.py``'s tolerance for K4 in fp32), on contiguous q/k/v and on
views of one packed qkv projection, then times it as ``chip_smoke.py``
phase 1 times kernels (the median of CUDA-event timings, L2 flushed, the
launches queued behind a device sleep, so the events time the device),
twice, beside ``scaled_dot_product_attention`` in fp32 (TF32 off), a
yardstick, and the bound (the two products over 67 TFLOP/s fp32, H100
SXM). It prints one JSON line a record, each with the card's name and
power limit and the path of the port it imported.

It imports the port by absolute name, so the same file times the K4 of
another checkout (any with ``ops/encoder_attention.py``) put first on the
path, for a before/after in one call:

    python3 -m slime_tpu_torch.probes.encoder_attention_f32
    cd <other checkout> && PYTHONPATH=. python3 <this checkout>/slime_tpu_torch/probes/encoder_attention_f32.py
"""
import json
import subprocess

import torch
import torch.nn.functional as F

from slime_tpu_torch.models.layers import fp32_accumulation
from slime_tpu_torch.ops import encoder_attention as ea
from slime_tpu_torch.probes import cuda_ms

SHAPE = (8, 577, 16, 64)
RTOL, ATOL = 2 ** -7, 1e-4
F32_OPS = 67e12
RUNS = 25


def card() -> str:
    """``name, power limit`` as nvidia-smi gives them (or why not)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi failed: {e}"


def run(seed: int = 0):
    """Check, then time; returns the records it printed."""
    if not torch.cuda.is_available():
        raise RuntimeError("this probe times K4 on a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(SHAPE, device=dev, generator=g) for _ in range(3))
    B, S, H, D = SHAPE
    qkv = torch.randn((B, S, 3 * H * D), device=dev, generator=g)
    packed = [t.reshape(SHAPE) for t in qkv.split(H * D, dim=-1)]
    scale = D ** -0.5
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB > L2
    common = {"card": card(), "port": ea.__file__, "shape": list(SHAPE), "dtype": "fp32"}
    records = []
    with fp32_accumulation():
        for name, (a, b_, c) in (("contiguous", (q, k, v)), ("packed qkv", packed)):
            got = ea.encoder_attention_kernel(a, b_, c, scale=scale)
            want = ea.encoder_attention_ref(a, b_, c, scale=scale)
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"K4 fp32 {name}: {m}")
            records.append({**common, "what": f"check {name}",
                            "max_abs_err": (got - want).abs().max().item()})
        kern = [cuda_ms(lambda: ea.encoder_attention_kernel(q, k, v, scale=scale), RUNS, flush)
                for _ in range(2)]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), RUNS,
                       flush)
    bound = 2 * 2 * B * H * S * S * D / F32_OPS * 1e3
    records.append({**common, "what": "kernel", "ms": kern, "bound_ms": bound,
                    "bound_by": "operations", "sdpa_fp32_ms": sdpa})
    for rec in records:
        print(json.dumps(rec))
    return records


if __name__ == "__main__":
    run()
