"""P2: the design probe of K4 (encoder attention) on the card.

Counterpart of the TPU probe ``f`` in ``scripts/bench_vit_attn{2..6}.py``,
which swept K4's Pallas design. Here each compiled variant of the Hopper
kernel (``ops.encoder_attention.VARIANTS``: query rows a block, keys a tile,
stages of the TMA ring) is held to ``encoder_attention_ref`` at CLIP-L's
shape, [8 crops, 577, 16 heads, 64] bf16, and timed as ``chip_smoke.py``
phase 1 times kernels: the median of CUDA-event timings with L2 flushed
between runs. Variant 0 is the production design.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 -m slime_tpu_torch.probes.encoder_attention
"""
from __future__ import annotations

import torch

from ..models.layers import fp32_accumulation
from . import cuda_ms
from ..ops import encoder_attention as ea

SHAPE = (8, 577, 16, 64)
RTOL, ATOL = 2 ** -7, 2e-3       # chip_smoke.py's tolerance for K4


def run(device=None, *, runs: int = 25, seed: int = 0, log=print):
    """Check every variant at ``SHAPE``, then time them in the order 0 1 2 3
    3 2 1 0 (the spread of one call shows beside the differences); log one
    line each and return their records ({variant, design, ms: [first,
    second], max_abs_err, floor_needed}). Raises if a variant disagrees with
    the plain version."""
    if not torch.cuda.is_available():
        raise RuntimeError("the P2 probe runs K4's variants on a CUDA card")
    dev = torch.device(device) if device is not None else torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(SHAPE, device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3))
    scale = SHAPE[-1] ** -0.5
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB > L2
    records = {}
    with fp32_accumulation():
        want = ea.encoder_attention_ref(q, k, v, scale=scale).float()
        for variant, design in ea.VARIANTS.items():
            got = ea.encoder_attention_kernel(q, k, v, scale=scale, variant=variant).float()
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"P2 variant {variant}: {m}")
            records[variant] = {
                "variant": variant, "design": design, "ms": [],
                "max_abs_err": (got - want).abs().max().item(),
                "floor_needed": ((got - want).abs() - RTOL * want.abs()).max().item()}
        order = list(ea.VARIANTS)
        for variant in order + order[::-1]:
            records[variant]["ms"].append(cuda_ms(
                lambda: ea.encoder_attention_kernel(q, k, v, scale=scale, variant=variant),
                runs, flush))
    for r in records.values():
        log(f"P2 encoder_attention variant {r['variant']} ({r['design']}) {list(SHAPE)} "
            f"bf16: kernel {r['ms'][0]:.4f}, {r['ms'][1]:.4f} ms; max_abs_err "
            f"{r['max_abs_err']:.3g}, floor needed {r['floor_needed']:.3g} (set {ATOL:g})")
    return list(records.values())


if __name__ == "__main__":
    run()
