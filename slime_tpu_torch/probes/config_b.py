"""Config B (per-row q4, the non-fused decode) traced on the card.

Builds SliME-8B as ``--load-4bit --int4-scheme absmax --quantize-lm-head``
does, answers bench.py's query (one 672x672 image, a 64-token prompt, the
prefill padded to 2048 positions) and traces one TTFT and 8 decode steps,
all with ``chip_smoke.py``'s own phase-5b code (``quantized_model``,
``query``, ``profile_slice``, loaded from this checkout's root). Prints
``profile_slice``'s summary as one JSON line: for the TTFT and a decode
step, host and device ms, idle share, launches, and [device ms, launches]
of each kernel class it names (K6's instances among them). The port is
imported by absolute name only, so the same file traces another checkout's
port put first on the path (a parent/change comparison in one call):

    python3 -m slime_tpu_torch.probes.config_b
    cd <other checkout> && PYTHONPATH=. python3 <this checkout>/slime_tpu_torch/probes/config_b.py
"""
import dataclasses
import importlib.util
import json
import statistics
import time
from pathlib import Path

import torch


def smoke():
    """This checkout's ``chip_smoke.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(dev=None, log=print):
    """Build config B, trace one TTFT and 8 decode steps; returns the record
    it prints."""
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.config import SliMEConfig

    sm = smoke()
    dev = torch.device(dev) if dev is not None else torch.device("cuda")
    cfg = SliMEConfig.slime_8b()
    params = sm.quantized_model(dev, cfg, "absmax", quantize_vision=False)
    img, ids, attn, anyres = sm.query(dev, cfg)
    cfg = dataclasses.replace(cfg, eos_token_id=-1)

    def request(max_new):
        crops, mask = anyres(img)
        return gen.generate(params, cfg, ids, attn, crops[None], mask[None],
                            max_new_tokens=max_new, compute_dtype=torch.bfloat16)

    request(1).cpu()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        request(1).cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    rec = {"probe": "config_b", **sm.profile_slice("b", params, cfg, ids, attn, img, anyres,
                                                   request, statistics.median(walls))}
    log(json.dumps(rec))
    return rec


if __name__ == "__main__":
    run()
