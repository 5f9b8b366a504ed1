"""One-command readiness check for released SliME weights, on the port.

The port's ``scripts/verify_released_weights.py``: the same probe inputs
(built from the config alone with numpy, seeds 0 and 1), the same checks,
golden file and exit codes, with the port's loader and forward. A golden
recorded by the JAX script is checked here, which makes the check a
cross-implementation parity check:

    python -m slime_tpu_torch.tools.verify_released_weights /path/to/SliME-8B \\
        [--golden golden.npz] [--record] [--model-base DIR] [--vision-path DIR] \\
        [--device cuda]

In order (each prints PASS/FAIL; the exit code is 0 only if all pass):

  1. **load (mode: full)** — ``checkpoint.load_pretrained`` on the directory
     (sharded index or single file, mm_projector.bin / sampler.bin adapter
     pickup, LoRA merge when ``--model-base`` is given).
  2. **logit parity** — the probe batch (``probe_inputs``: text + image) runs
     through ``slime.forward`` at fp32; the last-position logits are compared
     to the golden at ``--tol`` (default 1e-3). ``--record`` writes the golden
     instead.
  3. **greedy generations** — 3 fixed prompts (one multimodal, two text-only),
     16 greedy tokens each, compared token-exactly to the golden.
  4. **quantized loads** — ``load_bits=8`` and ``load_bits=4`` (NF4) re-run
     the probe; last-position top-1 agreement with this run's full-precision
     logits must clear ``--top1-int8`` / ``--top1-int4``.

``--device`` (the port's own flag) picks where it runs: the current CUDA
device unless it says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

N_GEN_PROMPTS = 3
GEN_TOKENS = 16
PROBE_B, PROBE_S = 2, 24
GOLDEN_NAME = "slime_tpu_golden.npz"


def probe_inputs(cfg):
    """Deterministic probe batch from the config alone (seed 0): token ids in
    [5, vocab), an '<image>' sentinel at position 2 of row 0, unit-normal
    pixels for the full crop grid; the JAX script's arrays."""
    from ..constants import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(0)
    MC = 1 + cfg.max_local_crops
    t = cfg.vision.image_size
    ids = rng.integers(5, cfg.llm.vocab_size, (PROBE_B, PROBE_S)).astype(np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    pixels = rng.standard_normal((PROBE_B, MC, 3, t, t)).astype(np.float32)
    mask = np.ones((PROBE_B, PROBE_S), bool)
    crop_mask = np.ones((PROBE_B, MC), bool)
    return ids, mask, pixels, crop_mask


def gen_prompts(cfg):
    """3 fixed prompts: [0] multimodal, [1-2] text-only; ids from seed 1."""
    from ..constants import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(1)
    prompts = []
    for i in range(N_GEN_PROMPTS):
        ids = rng.integers(5, cfg.llm.vocab_size, (1, 9)).astype(np.int32)
        if i == 0:
            ids[0, 1] = IMAGE_TOKEN_INDEX
        prompts.append(ids)
    return prompts


def on(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


@torch.no_grad()
def last_logits(params, cfg, ids, mask, pixels, crop_mask, device):
    """The fused sequence's last-position logits [B, V] at fp32, as numpy."""
    from ..models import slime
    from ..models.layers import fp32_accumulation

    with fp32_accumulation():
        logits, _ = slime.forward(params, cfg, *on(device, ids, mask, pixels, crop_mask),
                                  compute_dtype=torch.float32)
    return logits[:, -1, :].float().cpu().numpy()


def run_generations(params, cfg, device):
    from .. import generate as gen_mod

    outs = []
    _, _, pixels, crop_mask = probe_inputs(cfg)
    pixels, crop_mask = on(device, pixels[:1], crop_mask[:1])
    for i, ids in enumerate(gen_prompts(cfg)):
        ids_t, = on(device, ids)
        toks = gen_mod.generate(
            params, cfg, ids_t, torch.ones(ids_t.shape, dtype=torch.bool, device=device),
            pixels if i == 0 else None, crop_mask if i == 0 else None,
            max_new_tokens=GEN_TOKENS, temperature=0.0, eos_id=-1)
        outs.append(toks[0].cpu().numpy().astype(np.int32))
    return outs


def on_device(raw, device):
    """A loaded tree -> tensors on ``device`` in their stored dtypes, the LLM
    layers stacked (what ``generate`` takes)."""
    from .. import checkpoint as ckpt
    from ..models import llama

    params = ckpt.to_torch(raw, device=device)
    params["llm"]["layers"] = llama.stack_layers(params["llm"]["layers"])
    return params


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model_path")
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--vision-path", default=None)
    ap.add_argument("--golden", default=None,
                    help=f"golden .npz (default: <model_path>/{GOLDEN_NAME})")
    ap.add_argument("--record", action="store_true",
                    help="write the golden from this run instead of checking")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--top1-int8", type=float, default=0.95)
    ap.add_argument("--top1-int4", type=float, default=0.85)
    ap.add_argument("--skip-quant", action="store_true",
                    help="skip the 8/4-bit load checks (e.g. tiny test models)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    from .. import checkpoint as ckpt
    from ..config import SliMEConfig
    from ..models.layers import resolve_device
    from ..params import named_leaves

    device = resolve_device(args.device)
    golden_path = args.golden or os.path.join(args.model_path, GOLDEN_NAME)
    cfg = SliMEConfig.load(args.model_path)
    results = {}

    def report(name, ok, detail=""):
        results[name] = bool(ok)
        print(f"[{'PASS' if ok else 'FAIL'}] {name}" + (f" — {detail}" if detail else ""),
              flush=True)

    # 1. full-precision load ------------------------------------------------
    try:
        raw = ckpt.load_pretrained(args.model_path, model_base=args.model_base,
                                   cfg=cfg, vision_path=args.vision_path)
        params = on_device(raw, device)
        del raw
        n = sum(t.numel() for _, t in named_leaves(params))
        report("load_full", True, f"{n/1e9:.2f}B params")
    except Exception as e:  # noqa: BLE001 — report, don't crash the harness
        report("load_full", False, repr(e))
        print(json.dumps({"verify_released_weights": results, "ok": False}))
        return 1

    ids, mask, pixels, crop_mask = probe_inputs(cfg)
    full = last_logits(params, cfg, ids, mask, pixels, crop_mask, device)
    gens = run_generations(params, cfg, device)
    del params

    # 2+3. golden record / compare -------------------------------------------
    if args.record:
        arrays = {"last_logits": full}
        for i, g in enumerate(gens):
            arrays[f"gen_tokens_{i}"] = g
        np.savez(golden_path, **arrays)
        report("golden_recorded", True, golden_path)
    elif os.path.exists(golden_path):
        g = np.load(golden_path)
        delta = float(np.max(np.abs(full - g["last_logits"])))
        report("logit_parity", delta <= args.tol,
               f"max|Δ|={delta:.2e} tol={args.tol:g}")
        for i, gen in enumerate(gens):
            want = g[f"gen_tokens_{i}"]
            ok = gen.shape == want.shape and bool(np.all(gen == want))
            report(f"greedy_generation_{i}", ok,
                   "token-exact" if ok else f"got {gen.tolist()[:8]}… want {want.tolist()[:8]}…")
    else:
        report("golden_present", False,
               f"{golden_path} missing — run with --record first (here or "
               "with the JAX package's scripts/verify_released_weights.py)")

    # 4. quantized loads ------------------------------------------------------
    if not args.skip_quant:
        for bits, thresh in ((8, args.top1_int8), (4, args.top1_int4)):
            try:
                qraw = ckpt.load_pretrained(args.model_path,
                                            model_base=args.model_base,
                                            cfg=cfg, vision_path=args.vision_path,
                                            load_bits=bits)
                qfull = last_logits(on_device(qraw, device), cfg, ids, mask,
                                    pixels, crop_mask, device)
                top1 = float(np.mean(np.argmax(qfull, -1) == np.argmax(full, -1)))
                report(f"load_int{bits}", top1 >= thresh,
                       f"last-pos top-1 agreement {top1:.3f} (>= {thresh:g})")
            except Exception as e:  # noqa: BLE001
                report(f"load_int{bits}", False, repr(e))

    ok = all(results.values())
    print(json.dumps({"verify_released_weights": results, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
