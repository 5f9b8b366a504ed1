"""K2 (``fused_qkv_decode``) and K3 (``fused_o_residual``) at SliME-8B's
width, on the card.

For int8, q4g and dense bf16 weights in bf16 at B = 1 and 8 (dense also at
4, the eval path's batch; layer 1 of a 2-layer stack at H = NQ = 4096, NKV =
1024), this prints one JSON line per kernel and case with:

- ``ms``: the call's device time (the median of CUDA-event timings with L2
  flushed and the launches queued behind a device sleep, so the events time
  the device and not the host's enqueue), and ``ms_clean_flush`` the same
  with the L2 flushed by reads (no dirty lines to write back);
- ``host_us``: the host microseconds a call costs, issued back to back;
- ``launches``: from one ``torch.profiler`` trace of ``PROFILED`` calls (L2
  flushed before each), every kernel of the call by name with its mean
  device ms; ``starts_ms``, each kernel's mean start after the call's first
  kernel started (the row-per-warp K2: its row norm, then ``qkv_kernel``;
  on the ring K2 and K3 are one launch each); ``span_ms``, the mean time
  from a call's first kernel start to its last kernel end;
- ``max_abs_err`` against the plain version;
- ``bound_ms``: the bytes the call must move (weights and their scales, the
  norm's weight, x, attn and the outputs) over 3.35 TB/s (H100 SXM).
- on a tree whose K2 and K3 take the weight ring, ``ms_unchained`` and its
  launches: the same kernels launched without programmatic dependent
  launch.

It imports the port by absolute name, so the same file measures another
checkout's K2 and K3 put first on the path, for a before/after in one call:

    python3 -m slime_tpu_torch.probes.qkvo_decode [int8] [q4g] [dense]
    cd <other checkout> && PYTHONPATH=. python3 <this checkout>/slime_tpu_torch/probes/qkvo_decode.py
"""
import json
import os
import sys
import tempfile

import torch

from slime_tpu_torch.ops import fused_qkvo
from slime_tpu_torch.ops import quantization as quant
from slime_tpu_torch.probes.mlp_decode import device_ms, host_us

H, NQ, NKV = 4096, 4096, 1024
HBM_BPS = 3.35e12
PROFILED = 10
# kernels of csrc/fused_decode.cu that a K2 or K3 call launches
KERNELS = ("rms_norm", "qkv_kernel", "resid_kernel", "weight_ring")


def layers(fmt: str, g, dev):
    """Stacked input norm and attention projections, 2 layers: int8 per-row
    (scales 0.02 / 127, as bench.py), q4g (N(0, 0.02) weights quantized) or
    dense bf16 (N(0, 0.02))."""
    def proj(out_d, in_d):
        if fmt == "dense":
            return {"weight": (torch.randn((2, out_d, in_d), device=dev, generator=g)
                               * 0.02).to(torch.bfloat16)}
        if fmt == "q4g":
            w = torch.randn((2, out_d, in_d), device=dev, generator=g) * 0.02
            return {"weight": quant.quantize_weight_q4g(w)}
        q = torch.randint(-127, 128, (2, out_d, in_d), dtype=torch.int8, device=dev,
                          generator=g)
        return {"weight": {"q": q, "scale": torch.full((2, out_d, 1), 0.02 / 127.0,
                                                        device=dev)}}
    return {"input_layernorm": {"weight": 1 + 0.1 * torch.randn((2, H), device=dev,
                                                                 generator=g)},
            "q_proj": proj(NQ, H), "k_proj": proj(NKV, H), "v_proj": proj(NKV, H),
            "o_proj": proj(H, NQ)}


def traced_kernels(fn, flush):
    """[(start us, end us, name)] of the K2 / K3 kernels in one profiler
    trace of PROFILED calls (L2 flushed before each)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"
                   and any(k in e["name"] for k in KERNELS)), key=lambda k: k[0])


def profile_split(fn, flush, tries: int = 3):
    """({kernel: mean device ms}, {kernel: mean start ms after the call's
    first kernel}, mean span ms) over PROFILED calls, from the profiler's
    chrome trace; a trace that recorded fewer than PROFILED kernels is
    taken again, up to ``tries`` times, then reported empty."""
    for _ in range(tries):
        kernels = traced_kernels(fn, flush)
        if len(kernels) >= PROFILED:
            break
    else:
        return {}, {}, None
    short = lambda n: n.replace("void (anonymous namespace)::", "").split("(")[0]  # noqa: E731
    per_call = len(kernels) // PROFILED
    dur, start, spans = {}, {}, []
    for i in range(0, per_call * PROFILED, per_call):
        call = kernels[i:i + per_call]
        spans.append((max(k[1] for k in call) - call[0][0]) / 1e3)
        for t0, t1, name in call:
            dur.setdefault(short(name), []).append((t1 - t0) / 1e3)
            start.setdefault(short(name), []).append((t0 - call[0][0]) / 1e3)
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    return ({n: mean(v) for n, v in dur.items()}, {n: mean(v) for n, v in start.items()},
            mean(spans) if spans else None)


def pdl_owner():
    """The module whose ``PDL`` flag K2's and K3's ring launches read, or
    None on a tree where they do not take the ring."""
    try:
        from slime_tpu_torch.ops import weight_ring
    except ImportError:
        return None
    return weight_ring


def run(runs: int = 25, seed: int = 0, log=print, formats=("int8", "q4g", "dense")):
    """Measure K2 and K3 at 8B width in ``formats``, B = 1 and 8 (dense also
    4); returns the records."""
    if not torch.cuda.is_available():
        raise RuntimeError("K2 and K3 are measured on a CUDA card")
    from slime_tpu_torch.models.layers import fp32_accumulation

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB > L2
    records = []
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    with fp32_accumulation():
        for fmt in formats:
            g = torch.Generator(device=dev).manual_seed(seed)
            two = layers(fmt, g, dev)
            wb = {n: nbytes(*[t[1] for t in (two[n]["weight"].values() if fmt != "dense"
                                              else [two[n]["weight"]])])
                  for n in ("q_proj", "k_proj", "v_proj", "o_proj")}
            for B in ((1, 4, 8) if fmt == "dense" else (1, 8)):
                x = torch.randn((B, H), device=dev, generator=g).to(torch.bfloat16)
                attn = torch.randn((B, NQ), device=dev, generator=g).to(torch.bfloat16)
                cases = {
                    "k2": (lambda: fused_qkvo.fused_qkv_decode(x, two, 1),
                           lambda: fused_qkvo.fused_qkv_decode_ref(x, two, 1),
                           wb["q_proj"] + wb["k_proj"] + wb["v_proj"] + H * 4
                           + nbytes(x) + B * (NQ + 2 * NKV) * 2),
                    "k3": (lambda: fused_qkvo.fused_o_residual(attn, x, two, 1),
                           lambda: fused_qkvo.fused_o_residual_ref(attn, x, two, 1),
                           wb["o_proj"] + nbytes(attn, x) + B * H * 2),
                }
                for kname, (fn, ref, moved) in cases.items():
                    got, want = fn(), ref()
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    err = max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(got, want))
                    split, starts, span = profile_split(fn, flush)
                    rec = {"metric": f"{kname}_{fmt}_b{B}", "ms": device_ms(fn, runs, flush),
                           "ms_clean_flush": device_ms(fn, runs, flush, clean=True),
                           "host_us": host_us(fn), "launches": split, "starts_ms": starts,
                           "span_ms": span, "max_abs_err": err,
                           "bound_ms": moved / HBM_BPS * 1e3,
                           "card": torch.cuda.get_device_name(0)}
                    owner = pdl_owner()
                    if owner is not None:
                        # the same launches without programmatic dependent launch
                        owner.PDL = False
                        rec["ms_unchained"] = device_ms(fn, runs, flush)
                        (rec["launches_unchained"], rec["starts_ms_unchained"],
                         rec["span_ms_unchained"]) = profile_split(fn, flush)
                        owner.PDL = True
                    records.append(rec)
                    log(json.dumps(rec))
            del two
    return records


if __name__ == "__main__":
    run(**({"formats": tuple(sys.argv[1:])} if sys.argv[1:] else {}))
