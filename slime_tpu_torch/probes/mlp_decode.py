"""K1 (``fused_mlp_decode``) at SliME-8B's width, on the card.

For int8, q4g and dense bf16 weights in bf16 at B = 1 and 8 (dense also at
4, the eval path's batch; layer 1 of a 2-layer stack at H = 4096, I =
14336), this prints one JSON line each with:

- ``ms``: the whole call's device time (the median of CUDA-event timings
  with L2 flushed and the launches queued behind a device sleep, so the
  events time the device and not the host's enqueue), and ``ms_clean_flush``
  the same with the L2 flushed by reads (no dirty lines to write back);
- ``host_us``: the host microseconds a call costs, issued back to back;
- ``launches``: from one ``torch.profiler`` trace of ``PROFILED`` calls (L2
  flushed before each), every kernel of the call by name with its mean
  device ms, and ``span_ms``, the mean time from a call's first kernel
  start to its last kernel end (kernels that overlap count once);
- ``max_abs_err`` against the plain version and the one-ulp bound of the
  bf16 intermediate that the smoke holds it to;
- ``bound_ms``: the weights, x and y bytes over 3.35 TB/s (H100 SXM).
- on a tree with the weight ring (``weight_ring.PDL``), ``ms_unchained`` and
  its launches: the same kernels launched without programmatic dependent
  launch.

Then one line with the I2F instructions in the built library's SASS
(``cuobjdump -sass``), by kernel function of ``csrc/fused_decode.cu``, and
how many of them are the integer divisions' I2F.U32.RP.

It imports the port by absolute name, so the same file measures another
checkout's K1 put first on the path, for a before/after in one call:

    python3 -m slime_tpu_torch.probes.mlp_decode [int8] [q4g] [dense]
    cd <other checkout> && PYTHONPATH=. python3 <this checkout>/slime_tpu_torch/probes/mlp_decode.py
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from slime_tpu_torch.ops import _cuda, fused_mlp
from slime_tpu_torch.ops import quantization as quant

H, I = 4096, 14336
HBM_BPS = 3.35e12
SLEEP_CYCLES = 2_000_000          # ~1 ms at the H100's clock: longer than a wrapper's enqueue
PROFILED = 10
# kernels of csrc/fused_decode.cu that one fused_mlp_decode call launches
# (the weight ring's kernel was mlp_ring_kernel before K2 and K3 shared it;
# the tensor-core instance's reduction was splitk_reduce_kernel before K2
# and K3 shared it as split_reduce_kernel)
K1_KERNELS = ("rms_norm", "gate_up", "resid", "mlp_ring", "weight_ring", "qmm_wgmma",
              "splitk_reduce", "split_reduce")


def pdl_owner():
    """The module whose ``PDL`` flag the ring's launches read
    (``ops/weight_ring.py``; ``fused_mlp`` on a tree from before it), or
    None on a tree without the ring."""
    try:
        from slime_tpu_torch.ops import weight_ring
        return weight_ring
    except ImportError:
        return fused_mlp if hasattr(fused_mlp, "PDL") else None


def device_ms(fn, runs: int, flush, clean: bool = False) -> float:
    """Median ms of fn() on the device: L2 flushed, then a device sleep that
    the host's enqueue of fn() hides behind, then the timed events. The
    flush writes 256 MB (as ``chip_smoke.py``'s), so fn() also pays the
    write-back of the dirty lines it evicts; ``clean`` flushes by reading
    them instead."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        if clean:
            flush.sum()
        else:
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


def layers(fmt: str, g, dev):
    """Stacked post-attention norm and MLP weights, 2 layers: int8 per-row
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
    return {"post_attention_layernorm": {"weight": 1 + 0.1 * torch.randn(
                (2, H), device=dev, generator=g)},
            "gate_proj": proj(I, H), "up_proj": proj(I, H), "down_proj": proj(H, I)}


def traced_kernels(fn, flush):
    """[(start us, end us, name)] of the K1 kernels in one profiler trace of
    PROFILED calls (L2 flushed before each)."""
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
                   and any(k in e["name"] for k in K1_KERNELS)), key=lambda k: k[0])


def profile_split(fn, flush, tries: int = 3):
    """({kernel name: mean device ms}, mean span ms) over PROFILED calls, from
    the profiler's chrome trace; a trace that recorded fewer than PROFILED
    kernels (a process's first session can come back empty) is taken again,
    up to ``tries`` times, then reported empty: ({}, None)."""
    for _ in range(tries):
        kernels = traced_kernels(fn, flush)
        if len(kernels) >= PROFILED:
            break
    else:
        return {}, None
    by_name = {}
    for t0, t1, name in kernels:
        by_name.setdefault(name, []).append((t1 - t0) / 1e3)
    split = {n: sum(v) / len(v) for n, v in by_name.items()}
    per_call = len(kernels) // PROFILED
    spans = [max(k[1] for k in kernels[i:i + per_call]) - kernels[i][0]
             for i in range(0, per_call * PROFILED, per_call)] if per_call else []
    return split, (sum(spans) / len(spans) / 1e3 if spans else None)


def i2f_counts() -> dict:
    """{kernel function: [I2F instructions, those of them that are
    I2F.U32.RP]} over the SASS of the built library's fused_decode kernels
    (None if cuobjdump is missing). I2F.U32.RP is the reciprocal step of an
    integer division by a value known only at run time (an index, not a
    weight)."""
    lib = _cuda.library()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            fn = fn if any(k in fn for k in K1_KERNELS) else None
            if fn:
                counts[fn] = [0, 0]
        elif fn and "I2F" in line:
            counts[fn][0] += 1
            counts[fn][1] += "I2F.U32.RP" in line
    return counts


def weight_tensors(p):
    """A projection's weight tensors: the dense weight, or the quantized
    values and their scales."""
    w = p["weight"]
    return list(w.values()) if isinstance(w, dict) else [w]


def run(runs: int = 25, seed: int = 0, log=print, formats=("int8", "q4g", "dense")):
    """Measure K1 at 8B width in ``formats``, B = 1 and 8 (dense also 4);
    returns the records."""
    if not torch.cuda.is_available():
        raise RuntimeError("K1 is measured on a CUDA card")
    from slime_tpu_torch.models.layers import fp32_accumulation

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB > L2
    records = []
    with fp32_accumulation():
        for fmt in formats:
            g = torch.Generator(device=dev).manual_seed(seed)
            two = layers(fmt, g, dev)
            wbytes = sum(t[1].numel() * t.element_size() for n in ("gate_proj", "up_proj",
                                                                    "down_proj")
                         for t in weight_tensors(two[n]))
            for B in ((1, 4, 8) if fmt == "dense" else (1, 8)):
                x = torch.randn((B, H), device=dev, generator=g).to(torch.bfloat16)
                fn = lambda: fused_mlp.fused_mlp_decode(x, two, 1)  # noqa: E731
                got, want = fn(), fused_mlp.fused_mlp_decode_ref(x, two, 1)
                ulp = fused_mlp.intermediate_ulp_bound(x, two, 1)
                err = (got.float() - want.float()).abs()
                excess = (err - 2 ** -7 * want.float().abs() - ulp).max().item()
                split, span = profile_split(fn, flush)
                rec = {"metric": f"k1_{fmt}_b{B}", "ms": device_ms(fn, runs, flush),
                       "ms_clean_flush": device_ms(fn, runs, flush, clean=True),
                       "host_us": host_us(fn), "launches": split, "span_ms": span,
                       "max_abs_err": err.max().item(), "excess_over_ulp_bound": excess,
                       "bound_ms": (wbytes + 2 * x.numel() * 2) / HBM_BPS * 1e3,
                       "card": torch.cuda.get_device_name(0)}
                owner = pdl_owner()
                if owner is not None:
                    # the same launches without programmatic dependent launch
                    owner.PDL = False
                    rec["ms_unchained"] = device_ms(fn, runs, flush)
                    rec["launches_unchained"], rec["span_ms_unchained"] = profile_split(fn,
                                                                                       flush)
                    owner.PDL = True
                records.append(rec)
                log(json.dumps(rec))
            del two
    rec = {"metric": "k1_sass_i2f", "counts": i2f_counts()}
    records.append(rec)
    log(json.dumps(rec))
    return records


if __name__ == "__main__":
    run(**({"formats": tuple(sys.argv[1:])} if sys.argv[1:] else {}))
