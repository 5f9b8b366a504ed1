"""The host side of a dense bf16 decode step on the card, ring against row per warp.

Builds SliME-8B's LLM at full width (bf16, dense, stacked; ``layers`` of its
32 layers, default 8 as the smoke's evaluation phase cuts it) from a seed,
prefills 4 right-padded text prompts (117, 160, 200 and 246 valid tokens of
256) and times single greedy decode steps (``generate._decode_loop`` with
one new token) under two routes of the same process, in turns:

- ``rule``: the routing rule as it stands (dense K1, K2 and K3 on the
  weight ring at B = 4);
- ``row``: dense K1, K2 and K3 forced onto the row-per-warp kernels (the
  routing functions answer None for dense weights), as before the ring took
  them.

For each route it prints one JSON line with the medians over ``rounds``
samples (each the median of 8 steps) of:

- ``enqueue_ms``: host time from the step's start to the return of the
  decode loop, before the closing synchronize (the loop's own
  ``done.all()`` check syncs once, before the step's launches);
- ``step_ms``: the same plus the closing synchronize, which is how the
  smoke's evaluation phase times a decode step;
- ``wrapper_us``: host microseconds a call of each decode wrapper (layer 1,
  x [4, 4096]) costs, issued 50 times back to back.

Then, for each route, a ``cProfile`` of 16 steps: host microseconds a step
in the decode wrappers, their launch functions and the CUDA library calls
(``_cuda.check``), and the ten functions with the most own time.

    python3 -m slime_tpu_torch.probes.dense_decode_host [layers] [rounds]
"""
import contextlib
import cProfile
import dataclasses
import json
import pstats
import statistics
import subprocess
import sys
import time

import torch

from slime_tpu_torch import generate as gen
from slime_tpu_torch.config import SliMEConfig
from slime_tpu_torch.models import llama
from slime_tpu_torch.ops import fused_mlp, fused_qkvo
from slime_tpu_torch.ops.weight_ring import DENSE

B, S = 4, 256
LENGTHS = (117, 160, 200, 246)
STEPS_A_SAMPLE = 8
PROFILED_STEPS = 16
# functions whose host time a step the profile reports, by name
PROFILED_FUNCS = ("decode_step", "fused_qkv_decode", "qkv_launch", "fused_o_residual",
                  "fused_mlp_decode", "mlp_launch", "check", "synchronize")


@contextlib.contextmanager
def route(name: str):
    """Run the body under route ``name``: "rule", or "row" (dense K1, K2 and
    K3 row per warp)."""
    rules = (fused_mlp.ring_route, fused_qkvo.qkv_ring_route, fused_qkvo.o_ring_route)
    if name == "row":
        def dense_none(rule):
            return lambda B, dtype, fmt, *a: None if fmt == DENSE else rule(B, dtype, fmt, *a)
        fused_mlp.ring_route, fused_qkvo.qkv_ring_route, fused_qkvo.o_ring_route = map(
            dense_none, rules)
    try:
        yield
    finally:
        fused_mlp.ring_route, fused_qkvo.qkv_ring_route, fused_qkvo.o_ring_route = rules


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def wrapper_us(fn, calls: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def sample(step):
    """(enqueue ms, step ms): medians over STEPS_A_SAMPLE steps."""
    enq, wall = [], []
    for _ in range(STEPS_A_SAMPLE):
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enq.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return statistics.median(enq), statistics.median(wall)


def host_profile(step):
    """Host us a step in PROFILED_FUNCS (cumulative, summed over every
    function of that name) and the ten functions with the most own time."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(PROFILED_STEPS):
        step()
        torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    per = {n: 0.0 for n in PROFILED_FUNCS}
    calls = {n: 0 for n in PROFILED_FUNCS}
    for (_, _, name), (_, nc, _, ct, _) in stats.items():
        if name in per:
            per[name] += ct
            calls[name] += nc
    own = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    return {"cum_us_a_step": {n: per[n] / PROFILED_STEPS * 1e6 for n in PROFILED_FUNCS},
            "calls_a_step": {n: calls[n] / PROFILED_STEPS for n in PROFILED_FUNCS},
            "top_own_us_a_step": [[f"{f.rsplit('/', 1)[-1]}:{ln} {name}",
                                   v[2] / PROFILED_STEPS * 1e6] for (f, ln, name), v in own]}


def run(layers: int = 8, rounds: int = 10, seed: int = 0, log=print):
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    cfg = SliMEConfig.slime_8b()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=layers))
    g = torch.Generator(device=dev).manual_seed(seed)
    llm = llama.init(cfg.llm, generator=g, device=dev, dtype=bf)
    llm["layers"] = llama.stack_layers(llm["layers"])
    ids = torch.randint(3, cfg.llm.vocab_size, (B, S), device=dev, generator=g)
    attn = torch.zeros((B, S), dtype=torch.bool, device=dev)
    for b, n in enumerate(LENGTHS):
        attn[b, :n] = True
    room = 2 * rounds * STEPS_A_SAMPLE + 2 * PROFILED_STEPS + 64
    log(json.dumps({"metric": "card", "card": card_line(), "layers": layers,
                    "rounds": rounds, "torch": torch.__version__}))
    with torch.no_grad():
        last, kvs, lengths, Lp = gen.prefill({"llm": llm}, cfg, ids, attn, None, None, bf)
        cache = llama.init_kv_cache(cfg.llm, B, Lp + room, dtype=bf, device=dev)
        cache = llama.prefill_into_cache(cache, kvs, lengths)
        del kvs
        first = last.argmax(-1).to(torch.int32)

        def step():
            gen._decode_loop(llm, cache, first, -1, cfg=cfg, max_new_tokens=2,
                             temperature=0.0, top_p=1.0, compute_dtype=bf, generator=None)

        x = torch.randn((B, cfg.llm.hidden_size), device=dev, generator=g).to(bf)
        a = torch.randn((B, cfg.llm.num_heads * cfg.llm.head_dim), device=dev,
                        generator=g).to(bf)
        wrappers = {"fused_qkv_decode": lambda: fused_qkvo.fused_qkv_decode(x, llm["layers"], 1),
                    "fused_o_residual": lambda: fused_qkvo.fused_o_residual(a, x, llm["layers"],
                                                                            1),
                    "fused_mlp_decode": lambda: fused_mlp.fused_mlp_decode(x, llm["layers"], 1)}
        for name in ("rule", "row"):
            with route(name):
                for _ in range(2):
                    step()
        torch.cuda.synchronize()
        got = {n: {"enqueue_ms": [], "step_ms": [], "wrapper_us": {w: [] for w in wrappers}}
               for n in ("rule", "row")}
        for r in range(rounds):
            for name in (("rule", "row") if r % 2 == 0 else ("row", "rule")):
                with route(name):
                    enq, wall = sample(step)
                    got[name]["enqueue_ms"].append(enq)
                    got[name]["step_ms"].append(wall)
                    for w, fn in wrappers.items():
                        got[name]["wrapper_us"][w].append(wrapper_us(fn))
        torch.cuda.synchronize()
        for name, rec in got.items():
            out = {"metric": f"dense_decode_host_{name}", "B": B, "layers": layers,
                   "enqueue_ms": statistics.median(rec["enqueue_ms"]),
                   "step_ms": statistics.median(rec["step_ms"]),
                   "step_ms_spread": [min(rec["step_ms"]), max(rec["step_ms"])],
                   "enqueue_ms_spread": [min(rec["enqueue_ms"]), max(rec["enqueue_ms"])],
                   "wrapper_us": {w: statistics.median(v) for w, v in rec["wrapper_us"].items()},
                   "samples_step_ms": rec["step_ms"]}
            log(json.dumps(out))
        for name in ("rule", "row"):
            with route(name):
                step()
                torch.cuda.synchronize()
                log(json.dumps({"metric": f"dense_decode_host_profile_{name}",
                                **host_profile(step)}))


if __name__ == "__main__":
    run(*map(int, sys.argv[1:3]))
