#!/usr/bin/env python3
"""The PyTorch port's main paths on one NVIDIA GPU: SliME-8B serving a query
(int8, and the CLI's 4-bit configurations), SliME-8B's staged pretraining,
and a context-parallel (ring attention) prefill of Llama-3-8B's full 8192
positions.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phase 0  requires CUDA, prints the card, the versions and the kernel build
         time, and turns TF32 off. Phases 1 and 3 run under
         ``layers.fp32_accumulation`` (no TF32, no reduced-precision bf16
         reductions), the policy ``generate`` and the train step pin for
         their own work.
Phase 1  runs the self-tests of the wgmma tile vocabulary
         (``csrc/hopper_selftest.cu`` against torch.matmul, exactly, in every
         operand form the attention kernels use, the int8 form of P3 and
         K8 against the exact integer product, and the 1-D bulk copy of
         K1-K3's weight ring byte for byte), then each hand-written
         kernel instance of the paths (encoder attention in bf16 and fp32 and
         its P2 design probe, the fused QKV / O-residual / MLP decode kernels
         in int8 and q4g at B up to 128, bf16 and fp32 (in bf16 at B <= 8
         on their weight ring, with its launches' device times from the
         profiler, K2 and K3 beside torch's int8 / int4 weight-only
         product), the flash-attention
         forward and its dK/dV and dQ backward kernels in bf16 and fp32 at D
         = 128, 256 and 384, the quantized matmul in q4, int8 and q4g (K6 on
         its weight ring at decode rows and on wgmma at prefill rows, each
         beside its mma.sync instance on the same inputs), also at a K that
         is not a multiple of 128, and the W8A8
         matmul at the CLIP-L tower's four linears and at such a K, bf16 and
         fp32, the ring-attention kernel K9 on 4 virtual ranks at S = 8192
         in bf16 and fp32, at D = 64 and at S/n = 48, the int4 design probes
         P1 and P4 and the int8 dot probe P3 in its three forms) against
         its plain PyTorch version on the card at the paths' shapes,
         asserts agreement, and times both (median of CUDA-event timings),
         and one PyTorch call computing the same function where there is one
         (scaled_dot_product_attention for the attention kernels,
         torch._int_mm for P3 and for K8's int8 product alone). It prints
         the smallest absolute floor each comparison needed, and each
         kernel's bound: the larger of its bytes over HBM bandwidth and its
         operations over the tensor-core peak (H100 SXM data sheet).
Phase 2  builds SliME-8B at full width from a seed (vision, projector and
         sampler in bf16; the LLM int8 weight-only, stacked, with an int8
         lm_head, as bench.py lays it out), then answers three requests
         through ``generate`` and one through ``generate_stream``: a 672x672
         image and a 64-token prompt, 64 greedy tokens each. It checks the
         outputs and that every kernel was launched on that path (the
         2048-position prefill takes the flash forward in all 32 layers).
Phase 3  times the slice's stages on the host clock around
         synchronised calls, and traces one request's TTFT and 8 decode
         steps with ``torch.profiler``: device busy time, idle share,
         kernel launches per step and the largest device kernels.
Phase 4  frees the serving model, builds SliME-8B for training (bf16 frozen
         LLM and CLIP-L, fp32 projector and sampler) and runs stages 1-3 of
         the staged pretraining through ``run_stage`` at S = 2048 with
         per-layer remat, on batches of 672x672 images (host anyres, uint8)
         and ~300-token texts collated as the JAX package does. It checks
         finite losses, that exactly the leaves each stage trains moved and
         the frozen ones did not, and the flash kernels' launch counts; it
         holds one stage-1 step with the kernels to the same step with the
         plain attention, splits a stage-1 step's time and traces it.

Phase 5  builds SliME-8B as ``--load-4bit --int4-scheme group
         --quantize-lm-head --quantize-vision`` does (config A: q4g LLM
         layers, int8 lm_head, W8A8 CLIP-L; projector and sampler bf16), at
         full width and depth from seed 0, one fp32 layer at a time through
         ``checkpoint.quantize_loaded``; answers phase 2's four requests and
         checks them as phase 2 does, and the launches per request (the
         q4g matmul's wgmma instance 7 x 32 per prefill, the W8A8 matmul
         4 x 23 per encode, the flash forward 32 per prefill, the q4g decode
         kernels 32 per step, each on its weight ring, the q4 and int8
         loaders never); then phase 3's
         stage times and traces for it, with K7's and K8's device time and
         launches in one TTFT.
Phase 5b builds config B (``--load-4bit --int4-scheme absmax
         --quantize-lm-head``: per-row q4 LLM layers, vision bf16) at full
         width and depth, answers one 16-token request twice, and checks
         that K6 ran 7 x 32 times in each prefill on its wgmma instance and
         in each decode step (the non-fused decode) on its weight ring, its
         mma.sync instance never, and that the answers repeat; then phase
         3's stage times and traces for it, with K6's device time by
         instance in one TTFT and a decode step.
Phase 6  rebuilds phase 2's int8 LLM and prefills S = 8192 random token ids:
         (a) ``llama.forward(ring=4)``, the collective ring on 4 virtual
         ranks, and (b) the forward without a ring (K5, 32 launches), both
         bf16; (c) K9 on layer 0's RoPE'd q/k/v of that prompt (exactly 4
         launches) and (c32) the same in fp32 (4 launches of its fp32
         instance); (a32) and (b32), the same two forwards in fp32 (the fp32
         K5 in b32); (d) the default fp32 forward at S = 2048 through the
         fp32 K5. It holds (a) to (b) and (a32) to (b32) (logits, argmax),
         K9 to its plain version, the collective ring and K5's forward, (c32)
         to the collective ring in fp32, and (d) to the plain attention, and
         prints the host walls, K9's device times and the peak memory.

Phase 7  the entry points at their default fp32 compute dtype, each run
         twice with the counts set to 0 before the first run and read after
         it (finite, the same both times, the expected kernels launched): on
         phase 2's int8 model one ``generate`` with the image for 8 tokens
         and ``decode_step`` at B = 65; on config A ``llama.forward`` at S =
         2048 (K7), one W8A8 ``encode_images`` (K8, K4) and ``decode_step``
         at B = 65 (q4g K1-K3); on config B ``llama.forward`` at S = 2048
         (K6). It runs inside phases 2 and 5, on their models.

The last lines are the kernels' JSON record, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. Any failure raises before that line.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_GENERATE, N_NEW, CHUNK = 3, 64, 16
TIMED_RUNS = 25
PROFILE_STEPS = 8
SLEEP_CYCLES = 2_000_000    # a device sleep longer than a wrapper's enqueue (cuda_ms)
# the bulk-copy self-test's two copies: multiples of 16 bytes, not powers of two
BULK_SIZES = (4800, 9584)
# bf16 outputs, fp32 sums in another order than the plain version: about one
# bf16 ulp (2^-8 relative), plus an absolute floor for small outputs. The
# floors lie above the largest any comparison of the kernels' tests needed on
# an H100 (PERF.md): under 2e-4 for K2-K4, 3.2e-3 for the MLP, whose bf16
# intermediate can flip by one ulp before the down projection.
# The flash kernels (fp32 online softmax over key tiles, p and ds rounded to
# bf16 per tile) against flash_fwd_ref / flash_bwd_ref (fp32 over whole rows
# from the same bf16 inputs) needed floors of up to 3.3e-3 on an H100 (K5c
# through autograd at the ragged S = 2000; PERF.md has each reading).
# The quantized matmul's loaders (exact integer weights in bf16 tiles, fp32
# sums in another order, bf16 out) needed floors of up to 2.3e-5 on an H100,
# the q4g decode kernels up to 3.7e-4 (K1 at B = 64); the W8A8 matmul, which
# rounds at the plain version's points after an exact integer dot, agreed
# exactly (PERF.md), as P3's integer product must (its probe asserts equality).
# The fp32 flash kernels (FFMA, nothing rounded) differ from their plain
# versions only in the order of fp32 sums: floors of up to 1.1e-6 on an H100.
# The D = 256 instances (no path runs them yet) are held as their D = 128
# twins are.
# K9 (bf16 out; p split into two bf16 halves for P.V) against its plain
# version (the TPU kernel's fp32 arithmetic through the same protocol): 9.3e-7
# (PERF.md); its fp32 instance and its bf16 FFMA instance (D other than 128
# and 256) are held as the other fp32 instances are. K7's wgmma instance
# (exact integer weights in bf16 fragments, fp32 group sums) as its mma.sync
# one; the P1 probe as K6, whose function it computes; the P4 probe's dots
# (fp32 sums of exact products) at 1e-4, its totals exactly.
# The MLP decode kernel in bf16 is held instead to the one-ulp bound of its
# bf16 intermediate a = silu(g) u (fused_mlp.intermediate_ulp_bound, per
# element: sum_i ulp(a_i) |w_down[o, i]|), which a fixed floor from one draw
# could not prove.
# The fp32 instances (the entry points' default compute dtype) round nothing
# the plain versions do not, so only the order of fp32 sums differs: 1e-4 on
# outputs of order 1 (K4 rounds its fp32 l to bf16 as the plain version
# does; a flip there moves a row by 2^-8, inside RTOL).
RTOL = 2 ** -7
ATOL = {"encoder_attention": 2e-3, "fused_qkv_decode": 2e-3,
        "fused_o_residual": 2e-3, "fused_mlp_decode": 2e-3,
        "fused_qkv_decode_q4g": 2e-3, "fused_o_residual_q4g": 2e-3,
        "fused_mlp_decode_q4g": 2e-3, "fused_mlp_decode_ring": 2e-3,
        "fused_mlp_decode_q4g_ring": 2e-3, "fused_qkv_decode_ring": 2e-3,
        "fused_qkv_decode_q4g_ring": 2e-3, "fused_o_residual_ring": 2e-3,
        "fused_o_residual_q4g_ring": 2e-3,
        "flash_fwd": 5e-3, "flash_bwd_dkdv": 5e-3, "flash_bwd_dq": 5e-3,
        "flash_fwd_f32": 1e-5, "flash_bwd_dkdv_f32": 1e-5, "flash_bwd_dq_f32": 1e-5,
        "flash_fwd_d256": 5e-3, "flash_bwd_dkdv_d256": 5e-3, "flash_bwd_dq_d256": 5e-3,
        "flash_fwd_f32_d256": 1e-5, "flash_bwd_dkdv_f32_d256": 1e-5,
        "flash_bwd_dq_f32_d256": 1e-5,
        "flash_fwd_wide": 5e-3, "flash_bwd_dkdv_wide": 5e-3, "flash_bwd_dq_wide": 5e-3,
        "flash_fwd_f32_wide": 1e-5, "flash_bwd_dkdv_f32_wide": 1e-5,
        "flash_bwd_dq_f32_wide": 1e-5,
        "quant_matmul_q4": 2e-3, "quant_matmul_int8": 2e-3, "quant_matmul_q4g": 2e-3,
        "quant_matmul_q4_ring": 2e-3, "quant_matmul_int8_ring": 2e-3,
        "quant_matmul_q4_wgmma": 2e-3, "quant_matmul_int8_wgmma": 2e-3,
        "w8a8_matmul": 1e-6, "ring_attention_rdma": 1e-4,
        "encoder_attention_f32": 1e-4, "fused_qkv_decode_f32": 1e-4,
        "fused_o_residual_f32": 1e-4, "fused_mlp_decode_f32": 1e-4,
        "fused_qkv_decode_f32_q4g": 1e-4, "fused_o_residual_f32_q4g": 1e-4,
        "fused_mlp_decode_f32_q4g": 1e-4, "quant_matmul_q4_f32": 1e-4,
        "quant_matmul_int8_f32": 1e-4, "quant_matmul_q4g_f32": 1e-4,
        "w8a8_matmul_f32": 1e-6, "ring_attention_rdma_f32": 1e-4,
        "ring_attention_rdma_ffma": 1e-4, "quant_matmul_q4g_wgmma": 2e-3,
        "p1_int4_matvec": 2e-3, "p4_q4g_unpack": 1e-4, "p3_int8_dot": 0.0}
# H100 SXM data sheet, dense: HBM bytes/s, bf16 and int8 tensor-core ops/s,
# fp32 ops/s outside the tensor cores
HBM_BPS, BF16_OPS, INT8_OPS, F32_OPS = 3.35e12, 989e12, 1979e12, 67e12
# phase 6: the context-parallel prefill's sequence (Llama-3-8B's
# max_position_embeddings) and virtual ranks, and the fp32 forward's length
CP_SEQ, CP_RANKS, F32_SEQ = 8192, 4, 2048
# phase 7: decode rows of the default-dtype decode_step (one past the decode
# kernels' former 64-row limit)
DEFAULT_DTYPE_ROWS = 65
FUSED = ("fused_qkv_decode", "fused_o_residual", "fused_mlp_decode")
# phase 6's comparisons, from readings on an H100 (PERF.md). The
# last-position logits (std 0.74) of the bf16 ring forward (a) and the bf16
# K5 forward (b) differed by up to 0.101, as much as any two bf16 attention
# paths through the 32 random layers do (K5 against the plain attention:
# 0.108; each 0.10 from the fp32 result), while this model's top two logits
# lie 0.037 apart: the argmax is held on the same two forwards in fp32 (a32,
# b32), which agreed to 4e-5. K9 on layer 0 against the collective ring and
# K5's forward (which round p to bf16 where K9 keeps about 17 bits); the fp32
# forward through the fp32 K5 against the plain fp32 attention.
CP_LOGIT_ATOL, CP_F32_LOGIT_ATOL, CP_ATTN_ATOL, F32_LOGIT_ATOL = 0.25, 1e-3, 2e-2, 1e-3
# the staged pretraining: (name, SliMEConfig and TrainConfig changes, batch
# size, steps, the parameter prefixes that stage moves)
TRAIN_STAGES = (
    ("stage 1", dict(use_global_only=True, mm_learnable_gated=0),
     dict(tune_mm_mlp_adapter=True, mm_learnable_gated=0), 4, 3,
     ("projector/projection/",)),
    ("stage 2", dict(use_global_only=True, mm_learnable_gated=1),
     dict(tune_mm_mlp_adapter=True, mm_learnable_gated=1), 2, 2,
     ("projector/attn/",)),
    ("stage 3", dict(use_local_only=True), dict(tune_mm_mlp_adapter=True), 2, 2,
     ("projector/projection/", "sampler/")),
)
TRAIN_TEXT, TRAIN_PROMPT, TRAIN_LR = 300, 40, 1e-3
# one stage-1 step with the kernels vs with the plain attention (bf16 model,
# fp32 online softmax vs the plain bf16 softmax normalisation): an H100 read
# 1.8e-5 relative on the loss and 6.3e-4 on the projector's gradient norm
# (PERF.md)
TRAIN_RTOL = 5e-3
KERNELS = {
    "encoder_attention": ("slime_tpu_torch/csrc/encoder_attention.cu",
                          "slime_tpu/ops/encoder_attention.py:88"),
    "fused_qkv_decode": ("slime_tpu_torch/csrc/fused_decode.cu",
                         "slime_tpu/ops/fused_qkvo.py:146"),
    "fused_o_residual": ("slime_tpu_torch/csrc/fused_decode.cu",
                         "slime_tpu/ops/fused_qkvo.py:209"),
    "fused_mlp_decode": ("slime_tpu_torch/csrc/fused_decode.cu",
                         "slime_tpu/ops/fused_mlp.py:366"),
    "flash_fwd": ("slime_tpu_torch/csrc/flash_attention.cu",
                  "slime_tpu/ops/flash_attention.py:133"),
    "flash_bwd_dkdv": ("slime_tpu_torch/csrc/flash_attention.cu",
                       "slime_tpu/ops/flash_attention.py:347"),
    "flash_bwd_dq": ("slime_tpu_torch/csrc/flash_attention.cu",
                     "slime_tpu/ops/flash_attention.py:389"),
    "fused_qkv_decode_q4g": ("slime_tpu_torch/csrc/fused_decode.cu",
                             "slime_tpu/ops/fused_qkvo.py:146"),
    "fused_o_residual_q4g": ("slime_tpu_torch/csrc/fused_decode.cu",
                             "slime_tpu/ops/fused_qkvo.py:209"),
    "fused_mlp_decode_q4g": ("slime_tpu_torch/csrc/fused_decode.cu",
                             "slime_tpu/ops/fused_mlp.py:366"),
    # K1-K3 on the weight ring (bf16 x, int8 or q4g weights, B <= 8, where a
    # launch plan exists: the decode steps)
    "fused_mlp_decode_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                              "slime_tpu/ops/fused_mlp.py:366"),
    "fused_mlp_decode_q4g_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                                  "slime_tpu/ops/fused_mlp.py:366"),
    "fused_qkv_decode_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                              "slime_tpu/ops/fused_qkvo.py:146"),
    "fused_qkv_decode_q4g_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                                  "slime_tpu/ops/fused_qkvo.py:146"),
    "fused_o_residual_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                              "slime_tpu/ops/fused_qkvo.py:209"),
    "fused_o_residual_q4g_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                                  "slime_tpu/ops/fused_qkvo.py:209"),
    "quant_matmul_q4": ("slime_tpu_torch/csrc/quant_matmul.cu",
                        "slime_tpu/ops/quant_matmul.py:130"),
    "quant_matmul_int8": ("slime_tpu_torch/csrc/quant_matmul.cu",
                          "slime_tpu/ops/quant_matmul.py:130"),
    "quant_matmul_q4g": ("slime_tpu_torch/csrc/quant_matmul.cu",
                         "slime_tpu/ops/quant_matmul.py:82"),
    # K6's Hopper instances: the weight ring at 1-8 bf16 rows (decode), wgmma
    # at 64 and more (prefill); the mma.sync records above take the rest
    "quant_matmul_q4_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                             "slime_tpu/ops/quant_matmul.py:130"),
    "quant_matmul_int8_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                               "slime_tpu/ops/quant_matmul.py:130"),
    "quant_matmul_q4_wgmma": ("slime_tpu_torch/csrc/quant_matmul.cu",
                              "slime_tpu/ops/quant_matmul.py:130"),
    "quant_matmul_int8_wgmma": ("slime_tpu_torch/csrc/quant_matmul.cu",
                                "slime_tpu/ops/quant_matmul.py:130"),
    "w8a8_matmul": ("slime_tpu_torch/csrc/w8a8_matmul.cu",
                    "slime_tpu/ops/w8a8_matmul.py:64"),
    "flash_fwd_f32": ("slime_tpu_torch/csrc/flash_attention.cu",
                      "slime_tpu/ops/flash_attention.py:133"),
    "flash_bwd_dkdv_f32": ("slime_tpu_torch/csrc/flash_attention.cu",
                           "slime_tpu/ops/flash_attention.py:347"),
    "flash_bwd_dq_f32": ("slime_tpu_torch/csrc/flash_attention.cu",
                         "slime_tpu/ops/flash_attention.py:389"),
    "ring_attention_rdma": ("slime_tpu_torch/csrc/ring_attention.cu",
                            "slime_tpu/ops/ring_attention_rdma.py:148"),
    "quant_matmul_q4g_wgmma": ("slime_tpu_torch/csrc/quant_matmul.cu",
                               "slime_tpu/ops/quant_matmul.py:82"),
    "p1_int4_matvec": ("slime_tpu_torch/csrc/int4_probes.cu", "bench_quant_kernel.py:75"),
    "p4_q4g_unpack": ("slime_tpu_torch/csrc/int4_probes.cu",
                      "scripts/bench_q4g_unpack_probe.py:90"),
    "p3_int8_dot": ("slime_tpu_torch/csrc/int8_dot.cu", "scripts/bench_int8_dot_probe.py:59"),
}
# K9's fp32 instance (FFMA, any D) and its bf16 FFMA instance (D other than
# 128 and 256)
KERNELS.update({"ring_attention_rdma" + sfx: KERNELS["ring_attention_rdma"]
                for sfx in ("_f32", "_ffma")})
# the D = 256 instances of K5-K5c, bf16 and fp32, and those at D > 256
# ("wide": the FFMA kernels over 128- or 256-column chunks, checked at D = 384)
KERNELS.update({n + sfx: KERNELS[n] for n in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
                for sfx in ("_d256", "_f32_d256", "_wide", "_f32_wide")})
# the fp32 instances of K4, K1-K3 (dense / int8 and q4g weights), K6, K7, K8:
# the default fp32 compute dtype of the entry points
KERNELS.update({n + "_f32": KERNELS[n] for n in (
    "encoder_attention", "fused_qkv_decode", "fused_o_residual", "fused_mlp_decode",
    "quant_matmul_q4", "quant_matmul_int8", "quant_matmul_q4g", "w8a8_matmul")})
KERNELS.update({n + "_f32_q4g": KERNELS[n] for n in (
    "fused_qkv_decode", "fused_o_residual", "fused_mlp_decode")})
D256 = tuple(n for n in KERNELS if n.endswith("_d256"))
WIDE = tuple(n for n in KERNELS if n.endswith("_wide"))
# K6's int8 instances have no caller on any path: the JAX package routes only q4
# and q4g weights to its quantized matmuls (layers.py:52-59). K6's q4
# mma.sync instance takes bf16 x of 9-63 rows (or a K the ring and TMA
# cannot read), which no path sends it: config B's decode takes the ring and
# its prefill wgmma. No path of the
# port trains in fp32 on the card (phase 4 trains the bf16 model), so the
# fp32 K5b and K5c have none either, and no model here has a head dim of 256
# or more (nor one other than 128 for K9's bf16 FFMA instance). K7's
# mma.sync instance takes bf16 x below 64 rows, which no path sends it (the
# prefill is padded to 2048 rows; decode runs the fused q4g K1-K3). The P1,
# P3 and P4 probes are design probes, off every path. K1-K3's row-per-warp
# instances in bf16 with int8 or q4g weights take B > 8 only (the weight
# ring takes B <= 8 at these widths), which no path sends them (decode runs
# at B = 1; phase 7's B = 65 is fp32). Phase 1 checks them; their launch
# counts stay 0.
OFF_PATH = ("quant_matmul_int8", "quant_matmul_int8_f32", "quant_matmul_int8_ring",
            "quant_matmul_int8_wgmma", "quant_matmul_q4", "flash_bwd_dkdv_f32",
            "flash_bwd_dq_f32", "quant_matmul_q4g", "ring_attention_rdma_ffma",
            "p1_int4_matvec", "p4_q4g_unpack", "p3_int8_dot") + tuple(
    n + sfx for n in FUSED for sfx in ("", "_q4g")) + D256 + WIDE


def _counters():
    """{record name: (wrapper, counter attribute)} of every kernel launch
    count."""
    from slime_tpu_torch.ops import encoder_attention as ea
    from slime_tpu_torch.ops import flash_attention as fa
    from slime_tpu_torch.ops import fused_mlp, fused_qkvo
    from slime_tpu_torch.ops import quant_matmul as qm
    from slime_tpu_torch.ops import ring_attention_rdma as rd
    from slime_tpu_torch.ops import w8a8_matmul as w8
    from slime_tpu_torch.probes import int8_dot as p3
    from slime_tpu_torch.probes import q4g_unpack as p4
    from slime_tpu_torch.probes import quant_matmul as p1
    fused = {"fused_qkv_decode": fused_qkvo.fused_qkv_decode,
             "fused_o_residual": fused_qkvo.fused_o_residual,
             "fused_mlp_decode": fused_mlp.fused_mlp_decode}
    out = {"encoder_attention": (ea.encoder_attention, "launches"),
           "encoder_attention_f32": (ea.encoder_attention, "f32_launches"),
           **{n: (fa.flash_attention, n.replace("flash_bwd_", "").replace("flash_", "")
                  + "_launches") for n in KERNELS if n.startswith("flash_")},
           "ring_attention_rdma": (rd.ring_attention_rdma, "launches"),
           "ring_attention_rdma_f32": (rd.ring_attention_rdma, "f32_launches"),
           "ring_attention_rdma_ffma": (rd.ring_attention_rdma, "ffma_launches"),
           "quant_matmul_q4g_wgmma": (qm.quant_matmul_q4g, "wgmma_launches"),
           "p1_int4_matvec": (p1.matvec, "launches"),
           "p4_q4g_unpack": (p4.stream, "launches"),
           "p3_int8_dot": (p3.dot, "launches"),
           "quant_matmul_q4": (qm.quant_matmul, "q4_launches"),
           "quant_matmul_q4_f32": (qm.quant_matmul, "q4_f32_launches"),
           "quant_matmul_int8": (qm.quant_matmul, "int8_launches"),
           "quant_matmul_int8_f32": (qm.quant_matmul, "int8_f32_launches"),
           **{f"quant_matmul_{f}_{r}": (qm.quant_matmul, f"{f}_{r}_launches")
              for f in ("q4", "int8") for r in ("ring", "wgmma")},
           "quant_matmul_q4g": (qm.quant_matmul_q4g, "launches"),
           "quant_matmul_q4g_f32": (qm.quant_matmul_q4g, "f32_launches"),
           "w8a8_matmul": (w8.w8a8_matmul, "launches"),
           "w8a8_matmul_f32": (w8.w8a8_matmul, "f32_launches")}
    for n, fn in fused.items():
        for sfx in ("", "_q4g", "_f32", "_f32_q4g"):
            out[n + sfx] = (fn, sfx.lstrip("_") + ("_" if sfx else "") + "launches")
    for n, fn in fused.items():
        out[n + "_ring"] = (fn, "ring_launches")
        out[n + "_q4g_ring"] = (fn, "q4g_ring_launches")
    return out


def launch_counts():
    """Every kernel instance's launch count, by record name. The wrappers
    count every launch and subsets of them (by dtype, weight format, head
    dim); this takes the subsets apart, so each launch lands in exactly one
    record."""
    counts = {n: getattr(fn, attr) for n, (fn, attr) in _counters().items()}
    for n in ("fused_qkv_decode", "fused_o_residual", "fused_mlp_decode"):
        # .launches: every call; .q4g / .f32: subsets; .f32_q4g: both
        both = counts[n + "_f32_q4g"]
        counts[n] -= counts[n + "_q4g"] + counts[n + "_f32"] - both
        counts[n + "_q4g"] -= both
        counts[n + "_f32"] -= both
    for n in FUSED:
        # .ring counts the calls on the weight ring (bf16), .q4g_ring the q4g ones
        ring_q4g = counts[n + "_q4g_ring"]
        counts[n + "_ring"] -= ring_q4g
        counts[n] -= counts[n + "_ring"]
        counts[n + "_q4g"] -= ring_q4g
    for n in ("encoder_attention", "quant_matmul_q4", "quant_matmul_int8", "quant_matmul_q4g",
              "w8a8_matmul"):
        counts[n] -= counts[n + "_f32"]
    # K7's .launches counts every route, K9's every instance; K6's every
    # route too: what is left is its mma.sync instance
    counts["quant_matmul_q4g"] -= counts["quant_matmul_q4g_wgmma"]
    for f in ("q4", "int8"):
        counts[f"quant_matmul_{f}"] -= (counts[f"quant_matmul_{f}_ring"]
                                        + counts[f"quant_matmul_{f}_wgmma"])
    counts["ring_attention_rdma"] -= (counts["ring_attention_rdma_f32"]
                                      + counts["ring_attention_rdma_ffma"])
    for n in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        # .*_launches counts every dtype and head dim; .*_f32 every head dim
        # in fp32; .*_d256 / .*_wide both dtypes at D = 256 / D > 256;
        # .*_f32_d256 / .*_f32_wide the fp32 ones among those
        f32d, f32w = counts[n + "_f32_d256"], counts[n + "_f32_wide"]
        counts[n] -= counts[n + "_f32"] + counts[n + "_d256"] + counts[n + "_wide"] - f32d - f32w
        counts[n + "_f32"] -= f32d + f32w
        counts[n + "_d256"] -= f32d
        counts[n + "_wide"] -= f32w
    return counts


def reset_launch_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_moved, ops, peak):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    HBM bandwidth and the operations over the peak for their type."""
    t_bytes, t_ops = nbytes_moved / HBM_BPS, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=TIMED_RUNS, flush=None, clean=False):
    """Median milliseconds of fn() over ``runs`` CUDA-event timings, after
    warm-up; ``flush`` (outside the timed region) evicts L2 between runs so
    each run streams its weights from HBM, as in a decode step: by writing
    it (fn() then also pays the write-back of the dirty lines it evicts) or,
    with ``clean``, by reading it. fn()'s launches are queued behind a device
    sleep (~1 ms), so the events time the device and not the host's enqueue
    (``dispatch_us`` reads that)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None and clean:
            flush.sum()
        elif flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dispatch_us(fn, calls=50):
    """Host microseconds per call of fn() issued back to back without a
    sync (its launches queue behind each other): the host cost of a
    wrapper, which bounds a decode step that the device finishes first."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_ms(fn, runs=3):
    """Median milliseconds of fn() on the host clock around synchronised
    calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def compare(name, got, want, floor=None):
    """(max abs error, smallest absolute floor that passes at RTOL) of kernel
    output(s) vs the plain version; raise if not close: within RTOL and
    ATOL[name], or with ``floor`` (a tensor of the output's shape) within
    RTOL, the floor and 1e-6 elementwise."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = need = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        excess = (g - w).abs() - RTOL * w.abs()
        if floor is None:
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL[name],
                                       msg=lambda m: f"{name}: kernel vs plain: {m}")
        elif not bool((excess <= floor + 1e-6).all()):
            raise AssertionError(f"{name}: kernel vs plain beyond the one-ulp bound by "
                                 f"{(excess - floor).max().item():.3g}")
        err = max(err, (g - w).abs().max().item())
        need = max(need, excess.max().item())
    return err, need


def int8_llm_params(cfg, generator, device):
    """Random SliME-8B LLM params, int8 weight-only with per-row scales of
    N(0, 0.02) rows, layers stacked [L, ...], int8 lm_head (bench.py:68-117)."""
    H, HD, I, NL = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.num_layers

    def q(out_d, in_d, lead=(NL,)):
        return {"q": torch.randint(-127, 128, lead + (out_d, in_d), dtype=torch.int8,
                                   device=device, generator=generator),
                "scale": torch.full(lead + (out_d, 1), 0.02 / 127.0, device=device)}

    ones = lambda *s: torch.ones(s, device=device)     # noqa: E731
    layers = {
        "input_layernorm": {"weight": ones(NL, H)},
        "q_proj": {"weight": q(cfg.num_heads * HD, H)},
        "k_proj": {"weight": q(cfg.num_kv_heads * HD, H)},
        "v_proj": {"weight": q(cfg.num_kv_heads * HD, H)},
        "o_proj": {"weight": q(H, cfg.num_heads * HD)},
        "post_attention_layernorm": {"weight": ones(NL, H)},
        "gate_proj": {"weight": q(I, H)},
        "up_proj": {"weight": q(I, H)},
        "down_proj": {"weight": q(H, I)},
    }
    embed = torch.randn((cfg.vocab_size, H), device=device, generator=generator) * 0.02
    return {"embed_tokens": embed.to(torch.bfloat16), "norm": {"weight": ones(H)},
            "layers": layers, "lm_head": {"weight": q(cfg.vocab_size, H, lead=())}}


class IdText:
    """Stand-in detokenizer for generate_stream (no tokenizer ships with the
    port): ids -> space-joined decimal text."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def trace_device(path):
    """From a torch.profiler chrome trace: (device busy ms, the union of
    kernel / memcpy / memset intervals; kernel launches; device ms by kernel)."""
    spans, by_name, launches = [], {}, 0
    for e in json.loads(Path(path).read_text())["traceEvents"]:
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
        launches += cat == "kernel"
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy / 1e3, launches, by_name


def trace_kernel(path, pattern):
    """(device ms, launches) of the kernels whose names hold ``pattern`` in
    a torch.profiler chrome trace."""
    ms, n = 0.0, 0
    for e in json.loads(Path(path).read_text())["traceEvents"]:
        if (e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"
                and pattern in e["name"]):
            ms += e["dur"] / 1e3
            n += 1
    return ms, n


def profile_slice(tag, params, cfg, ids, attn, img, anyres, request, ttft_ms):
    """Phase 3 (and 5's and 5b's part of it): stage times (host clock around
    synchronised calls, median of 3) and a torch.profiler trace of one TTFT
    and of PROFILE_STEPS decode steps. Idle share = 1 - device busy / the
    unprofiled host wall time. ``tag`` names the phase in the log and the
    trace files. Returns the traces' summary: for a decode step and the
    TTFT, host and device ms, idle share, launches, and [device ms,
    launches] of each kernel class it names."""
    from torch.profiler import ProfilerActivity, profile

    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import llama, slime, vit
    from slime_tpu_torch.models.layers import fp32_accumulation

    bf = torch.bfloat16
    out = Path(__file__).resolve().parent / "bench_out"
    out.mkdir(exist_ok=True)

    crops, mask = anyres(img)
    pv, cm = crops[None], mask[None]
    with fp32_accumulation():
        fused = slime.prepare_multimodal(params, cfg, ids, attn, pv, cm, compute_dtype=bf)
        idx = torch.clamp(fused.lengths.long() - 1, min=0)
        h1 = torch.randn((1, cfg.llm.hidden_size), device=ids.device).to(bf)
        stages = {
            "anyres": host_ms(lambda: anyres(img)),
            "vit.apply (8 crops)": host_ms(lambda: vit.apply(
                params["vision"], crops.to(bf), cfg.vision)),
            "encode_images (vit + projector + sampler)": host_ms(
                lambda: slime.encode_images(params, cfg, pv, cm, ids, attn, compute_dtype=bf)),
            "prepare_multimodal": host_ms(lambda: slime.prepare_multimodal(
                params, cfg, ids, attn, pv, cm, compute_dtype=bf)),
            f"llama.forward prefill ({fused.embeds.shape[1]} positions)": host_ms(
                lambda: llama.forward(params["llm"], fused.embeds, cfg.llm,
                                      positions=fused.positions, return_kv=True,
                                      compute_dtype=bf, logit_positions=idx)),
            "llama._lm_head (int8, B=1)": host_ms(lambda: llama._lm_head(params["llm"], h1)),
        }
    del fused
    for name, ms in stages.items():
        log(f"phase {tag} stage {name}: {ms:.2f} ms")

    # decode: a cache after one prefill, then steps of the generate loop
    last, kvs, lengths, L = gen.prefill(params, cfg, ids, attn, pv, cm, bf)
    cache = llama.prefill_into_cache(
        llama.init_kv_cache(cfg.llm, 1, L + N_NEW, dtype=bf, device=ids.device),
        kvs, lengths)
    del kvs
    first = last.argmax(-1).to(torch.int32)

    def steps(n):
        gen._decode_loop(params["llm"], cache, first, -1, cfg=cfg, max_new_tokens=n + 1,
                         temperature=0.0, top_p=1.0, compute_dtype=bf, generator=None)
        torch.cuda.synchronize()

    steps(4)
    step_ms = []
    for _ in range(32):
        t0 = time.perf_counter()
        steps(1)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"phase {tag} decode step host wall over 32 steps (EOS sync included): median "
        f"{statistics.median(step_ms):.2f} ms, mean {statistics.mean(step_ms):.2f}, "
        f"p90 {np.percentile(step_ms, 90):.2f}, max {max(step_ms):.2f}")
    step_ms = statistics.median(step_ms)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        steps(PROFILE_STEPS)
    prof.export_chrome_trace(str(out / f"profile_decode_{tag}.json"))
    busy, launches, by_name = trace_device(out / f"profile_decode_{tag}.json")
    busy /= PROFILE_STEPS
    summary = {"decode_step": {"host_ms": step_ms, "device_ms": busy,
                               "idle_share": 1 - busy / step_ms,
                               "launches": launches / PROFILE_STEPS, "kernels": {}}}
    log(f"phase {tag} decode step: device busy {busy:.2f} ms/step; idle share "
        f"{1 - busy / step_ms:.3f}; {launches / PROFILE_STEPS:.0f} kernel launches/step")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"phase {tag} decode kernel {ms / PROFILE_STEPS:8.3f} ms/step  {name[:90]}")
    for what, pattern in (("weight ring, all (weight_ring_kernel)", "weight_ring_kernel"),
                          ("K6 q4 weight ring (weight_ring_kernel<4, ...>)",
                           "weight_ring_kernel<4,"),
                          ("K6 mma.sync (qmm_kernel)", "qmm_kernel"),
                          ("split-K reduction (splitk_reduce_kernel)", "splitk_reduce_kernel"),
                          ("row norms of K1 and K2 (rms_norm_kernel)", "rms_norm_kernel"),
                          ("K2 row per warp (qkv_kernel)", "qkv_kernel"),
                          ("K1 / K3 row per warp (resid_kernel)", "resid_kernel")):
        ms, n = trace_kernel(out / f"profile_decode_{tag}.json", pattern)
        summary["decode_step"]["kernels"][what] = [ms / PROFILE_STEPS, n / PROFILE_STEPS]
        log(f"phase {tag} decode {what}: {ms / PROFILE_STEPS:.3f} ms/step of device time over "
            f"{n / PROFILE_STEPS:.0f} launches/step")
    del cache, last

    with profile(activities=acts) as prof:
        request(1).cpu()
    prof.export_chrome_trace(str(out / f"profile_ttft_{tag}.json"))
    busy, launches, by_name = trace_device(out / f"profile_ttft_{tag}.json")
    summary["ttft"] = {"host_ms": ttft_ms, "device_ms": busy, "idle_share": 1 - busy / ttft_ms,
                       "launches": launches, "kernels": {}}
    log(f"phase {tag} TTFT: device busy {busy:.2f} ms of {ttft_ms:.2f} ms unprofiled; "
        f"idle share {1 - busy / ttft_ms:.3f}; {launches} kernel launches")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"phase {tag} TTFT kernel {ms:8.3f} ms  {name[:90]}")
    for what, pattern in (("K7 wgmma (q4g_wgmma_kernel)", "q4g_wgmma_kernel"),
                          ("K6 wgmma (qmm_wgmma_kernel)", "qmm_wgmma_kernel"),
                          ("split-K reduction (splitk_reduce_kernel)", "splitk_reduce_kernel"),
                          ("K6 / K7 mma.sync (qmm_kernel)", "qmm_kernel"),
                          ("K8 row pass (w8a8_row_quant_kernel)", "w8a8_row_quant_kernel"),
                          ("K8 int8 GEMM (int8_gemm_kernel)", "int8_gemm_kernel")):
        ms, n = trace_kernel(out / f"profile_ttft_{tag}.json", pattern)
        if n:
            summary["ttft"]["kernels"][what] = [ms, n]
            log(f"phase {tag} TTFT {what}: {ms:.3f} ms of device time over {n} launches")
    return summary


def check_and_time(record, name, label, kern, ref, moved, ops, peak, flush, main,
                   library=None, dispatch=False, floor=None, clean=False):
    """Hold kern() to its plain version ref() and time both (and one PyTorch
    call computing the same function, where there is one). ``moved`` bytes
    and ``ops`` operations at ``peak`` give the bound; the record keeps the
    ``main`` case, the main path's shape (an instance that no main case
    reaches keeps its first). ``dispatch`` also logs the wrapper's host cost
    per call; ``floor`` is compare's; ``clean`` also logs kern()'s time with
    L2 flushed by reading (no write-back charged to it)."""
    err, need = compare(name, kern(), ref(), floor)
    rec = record[name]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    ms, plain = cuda_ms(kern, flush=flush), cuda_ms(ref, flush=flush)
    lib = None if library is None else cuda_ms(library, flush=flush)
    b_ms, b_by = bound(moved, ops, peak)
    if main or "ms" not in rec:     # an instance off the main shape keeps its first case
        rec.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    tol = (f"set {ATOL[name]:g}" if floor is None
           else f"one-ulp bound up to {floor.max().item():.3g}")
    log(f"phase 1 {name} {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
        f"{'-' if lib is None else f'{lib:.4f} ms'}, bound {b_ms:.4f} ms ({b_by}); "
        f"max_abs_err {err:.3g}, floor needed {need:.3g} ({tol})"
        + (f"; host dispatch {dispatch_us(kern):.1f} us/call" if dispatch else "")
        + (f"; ms_clean_flush {cuda_ms(kern, flush=flush, clean=True):.4f}" if clean else ""))


def sdpa(q, k, v, **kw):
    """torch's scaled_dot_product_attention over [B, H, S, D] views, GQA by
    ``enable_gqa`` where kv has fewer heads."""
    import torch.nn.functional as F
    gqa = k.shape[1] != q.shape[1]
    return F.scaled_dot_product_attention(q, k, v, **kw, **({"enable_gqa": True} if gqa else {}))


def flash_kernels(dev, g, flush, record):
    """Phase 1 for K5, K5b and K5c at the serving prefill's shape (q [1, 32,
    2048, 128], kv [1, 8, 2048, 128] bf16, causal, in llama's [B, S, H, D]
    storage) and at stage 1's batch of 4, plus three packed segments and a
    ragged S = 2000 through ``flash_attention(use_kernel=True)`` and
    autograd. The record keeps the B = 1 times, the bounds and the time of
    torch's causal GQA scaled_dot_product_attention: its forward for K5, its
    backward (dQ, dK and dV in one call) for K5b and K5c alike."""
    from slime_tpu_torch.ops import flash_attention as fa

    def bhsd(B, S, heads):
        return torch.randn((B, S, heads, 128), device=dev, generator=g).to(
            torch.bfloat16).transpose(1, 2)

    segs = torch.ones((1, 2048), dtype=torch.int32, device=dev)
    segs[:, 700:1400], segs[:, 1400:] = 2, 3
    cases = {"main": (1, 2048, None), "batch 4": (4, 2048, None),
             "segments": (1, 2048, segs), "ragged": (1, 2000, None)}
    for case, (B, S, seg) in cases.items():
        q, k, v, do = bhsd(B, S, 32), bhsd(B, S, 8), bhsd(B, S, 8), bhsd(B, S, 32)
        kw = dict(causal=True, segment_ids=seg)
        ro, rl = fa.flash_fwd_ref(q, k, v, **kw)
        delta = (do.float() * ro.float()).sum(-1)
        want_dq, want_dk, want_dv = fa.flash_bwd_ref(q, k, v, do, rl, delta, **kw)
        got = {"flash_fwd": fa.flash_fwd(q, k, v, **kw),
               "flash_bwd_dkdv": fa.flash_bwd_dkdv(q, k, v, do, rl, delta, **kw),
               "flash_bwd_dq": fa.flash_bwd_dq(q, k, v, do, rl, delta, **kw)}
        want = {"flash_fwd": (ro, rl), "flash_bwd_dkdv": (want_dk, want_dv),
                "flash_bwd_dq": want_dq}
        if case == "ragged":
            # the autograd path: forward kernel, delta from its output, K5b, K5c
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fa.flash_attention(*leaves, causal=True, use_kernel=True)
            out.backward(do)
            got["flash_fwd"] = (out.detach(),)
            want["flash_fwd"] = (ro,)
            got["flash_bwd_dkdv"] = (leaves[1].grad, leaves[2].grad)
            got["flash_bwd_dq"] = leaves[0].grad
        torch.cuda.synchronize()
        for name in got:
            err, need = compare(name, got[name], want[name])
            rec = record[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            log(f"phase 1 {name} {case} B={B} S={S}: max_abs_err {err:.3g}, floor "
                f"needed {need:.3g} (set {ATOL[name]:g})")
        if case in ("main", "batch 4"):
            fns = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v),
                                 lambda: fa.flash_fwd_ref(q, k, v)),
                   "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(q, k, v, do, rl, delta),
                                      lambda: fa.flash_bwd_dkdv_ref(q, k, v, do, rl, delta)),
                   "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, rl, delta),
                                    lambda: fa.flash_bwd_dq_ref(q, k, v, do, rl, delta))}
            # causal products of B x 32 heads x S^2 / 2 x 128: the forward
            # does 2 (QK^T, PV), dK/dV 4 (QK^T, dP, dV, dK), dQ 3 (QK^T, dP, dQ)
            prod = 2 * B * 32 * S * S * 128 // 2
            io = {"flash_fwd": (nbytes(q, k, v, ro, rl), 2 * prod),
                  "flash_bwd_dkdv": (nbytes(q, k, v, do, rl, delta, k, v), 4 * prod),
                  "flash_bwd_dq": (nbytes(q, k, v, do, rl, delta, q), 3 * prod)}
            lib = {}
            if case == "main":
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                lo = sdpa(ql, kl, vl, is_causal=True)
                lib = {"flash_fwd": lambda: sdpa(q, k, v, is_causal=True),
                       "flash_bwd_dkdv": lambda: torch.autograd.grad(
                           lo, (ql, kl, vl), do, retain_graph=True)}
                lib["flash_bwd_dq"] = lib["flash_bwd_dkdv"]
            for name, (kern, ref) in fns.items():
                ms, plain = cuda_ms(kern, flush=flush), cuda_ms(ref, flush=flush)
                b_ms, b_by = bound(*io[name], BF16_OPS)
                lib_ms = cuda_ms(lib[name], flush=flush) if name in lib else None
                if case == "main":
                    record[name].update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                        library_ms=lib_ms)
                log(f"phase 1 {name} [{B},32|8,2048,128] bf16 causal: kernel {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, library "
                    f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {b_ms:.4f} ms "
                    f"({b_by})")
            del lib
        del q, k, v, do, ro, rl, delta, want_dq, want_dk, want_dv, got, want
    torch.cuda.empty_cache()
    flash_kernels_f32(dev, g, flush, record)


def flash_kernels_f32(dev, g, flush, record):
    """Phase 1 for the fp32 K5, K5b and K5c (FFMA kernels) at the serving
    prefill's shape in fp32, q [1, 32, 2048, 128], kv [1, 8, 2048, 128],
    causal, in llama's [B, S, H, D] storage, against the plain versions;
    timed beside torch's fp32 scaled_dot_product_attention (forward; its
    backward for K5b and K5c alike), with the bound at the 67 TFLOP/s fp32
    rate."""
    from slime_tpu_torch.ops import flash_attention as fa

    B, S = 1, 2048
    q, k, v, do = (torch.randn((B, S, heads, 128), device=dev, generator=g).transpose(1, 2)
                   for heads in (32, 8, 8, 32))
    ro, rl = fa.flash_fwd_ref(q, k, v)
    delta = (do * ro).sum(-1)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lo = sdpa(ql, kl, vl, is_causal=True)
    backward = lambda: torch.autograd.grad(lo, (ql, kl, vl), do, retain_graph=True)  # noqa: E731
    prod = 2 * B * 32 * S * S * 128 // 2
    cases = {
        "flash_fwd_f32": (lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_fwd_ref(q, k, v),
                          nbytes(q, k, v, ro, rl), 2 * prod,
                          lambda: sdpa(q, k, v, is_causal=True)),
        "flash_bwd_dkdv_f32": (lambda: fa.flash_bwd_dkdv(q, k, v, do, rl, delta),
                               lambda: fa.flash_bwd_dkdv_ref(q, k, v, do, rl, delta),
                               nbytes(q, k, v, do, rl, delta, k, v), 4 * prod, backward),
        "flash_bwd_dq_f32": (lambda: fa.flash_bwd_dq(q, k, v, do, rl, delta),
                             lambda: fa.flash_bwd_dq_ref(q, k, v, do, rl, delta),
                             nbytes(q, k, v, do, rl, delta, q), 3 * prod, backward),
    }
    for name, (kern, ref, moved, ops, lib) in cases.items():
        check_and_time(record, name, "[1,32|8,2048,128] fp32 causal", kern, ref, moved, ops,
                       F32_OPS, flush, True, library=lib)
    del q, k, v, do, ro, rl, delta, ql, kl, vl, lo, cases
    torch.cuda.empty_cache()


def flash_kernels_d256(dev, g, flush, record):
    """Phase 1 for K5, K5b and K5c at D = 256 (no model here has that head
    dim; the port takes it as JAX does): q [1, 16, 2048, 256], kv [1, 4,
    2048, 256], causal, in llama's [B, S, H, D] storage, bf16 and fp32,
    against the plain versions; timed beside torch's scaled_dot_product_
    attention (forward; its backward for K5b and K5c alike)."""
    from slime_tpu_torch.ops import flash_attention as fa

    B, S, H, KVH, D = 1, 2048, 16, 4, 256
    for dtype, sfx, peak in ((torch.bfloat16, "", BF16_OPS), (torch.float32, "_f32", F32_OPS)):
        q, k, v, do = (torch.randn((B, S, heads, D), device=dev, generator=g).to(dtype)
                       .transpose(1, 2) for heads in (H, KVH, KVH, H))
        ro, rl = fa.flash_fwd_ref(q, k, v)
        delta = (do.float() * ro.float()).sum(-1)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lo = sdpa(ql, kl, vl, is_causal=True)
        backward = lambda: torch.autograd.grad(lo, (ql, kl, vl), do, retain_graph=True)  # noqa: E731
        prod = 2 * B * H * S * S * D // 2
        label = f"[{B},{H}|{KVH},{S},{D}] {'bf16' if sfx == '' else 'fp32'} causal"
        cases = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_fwd_ref(q, k, v),
                          nbytes(q, k, v, ro, rl), 2 * prod,
                          lambda: sdpa(q, k, v, is_causal=True)),
            "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(q, k, v, do, rl, delta),
                               lambda: fa.flash_bwd_dkdv_ref(q, k, v, do, rl, delta),
                               nbytes(q, k, v, do, rl, delta, k, v), 4 * prod, backward),
            "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, rl, delta),
                             lambda: fa.flash_bwd_dq_ref(q, k, v, do, rl, delta),
                             nbytes(q, k, v, do, rl, delta, q), 3 * prod, backward),
        }
        for name, (kern, ref, moved, ops, lib) in cases.items():
            check_and_time(record, name + sfx + "_d256", label, kern, ref, moved, ops, peak,
                           flush, True, library=lib)
        del q, k, v, do, ro, rl, delta, ql, kl, vl, lo, cases
        torch.cuda.empty_cache()


def flash_kernels_wide(dev, g, flush, record):
    """Phase 1 for K5, K5b and K5c at D = 384 (the FFMA kernels over three
    128-column chunks of D; no model here has such a head, JAX's rule sends
    it to its kernels): q [1, 8, 2048, 384], kv [1, 2, 2048, 384], causal, in
    llama's [B, S, H, D] storage, bf16 and fp32, against the plain versions,
    timed beside torch's scaled_dot_product_attention."""
    from slime_tpu_torch.ops import flash_attention as fa

    B, S, H, KVH, D = 1, 2048, 8, 2, 384
    for dtype, sfx, peak in ((torch.bfloat16, "_wide", BF16_OPS),
                             (torch.float32, "_f32_wide", F32_OPS)):
        q, k, v, do = (torch.randn((B, S, heads, D), device=dev, generator=g).to(dtype)
                       .transpose(1, 2) for heads in (H, KVH, KVH, H))
        ro, rl = fa.flash_fwd_ref(q, k, v)
        delta = (do.float() * ro.float()).sum(-1)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lo = sdpa(ql, kl, vl, is_causal=True)
        backward = lambda: torch.autograd.grad(lo, (ql, kl, vl), do, retain_graph=True)  # noqa: E731
        prod = 2 * B * H * S * S * D // 2
        label = f"[{B},{H}|{KVH},{S},{D}] {'bf16' if dtype == torch.bfloat16 else 'fp32'} causal"
        cases = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_fwd_ref(q, k, v),
                          nbytes(q, k, v, ro, rl), 2 * prod,
                          lambda: sdpa(q, k, v, is_causal=True)),
            "flash_bwd_dkdv": (lambda: fa.flash_bwd_dkdv(q, k, v, do, rl, delta),
                               lambda: fa.flash_bwd_dkdv_ref(q, k, v, do, rl, delta),
                               nbytes(q, k, v, do, rl, delta, k, v), 4 * prod, backward),
            "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, rl, delta),
                             lambda: fa.flash_bwd_dq_ref(q, k, v, do, rl, delta),
                             nbytes(q, k, v, do, rl, delta, q), 3 * prod, backward),
        }
        for name, (kern, ref, moved, ops, lib) in cases.items():
            check_and_time(record, name + sfx, label, kern, ref, moved, ops, peak, flush, True,
                           library=lib)
        del q, k, v, do, ro, rl, delta, ql, kl, vl, lo, cases
        torch.cuda.empty_cache()


def hopper_selftest(dev, g):
    """Phase 1's first check: the wgmma tile vocabulary against torch.matmul
    on small integers, where every fp32 sum is exact (bit for bit), in every
    operand form the attention kernels use: S = A.B^T and T = B.A^T (SS,
    K-major), O = bf16(S).V, P1 = bf16(S).B and P2 = bf16(T).A (RS, the
    shared operand read MN-major); then the int8 SS form of P3 and K8 (s8
    x s8 -> s32 at N = 128 and 256 over two K chunks) against the exact
    integer product; then the 1-D bulk copy of K1's weight ring, two copies
    of ragged sizes from a 16- but not 128-byte aligned source onto one
    mbarrier, byte for byte."""
    from slime_tpu_torch.ops import _cuda

    a, b = (torch.randint(-3, 4, (64, 64), device=dev, generator=g).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randint(-3, 4, (64, 128), device=dev, generator=g).to(torch.bfloat16)
    got = _cuda.hopper_selftest(a, b, v)
    want_s = torch.matmul(a.float(), b.float().T)
    want_t = torch.matmul(b.float(), a.float().T)
    rs, rt = want_s.to(torch.bfloat16).float(), want_t.to(torch.bfloat16).float()
    want = (want_s, torch.matmul(rs, v.float()), want_t, torch.matmul(rs, b.float()),
            torch.matmul(rt, a.float()))
    a8 = torch.randint(-128, 128, (64, 256), dtype=torch.int8, device=dev, generator=g)
    b8 = torch.randint(-128, 128, (256, 256), dtype=torch.int8, device=dev, generator=g)
    c128, c256 = _cuda.hopper_selftest_s8(a8, b8)
    exact = torch.matmul(a8.double(), b8.double().T).to(torch.int32)
    torch.cuda.synchronize()
    errs = {n: (x - w).abs().max().item() for n, x, w in zip(("S", "O", "T", "P1", "P2"),
                                                              got, want)}
    errs.update({n: (x - w).abs().max().item()
                 for n, x, w in (("C128 s8", c128, exact[:, :128]), ("C256 s8", c256, exact))})
    src = torch.randint(0, 256, (48 + sum(BULK_SIZES),), dtype=torch.uint8, device=dev,
                        generator=g)
    got = _cuda.bulk_selftest(src[48:], *BULK_SIZES)
    torch.cuda.synchronize()
    errs["bulk copy"] = int((got != src[48:]).sum().item())
    log("phase 1 hopper_selftest (TMA, SS and RS wgmma, K- and MN-major operands; SS s8 "
        f"wgmma at N = 128, 256; 1-D bulk copies of {BULK_SIZES[0]} + {BULK_SIZES[1]} bytes "
        "at a 48-byte offset): max abs err (for the copy: bytes that differ) "
        + ", ".join(f"{n} {e:g}" for n, e in errs.items()) + " (set 0)")
    if any(errs.values()):
        raise AssertionError(f"hopper_selftest disagrees with the exact product: {errs}")


def ring_moved_ops(q, k, n, causal=True):
    """(bytes, operations) of K9's bound on global q [B, H, S, D], k [B,
    KVH, S, D] over n ranks: q, k, v in and out out, plus the fp32 acc state
    a rank reads and writes on each (rank, step) pair it attends (n (n + 1)
    / 2 of them causal, n^2 full); operations 4 B H D S (S + 1) / 2 (the
    causal pairs) or 4 B H D S^2."""
    B, H, S, D = q.shape
    pairs = n * (n + 1) // 2 if causal else n * n
    state = B * H * (S // n) * D * 4
    ops = 4 * B * H * D * (S * (S + 1) // 2 if causal else S * S)
    return nbytes(q, k, k, q) + pairs * 2 * state, ops


def ring_kernel(dev, g, flush, record):
    """Phase 1 for K9 at the context-parallel prefill's shape: q [1, 32,
    8192, 128], kv [1, 8, 8192, 128] bf16 in llama's storage, causal, on 4
    virtual ranks (S/n = 2048), against its plain version; the library time
    is torch's causal scaled_dot_product_attention on the same global q/k/v
    with kv repeated to 32 heads. Bound (``ring_moved_ops``): the causal
    pairs' operations times 1.5 (P.V runs twice, on p's two bf16 halves) at
    the bf16 rate, or q, k, v, out and the fp32 state traffic."""
    from slime_tpu_torch.ops import ring_attention_rdma as rd

    def bhsd(heads):
        return torch.randn((1, CP_SEQ, heads, 128), device=dev, generator=g).to(
            torch.bfloat16).transpose(1, 2)

    q, k, v = bhsd(32), bhsd(8), bhsd(8)
    kr, vr = k.repeat_interleave(4, dim=1), v.repeat_interleave(4, dim=1)
    before = rd.ring_attention_rdma.launches
    rd.ring_attention_rdma(q, k, v, ring=CP_RANKS)
    per_call = rd.ring_attention_rdma.launches - before
    if per_call != CP_RANKS:
        raise AssertionError(f"K9 launched {per_call} times in one call on {CP_RANKS} ranks")
    moved, ops = ring_moved_ops(q, k, CP_RANKS)
    check_and_time(record, "ring_attention_rdma",
                   f"q [1,32,{CP_SEQ},128], kv [1,8,{CP_SEQ},128] bf16 causal, "
                   f"{CP_RANKS} virtual ranks ({per_call} launches per call)",
                   lambda: rd.ring_attention_rdma(q, k, v, ring=CP_RANKS),
                   lambda: rd.ring_attention_rdma_ref(q, k, v, ring=CP_RANKS),
                   moved, ops * 3 // 2, BF16_OPS, flush, True,
                   library=lambda: sdpa(q, kr, vr, is_causal=True))
    del q, k, v, kr, vr
    torch.cuda.empty_cache()


def ring_kernel_instances(dev, g, flush, record):
    """Phase 1 for K9's other instances on 4 virtual ranks, causal, in
    llama's storage, against the plain version and beside SDPA (kv repeated
    to the query heads): fp32 at the prefill's shape (the FFMA kernel, bound
    at the fp32 rate); bf16 at D = 64, [1, 32, 8192, 64] (the bf16 FFMA
    kernel); bf16 at D = 128 with S/n = 48, [1, 32, 192, 128] (the wgmma
    kernel on shards that are not a multiple of its 128-row tiles: a line,
    not the record)."""
    from slime_tpu_torch.ops import ring_attention_rdma as rd

    cases = (("ring_attention_rdma_f32", torch.float32, CP_SEQ, 128, F32_OPS, True),
             ("ring_attention_rdma_ffma", torch.bfloat16, CP_SEQ, 64, BF16_OPS, True),
             ("ring_attention_rdma", torch.bfloat16, 4 * 48, 128, BF16_OPS, False))
    for name, dtype, S, D, peak, main in cases:
        q, k, v = (torch.randn((1, S, heads, D), device=dev, generator=g).to(dtype)
                   .transpose(1, 2) for heads in (32, 8, 8))
        kr, vr = k.repeat_interleave(4, dim=1), v.repeat_interleave(4, dim=1)
        moved, ops = ring_moved_ops(q, k, CP_RANKS)
        wgmma = dtype == torch.bfloat16 and D in rd.WGMMA_HEAD_DIMS
        check_and_time(record, name,
                       f"q [1,32,{S},{D}], kv [1,8,{S},{D}] "
                       f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} causal, "
                       f"{CP_RANKS} virtual ranks (S/n = {S // CP_RANKS})",
                       lambda: rd.ring_attention_rdma(q, k, v, ring=CP_RANKS),
                       lambda: rd.ring_attention_rdma_ref(q, k, v, ring=CP_RANKS),
                       moved, ops * 3 // 2 if wgmma else ops, peak, flush, main,
                       library=lambda: sdpa(q, kr, vr, is_causal=True))
        del q, k, v, kr, vr
        torch.cuda.empty_cache()


def q4g_llm_layers(cfg, generator, device):
    """Random stacked decode layers in the CLI's q4g format: N(0, 0.02)
    weights quantized group-128 (``--int4-scheme group``)."""
    from slime_tpu_torch.ops.quantization import quantize_weight_q4g

    H, HD, I, NL = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.num_layers

    def q(out_d, in_d):
        return quantize_weight_q4g(
            torch.randn((NL, out_d, in_d), device=device, generator=generator) * 0.02)

    ones = lambda *s: torch.ones(s, device=device)     # noqa: E731
    return {"input_layernorm": {"weight": ones(NL, H)},
            "q_proj": {"weight": q(cfg.num_heads * HD, H)},
            "k_proj": {"weight": q(cfg.num_kv_heads * HD, H)},
            "v_proj": {"weight": q(cfg.num_kv_heads * HD, H)},
            "o_proj": {"weight": q(H, cfg.num_heads * HD)},
            "post_attention_layernorm": {"weight": ones(NL, H)},
            "gate_proj": {"weight": q(I, H)},
            "up_proj": {"weight": q(I, H)},
            "down_proj": {"weight": q(H, I)}}


def decode_kernels(dev, cfg, g, flush, record):
    """Phase 1 for K1-K3 at 8B width, layer 1 of a 2-layer stack: int8 (B =
    1, 8) and q4g (B = 1, 64) in bf16, as before; then, from a generator of
    their own, both formats at B = 65 and 128 in bf16 (one launch each, past
    the former 64-row limit) and at B = 1 and 65 in fp32 (the default
    compute dtype), and q4g at B = 8 in bf16. The records keep B = 1; K1-K3
    in bf16 at B <= 8 take the weight ring (``*_ring``, ``*_q4g_ring``: the
    routing rule of each wrapper), whose launches' device time (profiler)
    is logged at B = 1 and 8, and the row-per-warp bf16 instances keep
    their first case (B = 64 or 65). K2 and K3 are timed beside one PyTorch
    call of their int8 or q4g product alone (``decode_library``; in fp32
    where the installed torch takes fp32 x, else the reason is logged).
    The MLP in bf16 is held to the one-ulp bound of its bf16 intermediate."""
    from slime_tpu_torch.ops import fused_mlp, fused_qkvo
    from slime_tpu_torch.probes.mlp_decode import profile_split

    cfg2 = dataclasses.replace(cfg.llm, num_layers=2)
    H, NQ = cfg2.hidden_size, cfg2.num_heads * cfg2.head_dim
    NKV, I = cfg2.num_kv_heads * cfg2.head_dim, cfg2.intermediate_size
    g_new = torch.Generator(device=dev).manual_seed(SEED + 3)
    g_q4g8 = torch.Generator(device=dev).manual_seed(SEED + 10)
    bf, f32 = torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for fmt, batches in (("int8", (1, 8)), ("q4g", (1, 64))):
        two = (int8_llm_params(cfg2, g, dev)["layers"] if fmt == "int8"
               else q4g_llm_layers(cfg2, g, dev))
        fsfx = "_q4g" if fmt == "q4g" else ""

        def w(*names):          # layer 1's weights, scales and norm weights
            return [t[1] for n in names for t in (
                two[n]["weight"].values() if isinstance(two[n]["weight"], dict)
                else (two[n]["weight"],))]
        # name: (kernel, plain, layer-1 tensors read, output columns, MACs per row)
        cases = {
            "fused_qkv_decode": (lambda x, a: fused_qkvo.fused_qkv_decode(x, two, 1),
                                 lambda x, a: fused_qkvo.fused_qkv_decode_ref(x, two, 1),
                                 w("input_layernorm", "q_proj", "k_proj", "v_proj"),
                                 NQ + 2 * NKV, H * (NQ + 2 * NKV)),
            "fused_o_residual": (lambda x, a: fused_qkvo.fused_o_residual(a, x, two, 1),
                                 lambda x, a: fused_qkvo.fused_o_residual_ref(a, x, two, 1),
                                 w("o_proj"), H, NQ * H),
            "fused_mlp_decode": (lambda x, a: fused_mlp.fused_mlp_decode(x, two, 1),
                                 lambda x, a: fused_mlp.fused_mlp_decode_ref(x, two, 1),
                                 w("post_attention_layernorm", "gate_proj", "up_proj",
                                   "down_proj"), H, 3 * H * I),
        }
        code = fused_qkvo.INT8 if fmt == "int8" else fused_qkvo.Q4G
        # each wrapper's routing rule: (B, dtype) -> the weight ring or not
        routes = {"fused_qkv_decode": lambda B, d: fused_qkvo.qkv_ring_route(
                      B, d, code, H, NQ, NKV, sms),
                  "fused_o_residual": lambda B, d: fused_qkvo.o_ring_route(
                      B, d, code, NQ, H, sms),
                  "fused_mlp_decode": lambda B, d: fused_mlp.ring_route(B, d, code, H, I, sms)}
        # (activation dtype, record suffix, batch sizes, generator)
        runs = ((bf, "", batches, g), (bf, "", (65, 128), g_new), (f32, "_f32", (1, 65), g_new))
        if fmt == "q4g":
            runs += ((bf, "", (8,), g_q4g8),)
        for dtype, dsfx, bs, gen in runs:
            for B in bs:
                x = torch.randn((B, H), device=dev, generator=gen).to(dtype)
                a = torch.randn((B, NQ), device=dev, generator=gen).to(dtype)
                for name, (kern, ref, reads, cols, macs) in cases.items():
                    acts = (x, a) if name == "fused_o_residual" else (x,)
                    floor = (fused_mlp.intermediate_ulp_bound(x, two, 1)
                             if name == "fused_mlp_decode" and dtype == bf else None)
                    ring = routes[name](B, dtype) is not None
                    library = (decode_library(name, fmt, two, x, a)
                               if name != "fused_mlp_decode" else None)
                    check_and_time(record, name + dsfx + fsfx + ("_ring" if ring else ""),
                                   f"8B width {fmt} {'bf16' if dtype == bf else 'fp32'} "
                                   f"B={B} layer 1",
                                   lambda: kern(x, a), lambda: ref(x, a),
                                   nbytes(*acts, *reads) + B * cols * x.element_size(),
                                   2 * B * macs, BF16_OPS if dtype == bf else F32_OPS, flush,
                                   main=B == 1, dispatch=B == 1, floor=floor, library=library)
                    if ring and B in (1, 8):
                        short = lambda n: n.replace("void (anonymous namespace)::",  # noqa: E731
                                                    "").split("(")[0]
                        split, span = profile_split(lambda: kern(x, a), flush)
                        log(f"phase 1 {name}{fsfx}_ring {fmt} B={B} launches "
                            f"(profiler, device ms each, L2 flushed): "
                            + ", ".join(f"{short(n)} {ms:.4f}" for n, ms in split.items())
                            + f"; first start to last end {span:.4f} ms")
        del two, cases


def decode_library(name, fmt, two, x, a):
    """One PyTorch call of K2's or K3's bf16 product alone (no row norm, no
    residual) on layer 1's weights: torch._weight_int8pack_mm (int8) or
    torch._weight_int4pack_mm at group size 128 (q4g), over W_q, W_k and
    W_v concatenated (once, outside the timing) for K2. None, with the
    reason logged, where the installed torch does not run it on this card."""
    names = ("q_proj", "k_proj", "v_proj") if name == "fused_qkv_decode" else ("o_proj",)
    act = x if name == "fused_qkv_decode" else a
    ws = [two[n]["weight"] for n in names]
    if fmt == "int8":
        return int8pack_library(name, act, torch.cat([w["q"][1] for w in ws]),
                                torch.cat([w["scale"][1, :, 0] for w in ws]))
    return int4pack_library(act, {"q4g": torch.cat([w["q4g"][1] for w in ws]),
                                  "scale": torch.cat([w["scale"][1] for w in ws])}, name)


def int8pack_library(name, x, q, scale):
    """torch._weight_int8pack_mm(x, q, scale) (bf16 x, int8 q [N, K], scales
    [N]): per-row int8 weights' product. None, with the reason logged, where
    the installed torch does not run it on this card."""
    if not hasattr(torch, "_weight_int8pack_mm"):
        log(f"phase 1 {name}: this torch has no torch._weight_int8pack_mm")
        return None
    scale = scale.to(x.dtype)
    fn = lambda: torch._weight_int8pack_mm(x, q, scale)  # noqa: E731
    try:
        fn()
        torch.cuda.synchronize()
        return fn
    except (RuntimeError, NotImplementedError) as e:
        log(f"phase 1 {name}: torch._weight_int8pack_mm does not run here: "
            f"{str(e).splitlines()[0][:160]}")
        return None


def int4pack_library(x, qw, name="quant_matmul_q4g_wgmma"):
    """torch._weight_int4pack_mm on q4g inputs (K7's, K2's, K3's) or per-row
    q4 ones with the scales given per group of 128 (K6's), as a yardstick:
    the signed nibbles n as unsigned n + 8 with zero points 0 and the group
    scales in bf16 (that call's form, w = (u - 8) s + 0), group size 128.
    None, with the reason logged, where the installed torch does not run it
    on this card."""
    from slime_tpu_torch.ops import quantization as quant
    try:
        u = quant.int_values(qw).to(torch.int32) + 8
        packed = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
        wp = torch._convert_weight_to_int4pack(packed, 8)
        s = qw["scale"].to(torch.bfloat16).T.contiguous()
        sz = torch.stack([s, torch.zeros_like(s)], dim=-1).contiguous()
        fn = lambda: torch._weight_int4pack_mm(x, wp, 128, sz)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        return fn
    except (RuntimeError, NotImplementedError, AttributeError, TypeError) as e:
        log(f"phase 1 {name}: torch._weight_int4pack_mm does not run here: "
            f"{str(e).splitlines()[0][:160]}")
        return None


def int_mm_library(x, qw):
    """torch._int_mm of K8's int8 operands (x quantized per token as the
    plain version does, the int8 weight): the int8 product alone, without
    the row pass and the epilogue. None, with the reason logged, where the
    installed torch does not run it on this card."""
    xf = x.float()
    am = xf.abs().amax(dim=-1, keepdim=True)
    xq = torch.round(xf / torch.where(am > 0, am * (1.0 / 127.0), torch.ones_like(am))).to(
        torch.int8)
    try:
        fn = lambda: torch._int_mm(xq, qw["q"].T)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        return fn
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        log(f"phase 1 w8a8_matmul: torch._int_mm does not run here: "
            f"{str(e).splitlines()[0][:160]}")
        return None


def quant_kernels(dev, g, flush, record):
    """Phase 1 for the quantized matmul (K6: q4 and int8; K7: q4g) and the
    W8A8 matmul (K8) at the serving shapes: K6 at decode (B = 1) and
    prefill (B = 2048) rows of q_proj [4096, 4096] and down_proj [4096,
    14336] on the instance its routing names (the weight ring, wgmma), each
    beside its mma.sync instance on the same inputs (the "was" lines, the
    parent's kernel at these shapes); then, from a generator of their own,
    the ring at k/v [1024, 4096] and at B = 8, wgmma at gate_proj and k/v,
    int8 on both, and the mma.sync records at 32 rows (the rows it still
    takes); the ring cases also with L2 flushed by reading;
    K7's wgmma instance at prefill rows of gate_proj [14336, 4096]
    (the record), q_proj, k_proj [1024, 4096] and down_proj (config A's
    prefill shapes), and at 64 and 100 rows; K7's mma.sync instance at
    decode rows (B = 1); from a generator of their own, the fp32 instances
    (the FFMA K6/K7) at the same shapes, and K6 at a K that is not a
    multiple of 128; K8 at one 8-crop encode's 4616 tokens of the CLIP-L
    tower's four linears (qkv [3072, 1024], out_proj, fc1, fc2) and at K =
    1000, in bf16, and in fp32 at qkv, beside torch._int_mm of its int8
    operands (the product alone).
    K6's int8 instances are timed beside ``torch._weight_int8pack_mm``, and
    K6's q4 instances (K a multiple of 128) and K7's wgmma and mma.sync
    instances beside ``torch._weight_int4pack_mm`` at group size 128
    (``int4pack_library``; per-row q4 as its row's one scale repeated over
    the row's K / 128 groups), where the installed torch runs them on the
    card."""
    from slime_tpu_torch.ops import quant_matmul as qm
    from slime_tpu_torch.ops import quantization as quant
    from slime_tpu_torch.ops import w8a8_matmul as w8

    bf, f32 = torch.bfloat16, torch.float32

    def k6_case(name, M, N, K, main, gen, was):
        """K6 in bf16 at x [M, K], W [N, K] on the instance k6_route names
        (record ``name``_<route>), and with ``was`` its mma.sync instance on
        the same inputs (record ``name``, never its main case)."""
        code = qm._Q4 if name == "quant_matmul_q4" else qm._INT8
        w = torch.randn((N, K), device=dev, generator=gen) * 0.02
        x = torch.randn((M, K), device=dev, generator=gen).to(bf)
        qw = quant.quantize_weight(w, 4 if code == qm._Q4 else 8)
        del w
        route = qm.k6_route(M, K, bf, code, N, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        library = (int8pack_library(name, x, qw["q"], qw["scale"][:, 0]) if code == qm._INT8
                   else int4pack_library(x, {"q4": qw["q4"], "scale": qw["scale"].expand(
                       N, K // 128)}, name))
        if library is not None:
            log(f"phase 1 {name} x [{M}, {K}], W [{N}, {K}]: library's max_abs_err against "
                f"the plain version "
                f"{(library().float() - qm.quant_matmul_ref(x, qw).float()).abs().max():.3g}")
        moved, ops = nbytes(x, *qw.values()) + M * N * 2, 2 * M * N * K
        check_and_time(record, name if route == "mma" else f"{name}_{route}",
                       f"x [{M}, {K}] bf16, W [{N}, {K}] ({route})",
                       lambda: qm.quant_matmul(x, qw), lambda: qm.quant_matmul_ref(x, qw),
                       moved, ops, BF16_OPS, flush, main, library=library, dispatch=M == 1,
                       clean=route == "ring")
        if was and route != "mma":        # the mma.sync GEMM itself: not counted
            w_int = qw["q4"] if code == qm._Q4 else qw["q"]
            check_and_time(record, name, f"x [{M}, {K}] bf16, W [{N}, {K}] (was: the "
                           f"mma.sync instance)", lambda: qm._launch(code, x, w_int, qw["scale"]),
                           lambda: qm.quant_matmul_ref(x, qw), moved, ops, BF16_OPS, flush,
                           False)

    # K6 at the parent's cases, on the same draws: the new instances and
    # their mma.sync "was" lines (main: the record's case)
    for name, M, N, K, main in (("quant_matmul_q4", 1, 4096, 4096, True),
                                ("quant_matmul_q4", 1, 4096, 14336, False),
                                ("quant_matmul_q4", 2048, 4096, 4096, False),
                                ("quant_matmul_q4", 2048, 4096, 14336, True),
                                ("quant_matmul_int8", 1, 4096, 4096, True),
                                ("quant_matmul_int8", 2048, 4096, 14336, True)):
        k6_case(name, M, N, K, main, g, True)
    # (record name, rows, out, in, the record's case)
    cases = [("quant_matmul_q4g_wgmma", 2048, 14336, 4096, True),
             ("quant_matmul_q4g_wgmma", 2048, 4096, 4096, False),
             ("quant_matmul_q4g_wgmma", 2048, 1024, 4096, False),
             ("quant_matmul_q4g_wgmma", 2048, 4096, 14336, False),
             ("quant_matmul_q4g_wgmma", 64, 14336, 4096, False),
             ("quant_matmul_q4g_wgmma", 100, 4096, 4096, False),
             ("quant_matmul_q4g", 1, 4096, 4096, True)]
    f32_cases = [("quant_matmul_q4_f32", 1, 4096, 4096, True),
                 ("quant_matmul_q4_f32", 2048, 4096, 4096, False),
                 ("quant_matmul_int8_f32", 1, 4096, 4096, True),
                 ("quant_matmul_q4g_f32", 2048, 14336, 4096, True),
                 ("quant_matmul_q4g_f32", 1, 4096, 4096, False)]
    g_f32 = torch.Generator(device=dev).manual_seed(SEED + 4)
    for name, M, N, K, main in cases + f32_cases:
        gen, dtype = (g_f32, f32) if name.endswith("_f32") else (g, bf)
        w = torch.randn((N, K), device=dev, generator=gen) * 0.02
        x = torch.randn((M, K), device=dev, generator=gen).to(dtype)
        if name.startswith("quant_matmul_q4g"):
            qw = quant.quantize_weight_q4g(w)
            kern, ref = qm.quant_matmul_q4g, qm.quant_matmul_q4g_ref
        else:
            qw = quant.quantize_weight(w, 4 if name.startswith("quant_matmul_q4") else 8)
            kern, ref = qm.quant_matmul, qm.quant_matmul_ref
        del w
        library = None
        if name in ("quant_matmul_q4g_wgmma", "quant_matmul_q4g", "quant_matmul_q4g_f32") and main:
            library = int4pack_library(x, qw, name)
        if name == "quant_matmul_int8_f32":
            library = int8pack_library(name, x, qw["q"], qw["scale"][:, 0])
        check_and_time(record, name, f"x [{M}, {K}] {'fp32' if dtype == f32 else 'bf16'}, "
                       f"W [{N}, {K}]", lambda: kern(x, qw), lambda: ref(x, qw),
                       nbytes(x, *qw.values()) + M * N * x.element_size(), 2 * M * N * K,
                       F32_OPS if dtype == f32 else BF16_OPS, flush, main, dispatch=M == 1,
                       library=library)
    # K6's other instances and shapes, from a generator of their own: the
    # ring at k/v and at 8 rows (beside mma.sync: the down projection's 8
    # rows take two ring launches), q4 wgmma at gate_proj and k/v, int8 on
    # the ring at down_proj and on wgmma at q_proj, the mma.sync records at
    # 32 rows
    g_k6 = torch.Generator(device=dev).manual_seed(SEED + 10)
    for name, M, N, K, main in (("quant_matmul_q4", 1, 1024, 4096, False),
                                ("quant_matmul_q4", 8, 4096, 4096, False),
                                ("quant_matmul_q4", 8, 4096, 14336, False),
                                ("quant_matmul_q4", 2048, 14336, 4096, False),
                                ("quant_matmul_q4", 2048, 1024, 4096, False),
                                ("quant_matmul_int8", 1, 4096, 14336, False),
                                ("quant_matmul_int8", 2048, 4096, 4096, False),
                                ("quant_matmul_q4", 32, 4096, 4096, True),
                                ("quant_matmul_int8", 32, 4096, 4096, True)):
        k6_case(name, M, N, K, main, g_k6, M == 8)
    # K6 at a K that is not a multiple of 128 (int8 any K, q4 any even K: the
    # kernels mask their last k-tile), from a generator of its own
    g_k = torch.Generator(device=dev).manual_seed(SEED + 8)
    for name, M, N, K in (("quant_matmul_int8", 1, 4096, 1000),
                          ("quant_matmul_int8", 2048, 4096, 1000),
                          ("quant_matmul_q4", 1, 4096, 1000),
                          ("quant_matmul_q4", 2048, 4096, 1002),
                          ("quant_matmul_int8_f32", 37, 1000, 200),
                          ("quant_matmul_q4_f32", 37, 1000, 200)):
        dtype = f32 if name.endswith("_f32") else bf
        qw = quant.quantize_weight(torch.randn((N, K), device=dev, generator=g_k) * 0.02,
                                   4 if name.startswith("quant_matmul_q4") else 8)
        x = torch.randn((M, K), device=dev, generator=g_k).to(dtype)
        library = (int8pack_library(name, x, qw["q"], qw["scale"][:, 0])
                   if name.startswith("quant_matmul_int8") else None)
        check_and_time(record, name, f"x [{M}, {K}] {'fp32' if dtype == f32 else 'bf16'}, "
                       f"W [{N}, {K}] (K not a multiple of 128)",
                       lambda: qm.quant_matmul(x, qw), lambda: qm.quant_matmul_ref(x, qw),
                       nbytes(x, *qw.values()) + M * N * x.element_size(), 2 * M * N * K,
                       F32_OPS if dtype == f32 else BF16_OPS, flush, False, library=library)
    # K8 at one 8-crop encode's 4616 tokens: the packed qkv (the record), fc2,
    # then from a generator of their own out_proj, fc1 and a K of 1000; fp32
    # at qkv. Library: torch._int_mm on the quantized x, the int8 product alone
    g_w8 = torch.Generator(device=dev).manual_seed(SEED + 9)
    for N, K, main, dtype, gen in ((3072, 1024, True, bf, g), (1024, 4096, False, bf, g),
                                   (3072, 1024, True, f32, g_f32), (1024, 1024, False, bf, g_w8),
                                   (4096, 1024, False, bf, g_w8), (3072, 1000, False, bf, g_w8)):
        sfx = "_f32" if dtype == f32 else ""
        M = 8 * 577
        qw = quant.quantize_weight(torch.randn((N, K), device=dev, generator=gen) * 0.02, 8)
        bias = torch.randn((N,), device=dev, generator=gen) * 0.02
        x = torch.randn((M, K), device=dev, generator=gen).to(dtype)
        check_and_time(record, "w8a8_matmul" + sfx,
                       f"x [{M}, {K}] {'fp32' if sfx else 'bf16'}, W [{N}, {K}] int8 (library: "
                       f"the int8 product alone)",
                       lambda: w8.w8a8_matmul(x, qw, bias),
                       lambda: w8.w8a8_matmul_ref(x, qw, bias),
                       nbytes(x, *qw.values(), bias) + M * N * x.element_size(),
                       2 * M * N * K, INT8_OPS, flush, main, library=int_mm_library(x, qw))
    torch.cuda.empty_cache()


def probe_kernels(dev, record, flush):
    """Phase 1 for the P1, P3 and P4 probes: each variant, form or mode held
    to its plain version and timed (``probes.quant_matmul.run``,
    ``probes.int8_dot.run``, ``probes.q4g_unpack.run``, which print their
    JSON lines); the records keep P1's magic variant at 64 rows a block,
    P3's nt form at its faster tile (beside torch._int_mm) and P4's
    unpack_dot mode, each beside its plain version, with their bounds; P1's
    also beside ``torch._weight_int4pack_mm`` on its inputs (K6's q4
    function: ``int4pack_library``)."""
    from slime_tpu_torch.probes import int8_dot as p3
    from slime_tpu_torch.probes import q4g_unpack as p4
    from slime_tpu_torch.probes import quant_matmul as p1

    recs, plain_ms, int8_ms = p1.run(dev, runs=TIMED_RUNS, seed=SEED, log=log)
    main = next(r for r in recs if r["variant"] == "magic" and r["rows"] == 64)
    moved = p1.OUT * p1.IN // 2 + p1.IN * 2 + p1.OUT * 4 + p1.OUT * 2
    b_ms, b_by = bound(moved, 2 * p1.OUT * p1.IN, BF16_OPS)
    x, qw = p1.make_inputs(dev, SEED)
    library = int4pack_library(x, {"q4": qw["q4"], "scale": qw["scale"].expand(
        p1.OUT, p1.IN // 128)}, "p1_int4_matvec")
    lib_ms = None if library is None else cuda_ms(library, flush=flush)
    record["p1_int4_matvec"].update(
        max_abs_err=max(r["max_abs_err"] for r in recs), ms=main["us"] / 1e3,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    ring = next(r for r in recs if r["variant"] == "ring")
    log(f"phase 1 p1_int4_matvec: magic, 64 rows a block {main['us'] / 1e3:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{b_ms:.4f} ms ({b_by}); K6 at this shape on its weight "
        f"ring {ring['us'] / 1e3:.4f} ms; K6's int8 instance at the same rows "
        f"{int8_ms:.4f} ms")
    res, p4_plain = p4.run(dev, seed=SEED, log=log)
    L, I, H = p4.SHAPE
    moved = L * I * H // 2 + H * 2 + L * I * 4
    b_ms, b_by = bound(moved, 2 * L * I * H, BF16_OPS)
    record["p4_q4g_unpack"].update(
        max_abs_err=max(r["max_abs_err"] for r in res.values()), ms=res["unpack_dot"]["ms"],
        plain_ms=p4_plain["unpack_dot"], bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"phase 1 p4_q4g_unpack: unpack_dot {res['unpack_dot']['ms']:.4f} ms, plain "
        f"{p4_plain['unpack_dot']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); dma "
        f"{res['dma']['ms']:.4f}, unpack {res['unpack']['ms']:.4f} ms")
    torch.cuda.empty_cache()
    recs, plain_ms, lib = p3.run(dev, runs=TIMED_RUNS, seed=SEED, log=log)
    M, K, N = p3.M, p3.K, p3.N
    for form in p3.FORMS:
        best = min((r for r in recs if r["form"] == form), key=lambda r: r["ms"])
        out_bytes = 2 if form == "nn_bf16" else 4
        b_ms, b_by = bound(M * K + N * K + M * N * out_bytes, 2 * M * N * K, INT8_OPS)
        log(f"phase 1 p3_int8_dot {form}: 128 x {best['tile_n']} {best['ms']:.4f} ms (equal "
            f"to the exact product), plain {plain_ms[form]:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if form == "nt":
            record["p3_int8_dot"].update(
                max_abs_err=0.0, ms=best["ms"], plain_ms=plain_ms[form], bound_ms=b_ms,
                bound_by=b_by, library_ms=lib["int_mm"])
    int_mm = "does not run here" if lib["int_mm"] is None else f"{lib['int_mm']:.4f} ms"
    log(f"phase 1 p3_int8_dot library: torch._int_mm {int_mm}, bf16 torch.matmul "
        f"{lib['bf16']:.4f} ms")
    torch.cuda.empty_cache()


def kernel_phase(dev, cfg):
    """Phase 1: every kernel against its plain version; returns the record."""
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.ops import encoder_attention as ea
    from slime_tpu_torch.probes import encoder_attention as p2

    g = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)   # 256 MB > L2
    record = {n: {"max_abs_err": 0.0} for n in KERNELS}
    # the self-test and the D = 256 checks draw from generators of their own,
    # so every other check sees the inputs of earlier versions of this phase
    hopper_selftest(dev, torch.Generator(device=dev).manual_seed(SEED + 1))
    with fp32_accumulation():
        q, k, v = (torch.randn((8, 577, 16, 64), device=dev, generator=g).to(torch.bfloat16)
                   for _ in range(3))
        # two products of 8 x 16 heads x 577^2 x 64; q, k, v in, out out
        check_and_time(record, "encoder_attention", "[8,577,16,64] bf16",
                       lambda: ea.encoder_attention(q, k, v),
                       lambda: ea.encoder_attention_ref(q, k, v), 4 * nbytes(q),
                       2 * 2 * 8 * 16 * 577 * 577 * 64, BF16_OPS, flush, True,
                       library=lambda: sdpa(*(t.transpose(1, 2) for t in (q, k, v))))
        g32 = torch.Generator(device=dev).manual_seed(SEED + 5)
        q, k, v = (torch.randn((8, 577, 16, 64), device=dev, generator=g32) for _ in range(3))
        check_and_time(record, "encoder_attention_f32", "[8,577,16,64] fp32",
                       lambda: ea.encoder_attention(q, k, v),
                       lambda: ea.encoder_attention_ref(q, k, v), 4 * nbytes(q),
                       2 * 2 * 8 * 16 * 577 * 577 * 64, F32_OPS, flush, True,
                       library=lambda: sdpa(*(t.transpose(1, 2) for t in (q, k, v))))
        del q, k, v
    p2.run(dev, runs=TIMED_RUNS, seed=SEED, log=log)           # the P2 probe: K4's variants
    with fp32_accumulation():
        decode_kernels(dev, cfg, g, flush, record)
        flash_kernels(dev, g, flush, record)
        flash_kernels_d256(dev, torch.Generator(device=dev).manual_seed(SEED + 2), flush,
                           record)
        flash_kernels_wide(dev, torch.Generator(device=dev).manual_seed(SEED + 6), flush,
                           record)
        quant_kernels(dev, g, flush, record)
        ring_kernel(dev, g, flush, record)
        ring_kernel_instances(dev, torch.Generator(device=dev).manual_seed(SEED + 7), flush,
                              record)
    probe_kernels(dev, record, flush)
    del flush
    torch.cuda.empty_cache()
    return record


def query(dev, cfg):
    """bench.py's query: one 672x672 image, a 64-token prompt with the image
    sentinel at position 2, and the device anyres for that image size."""
    from slime_tpu_torch.config import IMAGE_TOKEN_INDEX
    from slime_tpu_torch.data.image_ops import make_device_anyres_fn

    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(rng.integers(0, 255, (672, 672, 3), dtype=np.uint8)).to(dev)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 64)).astype(np.int64)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    ids = torch.from_numpy(ids).to(dev)
    attn = torch.ones((1, 64), dtype=torch.bool, device=dev)
    return img, ids, attn, make_device_anyres_fn((672, 672), device=dev)


def serve(tag, dev, cfg, params, expect, profile_tag):
    """Answer N_GENERATE generate requests and one generate_stream request
    on bench.py's query with the counts set to 0 just before and read just
    after; check the answers and ``expect`` ({kernel: (count, exact)}: the
    launches for the window's requests and decode steps); time TTFT and the
    decode rate; then profile the slice (phase ``profile_tag``). Returns the
    window's launch counts."""
    from slime_tpu_torch import generate as gen

    img, ids, attn, anyres = query(dev, cfg)
    # a fixed-length answer: random weights make EOS meaningless
    cfg_run = dataclasses.replace(cfg, eos_token_id=-1)
    # generate_stream sizes its cache one longer than generate's default; the
    # same cache length makes both run identical shapes, so their greedy
    # answers must agree token for token
    cache_len = cfg.tokenizer_model_max_length + N_NEW + 1

    def request(max_new):
        crops, mask = anyres(img)
        return gen.generate(params, cfg_run, ids, attn, crops[None], mask[None],
                            max_new_tokens=max_new, compute_dtype=torch.bfloat16,
                            cache_len=cache_len)

    request(2)                                     # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()

    reset_launch_counts()
    latencies, answers = [], []
    for _ in range(N_GENERATE):
        t0 = time.perf_counter()
        toks = request(N_NEW).cpu()
        latencies.append(time.perf_counter() - t0)
        answers.append(toks)
    t0 = time.perf_counter()
    crops, mask = anyres(img)
    texts = list(gen.generate_stream(params, cfg_run, IdText(), ids, attn, crops[None],
                                     mask[None], max_new_tokens=N_NEW, chunk=CHUNK,
                                     compute_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = launch_counts()
    log(f"phase {tag} launches on the main path: {json.dumps(launches)}")

    # outputs: shape, range, determinism, the stream agrees with generate
    V = cfg.llm.vocab_size
    for toks in answers:
        if toks.shape != (1, N_NEW) or int(toks.min()) < 0 or int(toks.max()) >= V:
            raise AssertionError(f"tokens out of shape/range: {tuple(toks.shape)} "
                                 f"[{int(toks.min())}, {int(toks.max())}]")
        if not torch.equal(toks, answers[0]):
            raise AssertionError("greedy requests on the same input disagree")
    if not texts or texts[-1] != IdText().decode(answers[0][0].tolist()):
        raise AssertionError("generate_stream text differs from generate's tokens")
    requests = N_GENERATE + 1
    steps = requests * (N_NEW - 1)
    for n, (want, exact) in expect(requests, steps).items():
        if launches[n] < want or (exact and launches[n] != want):
            raise AssertionError(f"phase {tag}: {n} launched {launches[n]} times in "
                                 f"{requests} requests and {steps} decode steps, expected "
                                 f"{'' if exact else 'at least '}{want}")

    # first-step logits, and TTFT = anyres + encode + fusion + prefill + 1st token
    crops, mask = anyres(img)
    last, _, lengths, L = gen.prefill(params, cfg_run, ids, attn, crops[None],
                                       mask[None], torch.bfloat16)
    if last.shape != (1, V) or not bool(torch.isfinite(last).all()):
        raise AssertionError("first-step logits are not finite [1, V]")
    log(f"phase {tag} prefill: {int(lengths[0])} valid of {L} positions; first-step "
        f"logits finite, argmax {int(last.argmax())} == answer {int(answers[0][0, 0])}: "
        f"{int(last.argmax()) == int(answers[0][0, 0])}")
    del last
    ttft = []
    for _ in range(3):
        t0 = time.perf_counter()
        request(1).cpu()
        ttft.append(time.perf_counter() - t0)
    ttft_s, e2e_s = statistics.median(ttft), statistics.median(latencies)
    log(f"phase {tag} TTFT {ttft_s * 1e3:.1f} ms (median of 3; anyres + encode + "
        f"fusion + {L}-position prefill + first token)")
    log(f"phase {tag} request latency {e2e_s * 1e3:.1f} ms (median of {N_GENERATE}); "
        f"decode {(N_NEW - 1) / (e2e_s - ttft_s):.2f} tok/s; "
        f"{N_GENERATE / sum(latencies) * 60:.2f} queries/min at bs=1; "
        f"stream request {stream_s * 1e3:.1f} ms, {len(texts)} chunks")
    log(f"phase {tag} peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    profile_slice(profile_tag, params, cfg_run, ids, attn, img, anyres, request,
                  ttft_s * 1e3)
    return launches


def default_dtype_run(what, fn, expect):
    """Phase 7: fn() at the entry points' default fp32 compute dtype, with
    the counts set to 0 just before and read just after; then fn() again.
    Both results must be finite and equal (the kernels sum in a fixed
    order), and each kernel of ``expect`` ({record: (count, exact)}) must
    have launched its count. Returns the first run's counts."""
    reset_launch_counts()
    t0 = time.perf_counter()
    first = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    again = fn()
    outs = [t for t in (first if isinstance(first, tuple) else (first,))]
    reps = [t for t in (again if isinstance(again, tuple) else (again,))]
    ok = all(bool(torch.isfinite(t.float()).all()) for t in outs)
    same = all(torch.equal(a, b) for a, b in zip(outs, reps))
    wrong = {n: counts[n] for n, (want, exact) in expect.items()
             if counts[n] < want or (exact and counts[n] != want)}
    log(f"phase 7 {what} (default fp32): host wall {wall:.1f} ms; launched "
        f"{json.dumps({n: c for n, c in counts.items() if c})}; finite {ok}, repeats {same}")
    if not ok or not same or wrong:
        raise AssertionError(f"phase 7 {what}: finite {ok}, repeats {same}, launches off "
                             f"{wrong} (expected {expect})")
    return counts


def serve_phases(dev, cfg):
    """Phases 2 and 3 on the int8 serving model, and phase 7's int8 part;
    returns the launch counts of the counted windows (3 generate requests
    and 1 stream request; phase 7's first runs)."""
    from slime_tpu_torch.models import projector, sampler, vit

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    kw = dict(generator=g, device=dev, dtype=torch.bfloat16)
    params = {"vision": vit.init(cfg.vision, **kw),
              "projector": projector.init(cfg, **kw),
              "sampler": sampler.init(cfg, **kw),
              "llm": int8_llm_params(cfg.llm, g, dev)}
    torch.cuda.synchronize()
    log(f"phase 2 params built on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")

    def expect(requests, steps):
        # one 2048-position prefill per request, the flash forward in each layer
        return {"encoder_attention": (23 * requests, False),
                "fused_qkv_decode_ring": (32 * steps, False),
                "fused_o_residual_ring": (32 * steps, False),
                "fused_mlp_decode_ring": (32 * steps, False),
                **{n: (0, True) for n in FUSED},
                "flash_fwd": (32 * requests, True)}
    launches = serve("2", dev, cfg, params, expect, "3")

    # ---------------- phase 7 (int8 model): the default compute dtype ----------------
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import llama
    img, ids, attn, anyres = query(dev, cfg)
    cfg_run = dataclasses.replace(cfg, eos_token_id=-1)
    L, vis = cfg.llm.num_layers, cfg.vision.num_layers + cfg.vision.select_layer + 1
    n_new = 8

    def request():
        crops, mask = anyres(img)
        return gen.generate(params, cfg_run, ids, attn, crops[None], mask[None],
                            max_new_tokens=n_new)
    got = default_dtype_run(
        "generate with an image, int8 LLM, 8 tokens", request,
        {"encoder_attention_f32": (vis, True), "flash_fwd_f32": (L, True),
         **{n + "_f32": (L * (n_new - 1), True) for n in FUSED}})
    tok = torch.from_numpy(np.random.default_rng(SEED).integers(
        5, cfg.llm.vocab_size, (DEFAULT_DTYPE_ROWS,))).to(dev)

    def step():
        cache = llama.init_kv_cache(cfg.llm, DEFAULT_DTYPE_ROWS, 16, device=dev)
        return llama.decode_step(params["llm"], cache, tok, cfg.llm)[0]
    for n, c in default_dtype_run(
            f"decode_step at B = {DEFAULT_DTYPE_ROWS}, stacked int8 layers", step,
            {n + "_f32": (L, True) for n in FUSED}).items():
        got[n] += c
    for n, c in got.items():
        launches[n] += c
    del params
    return launches


def quantized_model(dev, cfg, scheme, quantize_vision):
    """SliME-8B as the CLI's ``--load-4bit --int4-scheme {scheme}
    --quantize-lm-head [--quantize-vision]`` builds it, from fp weights drawn
    from seed 0 on the card: each LLM layer is drawn in fp32 and quantized
    through ``checkpoint.quantize_loaded`` before the next is drawn (the fp32
    layers are never all held), the layers stacked; then the int8 lm_head
    and, with ``quantize_vision``, the W8A8 CLIP-L. Embeddings, norms,
    projector and sampler stay bf16 (norms fp32)."""
    from slime_tpu_torch.checkpoint import quantize_loaded
    from slime_tpu_torch.models import llama, projector, sampler, vit

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    kw = dict(generator=g, device=dev, dtype=torch.bfloat16)
    layers = []
    for _ in range(cfg.llm.num_layers):
        one = {"llm": {"layers": [llama.init_layer(cfg.llm, generator=g, device=dev)]}}
        layers += quantize_loaded(one, cfg, load_bits=4, int4_scheme=scheme)["llm"]["layers"]
        del one
    H, V = cfg.llm.hidden_size, cfg.llm.vocab_size
    llm = {"embed_tokens": (torch.randn((V, H), device=dev, generator=g) * 0.02).to(
               torch.bfloat16),
           "norm": {"weight": torch.ones(H, device=dev)},
           "layers": llama.stack_layers(layers),
           "lm_head": {"weight": torch.randn((V, H), device=dev, generator=g) * 0.02}}
    del layers
    params = quantize_loaded({"vision": vit.init(cfg.vision, **kw),
                              "projector": projector.init(cfg, **kw),
                              "sampler": sampler.init(cfg, **kw), "llm": llm}, cfg,
                             quantize_lm_head=True, quantize_vision=quantize_vision)
    torch.cuda.synchronize()
    fmts = sorted({k for k in params["llm"]["layers"]["q_proj"]["weight"]})
    log(f"quantized SliME-8B ({scheme}, vision "
        f"{'W8A8' if quantize_vision else 'bf16'}) built on the card in "
        f"{time.perf_counter() - t0:.1f} s: LLM layer leaves {fmts}; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    return params


def default_dtype_quantized(dev, cfg, params, fmt):
    """Phase 7 on a 4-bit model (config A: ``fmt`` "q4g", W8A8 tower; config
    B: "q4"): ``llama.forward`` at S = F32_SEQ random ids in fp32 (K7 or K6
    in each linear, the fp32 K5 in each layer); on config A also one W8A8
    encode of bench.py's image in fp32 (``encode_images``: K8 and K4) and
    ``decode_step`` at B = DEFAULT_DTYPE_ROWS (the q4g K1-K3). Returns the
    first runs' launch counts."""
    from slime_tpu_torch.models import llama, slime

    L, vis = cfg.llm.num_layers, cfg.vision.num_layers + cfg.vision.select_layer + 1
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(5, cfg.llm.vocab_size, (1, F32_SEQ))).to(dev)
    last = torch.tensor([F32_SEQ - 1], device=dev)
    kernel = "quant_matmul_q4g_f32" if fmt == "q4g" else "quant_matmul_q4_f32"

    def forward():
        emb = llama.embed(params["llm"], ids).to(torch.float32)
        return llama.forward(params["llm"], emb, cfg.llm, logit_positions=last)[0]
    got = default_dtype_run(f"llama.forward, {fmt} layers, S = {F32_SEQ}", forward,
                            {kernel: (7 * L, True), "flash_fwd_f32": (L, True)})
    if fmt != "q4g":
        return got
    img, q_ids, attn, anyres = query(dev, cfg)

    def encode():
        crops, mask = anyres(img)
        return slime.encode_images(params, cfg, crops[None], mask[None], q_ids, attn)
    tok = torch.from_numpy(rng.integers(5, cfg.llm.vocab_size, (DEFAULT_DTYPE_ROWS,))).to(dev)

    def step():
        cache = llama.init_kv_cache(cfg.llm, DEFAULT_DTYPE_ROWS, 16, device=dev)
        return llama.decode_step(params["llm"], cache, tok, cfg.llm)[0]
    for what, fn, expect in (
            ("W8A8 encode_images (8 crops)", encode,
             {"w8a8_matmul_f32": (4 * vis, True), "encoder_attention_f32": (vis, True)}),
            (f"decode_step at B = {DEFAULT_DTYPE_ROWS}, stacked q4g layers", step,
             {n + "_f32_q4g": (L, True) for n in FUSED})):
        for n, c in default_dtype_run(what, fn, expect).items():
            got[n] += c
    return got


def quantized_serve_phases(dev, cfg):
    """Phases 5 (config A) and 5b (config B); returns their launch counts."""
    from slime_tpu_torch import generate as gen

    torch.cuda.reset_peak_memory_stats()
    params = quantized_model(dev, cfg, "group", quantize_vision=True)
    L = cfg.llm.num_layers
    vis = cfg.vision.num_layers + cfg.vision.select_layer + 1

    def expect(requests, steps):
        exact = {"quant_matmul_q4g_wgmma": 7 * L * requests, "quant_matmul_q4g": 0,
                 "w8a8_matmul": 4 * vis * requests,
                 "encoder_attention": vis * requests, "flash_fwd": L * requests,
                 **{n + "_q4g_ring": L * steps for n in FUSED},
                 **{n + sfx: 0 for n in FUSED for sfx in ("", "_q4g", "_ring")},
                 **{f"quant_matmul_{f}{r}": 0 for f in ("q4", "int8")
                    for r in ("", "_ring", "_wgmma")}}
        return {n: (want, True) for n, want in exact.items()}
    launches = serve("5", dev, cfg, params, expect, "5")
    for n, c in default_dtype_quantized(dev, cfg, params, "q4g").items():
        launches[n] += c
    del params
    torch.cuda.empty_cache()

    # ---------------- phase 5b: config B ----------------
    torch.cuda.reset_peak_memory_stats()
    params = quantized_model(dev, cfg, "absmax", quantize_vision=False)
    img, ids, attn, anyres = query(dev, cfg)
    cfg_run = dataclasses.replace(cfg, eos_token_id=-1)
    n_new = 16
    reset_launch_counts()
    answers, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        crops, mask = anyres(img)
        answers.append(gen.generate(params, cfg_run, ids, attn, crops[None], mask[None],
                                    max_new_tokens=n_new,
                                    compute_dtype=torch.bfloat16).cpu())
        walls.append(time.perf_counter() - t0)
    got = launch_counts()
    log(f"phase 5b launches: {json.dumps(got)}")
    # 7 x L K6 launches in each prefill (2048 rows: wgmma) and each non-fused
    # decode step (1 row: the weight ring), none on the mma.sync instance
    want = {"quant_matmul_q4_wgmma": 7 * L * 2, "quant_matmul_q4_ring": 7 * L * 2 * (n_new - 1),
            "quant_matmul_q4": 0, "flash_fwd": 2 * L}
    if any(got[n] != c for n, c in want.items()):
        raise AssertionError(f"phase 5b: launches {({n: got[n] for n in want})}, expected "
                             f"{want} (2 prefills and {2 * (n_new - 1)} non-fused decode "
                             f"steps)")
    if any(got[n] for n in got if n not in (*want, "encoder_attention")):
        raise AssertionError("phase 5b launched a kernel off its path")
    t0 = time.perf_counter()
    crops, mask = anyres(img)
    gen.generate(params, cfg_run, ids, attn, crops[None], mask[None], max_new_tokens=1,
                 compute_dtype=torch.bfloat16).cpu()
    ttft = time.perf_counter() - t0
    toks = answers[0]
    if (toks.shape != (1, n_new) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.llm.vocab_size or not torch.equal(toks, answers[1])):
        raise AssertionError(f"phase 5b: answers {answers} are out of range or differ")
    log(f"phase 5b: two {n_new}-token requests agree; request wall {walls[0] * 1e3:.1f}, "
        f"{walls[1] * 1e3:.1f} ms; TTFT {ttft * 1e3:.1f} ms (one request, 1 token); "
        f"decode {(n_new - 1) / (walls[1] - ttft):.2f} tok/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # phase 3's stage times and traces for config B: one TTFT and 8 decode
    # steps, K6's device time by instance
    def request(max_new):
        crops, mask = anyres(img)
        return gen.generate(params, cfg_run, ids, attn, crops[None], mask[None],
                            max_new_tokens=max_new, compute_dtype=torch.bfloat16)
    ttfts = []
    for _ in range(3):
        t0 = time.perf_counter()
        request(1).cpu()
        ttfts.append(time.perf_counter() - t0)
    profile_slice("5b", params, cfg_run, ids, attn, img, anyres, request,
                  statistics.median(ttfts) * 1e3)
    for n, c in default_dtype_quantized(dev, cfg, params, "q4").items():
        got[n] += c
    del params
    torch.cuda.empty_cache()
    for n, c in got.items():
        launches[n] += c
    return launches


def train_batches(cfg, rng, n, B):
    """n collated batches of B samples: a 672x672 image cut by the host
    anyres into uint8 crops, ~300 text tokens with the image sentinel, the
    first TRAIN_PROMPT tokens unlabelled, padded to the model's 2048."""
    from PIL import Image

    from slime_tpu_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from slime_tpu_torch.data.dataset import collate
    from slime_tpu_torch.data.image_ops import process_anyres_image_host

    out = []
    for _ in range(n):
        items = []
        for _ in range(B):
            img = Image.fromarray(rng.integers(0, 255, (672, 672, 3), dtype=np.uint8))
            crops, mask, _ = process_anyres_image_host(img, normalize=False)
            ids = rng.integers(5, cfg.llm.vocab_size, TRAIN_TEXT + int(rng.integers(0, 40)))
            ids[0], ids[5] = cfg.bos_token_id, IMAGE_TOKEN_INDEX
            labels = ids.copy()
            labels[:TRAIN_PROMPT] = IGNORE_INDEX
            items.append({"input_ids": ids, "labels": labels, "pixel_values": crops,
                          "crop_mask": mask})
        out.append(collate(items, pad_token_id=cfg.pad_token_id,
                           seq_len=cfg.tokenizer_model_max_length))
    return out


def snapshot(params):
    """Per leaf: a copy (vision, projector, sampler) or, for the 16 GB LLM,
    two integer sums over its bits (any in-place write moves them)."""
    from slime_tpu_torch.params import named_leaves

    snap = {}
    for path, t in named_leaves(params):
        t = t.detach()
        if not path.startswith("llm/"):
            snap[path] = t.clone()
            continue
        bits = t.reshape(-1).view(torch.int16)
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=t.device)
        for c in range(0, bits.numel(), 2 ** 26):
            x = bits[c:c + 2 ** 26].to(torch.int64)
            s1, s2 = s1 + x.sum(), s2 + (x * x).sum()
        snap[path] = torch.stack([s1, s2])
    return snap


def moved_leaves(before, after):
    return sorted(p for p in before if not torch.equal(before[p], after[p]))


def train_phase(dev, cfg, fa):
    """Phase 4: stages 1-3 of the staged pretraining at full width."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from slime_tpu_torch.models import llama, projector, sampler, slime, vit
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.ops.loss import chunked_cross_entropy
    from slime_tpu_torch.params import named_leaves
    from slime_tpu_torch.train.optim import TrainConfig
    from slime_tpu_torch.train.step import init_train_state, make_train_step
    from slime_tpu_torch.train.trainer import RunConfig, run_stage

    bf = torch.bfloat16
    out_dir = Path(__file__).resolve().parent / "bench_out"
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    params = {"vision": vit.init(cfg.vision, generator=g, device=dev, dtype=bf),
              "projector": projector.init(cfg, generator=g, device=dev),
              "sampler": sampler.init(cfg, generator=g, device=dev),
              "llm": llama.init(cfg.llm, generator=g, device=dev, dtype=bf)}
    params["llm"]["layers"] = llama.stack_layers(params["llm"]["layers"])
    torch.cuda.synchronize()
    log(f"phase 4 params built on the card in {time.perf_counter() - t0:.1f} s: LLM "
        f"and CLIP-L bf16, projector and sampler fp32; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    rng = np.random.default_rng(SEED)
    to_dev = lambda b: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}  # noqa: E731
    launches = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    L = cfg.llm.num_layers
    first = None
    for name, cfg_kw, tc_kw, B, steps, moving in TRAIN_STAGES:
        scfg = dataclasses.replace(cfg, **cfg_kw)
        tc = TrainConfig(learning_rate=TRAIN_LR, total_steps=steps, **tc_kw)
        batches = train_batches(cfg, rng, steps, B)
        if first is None:
            first = (scfg, tc, to_dev(batches[0]), params)
        stage_dir = out_dir / f"train_{name.replace(' ', '')}"
        shutil.rmtree(stage_dir, ignore_errors=True)
        before = snapshot(params)
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.fwd_launches = 0
        fa.flash_attention.dkdv_launches = 0
        fa.flash_attention.dq_launches = 0
        t0 = time.perf_counter()
        params, _ = run_stage(params, scfg, tc,
                              RunConfig(output_dir=str(stage_dir), save_steps=0, log_steps=1,
                                        seed=SEED),
                              batches, remat=True,
                              generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"flash_fwd": fa.flash_attention.fwd_launches,
               "flash_bwd_dkdv": fa.flash_attention.dkdv_launches,
               "flash_bwd_dq": fa.flash_attention.dq_launches}
        want = {"flash_fwd": 2 * L * steps, "flash_bwd_dkdv": L * steps,
                "flash_bwd_dq": L * steps}
        log(f"phase 4 {name} launches {json.dumps(got)} (expected {json.dumps(want)}: "
            f"{L} layers x {steps} steps, the forward twice under remat)")
        if got != want:
            raise AssertionError(f"{name}: flash launches {got} != {want}")
        for k in launches:
            launches[k] += got[k]
        recs = [json.loads(line) for line in
                (stage_dir / "metrics.jsonl").read_text().splitlines()]
        for r in recs:
            log(f"phase 4 {name} step {r['step']}: {B * 2048 / r['tokens_per_sec'] * 1e3:.1f} "
                f"ms, {r['tokens_per_sec']:.1f} tokens/s, loss {r['loss']:.5f}, grad_norm "
                f"{r['grad_norm']:.5f}, target tokens {r['target_tokens']}")
        if len(recs) != steps or not all(np.isfinite([r["loss"] for r in recs])):
            raise AssertionError(f"{name}: losses {[r['loss'] for r in recs]}")
        moved = moved_leaves(before, snapshot(params))
        heads = sorted({m for m in moving if any(p.startswith(m) for p in moved)})
        stray = [p for p in moved if not p.startswith(moving)]
        log(f"phase 4 {name}: {len(moved)} leaves moved under {heads}; stage wall "
            f"{wall:.1f} s; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if stray or heads != sorted(moving):
            raise AssertionError(f"{name}: moved {moved}, expected only and all of {moving}")
        del before

    # one stage-1 step with the kernels vs the same step with the plain attention
    scfg, tc, batch, start = first

    def grad_step(use_kernel):
        state, _ = init_train_state(start, tc)
        with fp32_accumulation():
            loss, _ = slime.loss_fn(state["params"], scfg, batch, training=True,
                                    use_kernel=use_kernel, compute_dtype=bf, remat=True)
            loss.backward()
        sq = sum(p.grad.float().square().sum() for _, p in
                 named_leaves(state["params"]["projector"]) if p.grad is not None)
        return float(loss.detach()), float(torch.sqrt(sq))

    (lk, gk), (lp, gp) = grad_step(True), grad_step(False)
    log(f"phase 4 stage-1 step, kernels vs plain attention: loss {lk:.6f} vs {lp:.6f} "
        f"(rel {abs(lk - lp) / abs(lp):.3g}); projector grad norm {gk:.6f} vs {gp:.6f} "
        f"(rel {abs(gk - gp) / abs(gp):.3g}); set {TRAIN_RTOL:g}")
    if abs(lk - lp) > TRAIN_RTOL * abs(lp) or abs(gk - gp) > TRAIN_RTOL * abs(gp):
        raise AssertionError("the kernel step and the plain-attention step disagree")

    # where a stage-1 step's time goes
    state, tx = init_train_state(start, tc)
    step = make_train_step(scfg, tc, tx, remat=True)
    step(state, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = min(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out_dir / "profile_train_step.json"))
    busy, n_kernels, by_name = trace_device(out_dir / "profile_train_step.json")
    groups = {"flash attention (K5, K5b, K5c)": ("flash_",),
              "encoder attention (K4)": ("enc_attn",),
              "GEMMs (cuBLAS)": ("gemm", "xmma", "nvjet", "cutlass", "cublas")}
    split = {k: 0.0 for k in groups}
    split["other kernels, copies"] = 0.0
    for kname, kms in by_name.items():
        low = kname.lower()
        key = next((k for k, pats in groups.items() if any(p in low for p in pats)),
                   "other kernels, copies")
        split[key] += kms
    log(f"phase 4 stage-1 step (B=4, S=2048, remat): host wall {wall:.1f} ms "
        f"(best of 2, unprofiled); device busy {busy:.1f} ms; idle share "
        f"{1 - busy / wall:.3f}; {n_kernels} kernel launches")
    for k, kms in split.items():
        log(f"phase 4 stage-1 step device time {k}: {kms:.1f} ms")
    for part, pat in (("K5 (flash_fwd_kernel)", "flash_fwd_kernel"),
                      ("K5b (flash_bwd_dkdv_kernel)", "flash_bwd_dkdv_kernel"),
                      ("K5c (flash_bwd_dq_kernel)", "flash_bwd_dq_kernel")):
        kms = sum(v for kname, v in by_name.items() if pat in kname)
        n = sum(1 for kname in by_name if pat in kname)
        log(f"phase 4 stage-1 step device time {part}: {kms:.1f} ms ({n} kernel names)")
    for kname, kms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"phase 4 stage-1 step kernel {kms:8.2f} ms  {kname[:90]}")
    del state, tx, step

    with fp32_accumulation():
        vis = host_ms(lambda: slime.encode_images(
            start, scfg, batch["pixel_values"], batch["crop_mask"], batch["input_ids"],
            batch["attention_mask"], compute_dtype=bf))
        hid = torch.randn((4, 2048, cfg.hidden_size), device=dev, generator=g).to(bf)
        hid.requires_grad_()

        def ce():
            total, _ = chunked_cross_entropy(hid, start["llm"]["lm_head"], batch["labels"])
            total.backward()
        ce_ms = host_ms(ce)
        ids = torch.randint(0, cfg.llm.vocab_size, (4, 2048), device=dev, generator=g)
        emb = llama.embed(start["llm"], ids).to(bf)
        llm_fwd = host_ms(lambda: llama.forward(start["llm"], emb, cfg.llm,
                                                compute_dtype=bf, return_hidden=True))
    log(f"phase 4 stage-1 parts (host clock, synchronised, median of 3): encode_images (CLIP-L on "
        f"32 crops, projector, sampler) {vis:.1f} ms; chunked CE forward + backward "
        f"{ce_ms:.1f} ms; frozen LLM forward without grad {llm_fwd:.1f} ms")
    return launches


def context_parallel_phase(dev, cfg):
    """Phase 6: context-parallel prefill at full width on phase 2's int8
    SliME-8B LLM (B = 1, S = CP_SEQ random token ids from the seed, logits
    at the last position) with the counts set to 0 just before and read just
    after: (a) ``llama.forward(ring=4)`` in bf16, the collective ring on 4
    virtual ranks; (b) ``llama.forward`` without a ring in bf16, K5 in each
    layer; (c) K9 on layer 0's RoPE'd q/k/v of that prompt (``embed`` ->
    ``rms_norm`` -> ``linear`` -> ``apply_rope``); (a32) and (b32), (a) and
    (b) with the default fp32 compute dtype (the fp32 K5 in each layer of
    b32); (d) ``llama.forward`` with its default fp32 compute dtype at S =
    F32_SEQ. Then the checks: (a) against (b) (logits; each one's top token
    within the tolerance of the other's top logit), (a32) against (b32)
    (logits and the same argmax), the bf16 noise (the bf16 forward with the
    plain attention beside (a), (b) and (b32)), K9 against its plain
    version, the collective ring and K5's forward, (d) against the same call
    with the plain attention; and the times. Returns the launch counts."""
    from slime_tpu_torch.models import layers as L
    from slime_tpu_torch.models import llama
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.ops import flash_attention as fa
    from slime_tpu_torch.ops import ring_attention as ra
    from slime_tpu_torch.ops import ring_attention_rdma as rd

    bf, lcfg = torch.bfloat16, cfg.llm
    NH, NKV, HD = lcfg.num_heads, lcfg.num_kv_heads, lcfg.head_dim
    params = int8_llm_params(lcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    ids = torch.from_numpy(np.random.default_rng(SEED).integers(
        5, lcfg.vocab_size, (1, CP_SEQ))).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        return out

    def layer0_qkv(emb):
        lp = llama._layer(params["layers"], 0)
        h = L.rms_norm(lp["input_layernorm"], emb, eps=lcfg.rms_norm_eps)
        cos, sin = llama.rope_table(lcfg, lcfg.max_position_embeddings, dev)
        q = llama.apply_rope(L.linear(lp["q_proj"], h).reshape(1, CP_SEQ, NH, HD),
                             cos[:CP_SEQ], sin[:CP_SEQ])
        k = llama.apply_rope(L.linear(lp["k_proj"], h).reshape(1, CP_SEQ, NKV, HD),
                             cos[:CP_SEQ], sin[:CP_SEQ])
        v = L.linear(lp["v_proj"], h).reshape(1, CP_SEQ, NKV, HD)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def top_within(x, y):
        """y's logit at x's top token lies within CP_LOGIT_ATOL of y's top."""
        return float(y[0, 0, int(x.argmax())]) >= float(y.max()) - CP_LOGIT_ATOL

    with fp32_accumulation():
        emb = llama.embed(params, ids).to(bf)
        last = torch.tensor([CP_SEQ - 1], device=dev)
        fwd = lambda **kw: llama.forward(params, emb, lcfg, logit_positions=last,  # noqa: E731
                                         **kw)[0]
        fwd(ring=CP_RANKS, compute_dtype=bf)           # warm-up (allocator, cuBLAS)
        fwd(compute_dtype=bf)
        torch.cuda.synchronize()
        reset_launch_counts()
        ring_logits = timed("(a) forward bf16, ring=4",
                            lambda: fwd(ring=CP_RANKS, compute_dtype=bf))
        after_ring = launch_counts()
        flash_logits = timed("(b) forward bf16, K5", lambda: fwd(compute_dtype=bf))
        q, k, v = layer0_qkv(emb)
        k9 = timed("(c) K9 on layer 0", lambda: rd.ring_attention_rdma(q, k, v, ring=CP_RANKS))
        q32, k32, v32 = layer0_qkv(emb.to(torch.float32))
        k9_32 = timed("(c32) K9 fp32 on layer 0",
                      lambda: rd.ring_attention_rdma(q32, k32, v32, ring=CP_RANKS))
        ring32 = timed("(a32) forward fp32, ring=4", lambda: fwd(ring=CP_RANKS))
        flash32 = timed("(b32) forward fp32, K5 fp32", fwd)
        f32_last = torch.tensor([F32_SEQ - 1], device=dev)
        f32_logits = timed("(d) forward fp32 at S = 2048, K5 fp32", lambda: llama.forward(
            params, emb[:, :F32_SEQ], lcfg, logit_positions=f32_last)[0])
        launches = launch_counts()
        log(f"phase 6 launches on the path: {json.dumps(launches)}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        # the checks (their kernel launches come after the counts were read)
        L_ = lcfg.num_layers
        want = {"ring_attention_rdma": CP_RANKS, "ring_attention_rdma_f32": CP_RANKS,
                "flash_fwd": L_, "flash_fwd_f32": 2 * L_}
        wrong = {n: c for n, c in launches.items() if c != want.get(n, 0)}
        if wrong or any(after_ring.values()):
            raise AssertionError(f"phase 6 launches {wrong} (expected {want}; the ring forward "
                                 f"alone launched {after_ring})")
        V = lcfg.vocab_size
        outs = {"(a)": ring_logits, "(b)": flash_logits, "(a32)": ring32, "(b32)": flash32,
                "(d)": f32_logits}
        for name, lg in outs.items():
            if lg.shape != (1, 1, V) or not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"phase 6 {name}: logits not finite [1, 1, {V}]")
        for (x, y, atol) in (("(a)", "(b)", CP_LOGIT_ATOL), ("(a32)", "(b32)", CP_F32_LOGIT_ATOL)):
            err = (outs[x] - outs[y]).abs().max().item()
            top2 = torch.topk(outs[y][0, 0], 2).values.tolist()
            log(f"phase 6 {x} vs {y}: last-position logits max abs diff {err:.4g} (set "
                f"{atol:g}; logit std {outs[y].std().item():.4g}); argmax "
                f"{int(outs[x].argmax())} vs {int(outs[y].argmax())} ({y}'s top two "
                f"{top2[0]:.4f}, {top2[1]:.4f})")
            if err > atol:
                raise AssertionError(f"phase 6: {x} and {y} disagree")
        if not (top_within(ring_logits, flash_logits) and top_within(flash_logits, ring_logits)):
            raise AssertionError("phase 6: (a)'s and (b)'s top tokens differ by more than the "
                                 "tolerance")
        if int(ring32.argmax()) != int(flash32.argmax()):
            raise AssertionError("phase 6: (a32) and (b32) pick different tokens")
        # the bf16 rounding noise of this model: a third bf16 attention path
        # (the plain one) and each bf16 forward against the fp32 result
        outs["(b-plain)"] = fwd(compute_dtype=bf, use_kernel=False)
        noise = {f"{x} vs {y}": (outs[x] - outs[y]).abs().max().item() for x, y in (
            ("(b-plain)", "(b)"), ("(b-plain)", "(a)"), ("(a)", "(b32)"), ("(b)", "(b32)"),
            ("(b-plain)", "(b32)"))}
        log("phase 6 bf16 noise, last-position logits max abs diff: " + "; ".join(
            f"{k} {e:.4g}" for k, e in noise.items()) + f"; (b-plain) argmax "
            f"{int(outs['(b-plain)'].argmax())}")

        ref = rd.ring_attention_rdma_ref(q, k, v, ring=CP_RANKS)
        err_ref, need = compare("ring_attention_rdma", k9, ref)
        del ref
        others = {"the collective ring": ra.ring_attention(q, k, v, ring=CP_RANKS),
                  "K5's forward": fa.flash_fwd(q, k, v)[0]}
        msg = f"phase 6 (c) K9 on layer 0: vs its plain version max abs err {err_ref:.3g} " \
              f"(floor needed {need:.3g}, set {ATOL['ring_attention_rdma']:g})"
        for name, other in others.items():
            e = (k9.float() - other.float()).abs().max().item()
            msg += f"; vs {name} {e:.3g}"
            torch.testing.assert_close(k9.float(), other.float(), rtol=RTOL, atol=CP_ATTN_ATOL,
                                       msg=lambda m: f"phase 6 K9 vs {name}: {m}")
        log(msg + f" (set {CP_ATTN_ATOL:g})")
        del others
        k9_ms = cuda_ms(lambda: rd.ring_attention_rdma(q, k, v, ring=CP_RANKS), runs=10)
        err32, need32 = compare("ring_attention_rdma_f32", k9_32,
                                ra.ring_attention(q32, k32, v32, ring=CP_RANKS))
        log(f"phase 6 (c32) K9 fp32 on layer 0 vs the collective ring in fp32: max abs err "
            f"{err32:.3g} (floor needed {need32:.3g}, set {ATOL['ring_attention_rdma_f32']:g})")
        k9_32_ms = cuda_ms(lambda: rd.ring_attention_rdma(q32, k32, v32, ring=CP_RANKS), runs=3)

        plain = llama.forward(params, emb[:, :F32_SEQ], lcfg, logit_positions=f32_last,
                              use_kernel=False)[0]
        err = (f32_logits - plain).abs().max().item()
        log(f"phase 6 (d) fp32 forward, K5 fp32 vs plain attention: logits max abs diff "
            f"{err:.4g} (set {F32_LOGIT_ATOL:g}); argmax {int(f32_logits.argmax())} vs "
            f"{int(plain.argmax())}")
        if err > F32_LOGIT_ATOL or int(f32_logits.argmax()) != int(plain.argmax()):
            raise AssertionError("phase 6: the fp32 kernel forward and the plain one disagree")
    for name, ms in walls.items():
        log(f"phase 6 host wall {name}: {ms:.1f} ms")
    log(f"phase 6 K9 device time (4 launches and the kv copies, CUDA events, median of 10): "
        f"{k9_ms:.3f} ms; fp32 (median of 3) {k9_32_ms:.3f} ms; peak memory of (a)-(d) "
        f"{peak:.2f} GiB")
    del params, emb, q, k, v, k9, q32, k32, v32, k9_32
    torch.cuda.empty_cache()
    return launches


def main():
    # ---------------- phase 0 ----------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    from slime_tpu_torch.config import SliMEConfig
    from slime_tpu_torch.ops import _cuda
    from slime_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    log(f"card: {card_line()}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN; phases 1 and 3, generate's and the train "
        "step's own work run with fp32 accumulation (no reduced-precision bf16 "
        "reductions)")
    t0 = time.perf_counter()
    _cuda.library()
    log(f"kernel build: {_cuda.build_seconds if _cuda.build_seconds is not None else 0.0:.2f} s "
        f"nvcc (cached library: {_cuda.build_seconds is None}); load "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = SliMEConfig.slime_8b()

    record = kernel_phase(dev, cfg)                              # phase 1
    launches = serve_phases(dev, cfg)                            # phases 2, 3
    torch.cuda.empty_cache()
    for name, n in train_phase(dev, cfg, fa).items():            # phase 4
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in quantized_serve_phases(dev, cfg).items():     # phases 5, 5b
        launches[name] += n
    torch.cuda.empty_cache()
    for name, n in context_parallel_phase(dev, cfg).items():     # phase 6
        launches[name] += n
    idle = [n for n in KERNELS if n not in OFF_PATH and launches[n] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")

    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], "max_abs_err": record[n]["max_abs_err"],
                "ms": record[n]["ms"], "plain_ms": record[n]["plain_ms"],
                "bound_ms": record[n]["bound_ms"], "bound_by": record[n]["bound_by"],
                "library_ms": record[n]["library_ms"]}
               for n, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
