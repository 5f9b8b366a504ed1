#!/usr/bin/env python3
"""The PyTorch port's main paths on one NVIDIA GPU: SliME-8B serving a query
(int8, and the CLI's 4-bit configurations; several images, beam search, the
identity resampler) and many fine-tunes at once (multi-LoRA), SliME-8B's
staged pretraining, its QLoRA SFT and QLoRA-DPO through the training CLI and
a full-parameter step with 8-bit Adam moments, a context-parallel (ring
attention) prefill of Llama-3-8B's full 8192 positions, and SliME-8B's
evaluation (the eval harness, the benchmark drivers, the video path, the eval
CLI and the checkpoint verifier) in bf16, and the other model families:
Mixtral-8x7B's MoE layers (8 of 32 layers) serving and training, MPT-7B
and a Mamba block.

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
         profiler; K1 in bf16 on int8 weights from 9 rows on tensor cores,
         at B = 9-128 beside its row-per-warp instance on the same inputs;
         K1-K3 beside torch's int8 / int4 weight-only product), and on dense
         bf16 weights at B = 1, 4-6, 8, 9, 20, 40, 64, 65 and 128, K3 also
         at 2, 3 and 7 (all three on the weight ring at B <= 4 and on
         tensor cores from 5; each beside the instances its rule does not
         take on the same inputs, K3's at 1-8; all beside
         torch.nn.functional.linear of the bf16 product), the flash-attention
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

Phase 8  serves through the continuous-batching engine
         (``serve.batch_engine.BatchDecodeEngine``, 4 slots, bf16) on phase
         2's int8 model before it is freed: bench.py's query twice (the
         second hits the prefix cache) and text prompts of 60 and 300
         tokens, 64 greedy tokens each, two submitted at once and two after 4
         ticks. It holds each answer to ``generate``'s (equal, or parted at a
         near tie of generate's logits, ENGINE_TIE_ATOL), counts the launches
         (K4 23 per multimodal admission, K1-K3 on the weight ring 32 each per
         decode step at B = 4 and per chunk of <= 8 rows, K1-K3 on tensor
         cores 32 each per fused chunk of 9-64 rows, K5 never), serves one request through
         ``start()``/``stop()``, cancels one, traces a 4-slot tick at k = 1 and
         k = 8 and the 300-token prompt's two chunks, and runs the int8 KV
         pool twice (finite scales, the same answers, the float pool's first
         tokens), with TTFTs, the aggregate rate and the peak memory.

Phase 9  serves the stack around the engine on phase 2's int8 model (bf16, 4
         slots) before it is freed, with a stand-in byte tokenizer: the
         batched worker's HTTP routes from a thread (two greedy streams of
         61 and 301 tokens submitted together, a ``choices`` grammar
         request, /v1/chat/completions plain and streamed, /v1/completions
         with n = 2, /worker_get_status), held to the in-process engine's
         tokens; then speculative decoding in process (spec_k 4, 8 rounds a
         dispatch) on one 64-token request with a random 0.6B bf16 draft and
         with the target as its own draft: every emitted token is the argmax
         of its verify chunk under the accept rule, the tokens equal the
         plain engine's up to its first near tie, K1-K3 on tensor cores
         launch 32 each a verify chunk and K1-K3 on the ring 32 each a
         plain step (and a
         draft step where the draft is the target). It traces a dispatch of
         8 rounds (draft steps, verify chunk, ingest) and a k = 8 tick with
         one constrained slot against none, and prints the acceptance,
         TTFTs, rates and the grammar's size and compile time.

         Then multi-LoRA on the same model: two random adapters (r = 128,
         alpha = 256, all seven projections, generator seeds 1 and 2)
         written in PEFT layout by ``checkpoint.save_lora_checkpoint`` and
         loaded by ``BatchedWorker.load_adapter``; bench.py's query and one
         text request per adapter, 32 greedy tokens each, submitted
         together: each adapter's answer held to ``generate`` with it
         attached, the query's to the plain engine's (up to a near tie);
         ticks with an adapter slot launch no K1-K3, the ticks after they
         free launch them on the ring; a k = 1 tick traced with and without
         an adapter slot.

Phase 10 runs the training CLI (``slime_tpu_torch.train.cli.main``, the
         port's scripts/train_slime.py) as scripts/llama3_8b_lora_sft.sh
         runs it with --bits 4 (QLoRA: an NF4 LLM, r = 128, alpha = 256,
         llama3 template, S = 2048, modality-grouped batches) plus --remat
         and --gradient-accumulation-steps 2, on SliME-8B at full width,
         its LLM cut to CUT_LAYERS = 8 of 32 layers (for the script's time;
         32 until PR 20), from random weights (a config-only model
         directory), over 16
         records (8 with a 672x672 PNG, 8 text-only, ~300-token
         conversations) and the stand-in byte tokenizer; cut to batch 4 and
         2 micro-steps, with one saved state. The same command then resumes
         from it for 2 more micro-steps and is held to the first trainer
         continued on the same batches; the NF4 base and every frozen leaf
         keep their bytes; the adapter files load back with ``import_peft``;
         the native preprocess library loads and its crops lie within the
         PIL path's bound; K4 launches 23 times a multimodal micro-step, K5
         twice and K5b and K5c once a layer. One micro-step is traced (idle
         share, K5-K5c, the NF4 dequantizing copies) and 2 micro-steps run
         packed
         (--seq-packing, text-only rows: K5 with segment_ids).

         Then the other branches on phase 2's model (counted, inside phase
         2 after multi-LoRA): ``generate`` with two images ([1, 2, 8, 3,
         336, 336], a 4096-position prompt) twice, the same tokens; one
         image through ``prepare_multimodal_multi``, exactly
         ``prepare_multimodal``'s fusion; ``beam_search`` at 3 beams (K1-K3
         on the ring at 3 rows) and at 1 beam against greedy ``generate``,
         the best beam's joint log-prob against greedy's, and one step's
         cache reorder timed alone; a two-image request to the model
         worker over HTTP, the in-process ``generate``'s tokens; the
         identity resampler at full width (mlp2x_gelu, 4 local crops, 5 x
         576 image tokens) through ``generate``, its 'unpad' merge (every
         row the flat merge's or ``image_newline``) and the sampler's
         'spatial' merge (a permutation of the flat rows), exactly.

Phase 11a runs QLoRA-DPO from the CLI: phase 10's QLoRA flags with --task
         DPO --dpo-loss-type sigmoid --dpo-beta 0.1, on phase 10's cut
         model (8 of 32 LLM layers), 2 pairs (4 rows) a
         step, S = 2048, 3 steps over 8 preference records (4 with a
         672x672 image, ~300-byte answers sharing a prompt): the first loss
         log 2 (adapters at B = 0), the NF4 base's bytes kept, the adapters
         moved, K4 2 x 23, K5 3 and K5b and K5c once a layer a step, one
         step traced;
         then an ipo, token-weighted, SFT-mixed command for a step.
Phase 11b builds phase 4's bf16 SliME-8B, its LLM cut to 8 of 32 layers
         (for time; 32 until PR 20), and trains every leaf but the
         tower with 8-bit Adam moments (B = 1, S = 2048, remat) through the
         ``Trainer``: the state's bytes against fp32 Adam's, peak memory,
         step and update times; gate_proj's codes and scales after step 1
         against ``opt8.leaf_update`` on the same gradient (layers 0, 1 and
         the last), exactly; every trainable leaf moved; step 2 after the train
         state's round trip through the host equal to the uninterrupted
         step 2.

Phase 12  builds SliME-8B at full width, its LLM cut to 8 of 32 layers
         (for time; 32 until PR 20), in bf16 throughout (dense
         stacked LLM: what the eval CLI loads a bf16 checkpoint into) and
         runs the evaluation path with a byte tokenizer and EOS off:
         ``eval.harness.run_eval`` on 8 questions over 4 images (16 tokens,
         llama3 template) at batch 4 and at batch 1, equal up to a logged
         near tie, the launches of each request asserted (K4 23, K5 once a
         layer a prefill, dense K1-K3 on the weight ring at up to 4 rows,
         on tensor cores at beam search's 6, once a layer a decode step)
         and one
         batch and the decode step
         traced; ``run_eval(num_beams=3)`` on 2 questions (the best beam's
         prefix leads greedy's after they part, as beam search guarantees);
         ``video.run_video_mme`` on 8 frames of 640x360 against ``generate``
         on ``process_video_frames``' pixels; ``benchmarks.run_mmbench`` with
         circular rounds; the serving engine at the batched worker's
         defaults (8 slots) on 8 text prompts, plainly and speculating with
         a random 0.6B draft (spec_k 4), its tokens against ``generate``'s
         and each other's up to a near tie, the launches of its 8-row
         decode steps, its 64-row fused chunk and its 40-row verify chunks
         asserted (K1-K3 on tensor cores, K3 never row per warp), the chunk
         and an 8-slot tick traced, each also with K3 row per warp from 5
         rows as before (uncounted), a speculative tick traced; then the model, its LLM cut to 2 layers at full
         width (for disk and time only), saved and run through ``eval.cli``
         (2 chunks, ``--merge --scorer textvqa``) and
         ``tools.verify_released_weights`` (record, check: PASS; one
         corrupted weight: FAIL, rc 1).

Phase 13  the other model families. SliME with Mixtral-8x7B (MoE layers:
         8 experts, top 2) at full width, cut to 8 of its 32 layers (its
         bf16 experts hold 2.82 GB a layer: 90.2 GB at 32 layers would not
         fit the card; 16 until PR 20, 8 for the script's time), bf16,
         stacked, from seed 0: ``_moe`` on layer 0 for
         64 tokens (the sparse dispatch) against the same tokens in chunks of
         16 (the dense masked path) in fp32 and bf16, and
         ``moe_ffn_sparse`` against a per-token loop; bench.py's query
         through ``generate`` (32 greedy tokens, K4 23 and K5 8 launches,
         nothing else; the first 8 tokens held to the argmax of a full
         forward teacher-forced on them, in bf16 and in fp32 compute), the
         prefill's and a decode step's device and host times, host syncs and
         the sparse dispatch's share of the prefill; 4 requests through the
         engine with an int8 KV pool, 256-position chunks and k = 1 ticks,
         each held to ``generate`` on an int8 cache, in bf16 and in fp32
         compute. Where two bf16 runs part, every routing of both is taped
         and the first layer whose top-k differs must have done so at a
         router near tie (``router_tie_rule``); in fp32 compute a split must
         be a near tie of the logits. ``slime.loss_fn`` and its backward on 2
         of the layers at S = 2048 with remat and the router aux loss (K5b,
         K5c once a layer; the gates' gradients non-zero). Then MPT-7B at
         full width and depth (bf16 ``forward`` on 2048 ids, top-1 held to
         the fp32 forward of the same weights up to near ties) and a Mamba
         block at d_model 1024 on [5, 577, 1024] (against its scan done one
         position at a time, and causal).

Phase 14  the (data, fsdp, model) mesh over NCCL, one rank a card, at
         min(device_count, 4) ranks (the last phase: at one rank this
         process is rank 0 and destroys its group at the end; at more the
         ranks are spawned). Phase 2's int8 SliME-8B at full width and depth
         sharded by the rule table: bench.py's query through
         ``generate(mesh=...)`` (64 greedy tokens, bit-equal at one rank to
         the unsharded non-fused ``generate``, JAX's decode under a mesh;
         K4 23 and K5 32 launches, K1-K3 none), TTFT, one decode step traced
         (device and host ms, NCCL's kernels); phase 8's four requests
         through the engine with ``mesh=`` (each held to ``generate(mesh)``
         up to a near tie); a LoRA step (r 128 on the int8 base, S = 2048,
         remat, 2 rows a rank, 2 steps) on (1, world, 1) against the
         one-process step on the same global batch (at one rank within the
         one-process step's own repeat spread), step ms, tokens/s, peak GiB,
         K5b and K5c launched; ``moe_ffn_ep`` at Mixtral-8x7B's layer shapes
         (2048 tokens, factor 4: nothing dropped) against
         ``moe_ffn_sparse`` in fp32 (1e-4) and bf16 (8 ulps), timed; then
         the composed multimodal train step (``parallel.composed``) of
         SliME-8B at full width, its LLM cut to 4 of 32 layers (6 at three
         ranks; a memory cut that the stages divide), on the (data, fsdp,
         model, pp) = (1, 1, 1, world) mesh: full-parameter bf16 with AdamW,
         4 rows of 1 + 7 crops, S = 2048, n_micro 4, remat, 2 steps; at one
         rank step 1's loss within the one-process step's own repeat spread
         (``train.step.make_train_step``, run first and freed); K4, K5, K5b
         and K5c launched; step ms, tokens/s, peak GiB beside
         ``memory_plan.plan_mm``'s bytes (JAX's model, recorded);
         ``pipeline_forward`` held to ``llama.forward`` (top-1 up to near
         ties) on the same weights.

``main`` logs each phase's wall time, and all of them in one line before
the records.

The last lines are the kernels' JSON record, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. Any failure raises before that line.
"""
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
import types
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
# could not prove. K2 on dense bf16 weights on an instance that writes its
# bf16 row norm h (the tensor-core one; the row-per-warp one past 8 rows)
# is held in two parts: h to the plain version's up to rounding flips
# (fused_qkvo.norm_flips: one ulp, on values within 2^-17 of a midpoint; a
# flip moves every element of the row that holds the same bf16 x: at 20
# rows on an H100 50 of h's 81920 elements, which moved q, k, v up to
# 2.29e-3 past RTOL from the plain version's, 2.6e-6 from the projections
# of the kernel's own h; PERF.md), and q, k, v to the plain projections of
# that h at ATOL.
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
        "p1_int4_matvec": 2e-3, "p4_q4g_unpack": 1e-4, "p3_int8_dot": 0.0,
        "fused_qkv_decode_dense": 2e-3, "fused_o_residual_dense": 2e-3,
        "fused_mlp_decode_dense": 2e-3, "fused_qkv_decode_dense_ring": 2e-3,
        "fused_mlp_decode_dense_ring": 2e-3, "fused_o_residual_dense_ring": 2e-3,
        "fused_mlp_decode_wgmma": 2e-3, "fused_qkv_decode_wgmma": 2e-3,
        "fused_o_residual_wgmma": 2e-3, "fused_mlp_decode_dense_wgmma": 2e-3,
        "fused_qkv_decode_dense_wgmma": 2e-3, "fused_o_residual_dense_wgmma": 2e-3}
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
# phase 8: the engine's slots, its two text prompts' lengths (the longer one
# is admitted in a 256-position chunk and a fused 64-row one), its cache in
# whole 256-position decode windows, and the bound on generate's logit gap
# at a step where an engine answer parts from generate's: phase 6's bound
# between two bf16 attention paths through the random 32 layers, whose
# logits moved by up to 0.108 there (the engine's chunks and windows are
# other attention paths than generate's one prefill)
ENGINE_SLOTS, ENGINE_TEXT, ENGINE_WINDOW, ENGINE_TIE_ATOL = 4, (60, 300), 256, 0.25
# the rows of that fused chunk (the 300-token prompt's last 44 positions,
# padded to a power of two), where phase 1 times K1-K3's row-per-warp
# instances
CHUNK_ROWS = 64
# the other rows where phase 1 times K1's tensor-core instance (int8, bf16)
# beside its row-per-warp one: with 20 and 64, every tile shape from one
# row past the ring's 8 to one 64-token tile, and 65 and 128 (two tiles);
# K2's and K3's at the first of them (and 20, 64, 65, 128)
K1_WGMMA_ROWS = (9, 16, 32)
# the rows past the dense ring's where phase 1 times K1-K3's dense
# instances (a bf16 checkpoint): 5, one past the ring's 4; 9, one past 8;
# the verify chunks of 4 and 8 slots (20, 40); the fused chunk (64); one
# and two token tiles past it
DENSE_WGMMA_ROWS = (5, 9, 20, 40, 64, 65, 128)
# dense K3 also at every row count of 1-8: its tensor-core instance beside
# the ring at 1-4 (where the rule's boundary lies) and the "was" at 5-8
DENSE_O_ROWS = tuple(range(1, 9)) + DENSE_WGMMA_ROWS[1:]
# phase 9: speculation's proposals a round and rounds a dispatch (the
# engine's defaults), the verify chunk's rows (4 slots x (K + 1)), which
# phase 1 also times; the text prompts' lengths in bytes; the choices
# grammar; the random draft: scripts/bench_spec_engine_8b.py:59-63's 0.6B
# bf16 Llama (Llama-3's vocabulary)
SPEC_K, SPEC_ROUNDS = 4, 8
VERIFY_ROWS = ENGINE_SLOTS * (SPEC_K + 1)
SERVE_TEXT = (60, 300)
CHOICES = ("yes", "no", "maybe")
# phase 9's multi-LoRA adapters (scripts/llama3_8b_lora_sft.sh's rank and
# alpha) and their requests' greedy tokens
LORA_R, LORA_ALPHA, LORA_NEW = 128, 256, 32
DRAFT_LLM = dict(hidden_size=2048, intermediate_size=5504, num_layers=2, num_heads=16,
                 num_kv_heads=8, head_dim=128, rope_theta=500000.0,
                 max_position_embeddings=4096)
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
# phase 10: the training CLI's records (half with an image), its batch
# (scripts/llama3_8b_lora_sft.sh has 16), K4's launches an encode (the
# tower's 23 layers run), and the resume comparison's bound: one bf16 ulp
# of a leaf's largest entry
TRAIN_CLI_RECORDS, TRAIN_CLI_BATCH, TRAIN_CLI_K4 = 16, 4, 23
TRAIN_CLI_RESUME_TOL = 2 ** -8
# phases 2-3's other branches: the two-image and identity prompts' length
# (room for two images' 2 x 1585 tokens and the identity path's 5 x 576), the
# greedy and beam tokens, and the slack of the best beam's joint log-prob
# against greedy's when both are scored again teacher-forced at B = 1 (bf16
# logits of another row count; phase 6 saw bf16 paths move logits by 0.1)
BRANCH_LEN, BRANCH_NEW, BEAM_SCORE_SLACK = 4096, 32, 0.1
# phase 11a: QLoRA-DPO's preference records (half with an image), pairs a
# step (bench_dpo_8b.py's 4 rows) and steps; phase 11b: the full-parameter
# step's learning rate (large enough that one Adam step of +-lr moves a bf16
# 1.0, the norms' weights, by at least an ulp)
DPO_RECORDS, DPO_PAIRS, DPO_STEPS = 8, 2, 3
OPT8_LR = 5e-3
# phases 10, 11a, 11b and 12 run SliME-8B at full width with its LLM cut to
# this many of its 32 layers, for the script's time (they ran at 32 until
# PR 20; the serving phases 2-9 keep all 32)
CUT_LAYERS = 8
# phase 12: the eval harness's questions (on 4 images of these sizes, one
# prompt past a 64-token bucket), new tokens an answer, batch, beams, the
# video's frames and the LLM layers of the checkpoint written for the CLI
EVAL_SIZES = ((672, 672), (1000, 600), (400, 900), (336, 336))
EVAL_QUESTIONS, EVAL_NEW, EVAL_BATCH, EVAL_BEAMS = 8, 16, 4, 3
EVAL_FRAMES, EVAL_CKPT_LAYERS = 8, 2
# phase 12's engine: the batched worker's defaults (max_slots 8, spec_k 4,
# spec_rounds 8, cache_len 2048, a 512 MB prefix cache) on the bf16
# checkpoint; text prompts of random ids (one of 300: its admission ends in
# a fused chunk of its last 44 positions, padded to 64 rows) and the greedy
# tokens of each
EVAL_SLOTS, EVAL_SPEC_K = 8, 4
EVAL_ENGINE_TEXT, EVAL_ENGINE_NEW = (300, 24, 31, 40, 47, 52, 60, 75), 16
# phase 13: Mixtral-8x7B cut to 8 of its 32 layers (a memory cut, one
# layer's bf16 experts are 8 x 3 x 14336 x 4096 x 2 B = 2.82 GB, 90.2 GB at
# 32 layers, over the card's 80 GB; 16 until PR 20, then 8 for the script's
# time) and 2 of them for the training backward; the layer check's tokens
# and dense chunk; tokens a request, the
# first of them held to full forwards; MPT-7B's prompt; the Mamba block's
# input (5 crops of 577 tokens at CLIP-L's width)
MIXTRAL_LAYERS, MIXTRAL_TRAIN_LAYERS = 8, 2
MOE_TOKENS, MOE_CHUNK, MOE_NEW, MOE_FORWARD_TOKENS = 64, 16, 32, 8
# a router near tie (router_tie_rule): the chosen and the dropped expert's
# gate logits within this many bf16 ulps of the row's largest |logit|
ROUTER_TIE_ULPS = 4
MPT_SEQ, MAMBA_SHAPE = 2048, (5, 577, 1024)
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
    # K1-K3's row-per-warp kernels on dense bf16 weights with bf16 activations
    # (the bf16 checkpoints of the eval path before their tensor-core
    # instances; off the paths, phase 1 times them as the "was")
    "fused_qkv_decode_dense": ("slime_tpu_torch/csrc/fused_decode.cu",
                               "slime_tpu/ops/fused_qkvo.py:146"),
    "fused_o_residual_dense": ("slime_tpu_torch/csrc/fused_decode.cu",
                               "slime_tpu/ops/fused_qkvo.py:209"),
    "fused_mlp_decode_dense": ("slime_tpu_torch/csrc/fused_decode.cu",
                               "slime_tpu/ops/fused_mlp.py:366"),
    # K1-K3 (B <= 4) on the weight ring with dense bf16
    # weights: the bf16 checkpoints' decode steps (phase 12)
    "fused_qkv_decode_dense_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                                    "slime_tpu/ops/fused_qkvo.py:146"),
    "fused_mlp_decode_dense_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                                    "slime_tpu/ops/fused_mlp.py:366"),
    "fused_o_residual_dense_ring": ("slime_tpu_torch/csrc/fused_decode.cu",
                                    "slime_tpu/ops/fused_qkvo.py:209"),
    # K1 on tensor cores (bf16 x, int8 weights, B >= 9: the engine's fused
    # chunks, phase 8, and the speculative verify chunk, phase 9): K6's
    # wgmma main loop (csrc/qmm_wgmma.cuh) with a SwiGLU epilogue, then down
    # split over I, launched by slime_mlp_wgmma
    "fused_mlp_decode_wgmma": ("slime_tpu_torch/csrc/fused_decode.cu",
                               "slime_tpu/ops/fused_mlp.py:366"),
    # K2 and K3 on tensor cores (bf16 x, int8 weights, B >= 9: the same
    # chunks): K1's down launch (split_wgmma) over [W_q; W_k; W_v] after the
    # row norm (slime_qkv_wgmma) and over W_o with x as the residual
    # (slime_o_wgmma)
    "fused_qkv_decode_wgmma": ("slime_tpu_torch/csrc/fused_decode.cu",
                               "slime_tpu/ops/fused_qkvo.py:146"),
    "fused_o_residual_wgmma": ("slime_tpu_torch/csrc/fused_decode.cu",
                               "slime_tpu/ops/fused_qkvo.py:209"),
    # K1 and K2 on tensor cores with dense bf16 weights (bf16 x: a bf16
    # checkpoint's fused chunks and verify chunks, and its decode steps
    # past the ring's rows where the rules take them; phase 12's engine):
    # the same launches on the main loop's dense format, each weight tile
    # wgmma's A operand straight from shared memory
    "fused_mlp_decode_dense_wgmma": ("slime_tpu_torch/csrc/fused_decode.cu",
                                     "slime_tpu/ops/fused_mlp.py:366"),
    "fused_qkv_decode_dense_wgmma": ("slime_tpu_torch/csrc/fused_decode.cu",
                                     "slime_tpu/ops/fused_qkvo.py:146"),
    "fused_o_residual_dense_wgmma": ("slime_tpu_torch/csrc/fused_decode.cu",
                                     "slime_tpu/ops/fused_qkvo.py:209"),
}
# the decode kernels with a dense bf16 instance on the weight ring, and on
# tensor cores
DENSE_RING = ("fused_qkv_decode", "fused_o_residual", "fused_mlp_decode")
DENSE_WGMMA = ("fused_qkv_decode", "fused_o_residual", "fused_mlp_decode")
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
# instances in bf16 with q4g weights take B > 8 only (the weight ring takes
# B <= 8 at these widths), which no path sends them (decode runs at B = 1
# and 4; phase 7's B = 65 is fp32); nor do K1-K3's int8 bf16 row-per-warp
# instances take one: K1-K3 run the engine's fused chunks of 9-64 rows
# (phase 8) and the verify chunks (phase 9) on tensor cores (``*_wgmma``;
# phase 1 times the row-per-warp ones as their "was"). K1's and K2's
# row-per-warp instances on dense bf16 weights take no bf16 rows at these
# widths, nor K3's: the ring takes 1-4 and the tensor-core instances the
# rest (phase 12's decode steps, beam search's 6 rows, its engine's ticks,
# fused and verify chunks). Phase 1 checks them; the
# launch counts of these off-path instances stay 0.
OFF_PATH = ("fused_qkv_decode_dense", "fused_o_residual_dense", "fused_mlp_decode_dense",
            "fused_mlp_decode",
            "fused_qkv_decode",
            "fused_o_residual",
            "quant_matmul_int8", "quant_matmul_int8_f32", "quant_matmul_int8_ring",
            "quant_matmul_int8_wgmma", "quant_matmul_q4", "flash_bwd_dkdv_f32",
            "flash_bwd_dq_f32", "quant_matmul_q4g", "ring_attention_rdma_ffma",
            "p1_int4_matvec", "p4_q4g_unpack", "p3_int8_dot") + tuple(
    n + "_q4g" for n in FUSED) + D256 + WIDE


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
        out[n + "_dense"] = (fn, "dense_launches")
        if n in DENSE_RING:
            out[n + "_dense_ring"] = (fn, "dense_ring_launches")
        out[n + "_wgmma"] = (fn, "wgmma_launches")
        if n in DENSE_WGMMA:
            out[n + "_dense_wgmma"] = (fn, "dense_wgmma_launches")
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
        # .ring counts the calls on the weight ring (bf16), .q4g_ring the q4g
        # ones, .dense_ring the dense bf16 ones; .wgmma the calls on tensor
        # cores, .dense_wgmma the dense bf16 ones; .dense every bf16 call on
        # dense weights, on any instance
        ring_q4g, ring_dense = counts[n + "_q4g_ring"], counts.get(n + "_dense_ring", 0)
        wgmma_dense = counts.get(n + "_dense_wgmma", 0)
        counts[n + "_ring"] -= ring_q4g + ring_dense
        counts[n + "_wgmma"] -= wgmma_dense
        counts[n + "_dense"] -= ring_dense + wgmma_dense
        # what is left of .launches in bf16: int8 weights row per warp
        counts[n] -= (counts[n + "_ring"] + counts[n + "_dense"] + ring_dense
                      + counts[n + "_wgmma"] + wgmma_dense)
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
    ATOL[name], or with ``floor`` (a tensor of the output's shape, or a
    tuple of them, one an output) within RTOL, the floor and 1e-6
    elementwise."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    floors = floor if isinstance(floor, tuple) else (floor,) * len(got)
    err = need = 0.0
    for g, w, f in zip(got, want, floors):
        g, w = g.float(), w.float()
        excess = (g - w).abs() - RTOL * w.abs()
        if f is None:
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL[name],
                                       msg=lambda m: f"{name}: kernel vs plain: {m}")
        elif not bool((excess <= f + 1e-6).all()):
            raise AssertionError(f"{name}: kernel vs plain beyond the one-ulp bound by "
                                 f"{(excess - f).max().item():.3g}")
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


def profiled(fn, path, start=None, tries=3):
    """Run fn() under torch.profiler (host and CUDA activities) and write its
    chrome trace to ``path``; ``start()``, where given, runs before each
    session, outside it. A session that recorded no kernel (a process's
    first session can come back empty) is taken again, up to ``tries``
    times, fn() included; returns whether the trace holds a kernel, and
    logs the trace as not measured where it does not."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        if start is not None:
            start()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        if trace_kernel(path, "")[1]:
            return True
    log(f"profiler: no kernel recorded in {tries} sessions; {Path(path).name} not measured")
    return False


def profile_slice(tag, params, cfg, ids, attn, img, anyres, request, ttft_ms):
    """Phase 3 (and 5's and 5b's part of it): stage times (host clock around
    synchronised calls, median of 3) and a torch.profiler trace of one TTFT
    and of PROFILE_STEPS decode steps. Idle share = 1 - device busy / the
    unprofiled host wall time. ``tag`` names the phase in the log and the
    trace files. Returns the traces' summary: for a decode step and the
    TTFT, host and device ms, idle share, launches, and [device ms,
    launches] of each kernel class it names (a trace the profiler left
    empty is missing)."""
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
    summary = {}
    # up to 3 sessions of PROFILE_STEPS steps: 36 + 24 <= N_NEW cache positions
    if profiled(lambda: steps(PROFILE_STEPS), out / f"profile_decode_{tag}.json"):
        summary["decode_step"] = decode_summary(tag, out, step_ms)
    del cache, last

    if profiled(lambda: request(1).cpu(), out / f"profile_ttft_{tag}.json"):
        summary["ttft"] = ttft_summary(tag, out, ttft_ms)
    return summary


def decode_summary(tag, out, step_ms):
    """Phase ``tag``'s traced decode steps: host and device ms per step, idle
    share, launches, and [device ms, launches] per step of each kernel class."""
    busy, launches, by_name = trace_device(out / f"profile_decode_{tag}.json")
    busy /= PROFILE_STEPS
    summary = {"host_ms": step_ms, "device_ms": busy, "idle_share": 1 - busy / step_ms,
               "launches": launches / PROFILE_STEPS, "kernels": {}}
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
        summary["kernels"][what] = [ms / PROFILE_STEPS, n / PROFILE_STEPS]
        log(f"phase {tag} decode {what}: {ms / PROFILE_STEPS:.3f} ms/step of device time over "
            f"{n / PROFILE_STEPS:.0f} launches/step")
    return summary


def ttft_summary(tag, out, ttft_ms):
    """Phase ``tag``'s traced request: host and device ms, idle share,
    launches, and [device ms, launches] of each kernel class it ran."""
    busy, launches, by_name = trace_device(out / f"profile_ttft_{tag}.json")
    summary = {"host_ms": ttft_ms, "device_ms": busy, "idle_share": 1 - busy / ttft_ms,
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
            summary["kernels"][what] = [ms, n]
            log(f"phase {tag} TTFT {what}: {ms:.3f} ms of device time over {n} launches")
    return summary


def check_and_time(record, name, label, kern, ref, moved, ops, peak, flush, main,
                   library=None, dispatch=False, floor=None, clean=False, want=None):
    """Hold kern() to its plain version ref() (or to ``want`` where given)
    and time both (and one PyTorch call computing the same function, where
    there is one). ``moved`` bytes and ``ops`` operations at ``peak`` give
    the bound; the record keeps the ``main`` case, the main path's shape (an
    instance that no main case reaches keeps its first). ``dispatch`` also
    logs the wrapper's host cost per call; ``floor`` is compare's; ``clean``
    also logs kern()'s time with L2 flushed by reading (no write-back
    charged to it)."""
    err, need = compare(name, kern(), ref() if want is None else want, floor)
    rec = record[name]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    ms, plain = cuda_ms(kern, flush=flush), cuda_ms(ref, flush=flush)
    lib = None if library is None else cuda_ms(library, flush=flush)
    b_ms, b_by = bound(moved, ops, peak)
    if main or "ms" not in rec:     # an instance off the main shape keeps its first case
        rec.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    floors = floor if isinstance(floor, tuple) else (floor,)
    tol = (f"set {ATOL[name]:g}" if floor is None
           else f"one-ulp bound up to {max(f.max().item() for f in floors):.3g}")
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


def short_kernel(name):
    """A profiler kernel name without its return type, namespace and
    arguments (a kernel that is not a template has no "void " in front)."""
    return name.removeprefix("void ").removeprefix("(anonymous namespace)::").split("(")[0]


def decode_kernels(dev, cfg, g, flush, record):
    """Phase 1 for K1-K3 at 8B width, layer 1 of a 2-layer stack: int8 (B =
    1, 8) and q4g (B = 1, 64) in bf16, as before; then, from a generator of
    their own, both formats at B = 65 and 128 in bf16 (one launch each, past
    the former 64-row limit) and at B = 1 and 65 in fp32 (the default
    compute dtype), q4g at B = 8 and int8 at B = 64 (the engine's fused
    chunk, phase 8), 20 (the verify chunk, phase 9) and 9 in bf16, and K1
    alone at K1_WGMMA_ROWS' other rows. The records keep B = 1; K1-K3
    in bf16 at B <= 8 take the weight ring (``*_ring``, ``*_q4g_ring``: the
    routing rule of each wrapper), whose launches' device time (profiler)
    is logged at B = 1 and 8, and the row-per-warp bf16 instances keep
    B = 64. K1-K3 in bf16 on int8 weights at B >= 9 take their tensor-core
    instances (``*_wgmma``, records kept at B = 64; their launches' device
    times logged at 20 and 64), each timed beside the row-per-warp instance
    on the same inputs (``route="rows"``, uncounted: the "was" lines,
    records ``fused_qkv_decode`` etc.); at B = 8 the tensor-core instances
    are also timed where the rule keeps the ring, and K2's at 20 and 64 rows
    also in 3 splits of H (a partial second wave) beside the plan's 2. K2
    and K3 are timed beside one PyTorch call of their int8 or q4g product
    alone (``decode_library``; in fp32 where the installed torch takes fp32
    x, else the reason is logged), K1 beside two: [W_gate; W_up], then
    W_down on a fixed intermediate (in fp32 likewise). The MLP in bf16 is
    held to the one-ulp bound of its bf16 intermediate."""
    from slime_tpu_torch.ops import fused_mlp, fused_qkvo
    from slime_tpu_torch.probes.mlp_decode import profile_split

    cfg2 = dataclasses.replace(cfg.llm, num_layers=2)
    H, NQ = cfg2.hidden_size, cfg2.num_heads * cfg2.head_dim
    NKV, I = cfg2.num_kv_heads * cfg2.head_dim, cfg2.intermediate_size
    g_new = torch.Generator(device=dev).manual_seed(SEED + 3)
    g_q4g8 = torch.Generator(device=dev).manual_seed(SEED + 10)
    g_chunk = torch.Generator(device=dev).manual_seed(SEED + 11)
    g_k1 = torch.Generator(device=dev).manual_seed(SEED + 13)
    g_mid32 = torch.Generator(device=dev).manual_seed(SEED + 15)
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
        # each wrapper's routing rule: (B, dtype) -> the record suffix of the
        # instance it takes ("_ring", "_wgmma", or "" row per warp)
        sfx_of = {"ring": "_ring", "wgmma": "_wgmma", "rows": ""}
        routes = {"fused_qkv_decode": lambda B, d: sfx_of[fused_qkvo.k2_route(
                      B, d, code, H, NQ, NKV, sms)],
                  "fused_o_residual": lambda B, d: sfx_of[fused_qkvo.k3_route(
                      B, d, code, NQ, H, sms)],
                  "fused_mlp_decode": lambda B, d: sfx_of[fused_mlp.k1_route(
                      B, d, code, H, I, sms)]}
        # each wrapper's launches on a given instance (uncounted; K2 and K3
        # also split otherwise than the plan where n is given)
        forced = {"fused_qkv_decode": lambda x, a, r, n=None: fused_qkvo.qkv_launch(
                      x, two, 1, 1e-5, route=r, splits=n)[:3],
                  "fused_o_residual": lambda x, a, r, n=None: fused_qkvo.o_launch(
                      a, x, two, 1, route=r, splits=n)[0],
                  "fused_mlp_decode": lambda x, a, r, n=None: fused_mlp.mlp_launch(
                      x, two, 1, 1e-5, route=r)[0]}
        # K1's yardstick: [W_gate; W_up] then W_down on a fixed intermediate
        # (mid), each one PyTorch call of the int8 or int4 product alone
        mats = [two[n]["weight"] for n in ("gate_proj", "up_proj", "down_proj")]
        if fmt == "int8":
            gu_q = torch.cat([m["q"][1] for m in mats[:2]])
            gu_s = torch.cat([m["scale"][1, :, 0] for m in mats[:2]])

            def k1_library(x, mid):
                f1 = int8pack_library("fused_mlp_decode", x, gu_q, gu_s)
                f2 = int8pack_library("fused_mlp_decode", mid, mats[2]["q"][1],
                                      mats[2]["scale"][1, :, 0])
                return None if f1 is None or f2 is None else (lambda: (f1(), f2()))
        else:
            gu_w = {"q4g": torch.cat([m["q4g"][1] for m in mats[:2]]),
                    "scale": torch.cat([m["scale"][1] for m in mats[:2]])}
            dn_w = {"q4g": mats[2]["q4g"][1], "scale": mats[2]["scale"][1]}

            def k1_library(x, mid):
                f1 = int4pack_library(x, gu_w, "fused_mlp_decode_q4g")
                f2 = int4pack_library(mid, dn_w, "fused_mlp_decode_q4g")
                return None if f1 is None or f2 is None else (lambda: (f1(), f2()))
        # (activation dtype, record suffix, batch sizes, generator, the one
        # kernel timed or None for all three)
        runs = ((bf, "", batches, g, None), (bf, "", (65, 128), g_new, None),
                (f32, "_f32", (1, 65), g_new, None))
        if fmt == "q4g":
            runs += ((bf, "", (8,), g_q4g8, None),)
        else:       # the engine's fused chunk (phase 8): 64 rows; the verify
            # chunk (phase 9): 20 rows; the tensor-core instances' first row
            # (9) and K1's other ones
            runs += ((bf, "", (CHUNK_ROWS, VERIFY_ROWS), g_chunk, None),
                     (bf, "", K1_WGMMA_ROWS[:1], g_k1, None),
                     (bf, "", K1_WGMMA_ROWS[1:], g_k1, "fused_mlp_decode"))
        for dtype, dsfx, bs, gen, only in runs:
            for B in bs:
                x = torch.randn((B, H), device=dev, generator=gen).to(dtype)
                a = torch.randn((B, NQ), device=dev, generator=gen).to(dtype)
                mid = torch.randn((B, I), device=dev,
                                  generator=g_k1 if dtype == bf else g_mid32).to(dtype)
                for name, (kern, ref, reads, cols, macs) in cases.items():
                    if only not in (None, name):
                        continue
                    acts = (x, a) if name == "fused_o_residual" else (x,)
                    floor = (fused_mlp.intermediate_ulp_bound(x, two, 1)
                             if name == "fused_mlp_decode" and dtype == bf else None)
                    sfx = routes[name](B, dtype)
                    library = (decode_library(name, fmt, two, x, a)
                               if name != "fused_mlp_decode" else k1_library(x, mid))
                    moved = nbytes(*acts, *reads) + B * cols * x.element_size()
                    ops, peak = 2 * B * macs, BF16_OPS if dtype == bf else F32_OPS
                    label = f"8B width {fmt} {'bf16' if dtype == bf else 'fp32'} B={B} layer 1"
                    check_and_time(record, name + dsfx + fsfx + sfx, label,
                                   lambda: kern(x, a), lambda: ref(x, a), moved, ops, peak,
                                   flush, main=B in (1, CHUNK_ROWS), dispatch=B == 1,
                                   floor=floor, library=library)
                    if sfx == "_wgmma":
                        # the row-per-warp instance on the same inputs (uncounted)
                        check_and_time(record, name, label + " (was: the row-per-warp "
                                       "instance)", lambda: forced[name](x, a, "rows"),
                                       lambda: ref(x, a), moved, ops, peak, flush,
                                       main=B == CHUNK_ROWS, floor=floor, library=library)
                    if name == "fused_qkv_decode" and sfx == "_wgmma" and B in (
                            VERIFY_ROWS, CHUNK_ROWS):
                        # 3 splits of H (144 blocks a token tile: a partial second
                        # wave) against the plan's one wave (uncounted)
                        plan = fused_qkvo.wgmma_plan(B, NQ + 2 * NKV, H, sms)[0]
                        check_and_time(record, name + sfx, label + " (3 splits, not the "
                                       f"plan's {plan})", lambda: forced[name](x, a, "wgmma", 3),
                                       lambda: ref(x, a), moved, ops, peak, flush,
                                       main=False, library=library)
                    if fmt == "int8" and dtype == bf and B == 8:
                        # the tensor-core instance where the rule keeps the ring
                        check_and_time(record, name + "_wgmma", label + " (the tensor-core "
                                       "instance, which the rule does not take here)",
                                       lambda: forced[name](x, a, "wgmma"),
                                       lambda: ref(x, a), moved, ops, peak, flush,
                                       main=False, floor=floor, library=library)
                    if (sfx == "_ring" and B in (1, 8)) or (sfx == "_wgmma"
                                                            and B in (VERIFY_ROWS, CHUNK_ROWS)):
                        split, span = profile_split(lambda: kern(x, a), flush)
                        log(f"phase 1 {name}{fsfx}{sfx} {fmt} B={B} launches "
                            f"(profiler, device ms each, L2 flushed): "
                            + (", ".join(f"{short_kernel(n)} {ms:.4f}" for n, ms in split.items())
                               + f"; first start to last end {span:.4f} ms" if split
                               else "not measured (the profiler recorded no kernel)"))
        del two, cases


def dense_llm_layers(cfg, generator, device):
    """Random stacked decode layers on dense bf16 weights, N(0, 0.02): what
    a bf16 checkpoint loads into (``checkpoint.load_for_serving``)."""
    H, HD, I, NL = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.num_layers

    def w(out_d, in_d):
        return (torch.randn((NL, out_d, in_d), device=device, generator=generator)
                * 0.02).to(torch.bfloat16)

    ones = lambda *s: torch.ones(s, device=device)     # noqa: E731
    return {"input_layernorm": {"weight": ones(NL, H)},
            "q_proj": {"weight": w(cfg.num_heads * HD, H)},
            "k_proj": {"weight": w(cfg.num_kv_heads * HD, H)},
            "v_proj": {"weight": w(cfg.num_kv_heads * HD, H)},
            "o_proj": {"weight": w(H, cfg.num_heads * HD)},
            "post_attention_layernorm": {"weight": ones(NL, H)},
            "gate_proj": {"weight": w(I, H)},
            "up_proj": {"weight": w(I, H)},
            "down_proj": {"weight": w(H, I)}}


def dense_decode_kernels(dev, cfg, flush, record):
    """Phase 1 for K1-K3 on dense bf16 weights (a bf16 checkpoint: the eval
    path and phase 12's engine) at 8B width, layer 1 of a 2-layer stack,
    from a generator of their own: all three at B = 1, 4, 6, 8 and at
    DENSE_WGMMA_ROWS (5, the verify chunks of 4 and 8 slots, the fused
    chunk, one and two token tiles past it), K3 also at 2, 3 and 7
    (DENSE_O_ROWS: every row count of 1-8). Each runs the instance
    its wrapper's rule takes (``k1_route``, ``k2_route``, ``k3_route``:
    records ``*_dense_ring``, ``*_dense_wgmma`` or ``*_dense`` row per
    warp; the ring's records keep B = 1, the tensor-core ones B = 64), and
    is timed beside the instances the rule does not take on the same inputs
    (``fused_mlp.mlp_launch`` with ``route``, ``fused_qkvo.qkv_launch`` /
    ``o_launch`` alike, uncounted): at 4-8 rows every instance there is
    (K3 at 1-8), at 1 and from 9 the row-per-warp one ("was": the instance
    the rule took before the ring or the tensor-core ones). The
    tensor-core instances have their launches' device times (profiler)
    logged at 64 rows, as the ring's at 1 and 4. Each is timed
    beside ``torch.nn.functional.linear`` of its bf16 product alone on the
    same weights (K2: W_q, W_k, W_v concatenated; K3: W_o; K1: W_gate and
    W_up concatenated, then W_down on a fixed intermediate), a yardstick;
    the MLP is held to the one-ulp bound of its bf16 intermediate, K2 on
    tensor cores, and row per warp off the decode rows 1, 4, 6 and 8, to
    the plain projections of the row norm it wrote (``qkv_own_norm``)."""
    import torch.nn.functional as F

    from slime_tpu_torch.ops import fused_mlp, fused_qkvo
    from slime_tpu_torch.probes.mlp_decode import profile_split

    bf = torch.bfloat16
    cfg2 = dataclasses.replace(cfg.llm, num_layers=2)
    H, NQ = cfg2.hidden_size, cfg2.num_heads * cfg2.head_dim
    NKV, I = cfg2.num_kv_heads * cfg2.head_dim, cfg2.intermediate_size
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    two = dense_llm_layers(cfg2, g, dev)
    w = lambda *names: [two[n]["weight"][1] for n in names]     # noqa: E731
    wqkv = torch.cat(w("q_proj", "k_proj", "v_proj"))
    wgu = torch.cat(w("gate_proj", "up_proj"))
    wo, wd = w("o_proj")[0], w("down_proj")[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    D = fused_qkvo.DENSE
    routes = {"fused_qkv_decode": lambda B: fused_qkvo.k2_route(B, bf, D, H, NQ, NKV, sms),
              "fused_o_residual": lambda B: fused_qkvo.k3_route(B, bf, D, NQ, H, sms),
              "fused_mlp_decode": lambda B: fused_mlp.k1_route(B, bf, D, H, I, sms)}
    # the instance each rule took before the tensor-core ones (the "was")
    before = {"fused_qkv_decode": lambda B: "ring" if B <= 8 else "rows",
              "fused_o_residual": lambda B: "ring" if B <= fused_qkvo.DENSE_O_RING_ROWS
              else "rows",
              "fused_mlp_decode": lambda B: "ring" if B <= fused_mlp.DENSE_RING_ROWS
              else "rows"}
    sfx = {"ring": "_dense_ring", "wgmma": "_dense_wgmma", "rows": "_dense"}
    what = {"ring": "the weight ring", "wgmma": "the tensor-core instance",
            "rows": "the row-per-warp instance"}
    # the decode rows at which all three run, every instance held to the
    # plain version outright where it does not run on tensor cores
    decode_rows = (1, 4, 6, 8)
    for B in sorted(set(decode_rows) | set(DENSE_WGMMA_ROWS) | set(DENSE_O_ROWS)):
        x = torch.randn((B, H), device=dev, generator=g).to(bf)
        a = torch.randn((B, NQ), device=dev, generator=g).to(bf)
        mid = torch.randn((B, I), device=dev, generator=g).to(bf)
        # name: (kernel, plain, library, the instances on the same inputs
        # (uncounted), layer-1 tensors read, activations, output columns,
        # MACs per row)
        cases = {
            "fused_qkv_decode": (lambda: fused_qkvo.fused_qkv_decode(x, two, 1),
                                 lambda: fused_qkvo.fused_qkv_decode_ref(x, two, 1),
                                 lambda: F.linear(x, wqkv),
                                 lambda r: fused_qkvo.qkv_launch(x, two, 1, 1e-5, route=r)[:3],
                                 w("input_layernorm", "q_proj", "k_proj", "v_proj"), (x,),
                                 NQ + 2 * NKV, H * (NQ + 2 * NKV)),
            "fused_o_residual": (lambda: fused_qkvo.fused_o_residual(a, x, two, 1),
                                 lambda: fused_qkvo.fused_o_residual_ref(a, x, two, 1),
                                 lambda: F.linear(a, wo),
                                 lambda r: fused_qkvo.o_launch(a, x, two, 1, route=r)[0],
                                 w("o_proj"), (x, a), H, NQ * H),
            "fused_mlp_decode": (lambda: fused_mlp.fused_mlp_decode(x, two, 1),
                                 lambda: fused_mlp.fused_mlp_decode_ref(x, two, 1),
                                 lambda: (F.linear(x, wgu), F.linear(mid, wd)),
                                 lambda r: fused_mlp.mlp_launch(x, two, 1, 1e-5, route=r)[0],
                                 w("post_attention_layernorm", "gate_proj", "up_proj",
                                   "down_proj"), (x,), H, 3 * H * I),
        }
        for name, (kern, ref, lib, forced, reads, acts, cols, macs) in cases.items():
            k3 = name == "fused_o_residual"
            if B not in (DENSE_O_ROWS if k3 else decode_rows + DENSE_WGMMA_ROWS):
                continue
            floor = (fused_mlp.intermediate_ulp_bound(x, two, 1)
                     if name == "fused_mlp_decode" else None)
            own = lambda r: (qkv_own_norm(x, two, 1, r, f"B={B} {what[r]}")  # noqa: E731
                             if name == "fused_qkv_decode" and r != "ring"
                             and (r == "wgmma" or B not in decode_rows) else None)
            route = routes[name](B)
            moved = nbytes(*acts, *reads) + B * cols * x.element_size()
            label = f"8B width dense bf16 B={B} layer 1"
            # the host's cost a call also where K3's boundary lies (4 rows)
            host = B == 1 or (k3 and B == 4)
            check_and_time(record, name + sfx[route], f"{label} ({what[route]})", kern, ref,
                           moved, 2 * B * macs, BF16_OPS, flush,
                           main=B == (CHUNK_ROWS if route == "wgmma" else 1),
                           dispatch=host, floor=floor, library=lib, want=own(route))
            # K3's tensor-core instance also at 1-4, beside the ring: where
            # its boundary (fused_qkvo.DENSE_O_RING_ROWS) lies
            others = (["rows"] if B > 8 or (B == 1 and not k3)
                      else ["ring", "rows", "wgmma"])
            for other in others:
                if other == route:
                    continue
                was = "rows" if route == "ring" else before[name](B)
                kind = ("was: " if other == was else "") + what[other]
                check_and_time(record, name + sfx[other], f"{label} ({kind}, which the rule "
                               "does not take here)", lambda: forced(other), ref, moved,
                               2 * B * macs, BF16_OPS, flush, main=False, floor=floor,
                               library=lib, want=own(other),
                               dispatch=k3 and B == 4 and other in ("ring", "wgmma"))
            if (route == "ring" and B in (1, 4)) or (route == "wgmma" and B == CHUNK_ROWS):
                split, span = profile_split(kern, flush)
                log(f"phase 1 {name}{sfx[route]} B={B} launches (profiler, device ms each, "
                    f"L2 flushed): "
                    + (", ".join(f"{short_kernel(n)} {ms:.4f}" for n, ms in split.items())
                       + f"; first start to last end {span:.4f} ms" if split
                       else "not measured (the profiler recorded no kernel)"))
    del two, wqkv, wgu


def qkv_own_norm(x, layers, li, route, label, eps=1e-5):
    """What K2's instance ``route`` (one that writes its bf16 row norm h:
    "wgmma", "rows") is held to on dense bf16 weights: the plain
    projections of the h it wrote (``fused_qkvo.qkv_proj_ref``), once h
    has been held to the plain version's up to rounding flips
    (``fused_qkvo.norm_flips``; raises on any other difference). Logs the
    flips and how far q, k, v stand from the plain version's own (the
    floor that comparison would need at RTOL)."""
    from slime_tpu_torch.ops import fused_qkvo
    *out, _, _, h = fused_qkvo.qkv_launch(x, layers, li, eps, route=route)
    flips, bad = fused_qkvo.norm_flips(h, x, layers["input_layernorm"]["weight"][li], eps)
    if bad:
        raise AssertionError(f"fused_qkv_decode {label}: {bad} elements of its row norm h "
                             f"differ from the plain version's by more than a rounding flip")
    need = max(((a.float() - b.float()).abs() - RTOL * b.float().abs()).max().item()
               for a, b in zip(out, fused_qkvo.fused_qkv_decode_ref(x, layers, li)))
    log(f"phase 1 fused_qkv_decode dense {label}: h differs from the plain version's in "
        f"{flips} of {h.numel()} elements, each a rounding flip; q, k, v against the plain "
        f"version's own h: floor needed {need:.3g}")
    return fused_qkvo.qkv_proj_ref(h, layers, li)


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
        dense_decode_kernels(dev, cfg, flush, record)
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


def teacher_logits(params, cfg, ids, attn, pv, cm, tokens, j, dtype=torch.bfloat16,
                   kv_quant=False):
    """``generate``'s logits [V] at answer step j (``dtype`` compute, a float
    or with ``kv_quant`` an int8 cache), given its tokens before j: its
    prefill, then its decode steps on its own cache (length L + N_NEW), as
    ``generate`` runs them."""
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import llama
    from slime_tpu_torch.models.layers import fp32_accumulation

    with torch.no_grad(), fp32_accumulation():
        logits, kvs, lengths, L = gen.prefill(params, cfg, ids, attn, pv, cm, dtype)
        cache = llama.prefill_into_cache(
            llama.init_kv_cache(cfg.llm, 1, L + N_NEW, dtype=dtype, device=ids.device,
                                quantized=kv_quant), kvs, lengths)
        del kvs
        for i in range(1, j + 1):
            tok = torch.tensor([tokens[i - 1]], device=ids.device)
            logits, cache = llama.decode_step(params["llm"], cache, tok, cfg.llm,
                                              compute_dtype=dtype)
    return logits[0].float()


def check_answer(name, got, want, logits_at, phase="8"):
    """An engine answer against ``want`` (``generate``'s, or the engine's
    own on the plain path): equal, or parted at a near tie: at the first
    step where they differ, generate's logit of the engine's token lies
    within ENGINE_TIE_ATOL of that of ``want``'s token. Returns the step and
    gap (None when equal)."""
    if len(got) != len(want):
        raise AssertionError(f"phase {phase} {name}: {len(got)} tokens, the reference gave "
                             f"{len(want)}")
    if got == want:
        log(f"phase {phase} {name}: {len(got)} tokens equal")
        return None
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    lg = logits_at(j)
    gap = float(lg[want[j]] - lg[got[j]])
    log(f"phase {phase} {name}: parts at step {j} (here {got[j]}, reference {want[j]}): "
        f"generate's logit gap {gap:.4g} (near-tie bound {ENGINE_TIE_ATOL}); equal before it")
    if not abs(gap) <= ENGINE_TIE_ATOL:
        raise AssertionError(f"phase {phase} {name}: not a near tie at step {j}: gap {gap:.4g}")
    return j, gap


def chunk_launches(llm, chunks, sms):
    """K1-K3's launches over int8 bf16 chunks {padded rows: count} of 9-64
    rows (the engine's fused chunks, the speculative verify chunks): each on
    the instance its rule takes (``k1_route``, ``k2_route``, ``k3_route``:
    tensor cores from ``K1_WGMMA_MIN_ROWS`` rows), each once a layer."""
    from slime_tpu_torch.ops import fused_mlp, fused_qkvo
    H, I = llm.hidden_size, llm.intermediate_size
    NQ, NKV = llm.num_heads * llm.head_dim, llm.num_kv_heads * llm.head_dim
    out = {n + sfx: 0 for n in FUSED for sfx in ("", "_wgmma")}
    for c, n in chunks.items():
        if not 8 < c <= 64:
            continue
        bf, fmt = torch.bfloat16, fused_qkvo.INT8
        for name, route in (("fused_qkv_decode", fused_qkvo.k2_route(c, bf, fmt, H, NQ, NKV,
                                                                     sms)),
                            ("fused_o_residual", fused_qkvo.k3_route(c, bf, fmt, NQ, H, sms)),
                            ("fused_mlp_decode", fused_mlp.k1_route(c, bf, fmt, H, I, sms))):
            out[name + ("_wgmma" if route == "wgmma" else "")] += llm.num_layers * n
    return out


def engine_phase(dev, cfg, params):
    """Phase 8: the continuous-batching engine (``serve.batch_engine``) on
    phase 2's int8 model, bf16 compute; returns the launch counts of the
    float engine's run."""
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import llama, slime
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request

    bf = torch.bfloat16
    out = Path(__file__).resolve().parent / "bench_out"
    out.mkdir(exist_ok=True)
    cfg_run = dataclasses.replace(cfg, eos_token_id=-1)
    V, NL = cfg.llm.vocab_size, cfg.llm.num_layers
    vis = cfg.vision.num_layers + cfg.vision.select_layer + 1
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    img, ids, attn, anyres = query(dev, cfg)
    crops, mask = anyres(img)
    with torch.no_grad(), fp32_accumulation():
        fused_len = int(slime.prepare_multimodal(params, cfg, ids, attn, crops[None],
                                                 mask[None], compute_dtype=bf).lengths[0])
    # the fused query and its answer, with the one position the fusion's
    # max_len (cache_len - max_new_tokens - 1) leaves, in whole windows
    cache_len = -(-(fused_len + N_NEW + 1) // ENGINE_WINDOW) * ENGINE_WINDOW
    rng = np.random.default_rng(SEED + 12)
    text = [rng.integers(5, V, (n,)) for n in ENGINE_TEXT]
    ids_np = ids[0].cpu().numpy()
    # (name, input_ids, pixel_values, crop_mask); the first two are submitted
    # at once, the last two after 4 ticks
    prompts = [("query A", ids_np, crops, mask), (f"text {ENGINE_TEXT[0]}", text[0], None, None),
               ("query B", ids_np, crops, mask), (f"text {ENGINE_TEXT[1]}", text[1], None, None)]
    log(f"phase 8 engine: max_slots {ENGINE_SLOTS}, cache_len {cache_len} (the query fuses to "
        f"{fused_len} positions), prefill_chunk_len 256, multi_step 8, prefix cache 512 MB, "
        f"bf16; requests: the query twice, text prompts of {ENGINE_TEXT} tokens, "
        f"{N_NEW} greedy tokens each")

    def as_tensors(p):
        t = torch.from_numpy(p[1][None].astype(np.int64)).to(dev)
        return (t, torch.ones_like(t, dtype=torch.bool),
                None if p[2] is None else p[2][None], None if p[3] is None else p[3][None])
    refs = {}
    for p in prompts[:2] + prompts[3:]:
        refs[p[1].size] = gen.generate(params, cfg_run, *as_tensors(p), max_new_tokens=N_NEW,
                                       compute_dtype=bf)[0].tolist()

    def run(kv_quant):
        """Drive the four requests through tick(); -> (engine, answers, TTFTs
        in s, wall s, launch counts, peak GiB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = BatchDecodeEngine(params, cfg_run, max_slots=ENGINE_SLOTS, cache_len=cache_len,
                                compute_dtype=bf, kv_quant=kv_quant, device=dev)
        reqs = [Request(input_ids=p[1], pixel_values=p[2], crop_mask=p[3],
                        max_new_tokens=N_NEW) for p in prompts]
        ttft = [None] * 4
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs[:2]:
            eng.submit(r)
        for tick in range(1, 4000):
            n = eng.tick()
            if tick == 4:
                for r in reqs[2:]:
                    eng.submit(r)
            for i, r in enumerate(reqs):
                if ttft[i] is None and not r.out_queue.empty():
                    ttft[i] = time.monotonic() - r._t_submit
            if tick > 4 and n == 0 and eng.pending.empty() and eng._admission is None:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if any(s is not None for s in eng.slots) or not eng.pending.empty():
            raise AssertionError("phase 8: the engine did not finish its requests")
        answers = [[t for c in r.stream() for t in c] for r in reqs]
        return eng, answers, ttft, wall, counts, torch.cuda.max_memory_allocated() / 2 ** 30

    eng, answers, ttft, wall, counts, peak = run(False)
    ring = sum(n for c, n in eng.chunk_rows.items() if c <= 8)
    rpw = sum(n for c, n in eng.chunk_rows.items() if 8 < c <= 64)
    log(f"phase 8 float cache: {sum(map(len, answers))} tokens in {wall:.3f} s "
        f"({sum(map(len, answers)) / wall:.2f} tok/s aggregate, admissions included); "
        f"{eng.decode_steps} decode steps at B = {ENGINE_SLOTS}; chunks by padded rows "
        f"{dict(sorted(eng.chunk_rows.items()))}; peak memory {peak:.2f} GiB")
    for (name, *_), t in zip(prompts, ttft):
        log(f"phase 8 TTFT {name}: {t * 1e3:.1f} ms (submit to the tick that emitted its "
            f"first token)")
    log(f"phase 8 metrics_summary: {json.dumps(eng.metrics_summary())}")
    log(f"phase 8 prefix cache: {json.dumps(eng.prefix_cache_stats())}")
    log(f"phase 8 launches: {json.dumps({n: c for n, c in counts.items() if c})}")
    want = {"encoder_attention": 2 * vis, "flash_fwd": 0,
            **{n + "_ring": NL * (eng.decode_steps + ring) for n in FUSED},
            **chunk_launches(cfg.llm, eng.chunk_rows, sms)}
    wrong = {n: c for n, c in counts.items() if c != want.get(n, 0)}
    if wrong or not rpw:
        raise AssertionError(f"phase 8 launches {wrong} (expected {want}); fused chunks of "
                             f"9-64 rows: {rpw}")
    for p, got in zip(prompts, answers):
        args = as_tensors(p)
        want_toks = refs[p[1].size]
        check_answer(p[0], got, want_toks,
                     lambda j: teacher_logits(params, cfg_run, *args, want_toks, j))

    # one request through the engine's own thread
    eng.start()
    try:
        got = [t for c in eng.submit(Request(input_ids=text[0], max_new_tokens=8)).stream()
               for t in c]
    finally:
        eng.stop()
    check_answer(f"text {ENGINE_TEXT[0]} through start()/stop()", got, refs[text[0].size][:8],
                 lambda j: teacher_logits(params, cfg_run, *as_tensors(prompts[1]),
                                          refs[text[0].size], j))
    # cancellation frees the slot
    victim = eng.submit(Request(input_ids=text[0], max_new_tokens=N_NEW))
    for _ in range(3):
        eng.tick()
    eng.cancel(victim.request_id)
    eng.tick()
    n_cut = len([t for c in victim.stream() for t in c])
    if not victim.cancelled or n_cut >= N_NEW or any(s is not None for s in eng.slots):
        raise AssertionError(f"phase 8 cancel: cancelled {victim.cancelled}, {n_cut} tokens, "
                             f"slots {[s is not None for s in eng.slots]}")
    log(f"phase 8 cancel: the request stopped after {n_cut} tokens; every slot free")

    # a 4-slot tick at k = 1 and k = 8, traced
    busy_reqs = [eng.submit(Request(input_ids=text[0], max_new_tokens=200))
                 for _ in range(ENGINE_SLOTS)]
    eng.tick()
    for k in (1, 8):
        eng._flush_inflight()
        eng.multi_step = k
        for _ in range(3):
            eng.tick()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.tick()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = statistics.median(walls)
        # exactly three dispatches inside the trace: none in flight at its
        # start, the last one read at its end
        eng._flush_inflight()

        def three_ticks():
            for _ in range(3):
                eng.tick()
            eng._flush_inflight()

        path = out / f"profile_engine_tick_k{k}.json"
        if not profiled(three_ticks, path):
            continue
        busy, launches, _ = trace_device(path)
        busy /= 3
        log(f"phase 8 tick, {ENGINE_SLOTS} slots, k = {k} ({'overlapped' if k > 1 else 'one step'}): "
            f"host wall {wall_ms:.2f} ms (median of 5), device busy {busy:.2f} ms, idle share "
            f"{1 - busy / wall_ms:.3f}, {launches / 3:.0f} launches per tick, "
            f"{busy / k:.2f} device ms and {ENGINE_SLOTS * k / wall_ms * 1e3:.1f} tokens/s "
            f"per step")
    for r in busy_reqs:
        eng.cancel(r.request_id)
    eng.tick()
    eng._flush_inflight()

    # one 256-position chunk and the 300-token prompt's fused chunk, traced
    with torch.no_grad(), fp32_accumulation():
        emb = llama.embed(params["llm"], torch.from_numpy(text[1].astype(np.int64)).to(dev)
                          ).to(bf)[None]
        tail = torch.nn.functional.pad(emb[:, 256:], (0, 0, 0, 64 - (emb.shape[1] - 256)))
        cache1 = llama.init_kv_cache(cfg.llm, 1, cache_len, dtype=bf, device=dev)
        for name, chunk in (("256-position chunk (non-fused)", emb[:, :256]),
                            ("64-row fused chunk (K1-K3 wgmma)", tail)):
            start = 0 if chunk.shape[1] == 256 else 256
            for _ in range(2):
                cache1["length"].fill_(start)
                eng._prefill_chunk(cache1, chunk)
            torch.cuda.synchronize()
            path = out / f"profile_engine_chunk_{chunk.shape[1]}.json"
            if not profiled(lambda: eng._prefill_chunk(cache1, chunk), path,
                            start=lambda: cache1["length"].fill_(start)):
                continue
            busy, launches, by_name = trace_device(path)
            parts = ", ".join(f"{pat} {ms:.3f} ms / {n}" for pat, (ms, n) in (
                (pat, trace_kernel(path, pat)) for pat in (
                    "qkv_kernel", "gate_up_kernel", "resid_kernel", "rms_norm_kernel",
                    "weight_ring_kernel", "qmm_wgmma_kernel", "split_reduce_kernel")) if n)
            top = "; ".join(f"{ms:.2f} ms {n[:60]}" for n, ms in
                            sorted(by_name.items(), key=lambda kv: -kv[1])[:4])
            log(f"phase 8 {name}: device busy {busy:.2f} ms, {launches} launches"
                + (f"; {parts}" if parts else "") + f"; largest: {top}")
        del cache1
    del eng
    torch.cuda.empty_cache()

    # the int8 KV pool: finite scales, the same answers twice, the float
    # engine's first tokens
    runs = []
    for _ in range(2):
        eng_q, answers_q, ttft_q, wall_q, _, peak_q = run(True)
        finite = all(bool(torch.isfinite(eng_q.cache[n]).all()) for n in ("k_scale", "v_scale"))
        runs.append(answers_q)
        log(f"phase 8 int8 cache: {sum(map(len, answers_q))} tokens in {wall_q:.3f} s; TTFTs "
            f"{[round(t * 1e3, 1) for t in ttft_q]} ms; scales finite {finite}; peak memory "
            f"{peak_q:.2f} GiB")
        del eng_q
        torch.cuda.empty_cache()
        if not finite:
            raise AssertionError("phase 8 int8 cache: scales not finite")
    same_first = [a[0] == b[0] for a, b in zip(runs[0], answers)]
    agree = [sum(x == y for x, y in zip(a, b)) for a, b in zip(runs[0], answers)]
    log(f"phase 8 int8 cache vs float: first tokens equal {same_first}; tokens equal per "
        f"request {agree} of {N_NEW}")
    if runs[0] != runs[1] or not all(same_first):
        raise AssertionError(f"phase 8 int8 cache: repeats {runs[0] == runs[1]}, first tokens "
                             f"equal {same_first}")
    return counts


class ByteTokenizer:
    """Stand-in tokenizer for phases 9 and 10 (no tokenizer ships with the
    repo): BOS, then the text's UTF-8 bytes as ids 0-255; decode keeps the
    ids below 256 as bytes and drops the others. ``pad_token_id`` and
    ``model_max_length`` are what the data pipeline and the training CLI
    read of a tokenizer (the padding id is never a byte)."""

    def __init__(self, bos_token_id, pad_token_id=None, model_max_length=2048):
        self.bos_token_id = bos_token_id
        self.pad_token_id = pad_token_id
        self.model_max_length = model_max_length

    def __call__(self, text):
        return types.SimpleNamespace(input_ids=[self.bos_token_id] + list(text.encode()))

    def decode(self, ids, skip_special_tokens=True):
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


def draft_params(cfg, generator, device):
    """The random 0.6B bf16 draft (DRAFT_LLM, stacked layers, int8-valued
    bf16 weights of scale 0.02 / 127 as bench_spec_engine_8b.py builds
    them, the lm_head tied to the embedding) and its SliMEConfig."""
    from slime_tpu_torch.config import LLMConfig
    dl = LLMConfig(vocab_size=cfg.llm.vocab_size, **DRAFT_LLM)
    H, HD, I, NL = dl.hidden_size, dl.head_dim, dl.intermediate_size, dl.num_layers

    def w(out_d, in_d):
        q = torch.randint(-127, 128, (NL, out_d, in_d), dtype=torch.int8, device=device,
                          generator=generator)
        return {"weight": (q.to(torch.float32) * (0.02 / 127.0)).to(torch.bfloat16)}
    layers = {"input_layernorm": {"weight": torch.ones((NL, H), device=device)},
              "post_attention_layernorm": {"weight": torch.ones((NL, H), device=device)},
              "q_proj": w(dl.num_heads * HD, H), "k_proj": w(dl.num_kv_heads * HD, H),
              "v_proj": w(dl.num_kv_heads * HD, H), "o_proj": w(H, dl.num_heads * HD),
              "gate_proj": w(I, H), "up_proj": w(I, H), "down_proj": w(H, I)}
    emb = (torch.randn((dl.vocab_size, H), device=device, generator=generator) * 0.02
           ).to(torch.bfloat16)
    llm = {"embed_tokens": emb, "norm": {"weight": torch.ones((H,), device=device)},
           "layers": layers, "lm_head": {"weight": emb}}
    return {"llm": llm}, dataclasses.replace(cfg, llm=dl)


def traced_engine(**kw):
    """A BatchDecodeEngine that names a speculative round's parts for the
    profiler (``spec_draft``, ``spec_verify``, ``spec_ingest``) and, while
    ``record`` is set, keeps each round's live rows, proposals and the
    argmax of its verify logits."""
    from torch.profiler import record_function

    from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine

    class Traced(BatchDecodeEngine):
        record = False

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rounds_log = []

        def _one_round(self, cur, d_len, alive, *a, **k):
            self._alive = alive
            return super()._one_round(cur, d_len, alive, *a, **k)

        def _draft_steps(self, *a, **k):
            with record_function("spec_draft"):
                return super()._draft_steps(*a, **k)

        def _verify(self, cur, props, window):
            with record_function("spec_verify"):
                logits = super()._verify(cur, props, window)
            if self.record:
                self.rounds_log.append((self._alive.clone(), props.clone(),
                                        logits.argmax(dim=-1).to(torch.int32)))
            return logits

        def _ingest(self, tokens, window):
            with record_function("spec_ingest"):
                super()._ingest(tokens, window)
    return Traced(**kw)


def verified_tokens(rounds_log, slot, K):
    """Host model of the greedy accept rule over one slot's recorded rounds:
    the concatenation of argmax[:acc + 1], acc the proposals' longest
    prefix equal to the verify argmax."""
    out = []
    for alive, props, am in rounds_log:
        if not bool(alive[slot]):
            continue
        p, a = props[slot].tolist(), am[slot].tolist()
        acc = next((i for i in range(K) if p[i] != a[i]), K)
        out.extend(a[:acc + 1])
    return out


def trace_ranges(path, names):
    """{range: (device ms, launches)} of the kernels launched inside each
    named ``record_function`` range of a torch.profiler chrome trace (by
    the correlation of each kernel with its launch call); the rest under
    None."""
    ev = json.loads(Path(path).read_text())["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
              if e.get("ph") == "X" and e.get("name") in names
              and str(e.get("cat", "")).lower() == "user_annotation"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    out = {n: [0.0, 0] for n in list(names) + [None]}
    by_kernel = {n: {} for n in list(names) + [None]}
    for e in ev:
        if e.get("ph") != "X" or str(e.get("cat", "")).lower() != "kernel":
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        name = next((n for t0, t1, n in ranges if t is not None and t0 <= t <= t1), None)
        out[name][0] += e["dur"] / 1e3
        out[name][1] += 1
        k = e["name"].replace("void (anonymous namespace)::", "").split("(")[0].split("<")[0]
        by_kernel[name][k] = by_kernel[name].get(k, 0.0) + e["dur"] / 1e3
    return out, by_kernel


def http_post(url, body, timeout=600):
    """POST JSON -> the open response (an HTTP error raises)."""
    import urllib.request
    return urllib.request.urlopen(urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}),
        timeout=timeout)


def http_json(url, body):
    with http_post(url, body) as r:
        return json.loads(r.read())


def http_stream(url, body):
    """POST to a worker stream route -> (the b"\\0"-delimited chunks, seconds
    to the first chunk, seconds to the last); an error chunk raises."""
    t0 = time.perf_counter()
    chunks, first, buf = [], None, b""
    with http_post(url, body) as r:
        while True:
            data = r.read1(65536)
            if not data:
                break
            buf += data
            *done, buf = buf.split(b"\0")
            for c in done:
                if c:
                    chunks.append(json.loads(c))
                    first = first or time.perf_counter() - t0
    bad = [c for c in chunks if c.get("error_code", 0) != 0]
    if bad or not chunks:
        raise AssertionError(f"phase 9: error reply from {url}: {bad or 'no chunk'}")
    return chunks, first, time.perf_counter() - t0


def http_sse(url, body):
    """POST with stream: true to an OpenAI route -> its SSE frames, which
    must end with [DONE]."""
    frames, done = [], False
    with http_post(url, body) as r:
        for line in r:
            line = line.strip()
            if not line:
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                done = True
                break
            frames.append(json.loads(payload))
    if not done or not frames:
        raise AssertionError(f"phase 9: SSE from {url} ended without [DONE]")
    return frames


def plain_logits(params, cfg, prompt, tokens):
    """The bf16 logits [len(tokens), V] at each answer step, teacher-forced on
    ``tokens`` after ``prompt`` in one forward (a trailing EOS gives the
    step after an answer that ended)."""
    from slime_tpu_torch.models import llama
    from slime_tpu_torch.models.layers import fp32_accumulation
    ids = torch.from_numpy(np.concatenate([prompt, tokens]).astype(np.int64))[None]
    ids = ids.to(params["llm"]["embed_tokens"].device)
    with torch.no_grad(), fp32_accumulation():
        logits, _ = llama.forward(params["llm"], llama.embed(params["llm"], ids).to(
            torch.bfloat16), cfg.llm, compute_dtype=torch.bfloat16)
    return logits[0, len(prompt) - 1:len(prompt) - 1 + len(tokens)]


def near_tie_rule(name, got, want, logits, eos, phase="9", ref="the plain engine's"):
    """``got`` against ``want`` (the plain engine's tokens), with ``logits``
    the plain tokens' teacher-forced logits: equal up to the first step
    whose top-two gap lies under ENGINE_TIE_ATOL, and where they part the
    two tokens' logits lie within ENGINE_TIE_ATOL of each other (a forward
    is another attention path than the engine's, so either may be the
    larger). Logs the first near tie and the parting step with its gap."""
    top2 = logits.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    tie = next((i for i, g in enumerate(gaps) if g < ENGINE_TIE_ATOL), None)
    # a sequence that ended early ended on EOS, which it does not emit
    got, want = list(got), list(want)
    n = max(len(got), len(want))
    got += [eos] * (n - len(got))
    want += [eos] * (n - len(want))
    part = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    gap = None if part is None else float(logits[part, want[part]] - logits[part, got[part]])
    log(f"phase {phase} {name}: {len(got)} tokens; "
        + (f"equal to {ref}" if part is None else
           f"parts from {ref} at step {part} (plain {want[part]}, here "
           f"{got[part]}: teacher-forced logit gap {gap:.4g}), equal before it")
        + (f"; first plain near tie at step {tie} (top-two gap {gaps[tie]:.4g}, bound "
           f"{ENGINE_TIE_ATOL})" if tie is not None else "; no plain near tie"))
    if part is not None and (tie is None or part < tie or abs(gap) > ENGINE_TIE_ATOL):
        raise AssertionError(f"phase {phase} {name}: parts from {ref} at step {part} "
                             f"(gap {gap:.4g}), first near tie at {tie}")


def drain(req):
    return [t for c in req.stream() for t in c]


def run_one(eng, ids, n):
    """One request through tick() -> (tokens, TTFT s, decode s): the
    engine's own record of it (``metrics_summary``'s: submit to the first
    token's sampling, then to the retirement)."""
    from slime_tpu_torch.serve.batch_engine import Request
    req = eng.submit(Request(input_ids=ids, max_new_tokens=n))
    for _ in range(20 * n):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    torch.cuda.synchronize()
    ttft, _, dec = eng._metrics[-1]
    return drain(req), ttft, dec


def serving_stack_phase(dev, cfg, params):
    """Phase 9: the serving stack on phase 2's int8 model, bf16: the batched
    worker's HTTP routes (stream, grammar, OpenAI, status) from a thread,
    then speculation in process with a random draft and with the target as
    its own draft. Returns the launch counts of its counted windows (the
    HTTP requests; each speculating engine's request)."""
    from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request
    from slime_tpu_torch.serve.batched_worker import BatchedWorker, build_server
    from slime_tpu_torch.serve.grammar import choices_regex, compile_regex, compile_token_dfa
    from slime_tpu_torch.serve.grammar import vocab_bytes_from_tokenizer

    bf = torch.bfloat16
    out = Path(__file__).resolve().parent / "bench_out"
    NL, V = cfg.llm.num_layers, cfg.llm.vocab_size
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    tok = ByteTokenizer(cfg.bos_token_id)
    rng = np.random.default_rng(SEED + 13)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    texts = ["".join(rng.choice(letters, n)) for n in SERVE_TEXT]
    prompts = [np.asarray(tok(t).input_ids, np.int32) for t in texts]
    cache_len = -(-(max(map(len, prompts)) + N_NEW + SPEC_ROUNDS * (SPEC_K + 1) + 2)
                  // ENGINE_WINDOW) * ENGINE_WINDOW
    common = dict(max_slots=ENGINE_SLOTS, cache_len=cache_len, compute_dtype=bf, device=dev,
                  prefix_cache_mb=0)
    launches = {n: 0 for n in KERNELS}
    log(f"phase 9: the serving stack, max_slots {ENGINE_SLOTS}, cache_len {cache_len}, "
        f"bf16, spec_k {SPEC_K}, spec_rounds {SPEC_ROUNDS}; text prompts of "
        f"{[len(p) for p in prompts]} tokens (BOS + bytes), {N_NEW} greedy tokens each")

    # the grammar, compiled for the byte vocabulary at the model's V
    t0 = time.perf_counter()
    vocab = vocab_bytes_from_tokenizer(tok, V)
    pattern = choices_regex(list(CHOICES))
    tdfa = compile_token_dfa(pattern, vocab, eos_id=cfg.eos_token_id)
    g_s = time.perf_counter() - t0
    log(f"phase 9 grammar {pattern!r}: {tdfa.allowed.shape[0]} states, tables "
        f"{(tdfa.allowed.shape[0] + 1) * V * 5 / 2 ** 20:.2f} MiB on the device (bool + int32 "
        f"[S + 1, V], state 0 included), compiled in {g_s:.3f} s (vocabulary table and DFA)")

    # ---- the in-process reference: both prompts submitted together ----
    ref = BatchDecodeEngine(params, cfg, **common)
    run_one(ref, prompts[0], 8)                      # warm
    reqs = [ref.submit(Request(input_ids=p, max_new_tokens=N_NEW, logprobs=1))
            for p in prompts]
    ttft_in = [None, None]
    t0 = time.perf_counter()
    for _ in range(4000):
        n = ref.tick()
        for i, r in enumerate(reqs):
            if ttft_in[i] is None and not r.out_queue.empty():
                ttft_in[i] = time.perf_counter() - t0
        if n == 0 and ref.pending.empty() and ref._admission is None:
            break
    torch.cuda.synchronize()
    wall_in = time.perf_counter() - t0
    want = [drain(r) for r in reqs]
    del ref
    log(f"phase 9 in process: {sum(map(len, want))} tokens in {wall_in:.3f} s "
        f"({sum(map(len, want)) / wall_in:.2f} tok/s aggregate); TTFTs "
        f"{[round(t * 1e3, 1) for t in ttft_in]} ms")

    # ---- over HTTP: the batched worker and its routes on a thread ----
    worker = BatchedWorker(controller_addr=None, worker_addr="smoke", model_name="slime-8b",
                           params=params, cfg=cfg, tokenizer=tok, register=False, **common)
    srv = build_server(worker, "127.0.0.1", 0, conv_mode="llama3")
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        got = [None, None]

        def stream(i):
            got[i] = http_stream(url + "/worker_generate_stream",
                                 {"prompt": texts[i], "max_new_tokens": N_NEW,
                                  "temperature": 0.0, "logprobs": 1})
        threads = [threading.Thread(target=stream, args=(i,)) for i in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall_http = time.perf_counter() - t0
        if any(g is None for g in got):
            raise AssertionError("phase 9: an HTTP stream failed")
        http_toks = [[e["token_id"] for e in g[0][-1]["logprobs"]] for g in got]
        for i, (chunks, first, last) in enumerate(got):
            n = chunks[-1]["n_tokens"]
            log(f"phase 9 HTTP stream {len(prompts[i])} tokens: TTFT {first * 1e3:.1f} ms "
                f"(in process {ttft_in[i] * 1e3:.1f}), {n} tokens, "
                f"{(n - 1) / max(last - first, 1e-9):.2f} tok/s after the first "
                f"({len(chunks)} chunks)")
        log(f"phase 9 HTTP: {sum(map(len, http_toks))} tokens in {wall_http:.3f} s "
            f"({sum(map(len, http_toks)) / wall_http:.2f} tok/s aggregate; in process "
            f"{sum(map(len, want)) / wall_in:.2f})")
        for i in range(2):
            near_tie_rule(f"HTTP stream {len(prompts[i])} tokens vs in process", http_toks[i],
                          want[i], plain_logits(params, cfg, prompts[i],
                                                    want[i] + [cfg.eos_token_id]),
                          cfg.eos_token_id)
        # the choices grammar over HTTP
        g_reply = http_stream(url + "/worker_generate_stream",
                              {"prompt": texts[0], "max_new_tokens": 8,
                               "choices": list(CHOICES)})[0][-1]
        if not compile_regex(pattern).matches(g_reply["text"].encode()):
            raise AssertionError(f"phase 9 grammar: {g_reply['text']!r} does not match "
                                 f"{pattern!r}")
        log(f"phase 9 grammar over HTTP: {g_reply['text']!r} fullmatches {pattern!r} "
            f"({g_reply['n_tokens']} tokens)")
        # the OpenAI routes
        chat = {"model": "slime-8b", "max_tokens": 16, "temperature": 0,
                "messages": [{"role": "user", "content": texts[0]}]}
        one = http_json(url + "/v1/chat/completions", chat)
        frames = http_sse(url + "/v1/chat/completions", {**chat, "stream": True})
        streamed = "".join(f["choices"][0]["delta"].get("content", "") for f in frames)
        comp = http_json(url + "/v1/completions", {"prompt": texts[0], "max_tokens": 16,
                                                   "temperature": 0, "n": 2})
        status = http_json(url + "/worker_get_status", {})
        ok = (one["object"] == "chat.completion" and len(one["choices"]) == 1
              and streamed == one["choices"][0]["message"]["content"]
              and frames[-1]["choices"][0]["finish_reason"] in ("stop", "length")
              and [c["index"] for c in comp["choices"]] == [0, 1]
              and comp["choices"][0]["text"] == comp["choices"][1]["text"]
              and status["model_names"] == ["slime-8b"])
        log(f"phase 9 OpenAI: chat {one['usage']}, SSE {len(frames)} frames equal to the JSON "
            f"reply {streamed == one['choices'][0]['message']['content']}; completions n = 2: "
            f"{len(comp['choices'])} choices, usage {comp['usage']}; status "
            f"{json.dumps(status['metrics'])}")
        if not ok:
            raise AssertionError(f"phase 9 OpenAI replies: {one}, {comp}, {status}")
    finally:
        srv.shutdown()
        worker.engine.stop()
        server.join(timeout=30)
    torch.cuda.synchronize()
    counts = launch_counts()
    eng = worker.engine
    ring = sum(n for c, n in eng.chunk_rows.items() if c <= 8)
    expect = {**{n + "_ring": NL * (eng.decode_steps + ring) for n in FUSED},
              **chunk_launches(cfg.llm, eng.chunk_rows, sms)}
    wrong = {n: c for n, c in counts.items() if c != expect.get(n, 0)}
    log(f"phase 9 HTTP launches: {json.dumps({n: c for n, c in counts.items() if c})} "
        f"({eng.decode_steps} decode steps, chunks {dict(eng.chunk_rows)})")
    if wrong and dev.type == "cuda":        # a CPU rehearsal counts no launch
        raise AssertionError(f"phase 9 HTTP launches {wrong} (expected {expect})")
    for n, c in counts.items():
        launches[n] += c
    del worker, eng
    torch.cuda.empty_cache()

    # ---- speculation in process: one 64-token request, plain and spec ----
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    dparams, dcfg = draft_params(cfg, g, dev)
    ids = prompts[0]
    plain = BatchDecodeEngine(params, cfg, **common)
    run_one(plain, ids, N_NEW)                       # warm
    plain_toks, plain_ttft, plain_dec = run_one(plain, ids, N_NEW)
    del plain
    teacher = plain_logits(params, cfg, ids, plain_toks + [cfg.eos_token_id])
    log(f"phase 9 plain engine, one request: {len(plain_toks)} tokens, TTFT "
        f"{plain_ttft * 1e3:.1f} ms, {(len(plain_toks) - 1) / plain_dec:.2f} tok/s after it")
    for name, dp, dc in (("random draft", dparams, dcfg), ("target as draft", params, cfg)):
        eng = traced_engine(params=params, cfg=cfg, draft_params=dp, draft_cfg=dc,
                            spec_k=SPEC_K, spec_rounds=SPEC_ROUNDS, **common)
        run_one(eng, ids, N_NEW)                     # warm
        eng.spec_stats.clear()
        eng.decode_steps = 0
        eng.chunk_rows.clear()
        eng.record = True
        eng.rounds_log.clear()
        reset_launch_counts()
        toks, ttft, dec = run_one(eng, ids, N_NEW)
        counts = launch_counts()
        eng.record = False
        st = dict(eng.spec_stats)
        acc = st.get("accepted", 0) / max(SPEC_K * st.get("slot_rounds", 1), 1)
        log(f"phase 9 spec, {name}: {len(toks)} tokens, TTFT {ttft * 1e3:.1f} ms, "
            f"{(len(toks) - 1) / dec:.2f} tok/s after it (plain {(len(plain_toks) - 1) / plain_dec:.2f}); "
            f"{st.get('rounds', 0)} rounds in {st.get('dispatches', 0)} dispatches "
            f"({st.get('slot_rounds', 0)} of them live), acceptance "
            f"{acc:.3f} of {SPEC_K} a round ({(st.get('accepted', 0) + st.get('slot_rounds', 0)) / max(st.get('slot_rounds', 1), 1):.2f} "
            f"tokens a round), {eng.decode_steps} plain steps")
        # every emitted token is its verify chunk's argmax under the accept rule
        ver = verified_tokens([(a.cpu(), p.cpu(), m.cpu()) for a, p, m in eng.rounds_log], 0,
                              SPEC_K)
        n = min(len(ver), len(toks) - 1)
        if toks[1:1 + n] != ver[:n] or n < len(toks) - 1 - eng.decode_steps:
            raise AssertionError(f"phase 9 spec {name}: emitted tokens are not the verify "
                                 f"chunks' argmax under the accept rule ({n} checked)")
        log(f"phase 9 spec, {name}: {n} tokens equal to their verify chunks' argmax under "
            f"the accept rule")
        near_tie_rule(f"spec, {name}", toks, plain_toks, teacher, cfg.eos_token_id)
        draft_fused = dp is params
        steps = st.get("rounds", 0) * (SPEC_K + 1) if draft_fused else 0
        ring = sum(n for c, n in eng.chunk_rows.items() if c <= 8)
        # the verify chunks (VERIFY_ROWS rows each) beside the admissions' chunks
        chunks = dict(eng.chunk_rows)
        chunks[VERIFY_ROWS] = chunks.get(VERIFY_ROWS, 0) + st.get("rounds", 0)
        expect = {**{n + "_ring": NL * (eng.decode_steps + ring + steps) for n in FUSED},
                  **chunk_launches(cfg.llm, chunks, sms)}
        wrong = {n: c for n, c in counts.items() if c != expect.get(n, 0)}
        log(f"phase 9 spec, {name} launches: {json.dumps({n: c for n, c in counts.items() if c})}")
        if (wrong and dev.type == "cuda") or not st.get("rounds"):
            raise AssertionError(f"phase 9 spec {name} launches {wrong} (expected {expect})")
        for k, c in counts.items():
            launches[k] += c
        # one dispatch of SPEC_ROUNDS rounds with every slot live, traced
        busy = [eng.submit(Request(input_ids=ids, max_new_tokens=200))
                for _ in range(ENGINE_SLOTS)]
        eng.tick()                                   # admissions
        eng.tick()                                   # a first dispatch
        path = out / f"profile_spec_{'random' if not draft_fused else 'self'}.json"
        walls, rounds = [], []

        def one_tick():
            r0, t0 = eng.spec_stats["rounds"], time.perf_counter()
            eng.tick()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            rounds.append(eng.spec_stats["rounds"] - r0)
        if profiled(one_tick, path):
            R = rounds[-1]
            parts, kern = trace_ranges(path, ("spec_draft", "spec_verify", "spec_ingest"))
            b_ms, b_n, _ = trace_device(path)
            rpw_ms = sum(ms for k, ms in kern["spec_verify"].items()
                         if k in ("qkv_kernel", "resid_kernel", "gate_up_kernel"))
            wg_ms = sum(ms for k, ms in kern["spec_verify"].items()
                        if k in ("rms_norm_kernel", "qmm_wgmma_kernel",
                                 "split_reduce_kernel"))
            log(f"phase 9 spec tick, {name}, {ENGINE_SLOTS} live slots, {R} rounds: host wall "
                f"{walls[-1]:.2f} ms, device busy {b_ms:.2f} ms (idle share "
                f"{1 - b_ms / walls[-1]:.3f}), {b_n} launches; a round on the device: "
                f"{b_ms / R:.2f} ms, draft steps {parts['spec_draft'][0] / R:.3f} "
                f"({parts['spec_draft'][1] // R} launches), verify chunk "
                f"{parts['spec_verify'][0] / R:.3f} of which K1-K3 row per warp "
                f"{rpw_ms / R:.3f}, K1-K3 on tensor cores (row norms included) "
                f"{wg_ms / R:.3f}, "
                f"ingest {parts['spec_ingest'][0] / R:.3f}, the rest "
                f"{parts[None][0] / R:.3f}; {ENGINE_SLOTS * (st.get('accepted', 0) + st.get('slot_rounds', 0)) / max(st.get('slot_rounds', 1), 1) / (walls[-1] / R) * 1e3:.1f} "
                f"tok/s at this acceptance")
            top = "; ".join(f"{k} {ms:.2f}" for k, ms in sorted(
                kern["spec_verify"].items(), key=lambda kv: -kv[1])[:4])
            log(f"phase 9 spec verify chunk, {name}, largest kernels over {R} rounds (ms): {top}")
        for r in busy:
            eng.cancel(r.request_id)
        eng.tick()
        del eng
        torch.cuda.empty_cache()

    # ---- a k = 8 tick with one constrained slot against none ----
    eng = BatchDecodeEngine(params, cfg, **common)
    # lowercase and spaces without end (EOS never allowed), so the slot
    # stays constrained through the traced ticks
    gid = eng.register_grammar(compile_token_dfa(r"[a-z ]*", vocab))
    for constrained in (0, 1):
        busy = [eng.submit(Request(input_ids=ids, max_new_tokens=200,
                                    grammar_id=gid if i < constrained else None))
                for i in range(ENGINE_SLOTS)]
        for _ in range(4):
            eng.tick()
        eng._flush_inflight()

        def three_ticks():
            for _ in range(3):
                eng.tick()
            eng._flush_inflight()
        path = out / f"profile_grammar_tick_{constrained}.json"
        if profiled(three_ticks, path):
            b_ms, b_n, _ = trace_device(path)
            log(f"phase 9 k = 8 tick, {ENGINE_SLOTS} slots, {constrained} constrained: device "
                f"busy {b_ms / 3:.2f} ms, {b_n / 3:.0f} launches a tick")
        for r in busy:
            eng.cancel(r.request_id)
        eng.tick()
        eng._flush_inflight()
    del eng, dparams
    torch.cuda.empty_cache()
    return launches


LORA_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def random_adapter(cfg, seed, device):
    """A random rank-LORA_R adapter (alpha LORA_ALPHA) on all seven
    projections of every layer, per-layer paths (PEFT's layout), fp32 from a
    torch.Generator: A ~ N(0, 1/in), B ~ N(0, (0.02)^2 / r), so each
    projection moves by about 4% of its output: the answers part from the
    base's."""
    llm = cfg.llm
    H, hd, I = llm.hidden_size, llm.head_dim, llm.intermediate_size
    dims = {"q_proj": (llm.num_heads * hd, H), "k_proj": (llm.num_kv_heads * hd, H),
            "v_proj": (llm.num_kv_heads * hd, H), "o_proj": (H, llm.num_heads * hd),
            "gate_proj": (I, H), "up_proj": (I, H), "down_proj": (H, I)}
    g = torch.Generator(device=device).manual_seed(seed)
    adapters = {}
    for li in range(llm.num_layers):
        for proj in LORA_PROJ:
            o, i = dims[proj]
            adapters[f"llm/layers/{li}/{proj}"] = {
                "A": torch.randn((LORA_R, i), generator=g, device=device) / i ** 0.5,
                "B": torch.randn((o, LORA_R), generator=g, device=device) * (0.02 / LORA_R ** 0.5)}
    return {"rank": LORA_R, "alpha": LORA_ALPHA, "adapters": adapters}


def multi_lora_phase(dev, cfg, params):
    """Phase 9, multi-LoRA: two random adapters written in PEFT layout
    (``checkpoint.save_lora_checkpoint``) and loaded by
    ``BatchedWorker.load_adapter`` on phase 2's int8 model (bf16); one base
    request (bench.py's query) and one text request per adapter, LORA_NEW
    greedy tokens each, submitted together. Each adapter answer is held to
    ``generate`` on the params with that adapter attached, the base answer to
    the plain engine's, both up to the first near tie; ticks with an adapter
    slot launch no K1-K3, ticks after the adapter slots free launch them on
    the ring. Then a k = 1 tick traced with and without an adapter slot.
    Returns the launch counts of the mixed run."""
    import shutil

    from slime_tpu_torch import checkpoint as ckpt
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.serve.batch_engine import Request
    from slime_tpu_torch.serve.batched_worker import BatchedWorker
    from slime_tpu_torch.train import lora

    bf = torch.bfloat16
    out = Path(__file__).resolve().parent / "bench_out"
    cfg_run = dataclasses.replace(cfg, eos_token_id=-1)
    img, ids, attn, anyres = query(dev, cfg)
    crops, mask = anyres(img)
    ids_np = ids[0].cpu().numpy()
    tok = ByteTokenizer(cfg.bos_token_id)
    rng = np.random.default_rng(SEED + 15)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    texts = [np.asarray(tok("".join(rng.choice(letters, n))).input_ids, np.int32)
             for n in SERVE_TEXT]
    cache_len = 2048
    worker = BatchedWorker(controller_addr=None, worker_addr="smoke", model_name="slime-8b",
                           params=params, cfg=cfg_run, tokenizer=tok, register=False,
                           max_slots=ENGINE_SLOTS, cache_len=cache_len, compute_dtype=bf,
                           device=dev, prefix_cache_mb=0)
    eng = worker.engine
    eng.stop()           # this phase ticks the worker's engine itself
    # the plain engine's answer to the query (no adapter registered yet)
    base_req = eng.submit(Request(input_ids=ids_np, pixel_values=crops, crop_mask=mask,
                                  max_new_tokens=LORA_NEW))
    for _ in range(400):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    want_base = drain(base_req)

    states, t0 = [], time.perf_counter()
    for i, seed in enumerate((1, 2)):
        st = random_adapter(cfg, seed, dev)
        d = out / f"lora_adapter_{i + 1}"
        shutil.rmtree(d, ignore_errors=True)
        ckpt.save_lora_checkpoint(str(d), {}, st, cfg)
        states.append(st)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aids = [worker.load_adapter(f"a{i + 1}", str(out / f"lora_adapter_{i + 1}"))
            for i in range(2)]
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in (out / "lora_adapter_1").iterdir()) / 2 ** 30
    log(f"phase 9 multi-LoRA: two adapters r = {LORA_R}, alpha = {LORA_ALPHA}, on "
        f"{len(LORA_PROJ)} projections x {cfg.llm.num_layers} layers ({size:.2f} GiB each in "
        f"PEFT layout): written in {save_s:.1f} s, loaded and registered in {load_s:.1f} s "
        f"as adapter ids {aids}; registry {eng._n_adapters} entries, rank {eng._lora_rank}")

    # generate's answers with each adapter attached as lora entries (stacked)
    wants = []
    for st, p in zip(states, texts):
        attached = lora.attach(params, lora.stack_adapter_state(st, cfg.llm.num_layers))
        t = torch.from_numpy(p[None].astype(np.int64)).to(dev)
        wants.append(gen.generate(attached, cfg_run, t, torch.ones_like(t, dtype=torch.bool),
                                  max_new_tokens=LORA_NEW, compute_dtype=bf)[0].tolist())
    plains = [run_one(eng, p, LORA_NEW)[0] for p in texts]

    # the mixed run: adapters first (whole admissions), then the query (five
    # chunks), so the adapter slots free first and the query decodes alone
    reqs = [eng.submit(Request(input_ids=p, max_new_tokens=LORA_NEW, adapter_id=a))
            for p, a in zip(texts, aids)]
    reqs.append(eng.submit(Request(input_ids=ids_np, pixel_values=crops, crop_mask=mask,
                                   max_new_tokens=LORA_NEW)))
    torch.cuda.synchronize()
    reset_launch_counts()
    fused = [n + sfx for n in FUSED for sfx in ("", "_ring", "_wgmma")]
    ticks, t0 = [], time.perf_counter()
    for _ in range(2000):
        before = launch_counts()
        lora_before = eng._use_lora
        n = eng.tick()
        after = launch_counts()
        ticks.append((lora_before and eng._use_lora,
                      sum(after[k] - before[k] for k in fused)))
        if n == 0 and eng.pending.empty() and eng._admission is None:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    got = [drain(r) for r in reqs]
    with_lora = [k for lo, k in ticks if lo]
    last = max((i for i, (lo, _) in enumerate(ticks) if lo), default=len(ticks))
    after_free = [k for _, k in ticks[last + 1:]]
    log(f"phase 9 multi-LoRA mixed run: {sum(map(len, got))} tokens in {wall:.3f} s over "
        f"{len(ticks)} ticks; {len(with_lora)} ticks with an adapter slot launched "
        f"{sum(with_lora)} K1-K3; the {len(after_free)} ticks after the adapter slots freed "
        f"launched {sum(after_free)} (ring: {json.dumps({k: counts[k] for k in fused[:3]})}); "
        f"gathered view built {eng.lora_view_builds} times")
    if dev.type == "cuda" and (sum(with_lora) or not with_lora or not sum(after_free)):
        raise AssertionError(f"phase 9 multi-LoRA: K1-K3 launches {with_lora} with an adapter "
                             f"slot, {after_free} after")
    for i, (g, w, pl, p, st) in enumerate(zip(got, wants, plains, texts, states)):
        attached = lora.attach(params, lora.stack_adapter_state(st, cfg.llm.num_layers))
        near_tie_rule(f"multi-LoRA adapter {i + 1} vs generate with it attached", g, w,
                      plain_logits(attached, cfg, p, w + [cfg.eos_token_id]), cfg.eos_token_id)
        differs = next((j for j, (a, b) in enumerate(zip(w, pl)) if a != b), None)
        log(f"phase 9 multi-LoRA adapter {i + 1}: generate's answer with it parts from the "
            f"base engine's at step {differs}")
        if differs is None:
            raise AssertionError(f"phase 9 multi-LoRA: adapter {i + 1} changes no token")
    check_answer("multi-LoRA base query vs the plain engine", got[2], want_base,
                 lambda j: teacher_logits(params, cfg_run, ids, attn, crops[None], mask[None],
                                          want_base, j), phase="9")

    # a k = 1 tick with an adapter slot against one without (4 slots busy)
    for with_adapter in (1, 0):
        busy = [eng.submit(Request(input_ids=texts[0], max_new_tokens=200,
                                   adapter_id=aids[0] if i < with_adapter else None))
                for i in range(ENGINE_SLOTS)]
        for _ in range(4):
            eng.tick()
        eng._flush_inflight()
        eng.multi_step = 1
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.tick()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = statistics.median(walls)

        def three_ticks():
            for _ in range(3):
                eng.tick()
            eng._flush_inflight()
        path = out / f"profile_lora_tick_{with_adapter}.json"
        if profiled(three_ticks, path):
            busy_ms, n_k, _ = trace_device(path)
            busy_ms /= 3
            log(f"phase 9 multi-LoRA k = 1 tick, {ENGINE_SLOTS} slots, {with_adapter} with an "
                f"adapter: host wall {wall_ms:.2f} ms (median of 5), device busy "
                f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
                f"{n_k / 3:.0f} launches a tick")
        eng.multi_step = 8
        for r in busy:
            eng.cancel(r.request_id)
        eng.tick()
        eng._flush_inflight()
    del worker, eng
    for i in range(2):
        shutil.rmtree(out / f"lora_adapter_{i + 1}", ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def serve_phases(dev, cfg):
    """Phases 2 and 3 on the int8 serving model, phase 7's int8 part and
    phases 8 and 9; returns the launch counts of the counted windows (3
    generate requests and 1 stream request; phase 7's first runs; phase 8's
    float engine run; phase 9's HTTP requests and speculating requests)."""
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
    log(f"phases 2, 3, 7: wall {time.perf_counter() - t0:.1f} s")
    walls = []
    for tag, phase in (("phase 8", engine_phase), ("phase 9", serving_stack_phase),
                       ("phase 9 multi-LoRA", multi_lora_phase),
                       ("phases 2-3 branches", branches_phase)):
        for n, c in timed(walls, tag, phase, dev, cfg, params).items():
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

    from slime_tpu_torch.models import llama, slime
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.ops.loss import chunked_cross_entropy
    from slime_tpu_torch.params import named_leaves
    from slime_tpu_torch.train.optim import TrainConfig
    from slime_tpu_torch.train.step import init_train_state, make_train_step
    from slime_tpu_torch.train.trainer import RunConfig, run_stage

    bf = torch.bfloat16
    out_dir = Path(__file__).resolve().parent / "bench_out"
    t0 = time.perf_counter()
    params = bf16_train_params(dev, cfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
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
    if profiled(lambda: step(state, batch), out_dir / "profile_train_step.json"):
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


def tree_hash(tree):
    """{path: two int64 sums over each leaf's bytes} (any write moves them)."""
    from slime_tpu_torch.params import named_leaves

    out = {}
    for path, t in named_leaves(tree):
        b = t.detach().reshape(-1).view(torch.uint8)
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=t.device)
        for c in range(0, b.numel(), 2 ** 28):
            x = b[c:c + 2 ** 28].to(torch.int64)
            s1, s2 = s1 + x.sum(), s2 + (x * (x + 7)).sum()
        out[path] = (int(s1), int(s2))
    return out


def sft_data(root, cfg, tok):
    """TRAIN_CLI_RECORDS LLaVA-format records, half with a 672x672 PNG (PIL,
    from the seed), half text-only, each a ~300-token conversation (the
    stand-in tokenizer's bytes); -> (all records' JSON, the text-only JSON)."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 20)
    (root / "images").mkdir(parents=True)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz      "))
    words = lambda n: "".join(rng.choice(letters, n)).strip()  # noqa: E731
    recs, texts = [], []
    for i in range(TRAIN_CLI_RECORDS):
        q, a = words(90 + int(rng.integers(0, 20))), words(190 + int(rng.integers(0, 30)))
        if i % 2 == 0:
            Image.fromarray(rng.integers(0, 255, (672, 672, 3), dtype=np.uint8)).save(
                root / "images" / f"{i}.png")
            recs.append({"id": str(i), "image": f"{i}.png", "conversations": [
                {"from": "human", "value": "<image>\n" + q}, {"from": "gpt", "value": a}]})
        else:
            texts.append({"id": str(i), "conversations": [
                {"from": "human", "value": q}, {"from": "gpt", "value": a}]})
    (root / "sft.json").write_text(json.dumps(recs + texts))
    (root / "text.json").write_text(json.dumps(texts))
    return root / "sft.json", root / "text.json"


def train_cli_phase(dev, cfg):
    """Phase 10: the training CLI (``slime_tpu_torch.train.cli.main``),
    QLoRA on SliME-8B at full width and ``cfg``'s depth (CUT_LAYERS of 32
    from ``main``, for time) from random weights, as
    scripts/llama3_8b_lora_sft.sh runs it with --bits 4, cut in batch and
    steps; its resume, held to the uninterrupted trainer; one traced
    micro-step; a packed text-only run. Returns the launch counts of its
    training runs (the CLI's three commands)."""
    import gc
    import shutil

    from torch.profiler import record_function

    from slime_tpu_torch.data import native
    from slime_tpu_torch.data.image_ops import process_anyres_image_host
    from slime_tpu_torch.models import layers
    from slime_tpu_torch.params import named_leaves
    from slime_tpu_torch.train import cli, lora

    out = Path(__file__).resolve().parent / "bench_out"
    root = out / "train_cli"
    shutil.rmtree(root, ignore_errors=True)
    (root / "model").mkdir(parents=True)
    cfg.save(str(root / "model"))                      # config only: random weights
    tok = ByteTokenizer(cfg.bos_token_id, pad_token_id=cfg.eos_token_id)
    sft_json, text_json = sft_data(root, cfg, tok)
    L = cfg.llm.num_layers

    # the native preprocess library, and its crops against the PIL path's
    from PIL import Image
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("phase 10: the native preprocess library did not build or load")
    img = Image.open(root / "images" / "0.png")
    nat, nmask, _ = native.anyres_preprocess_native(np.asarray(img.convert("RGB")))
    pil, pmask, _ = process_anyres_image_host(img)
    n = int(nmask.sum())
    diff = float(np.abs(nat[:n] - pil[:n]).mean())
    corr = float(np.corrcoef(nat[:n].ravel(), pil[:n].ravel())[0, 1])
    log(f"phase 10 native preprocess: {native.build_native().name} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s; crops of a 672x672 image against the PIL path: "
        f"mean |diff| {diff:.4f} (bound 0.08), correlation {corr:.5f} (bound 0.995)")
    if not (np.array_equal(nmask, pmask) and diff < 0.08 and corr > 0.995):
        raise AssertionError("phase 10: native crops outside the PIL path's bound")

    flags = ["--model-path", str(root / "model"), "--data-path", str(sft_json),
             "--image-folder", str(root / "images"), "--version", "llama3",
             "--model-max-length", "2048", "--lora-enable", "--lora-r", "128",
             "--lora-alpha", "256", "--bits", "4", "--learning-rate", "2e-4",
             "--mm-projector-lr", "2e-5", "--warmup-ratio", "0.03", "--logging-steps", "1",
             "--group-by-modality-length", "--per-device-batch-size", str(TRAIN_CLI_BATCH),
             "--remat", "--gradient-accumulation-steps", "2"]
    log(f"phase 10: python -m slime_tpu_torch.train.cli {' '.join(flags[6:])} (from "
        f"scripts/llama3_8b_lora_sft.sh with --bits 4; cut: --per-device-batch-size "
        f"{TRAIN_CLI_BATCH} for 16, --max-steps / --save-steps for one saved state, "
        f"--logging-steps 1 for 10, no --pretrain-mm-* warm starts: random weights from "
        f"--seed); {TRAIN_CLI_RECORDS} records, half with a 672x672 image")
    hashes = []
    real_build = cli.build_params

    def build(*a):
        p = real_build(*a)
        torch.cuda.synchronize()
        hashes.append(tree_hash(p))
        return p
    counts = {k: 0 for k in ("encoder_attention", "flash_fwd", "flash_bwd_dkdv",
                             "flash_bwd_dq")}

    def run(tag, argv, steps, mm_steps):
        out_dir = argv[argv.index("--output-dir") + 1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        tr = cli.main(argv, tokenizer=tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launch_counts()
        c = {k: got[k] for k in counts}
        want = {"encoder_attention": TRAIN_CLI_K4 * mm_steps, "flash_fwd": 2 * L * steps,
                "flash_bwd_dkdv": L * steps, "flash_bwd_dq": L * steps}
        recs = [json.loads(x) for x in (Path(out_dir) / "metrics.jsonl").read_text()
                .splitlines()][-steps:]
        for r in recs:
            log(f"phase 10 {tag} step {r['step']}: loss {r['loss']:.5f}, grad_norm "
                f"{r['grad_norm']:.5f}, {r['tokens_per_sec']:.1f} tokens/s host "
                f"({TRAIN_CLI_BATCH * 2048 / r['tokens_per_sec'] * 1e3:.1f} ms a step), "
                f"target tokens {r.get('target_tokens')}"
                + (f", packing efficiency {r['packing_efficiency']:.3f}"
                   if "packing_efficiency" in r else ""))
        log(f"phase 10 {tag}: {wall:.1f} s in all (parameters built, NF4 quantized, "
            f"trained, saved); peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
            f"GiB; launches {json.dumps(c)} (expected {json.dumps(want)})")
        if len(recs) != steps or not all(np.isfinite(r["loss"]) for r in recs):
            raise AssertionError(f"phase 10 {tag}: losses {[r['loss'] for r in recs]}")
        if dev.type == "cuda" and c != want:
            raise AssertionError(f"phase 10 {tag}: launches {c} != {want}")
        for k in counts:
            counts[k] += c[k]
        return tr, recs

    cli.build_params = build
    try:
        run_dir = str(root / "run")
        # 2 micro-steps (one update), state-2 saved; then the same command
        # resumes from state-2 and takes steps 3-4 (the next update)
        tr1, _ = run("run", flags + ["--output-dir", run_dir, "--max-steps", "2",
                                     "--save-steps", "2"], 2, 2)
        tr2, recs2 = run("resumed run", flags + ["--output-dir", run_dir, "--max-steps", "4",
                                                 "--save-steps", "0"], 2, 2)
        if tr2.state["step"] != 4 or sorted(p.name for p in Path(run_dir).iterdir()) != [
                "adapter_config.json", "adapter_model.bin", "checkpoint-2", "config.json",
                "metrics.jsonl", "non_lora_trainables.bin", "state-2"]:
            raise AssertionError(f"phase 10: resumed at step {tr2.state['step']}, files "
                                 f"{sorted(p.name for p in Path(run_dir).iterdir())}")
        # only the adapters and the extras moved: the base's bytes are the
        # freshly built ones', the NF4 layers included
        after = tree_hash(tr2.base)
        nf4 = sorted(p for p in after if p.endswith("/nf4"))
        moved = sorted(p for p in after if after[p] != hashes[1].get(p))
        if moved or after.keys() != hashes[1].keys() or not nf4:
            raise AssertionError(f"phase 10: the frozen base moved ({moved[:4]}) or holds no "
                                 f"NF4 leaf ({len(nf4)})")
        trained = tr2.state["params"]
        base_leaves = dict(named_leaves(tr2.base))
        extras_moved = [p for p, t in named_leaves(trained["extras"])
                        if not torch.equal(t, base_leaves[p])]
        b_max = max(float(ab["B"].detach().abs().max()) for ab in trained["adapters"].values())
        log(f"phase 10: base unchanged ({len(after)} leaves, {len(nf4)} NF4, hashes equal to "
            f"the freshly built ones'); adapters' largest |B| {b_max:.3g}; "
            f"{len(extras_moved)} projector/sampler leaves moved")
        if not b_max > 0 or not extras_moved:
            raise AssertionError("phase 10: the adapters or the extras did not move")
        # the saved adapter files load back with import_peft
        from slime_tpu_torch import checkpoint as ckpt
        sd = ckpt.load_state_dict_file(str(Path(run_dir) / "adapter_model.bin"))
        back = lora.import_peft(sd, r=128, alpha=256)
        bad = [p for p, ab in trained["adapters"].items()
               if not all(np.array_equal(back["adapters"][p][k].numpy(),
                                         ab[k].detach().cpu().numpy()) for k in "AB")]
        log(f"phase 10: adapter_model.bin loads back with import_peft: "
            f"{len(back['adapters'])} adapters, {len(bad)} differ")
        if bad or set(back["adapters"]) != set(trained["adapters"]):
            raise AssertionError(f"phase 10: adapter files differ: {bad[:3]}")
        resumed = {p: t.detach().clone() for p, t in named_leaves(trained)}
        del tr2, trained, back, sd, base_leaves
        gc.collect()
        torch.cuda.empty_cache()

        # the uninterrupted run: the first trainer continues through steps
        # 3-4 on the batches the resumed command was fed (JAX's resume skips
        # none: the loader's first two)
        from slime_tpu_torch.config import SliMEConfig
        args = cli.parse_args(flags + ["--output-dir", str(root / "cont")])
        ds = cli.build_dataset(args, SliMEConfig.load(str(root / "model")), tok)
        tr1.rc = dataclasses.replace(tr1.rc, max_steps=4, save_steps=0,
                                     output_dir=str(root / "cont"))
        (root / "cont").mkdir()
        tr1.metrics_file = str(root / "cont" / "metrics.jsonl")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated() / 2 ** 30
        reset_launch_counts()
        tr1.train(cli.batches(args, ds, tok.pad_token_id))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        recs1 = [json.loads(x) for x in (root / "cont" / "metrics.jsonl").read_text()
                 .splitlines()]
        worst = max(float((t.detach() - resumed[p]).abs().max() / max(
            float(resumed[p].abs().max()), 1e-30)) for p, t in named_leaves(tr1.state["params"]))
        dl = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(recs1, recs2))
        log(f"phase 10 resume: steps 3-4 of the uninterrupted trainer against the resumed "
            f"command: losses {[r['loss'] for r in recs1]} vs {[r['loss'] for r in recs2]} "
            f"(largest rel diff {dl:.3g}); trained leaves' largest diff {worst:.3g} of the "
            f"leaf's largest entry (bound {TRAIN_CLI_RESUME_TOL:g}: a bf16 ulp)")
        log(f"phase 10 QLoRA steps: peak memory {peak:.2f} GiB over the steps "
            f"({base_mem:.2f} GiB held before them: the NF4 base, fp32 embeddings, lm_head "
            f"and tower, the adapters, Adam and the accumulator)")
        if worst > TRAIN_CLI_RESUME_TOL or dl > TRAIN_CLI_RESUME_TOL:
            raise AssertionError("phase 10: the resumed run is not the uninterrupted one")

        # one traced micro-step: idle share, K5-K5c, the dequantizing copies
        batch = tr1._put(next(iter(cli.batches(args, ds, tok.pad_token_id))))
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            tr1.step_fn(tr1.state, batch, tr1.generator)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = min(walls)
        real_deq = layers.dequantize_weight

        def traced_deq(w):
            with record_function("dequantize"):
                return real_deq(w)
        path = out / "profile_qlora_step.json"
        layers.dequantize_weight = traced_deq
        try:
            ok = profiled(lambda: tr1.step_fn(tr1.state, batch, tr1.generator), path)
        finally:
            layers.dequantize_weight = real_deq
        if ok:
            busy, n_k, by_name = trace_device(path)
            parts, _ = trace_ranges(path, ["dequantize"])
            log(f"phase 10 QLoRA micro-step (B = {TRAIN_CLI_BATCH}, S = 2048, remat, "
                f"multimodal): host wall {wall:.1f} ms (best of 2, unprofiled), "
                f"{TRAIN_CLI_BATCH * 2048 / wall * 1e3:.1f} tokens/s; device busy {busy:.1f} "
                f"ms; idle share {1 - busy / wall:.3f}; {n_k} kernel launches")
            for part, pat in (("K5 (flash_fwd_kernel)", "flash_fwd_kernel"),
                              ("K5b (flash_bwd_dkdv_kernel)", "flash_bwd_dkdv_kernel"),
                              ("K5c (flash_bwd_dq_kernel)", "flash_bwd_dq_kernel"),
                              ("K4 (enc_attn)", "enc_attn")):
                ms, nk = trace_kernel(path, pat)
                log(f"phase 10 QLoRA micro-step device time {part}: {ms:.2f} ms, {nk} launches")
            log(f"phase 10 QLoRA micro-step device time in the NF4 dequantizing copies "
                f"(forward, recompute and backward): {parts['dequantize'][0]:.1f} ms over "
                f"{parts['dequantize'][1]} launches")
            for kname, kms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
                log(f"phase 10 QLoRA micro-step kernel {kms:8.2f} ms  {kname[:90]}")
        del tr1, batch, resumed
        gc.collect()
        torch.cuda.empty_cache()

        # packed text-only rows: K5 with segment_ids
        run("packed run", flags + ["--data-path", str(text_json), "--output-dir",
                                   str(root / "packed"), "--seq-packing", "--max-steps", "2",
                                   "--save-steps", "0", "--num-train-epochs", "2"], 2, 0)
    finally:
        cli.build_params = real_build
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


class ByteIdTokenizer(ByteTokenizer):
    """The byte tokenizer whose decode writes every id (``IdText``): a random
    model's answers are mostly ids above 255, which text would drop."""

    def decode(self, ids, skip_special_tokens=True):
        return IdText().decode(ids)


def png_b64(arr):
    """A uint8 [H, W, 3] image as base64 PNG bytes (the HTTP image format)."""
    import base64
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def expect_launches(tag, got, want):
    """Raise unless each kernel of ``want`` ({record: count}) launched its
    count exactly (on the card; the CPU's plain versions count nothing)."""
    off = {n: (got.get(n, 0), w) for n, w in want.items() if got.get(n, 0) != w}
    log(f"phase {tag} launches {json.dumps({n: got.get(n, 0) for n in want})} (expected "
        f"{json.dumps(want)})")
    if torch.cuda.is_available() and off:
        raise AssertionError(f"phase {tag}: launches (got, expected) {off}")


def seq_logprobs(params, cfg, ids, attn, pv, cm, tokens):
    """Each of ``tokens``' bf16 log-probs after the prompt and the tokens
    before it, teacher-forced through ``prefill`` and B = 1 decode steps (a
    cache of L + len)."""
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import llama
    from slime_tpu_torch.models.layers import fp32_accumulation

    bf = torch.bfloat16
    with torch.no_grad(), fp32_accumulation():
        logits, kvs, lengths, L = gen.prefill(params, cfg, ids, attn, pv, cm, bf)
        cache = llama.prefill_into_cache(
            llama.init_kv_cache(cfg.llm, 1, L + len(tokens), dtype=bf, device=ids.device),
            kvs, lengths)
        del kvs
        out = []
        for i, t in enumerate(tokens):
            out.append(float(torch.log_softmax(logits.float(), dim=-1)[0, t]))
            if i + 1 < len(tokens):
                logits, cache = llama.decode_step(
                    params["llm"], cache, torch.tensor([t], dtype=torch.int32, device=ids.device),
                    cfg.llm, compute_dtype=bf)
    return out


def seq_score(params, cfg, ids, attn, pv, cm, tokens):
    """The joint bf16 log-prob of ``tokens`` after the prompt (``seq_logprobs``)."""
    return sum(seq_logprobs(params, cfg, ids, attn, pv, cm, tokens))


def branches_phase(dev, cfg, params):
    """Phases 2-3's other branches on the int8 model (bf16), each counted
    window with the counts set to 0 just before and read just after: a
    two-image ``generate`` (twice: the same tokens); one image through the
    multi-image splice against ``prepare_multimodal``; ``beam_search`` at
    3 beams (K1-K3 on the ring at 3 rows), at 1 beam against greedy
    ``generate`` and its best beam's score against greedy's; a two-image
    request to the model worker over HTTP against the in-process
    ``generate``; the identity resampler at full width (LLaVA-NeXT's layout:
    mlp2x_gelu, 4 local crops, 5 x 576 image tokens) through ``generate``,
    its 'unpad' merge and the sampler's 'spatial' merge, exactly. Returns
    the counted windows' launches."""
    import gc

    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.config import IMAGE_TOKEN_INDEX
    from slime_tpu_torch.data.image_ops import (make_device_anyres_fn,
                                                process_anyres_image_host,
                                                spatial_local_perm, unpad_token_order)
    from slime_tpu_torch.data.tokenization import tokenizer_image_token
    from slime_tpu_torch.models import projector, slime
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.serve.model_worker import ModelWorker
    from slime_tpu_torch.serve.model_worker import build_server as build_worker

    bf = torch.bfloat16
    L = cfg.llm.num_layers
    vis = cfg.vision.num_layers + cfg.vision.select_layer + 1
    img, ids, attn, anyres = query(dev, cfg)
    cfg_run = dataclasses.replace(cfg, eos_token_id=-1)
    rng = np.random.default_rng(SEED + 30)
    img2_np = rng.integers(0, 255, (672, 672, 3), dtype=np.uint8)
    img2 = torch.from_numpy(img2_np).to(dev)
    counts = {}

    def window(tag, fn, want):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launch_counts()
        expect_launches(tag, got, want)
        for n, c in got.items():
            counts[n] = counts.get(n, 0) + c
        return out, wall

    ring = lambda steps: {n + "_ring": L * steps for n in FUSED}   # noqa: E731

    # two images: [1, 2, 8, 3, 336, 336], each <image> its own block
    ids2 = ids.clone()
    ids2[:, 20] = IMAGE_TOKEN_INDEX
    cfg2 = dataclasses.replace(cfg_run, tokenizer_model_max_length=BRANCH_LEN)

    def two_images():
        (c1, m1), (c2, m2) = anyres(img), anyres(img2)
        return gen.generate(params, cfg2, ids2, attn, torch.stack([c1, c2])[None],
                            torch.stack([m1, m2])[None], max_new_tokens=BRANCH_NEW,
                            compute_dtype=bf)
    a, wall = window("2 two-image generate", two_images,
                     {"encoder_attention": vis, "flash_fwd": L, **ring(BRANCH_NEW - 1)})
    b = two_images()
    (c1, m1), (c2, m2) = anyres(img), anyres(img2)
    _, _, lengths, Lpad = gen.prefill(params, cfg2, ids2, attn, torch.stack([c1, c2])[None],
                                      torch.stack([m1, m2])[None], bf)
    log(f"phase 2 two-image generate ([1, 2, 8, 3, 336, 336], sentinels at 2 and 20): "
        f"{int(lengths[0])} valid of {Lpad} positions; {BRANCH_NEW} greedy tokens in "
        f"{wall * 1e3:.1f} ms; repeats {torch.equal(a, b)}; first tokens {a[0, :6].tolist()}")
    if not torch.equal(a, b) or a.shape != (1, BRANCH_NEW):
        raise AssertionError("phase 2: the two-image answers differ or are misshapen")

    # one image through the multi-image splice: the single-image fusion, exactly
    c, m = anyres(img)
    with torch.no_grad(), fp32_accumulation():
        single = slime.prepare_multimodal(params, cfg, ids, attn, c[None], m[None],
                                          compute_dtype=bf)
        multi = slime.prepare_multimodal_multi(params, cfg, ids, attn, c[None, None],
                                               m[None, None], compute_dtype=bf)
    same = all(torch.equal(x, y) for x, y in zip(single, multi))
    log(f"phase 2 one image through prepare_multimodal_multi equals prepare_multimodal: "
        f"{same} (embeds, mask, positions, labels, lengths; {int(single.lengths[0])} valid)")
    if not same:
        raise AssertionError("phase 2: the multi-image splice of one image is not the "
                             "single-image fusion")

    # beam search on bench.py's query
    def beam(K):
        c, m = anyres(img)
        return gen.beam_search(params, cfg_run, ids, attn, c[None], m[None], num_beams=K,
                               max_new_tokens=BRANCH_NEW, compute_dtype=bf)
    beam(3)                                           # warm-up (the sort's workspace)
    b3, wall = window("2 beam search, 3 beams", lambda: beam(3),
                      {"encoder_attention": vis, "flash_fwd": L, **ring(BRANCH_NEW - 1)})
    b1 = beam(1).cpu()
    c, m = anyres(img)
    greedy = gen.generate(params, cfg_run, ids, attn, c[None], m[None],
                          max_new_tokens=BRANCH_NEW, compute_dtype=bf).cpu()
    part = next((i for i in range(BRANCH_NEW) if int(b1[0, i]) != int(greedy[0, i])), None)
    gap = None
    if part is not None:
        logits = teacher_logits(params, cfg_run, ids, attn, c[None], m[None],
                                greedy[0].tolist(), part)
        top2 = logits.float().topk(2).values
        gap = float(top2[0] - top2[1])
    s_beam = seq_score(params, cfg_run, ids, attn, c[None], m[None], b3[0].tolist())
    s_greedy = seq_score(params, cfg_run, ids, attn, c[None], m[None], greedy[0].tolist())
    log(f"phase 2 beam_search (3 beams, {BRANCH_NEW} tokens, bench.py's query): "
        f"{wall * 1e3:.1f} ms, {wall * 1e3 / BRANCH_NEW:.2f} ms a token; 1 beam "
        + ("equals greedy generate token for token" if part is None else
           f"parts from greedy at step {part} (greedy's top-two gap there {gap:.4g}, "
           f"bound {ENGINE_TIE_ATOL})")
        + f"; best beam's joint log-prob {s_beam:.4f} / {BRANCH_NEW} = "
        f"{s_beam / BRANCH_NEW:.5f} against greedy's {s_greedy:.4f} / {BRANCH_NEW} = "
        f"{s_greedy / BRANCH_NEW:.5f} (teacher-forced, B = 1; slack {BEAM_SCORE_SLACK})")
    if part is not None and gap > ENGINE_TIE_ATOL:
        raise AssertionError(f"phase 2: 1-beam search parts from greedy at step {part}")
    if dev.type == "cuda":
        # a step's reorder of the whole cache by source beam (k, v of every
        # layer at 3 rows x L + BRANCH_NEW positions), alone on the device
        _, kvs, lengths, Lp = gen.prefill(params, cfg_run, ids, attn, c[None], m[None], bf)
        kv = torch.zeros((L, 3, Lp + BRANCH_NEW) + kvs[0][0].shape[2:], dtype=bf, device=dev)
        del kvs
        gather = torch.tensor([2, 0, 0], device=dev)
        reorder = cuda_ms(lambda: (kv[:, gather], kv[:, gather]))
        log(f"phase 2 beam_search's cache reorder a step (k and v [{L}, 3, {Lp + BRANCH_NEW}, "
            f"{cfg.llm.num_kv_heads}, {cfg.llm.head_dim}] bf16 gathered by source beam): "
            f"{reorder:.3f} ms on the device, {2 * nbytes(kv) * 2 / reorder / 1e6:.0f} GB/s "
            f"(read and write)")
        del kv
    if s_beam < s_greedy - BEAM_SCORE_SLACK:
        raise AssertionError("phase 2: the best beam scores below greedy")

    # a two-image request to the model worker over HTTP
    tok = ByteIdTokenizer(cfg.bos_token_id)
    worker = ModelWorker(controller_addr=None, worker_addr=None, model_name="slime-8b",
                         params=params, cfg=cfg, tokenizer=tok, compute_dtype=bf,
                         register=False, device=dev)
    srv = build_worker(worker, "localhost", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        prompt = "<image>\n<image>\nWhat differs between the two pictures?"
        imgs = [img.cpu().numpy(), img2_np]
        chunks, first_s, total_s = http_stream(
            f"http://localhost:{srv.port}/worker_generate_stream",
            {"prompt": prompt, "images": [png_b64(x) for x in imgs],
             "max_new_tokens": BRANCH_NEW, "temperature": 0.0})
    finally:
        srv.shutdown()
    del worker, srv                   # the server's routes refer to the worker and its params
    from PIL import Image
    crops = [process_anyres_image_host(Image.fromarray(x), max_crops=1 + cfg.max_local_crops)
             for x in imgs]
    hids = torch.from_numpy(tokenizer_image_token(prompt, tok, return_tensors="np")[None]
                            .astype(np.int64)).to(dev)
    with torch.no_grad():
        want = gen.generate(params, cfg, hids, torch.ones_like(hids, dtype=torch.bool),
                            torch.from_numpy(np.stack([x for x, _, _ in crops]))[None].to(dev),
                            torch.from_numpy(np.stack([y for _, y, _ in crops]))[None].to(dev),
                            max_new_tokens=BRANCH_NEW, compute_dtype=bf,
                            cache_len=cfg.tokenizer_model_max_length + BRANCH_NEW + 1)
    want_text = tok.decode(gen.trim_at_eos(want, cfg.eos_token_id)[0])
    log(f"phase 9 model worker over HTTP, two images: {len(chunks)} chunks, first after "
        f"{first_s * 1e3:.1f} ms, all in {total_s * 1e3:.1f} ms; streamed tokens equal the "
        f"in-process generate's: {chunks[-1]['text'] == want_text}")
    if chunks[-1]["text"] != want_text:
        raise AssertionError("phase 9: the two-image HTTP answer differs from generate's")

    # the identity resampler at full width (LLaVA-NeXT's layout)
    cfg_id = dataclasses.replace(cfg, mm_projector_type="mlp2x_gelu",
                                 mm_resampler_type="identity", max_local_crops=4,
                                 tokenizer_model_max_length=BRANCH_LEN)
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    params_id = {"vision": params["vision"], "llm": params["llm"],
                 "projector": projector.init(cfg_id, generator=g, device=dev)}
    anyres5 = make_device_anyres_fn((672, 672), max_crops=5, device=dev)
    c5, m5 = anyres5(img)
    cfg_id_run = dataclasses.replace(cfg_id, eos_token_id=-1)
    out, wall = window(
        "2 identity resampler generate",
        lambda: gen.generate(params_id, cfg_id_run, ids, attn, c5[None], m5[None],
                             max_new_tokens=8, compute_dtype=bf),
        {"encoder_attention": vis, "flash_fwd": L, **ring(7)})
    _, _, lengths, Lpad = gen.prefill(params_id, cfg_id_run, ids, attn, c5[None], m5[None], bf)
    log(f"phase 2 identity resampler (mlp2x_gelu projector, fp32, random; {int(m5.sum())} "
        f"crops x 576 tokens): generate of 8 tokens {wall * 1e3:.1f} ms; prefill "
        f"{int(lengths[0])} valid of {Lpad} positions; tokens {out[0].tolist()}")
    if int(lengths[0]) != 5 * 576 + ids.shape[1] - 1 or not bool((out >= 0).all()):
        raise AssertionError(f"phase 2: the identity path's prefill has {int(lengths[0])} "
                             f"valid positions")

    # its 'unpad' merge: every row the flat merge's or image_newline, exactly
    P, grid = cfg.vision.num_patches, cfg.vision.num_patches_per_side
    cfg_un = dataclasses.replace(cfg_id, mm_patch_merge_type="spatial_unpad")
    newline = (torch.randn((cfg.hidden_size,), generator=g, device=dev)
               / cfg.hidden_size ** 0.5)
    src, valid = unpad_token_order(2, 2, grid, (672, 672), 4 * P + 2 * grid)
    src_t, valid_t = torch.from_numpy(src).to(dev), torch.from_numpy(valid).to(dev)
    with torch.no_grad(), fp32_accumulation():
        flat, _ = slime.encode_images(params_id, cfg_id, c5[None], m5[None], ids, attn,
                                      compute_dtype=bf)
        un, un_valid = slime.encode_images({**params_id, "image_newline": newline}, cfg_un,
                                           c5[None], m5[None], ids, attn, compute_dtype=bf,
                                           unpad_order=(src_t[None], valid_t[None]))
        want = torch.cat([flat[0, :P], torch.where(
            (src_t < 0)[:, None], newline.to(bf)[None],
            flat[0, P + src_t.clamp(min=0).long()])])
    ok = torch.equal(un[0], want) and bool(un_valid.all())
    log(f"phase 2 'unpad' merge: {un.shape[1]} rows ({int((src < 0).sum())} newlines); each "
        f"row the flat merge's or image_newline, exactly: {ok}")
    if not ok:
        raise AssertionError("phase 2: the unpad merge's rows are not the flat merge's")

    # the sampler's 'spatial' merge: a permutation of the flat local rows
    dim = cfg.mm_resampler_dim
    perm = torch.from_numpy(spatial_local_perm(2, 2, int(round(dim ** 0.5)),
                                               cfg.max_local_crops * dim)).to(dev)
    with torch.no_grad(), fp32_accumulation():
        flat, _ = slime.encode_images(params, cfg, c[None], m[None], ids, attn,
                                      compute_dtype=bf)
        sp, _ = slime.encode_images(params, cfg, c[None], m[None], ids, attn,
                                    compute_dtype=bf, local_token_perm=perm[None])
    ok = torch.equal(sp[0, P + 1:], flat[0, P + 1:][perm.long()])
    log(f"phase 2 'spatial' merge: the local block ({cfg.max_local_crops * dim} rows) a "
        f"permutation of the flat merge's, exactly: {ok}")
    if not ok:
        raise AssertionError("phase 2: the spatial merge is not a permutation of the flat one")
    del params_id, flat, un, sp
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def dpo_data(root):
    """DPO_RECORDS preference records, half with a 672x672 PNG (from the
    seed): a ~90-byte prompt and ~300-byte chosen and rejected answers that
    share it; -> the records' JSON path."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 40)
    (root / "images").mkdir(parents=True, exist_ok=True)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz      "))
    words = lambda n: "".join(rng.choice(letters, n)).strip()  # noqa: E731
    recs = []
    for i in range(DPO_RECORDS):
        q = words(90)
        rec = {"id": str(i), "conversations": [{"from": "human", "value": q}],
               "chosen": words(290 + int(rng.integers(0, 20))),
               "rejected": words(290 + int(rng.integers(0, 20)))}
        if i % 2 == 0:
            Image.fromarray(rng.integers(0, 255, (672, 672, 3), dtype=np.uint8)).save(
                root / "images" / f"p{i}.png")
            rec["image"] = f"p{i}.png"
            rec["conversations"][0]["value"] = "<image>\n" + q
        recs.append(rec)
    (root / "pref.json").write_text(json.dumps(recs))
    return root / "pref.json"


def dpo_cli_phase(dev, cfg):
    """Phase 11a: QLoRA-DPO from the command line (``train.cli.main`` with
    phase 10's QLoRA flags and --task DPO), bench_dpo_8b.py's step (policy
    forward, dX backward, remat re-forward, a reference forward without
    gradient) at SliME-8B's full width and ``cfg``'s depth (CUT_LAYERS of
    32 from ``main``) from random fp32 weights;
    then an ipo, token-weighted, SFT-mixed command for one step. Returns the
    launch counts of both commands."""
    import gc
    import shutil

    from slime_tpu_torch.train import cli

    out = Path(__file__).resolve().parent / "bench_out"
    root = out / "dpo_cli"
    shutil.rmtree(root, ignore_errors=True)
    (root / "model").mkdir(parents=True)
    cfg.save(str(root / "model"))
    tok = ByteTokenizer(cfg.bos_token_id, pad_token_id=cfg.eos_token_id)
    pref = dpo_data(root)
    L = cfg.llm.num_layers
    vis = cfg.vision.num_layers + cfg.vision.select_layer + 1
    flags = ["--model-path", str(root / "model"), "--data-path", str(pref),
             "--image-folder", str(root / "images"), "--version", "llama3",
             "--model-max-length", "2048", "--lora-enable", "--lora-r", "128",
             "--lora-alpha", "256", "--bits", "4", "--learning-rate", "2e-4",
             "--mm-projector-lr", "2e-5", "--warmup-ratio", "0.03", "--logging-steps", "1",
             "--per-device-batch-size", str(DPO_PAIRS), "--remat", "--save-steps", "0",
             "--task", "DPO", "--device", str(dev)]
    log(f"phase 11a: python -m slime_tpu_torch.train.cli {' '.join(flags[6:])} "
        f"--dpo-loss-type sigmoid --dpo-beta 0.1 --max-steps {DPO_STEPS} (phase 10's QLoRA "
        f"flags; {DPO_RECORDS} preference records, half with a 672x672 image; "
        f"{DPO_PAIRS} pairs = {2 * DPO_PAIRS} rows a step)")
    hashes = []
    real_build = cli.build_params

    def build(*a):
        p = real_build(*a)
        torch.cuda.synchronize()
        hashes.append(tree_hash(p))
        return p
    counts = {}
    # a step: the reference's forward and the policy's (no gradient for the
    # frozen tower: one encode each), the policy's layers again under remat,
    # and its backward
    per_step = {"encoder_attention": 2 * vis, "flash_fwd": 3 * L, "flash_bwd_dkdv": L,
                "flash_bwd_dq": L}

    def run(tag, argv, steps):
        out_dir = argv[argv.index("--output-dir") + 1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        tr = cli.main(argv, tokenizer=tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launch_counts()
        expect_launches(f"11a {tag}", got, {n: c * steps for n, c in per_step.items()})
        for n in per_step:
            counts[n] = counts.get(n, 0) + got[n]
        recs = [json.loads(x) for x in (Path(out_dir) / "metrics.jsonl").read_text()
                .splitlines()]
        for r in recs:
            log(f"phase 11a {tag} step {r['step']}: loss {r['loss']:.6f}, reward margin "
                f"{r['reward_margin']:.5f}, accuracy {r['reward_accuracy']:.2f}, grad_norm "
                f"{r['grad_norm']:.5f}, {r['tokens_per_sec']:.1f} tokens/s host "
                f"({2 * DPO_PAIRS * 2048 / r['tokens_per_sec'] * 1e3:.1f} ms a step)"
                + "".join(f", {k} {r[k]:.2f}" for k in ("target_tokens", "target_weight_mass")
                          if k in r))
        log(f"phase 11a {tag}: {wall:.1f} s in all (parameters built, NF4 quantized, "
            f"trained, saved); peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if len(recs) != steps or not all(np.isfinite(r["loss"]) for r in recs):
            raise AssertionError(f"phase 11a {tag}: losses {[r['loss'] for r in recs]}")
        return tr, recs

    cli.build_params = build
    try:
        tr, recs = run("sigmoid", flags + ["--output-dir", str(root / "run"), "--max-steps",
                                           str(DPO_STEPS), "--dpo-loss-type", "sigmoid",
                                           "--dpo-beta", "0.1"], DPO_STEPS)
        # the adapters start at B = 0: the policy is the reference, h = 0
        if abs(recs[0]["loss"] - np.log(2.0)) > 1e-3:
            raise AssertionError(f"phase 11a: first loss {recs[0]['loss']} is not log 2")
        after = tree_hash(tr.base)
        moved = sorted(p for p in after if after[p] != hashes[0].get(p))
        b_max = max(float(ab["B"].detach().abs().max())
                    for ab in tr.state["params"]["adapters"].values())
        nf4 = sum(p.endswith("/nf4") for p in after)
        log(f"phase 11a: first loss {recs[0]['loss']:.6f} (log 2 = {np.log(2.0):.6f}); base "
            f"unchanged ({len(after)} leaves, {nf4} NF4); adapters' largest |B| {b_max:.3g}")
        if moved or not nf4 or not b_max > 0:
            raise AssertionError(f"phase 11a: the base moved ({moved[:3]}) or the adapters "
                                 f"did not")

        # one traced step
        from slime_tpu_torch.config import SliMEConfig
        args = cli.parse_args(flags + ["--output-dir", str(root / "run")])
        ds = cli.build_dataset(args, SliMEConfig.load(str(root / "model")), tok)
        batch = tr._put(next(iter(cli.batches(args, ds, tok.pad_token_id))))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.step_fn(tr.state, batch, tr.generator)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        log(f"phase 11a QLoRA-DPO step alone: peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({held:.2f} GiB held "
            f"before it: the NF4 base, fp32 embeddings, lm_head and tower, the adapters and "
            f"Adam)")
        path = out / "profile_dpo_step.json"
        if profiled(lambda: tr.step_fn(tr.state, batch, tr.generator), path):
            busy, n_k, by_name = trace_device(path)
            log(f"phase 11a QLoRA-DPO step ({2 * DPO_PAIRS} rows, S = 2048, remat): host wall "
                f"{wall:.1f} ms (unprofiled), {2 * DPO_PAIRS * 2048 / wall * 1e3:.1f} "
                f"tokens/s; device busy {busy:.1f} ms; idle share {1 - busy / wall:.3f}; "
                f"{n_k} kernel launches")
            for part, pat in (("K5 (flash_fwd_kernel)", "flash_fwd_kernel"),
                              ("K5b (flash_bwd_dkdv_kernel)", "flash_bwd_dkdv_kernel"),
                              ("K5c (flash_bwd_dq_kernel)", "flash_bwd_dq_kernel"),
                              ("K4 (enc_attn)", "enc_attn")):
                ms, nk = trace_kernel(path, pat)
                log(f"phase 11a QLoRA-DPO step device time {part}: {ms:.2f} ms, {nk} launches")
            for kname, kms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
                log(f"phase 11a QLoRA-DPO step kernel {kms:8.2f} ms  {kname[:90]}")
        del tr, batch, ds
        gc.collect()
        torch.cuda.empty_cache()

        tr, recs = run("ipo, token-weighted, SFT mix",
                       flags + ["--output-dir", str(root / "ipo"), "--max-steps", "1",
                                "--dpo-loss-type", "ipo", "--dpo-token-weighted",
                                "--sft-weight", "0.1"], 1)
        if "target_weight_mass" not in recs[0] or "target_tokens" in recs[0]:
            raise AssertionError(f"phase 11a: the token-weighted step logged {sorted(recs[0])}")
        del tr
    finally:
        cli.build_params = real_build
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def bf16_train_params(dev, cfg, seed=SEED):
    """Phase 4's build of SliME-8B for training: LLM and CLIP-L bf16 (LLM
    layers stacked), projector and sampler fp32, from ``seed``."""
    from slime_tpu_torch.models import llama, projector, sampler, vit

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    params = {"vision": vit.init(cfg.vision, generator=g, device=dev, dtype=bf),
              "projector": projector.init(cfg, generator=g, device=dev),
              "sampler": sampler.init(cfg, generator=g, device=dev),
              "llm": llama.init(cfg.llm, generator=g, device=dev, dtype=bf)}
    params["llm"]["layers"] = llama.stack_layers(params["llm"]["layers"])
    return params


def moments(tr):
    """The 8-bit moments of a trainer's optimizer, as a tree."""
    return {str(i): st for i, st in enumerate(st for g in tr.tx.groups for st in g["opt"].state)}


def opt8_phase(dev, cfg):
    """Phase 11b: a full-parameter step with 8-bit Adam moments on phase 4's
    bf16 SliME-8B at ``cfg``'s depth (CUT_LAYERS of 32 from ``main``; every
    leaf but the frozen tower trainable), B = 1, S =
    2048, remat, through the ``Trainer``: the state's size against fp32
    Adam's, peak memory, step and update times; every trainable leaf moved;
    ``layers/gate_proj``'s codes and scales after step 1 against opt8's
    whole-leaf function on the same gradient, exactly; step 2 after the
    train state's round trip through the host (``state_ckpt``) equal to the
    uninterrupted step 2. Returns the launch counts of its 3 steps."""
    import gc
    import shutil

    from slime_tpu_torch.params import named_leaves
    from slime_tpu_torch.train import opt8, state_ckpt
    from slime_tpu_torch.train import optim as optim_mod
    from slime_tpu_torch.train.optim import TrainConfig, label_tree
    from slime_tpu_torch.train.trainer import RunConfig, Trainer

    out = Path(__file__).resolve().parent / "bench_out" / "opt8"
    shutil.rmtree(out, ignore_errors=True)
    L = cfg.llm.num_layers
    vis = cfg.vision.num_layers + cfg.vision.select_layer + 1
    tc = TrainConfig(learning_rate=OPT8_LR, total_steps=2, warmup_ratio=0.0,
                     lr_schedule="constant", optim="adamw8bit")
    rc = RunConfig(output_dir=str(out), save_steps=0, log_steps=1, max_steps=1, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(bf16_train_params(dev, cfg), cfg, tc, rc, remat=True)
    torch.cuda.synchronize()
    labels = dict(named_leaves(label_tree(tr.params, tc)))
    trainable = {p: t for p, t in named_leaves(tr.params) if labels[p] != "frozen"}
    est = opt8.state_bytes(trainable)
    held = sum(t.numel() * t.element_size() for g in tr.tx.groups
               for st in g["opt"].state for t in st.values())
    log(f"phase 11b trainer built in {time.perf_counter() - t0:.1f} s: "
        f"{est['params'] / 1e9:.3f} G trainable parameters ({len(trainable)} leaves; the "
        f"tower frozen); opt8.state_bytes {est['int8_adam_bytes'] / 2 ** 30:.2f} GiB against "
        f"fp32 Adam's {est['fp32_adam_bytes'] / 2 ** 30:.2f} GiB (ratio {est['ratio']:.3f}); "
        f"8-bit state as allocated {held / 2 ** 30:.2f} GiB; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    # as allocated, each leaf's last block is padded to 256 codes
    padded = sum(-(-t.numel() // opt8.BLOCK) * (2 * opt8.BLOCK + 8) for t in trainable.values())
    if held != padded:
        raise AssertionError(f"phase 11b: the state holds {held} bytes, not {padded}")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in train_batches(cfg, np.random.default_rng(SEED + 50), 2, 1)]

    gate = tr.params["llm"]["layers"]["gate_proj"]["weight"]
    rows = (0, 1, L - 1)          # layer 1 crosses the first 2^26-element slice
    seen = {}
    real_update, real_step = opt8.update_leaf, optim_mod.GroupedAdamW.step
    upd_ms = []

    def spy(g, st, **kw):
        if g is gate.grad and not seen:
            seen.update(g={r: g[r].clone() for r in rows}, st=st)
        return real_update(g, st, **kw)

    def timed_step(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        norm = real_step(self)
        torch.cuda.synchronize()
        upd_ms.append((time.perf_counter() - t0) * 1e3)
        return norm

    before = snapshot(tr.params)
    walls = []

    def step(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train(batches)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return m

    reset_launch_counts()
    opt8.update_leaf, optim_mod.GroupedAdamW.step = spy, timed_step
    try:
        m1 = step(batches[:1])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # gate_proj's codes and scales against the whole-leaf function
        bc1, bc2 = opt8.bias_corrections(1, tc.adam_b1, tc.adam_b2, dev)
        nb = gate[0].numel() // opt8.BLOCK
        z = opt8.init_leaf(gate[0])
        exact = True
        for r in rows:
            _, mq, ms, vq, vs = opt8.leaf_update(
                seen["g"][r], z["m_q"], z["m_s"], z["v_q"], z["v_s"], bc1=bc1, bc2=bc2,
                b1=tc.adam_b1, b2=tc.adam_b2, eps=tc.adam_eps)
            st = seen["st"]
            exact &= all(torch.equal(st[k][r * nb:(r + 1) * nb], w)
                         for k, w in (("m_q", mq), ("m_s", ms), ("v_q", vq), ("v_s", vs)))
        log(f"phase 11b step 1: loss {m1['loss']:.5f}, grad_norm {m1['grad_norm']:.4f}; host "
            f"{walls[0]:.1f} ms, of it the 8-bit update {upd_ms[0]:.1f} ms; peak memory "
            f"{peak:.2f} GiB; layers/gate_proj's codes and scales of layers {list(rows)} "
            f"equal opt8.leaf_update of the same gradient: {exact}")
        if not seen or not exact:
            raise AssertionError("phase 11b: gate_proj's 8-bit moments are not the "
                                 "whole-leaf function's")
        del seen["g"]
        saved = state_ckpt._to_host(tr._checkpointed())     # the train state, on the host
        tr.rc = dataclasses.replace(rc, max_steps=2)
        m2 = step(batches[1:])
        h2, st2 = tree_hash(tr.params), tree_hash(moments(tr))
        moved = moved_leaves(before, snapshot(tr.params))
        stay = sorted(p for p in moved if labels[p] == "frozen")
        # w_noise is never read (the gate's noise scale comes from w_gate, as
        # in the reference): its gradient is 0 and Adam leaves it in place
        still = sorted(p for p in trainable if p not in moved and p != "projector/w_noise")
        # resume: the state from after step 1, restored into the trainer
        tr.state["step"] = state_ckpt._restore_into(tr._checkpointed(), saved)["step"]
        del saved
        m2r = step(batches[1:])
    finally:
        opt8.update_leaf, optim_mod.GroupedAdamW.step = real_update, real_step
    same = (m2r["loss"] == m2["loss"] and tree_hash(tr.params) == h2
            and tree_hash(moments(tr)) == st2)
    got = launch_counts()
    expect_launches("11b", got, {"encoder_attention": 3 * vis, "flash_fwd": 3 * 2 * L,
                                 "flash_bwd_dkdv": 3 * L, "flash_bwd_dq": 3 * L})
    log(f"phase 11b step 2: loss {m2['loss']:.5f}; host {walls[1]:.1f} ms, update "
        f"{upd_ms[1]:.1f} ms; {len(moved)} leaves moved, {len(still)} trainable leaves did not "
        f"({still[:3]}), {len(stay)} frozen ones did ({stay[:3]}); step 2 after the train "
        f"state's round trip through the host: loss {m2r['loss']:.5f}, parameters and "
        f"moments equal the uninterrupted step's: {same}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not all(np.isfinite([m1["loss"], m2["loss"]])) or still or stay or not same:
        raise AssertionError("phase 11b: a loss is not finite, a trainable leaf did not move, "
                             "a frozen one did, or the resumed step differs")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    return {n: got[n] for n in ("encoder_attention", "flash_fwd", "flash_bwd_dkdv",
                                "flash_bwd_dq")}


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


class IdByteTokenizer(ByteTokenizer):
    """ByteTokenizer whose decode writes printable bytes as themselves and
    every other id as ``<id>``, so an answer's text names each token."""

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) if 32 < i < 127 else f"<{i}>" for i in ids)


class Recorder:
    """Wraps ``generate`` / ``beam_search`` as the eval drivers call them,
    keeping each call's inputs and tokens."""

    def __init__(self):
        self.calls = []

    def wrap(self, fn):
        def recorded(params, cfg, ids, attn, pv=None, cm=None, **kw):
            out = fn(params, cfg, ids, attn, pv, cm, **kw)
            self.calls.append((ids, attn, pv, cm, out))
            return out
        return recorded

    def rows(self):
        """[(ids, attn, pv, cm, tokens) of one row] over every call, in order."""
        return [tuple(None if t is None else t[b:b + 1] for t in call[:4])
                + (call[4][b].tolist(),)
                for call in self.calls for b in range(call[0].shape[0])]


def eval_data(root, cfg):
    """Phase 12's files: 4 images, 8 questions on them (one long), 8 video
    frames of 640x360 in ``frames/v0``, an MMBench TSV of 2 rows with 4
    options, a TextVQA annotation."""
    import base64
    import io

    from PIL import Image

    rng = np.random.default_rng(SEED + 40)
    (root / "imgs").mkdir(parents=True)
    for i, (w, h) in enumerate(EVAL_SIZES):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "imgs" / f"im{i}.png")
    texts = ["What is in the picture?", "What color is the sky here?",
             "Describe the image in one sentence. " * 4, "Is there a cat?",
             "How many objects are there?", "What is written on the sign?",
             "Where was this taken?", "Which animal is this?"]
    questions = [{"question_id": i, "image": f"im{i % len(EVAL_SIZES)}.png", "text": t}
                 for i, t in enumerate(texts[:EVAL_QUESTIONS])]
    (root / "frames" / "v0").mkdir(parents=True)
    for i in range(EVAL_FRAMES):
        Image.fromarray(rng.integers(0, 255, (360, 640, 3), dtype=np.uint8)).save(
            root / "frames" / "v0" / f"{i:03d}.png")
    video = [{"video_id": "v0", "videoID": "v0", "question_id": f"v0-{i}",
              "duration": "short", "question": q, "answer": "A",
              "options": ["A. a cat", "B. a dog", "C. a car", "D. a tree"]}
             for i, q in enumerate(("What is shown?", "What moves in the video?"))]
    cols = ["index", "question", "hint", "A", "B", "C", "D", "answer", "category", "image"]
    lines = ["\t".join(cols)]
    for i in range(2):
        buf = io.BytesIO()
        # small: the TSV reader (csv, as the JAX package's) takes fields up to 128 KiB
        Image.fromarray(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)).save(buf, "PNG")
        lines.append("\t".join([str(i), f"Which option fits image {i}?", "a photo",
                                "red", "green", "blue", "black", "A", "c",
                                base64.b64encode(buf.getvalue()).decode()]))
    (root / "mmbench.tsv").write_text("\n".join(lines) + "\n")
    (root / "q.jsonl").write_text("".join(json.dumps(q) + "\n" for q in questions))
    (root / "ann.json").write_text(json.dumps({"data": [
        {"question_id": q["question_id"], "answers": ["yes"] * 10} for q in questions]}))
    return questions, video


def eval_phase(dev, cfg):
    """Phase 12: evaluation on SliME-8B at full width and ``cfg``'s depth
    (CUT_LAYERS of 32 from ``main``), bf16
    throughout (dense LLM, stacked; what ``eval.cli`` loads a bf16
    checkpoint into), with a byte tokenizer and EOS off (every answer runs
    its EVAL_NEW tokens). ``eval.harness.run_eval`` answers EVAL_QUESTIONS
    questions at batch 4 and at batch 1 (equal up to a logged near tie, held
    by generate's teacher-forced logits), with the launches per request
    asserted (K4 23 an encode, K5 a prefill once a layer; a decode step
    dense K1-K3 on the weight ring at <= 4 rows (tensor cores past them)
    once a layer each) and one
    batch traced; ``run_eval(num_beams=3)`` on 2
    questions
    (``check_beam``: beam search's guarantee against greedy's answer);
    ``video.run_video_mme`` on
    8 frames against ``generate`` on ``process_video_frames``' pixels;
    ``benchmarks.run_mmbench`` with ``all_rounds``; then the model cut to
    EVAL_CKPT_LAYERS LLM layers (full width; for disk and time only) saved
    and run through ``eval.cli`` (2 chunks, ``--merge --scorer textvqa``) and
    ``tools.verify_released_weights`` (record, check, and a corrupted
    weight that must fail). Returns the counted windows' launches."""
    import contextlib
    import gc
    import io
    import shutil

    from safetensors.torch import load_file, save_file

    from slime_tpu_torch import checkpoint as ckpt
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.data.tokenization import tokenizer_image_token
    from slime_tpu_torch.eval import benchmarks, cli, harness, video
    from slime_tpu_torch.models import llama
    from slime_tpu_torch.ops import fused_mlp, fused_qkvo
    from slime_tpu_torch.ops.weight_ring import DENSE
    from slime_tpu_torch.tools import verify_released_weights as verify

    bf = torch.bfloat16
    L = cfg.llm.num_layers
    vis = cfg.vision.num_layers + cfg.vision.select_layer + 1
    cfg = dataclasses.replace(cfg, eos_token_id=-1)
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "bench_out" / "eval"
    shutil.rmtree(root, ignore_errors=True)
    questions, video_qs = eval_data(root, cfg)
    tok = IdByteTokenizer(cfg.bos_token_id)
    t0 = time.perf_counter()
    params = ckpt.to_torch(bf16_train_params(dev, cfg, seed=SEED + 41), dtype=bf, device=dev)
    torch.cuda.synchronize()
    log(f"phase 12 params built on the card in {time.perf_counter() - t0:.1f} s: SliME-8B, "
        f"bf16 throughout, LLM dense and stacked; {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        "GiB allocated")
    counts, near_ties = {}, []
    real = {"generate": gen.generate, "beam_search": gen.beam_search}

    def window(tag, fn, per_call=None):
        """fn() with the launch counts from 0 and generate / beam_search
        recorded; ``per_call`` ({record: launches a call}) is asserted."""
        rec = Recorder()
        gen.generate, gen.beam_search = rec.wrap(real["generate"]), rec.wrap(real["beam_search"])
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            gen.generate, gen.beam_search = real["generate"], real["beam_search"]
        got = launch_counts()
        if per_call is not None:
            expect_launches(tag, got, {n: c * len(rec.calls) for n, c in per_call.items()})
            extra = {n: c for n, c in got.items() if c and n not in per_call}
            if extra and torch.cuda.is_available():
                raise AssertionError(f"phase {tag}: launched off the path: {extra}")
        for n, c in got.items():
            counts[n] = counts.get(n, 0) + c
        return rec, wall

    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    llm = cfg.llm

    def request(steps, rows):
        """The launches of one generate call of ``steps`` decode steps at
        ``rows`` rows: dense K1-K3 on the instances their rules take (the
        ring at 1-4 rows; tensor cores past them)."""
        return {"encoder_attention": vis, "flash_fwd": L,
                **dense_fused_launches(llm, {rows: steps}, sms)}

    def run(name, bs, qs=questions, **kw):
        return lambda: harness.run_eval(
            params, cfg, tok, qs, image_folder=str(root / "imgs"),
            answers_file=str(root / f"{name}.jsonl"), conv_mode="llama3", batch_size=bs,
            max_new_tokens=EVAL_NEW, progress=False, **kw)

    # ---- run_eval at batch 4 and 1: equal up to a near tie ----
    rec4, wall4 = window("12 run_eval batch 4", run("b4", EVAL_BATCH),
                         request(EVAL_NEW - 1, EVAL_BATCH))
    rec1, wall1 = window("12 run_eval batch 1", run("b1", 1), request(EVAL_NEW - 1, 1))
    rows4, rows1 = rec4.rows(), rec1.rows()
    lens = [int(r[1].sum()) for r in rows1]
    log(f"phase 12 run_eval: {EVAL_QUESTIONS} questions, {EVAL_NEW} tokens each; host "
        f"{wall4 * 1e3 / EVAL_QUESTIONS:.1f} ms a request at batch {EVAL_BATCH} "
        f"({len(rec4.calls)} calls), {wall1 * 1e3 / EVAL_QUESTIONS:.1f} at batch 1; prompts "
        f"{min(lens)}-{max(lens)} tokens, padded to {sorted({r[0].shape[1] for r in rows4})} "
        f"(batch {EVAL_BATCH}) and {sorted({r[0].shape[1] for r in rows1})} (batch 1)")
    answers4 = [json.loads(x) for x in open(root / "b4.jsonl")]
    answers1 = [json.loads(x) for x in open(root / "b1.jsonl")]
    if ([a["question_id"] for a in answers4] != list(range(EVAL_QUESTIONS))
            or [a["question_id"] for a in answers1] != list(range(EVAL_QUESTIONS))):
        raise AssertionError("phase 12: the answers files lack a question")
    for i, (r4, r1, a4, a1) in enumerate(zip(rows4, rows1, answers4, answers1)):
        if len(r4[4]) != EVAL_NEW or (r4[4] == r1[4]) != (a4["text"] == a1["text"]):
            raise AssertionError(f"phase 12 question {i}: tokens and text disagree")
        ids1, attn1, pv1, cm1 = r1[:4]
        part = check_answer(f"run_eval question {i}, batch {EVAL_BATCH} against batch 1",
                            r4[4], r1[4], lambda j: teacher_logits(
                                params, cfg, ids1, attn1, pv1, cm1, r1[4], j), phase="12")
        if part is not None:
            near_ties.append((i, *part))
    log(f"phase 12 batch {EVAL_BATCH} against batch 1: {len(near_ties)} near ties forgiven "
        f"{near_ties}")

    # ---- one batch traced, and the decode step at batch 4 ----
    out = root / "trace"
    out.mkdir()
    batch = run("trace", EVAL_BATCH, questions[:EVAL_BATCH])
    host = host_ms(batch, runs=1)
    if profiled(batch, out / "profile_eval_batch.json"):
        busy, launches, by_name = trace_device(out / "profile_eval_batch.json")
        log(f"phase 12 traced batch ({EVAL_BATCH} questions, {EVAL_NEW} tokens): device busy "
            f"{busy:.1f} ms of {host:.1f} ms unprofiled; idle share {1 - busy / host:.3f}; "
            f"{launches} kernel launches")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"phase 12 batch kernel {ms:8.3f} ms  {name[:90]}")
    ids, attn, pv, cm, _ = rec4.calls[0]
    with torch.no_grad():
        last, kvs, lengths, Lp = gen.prefill(params, cfg, ids, attn, pv, cm, bf)
        cache = llama.prefill_into_cache(llama.init_kv_cache(
            cfg.llm, ids.shape[0], Lp + N_NEW, dtype=bf, device=dev), kvs, lengths)
        del kvs
        first = last.argmax(-1).to(torch.int32)

        def steps(n):
            gen._decode_loop(params["llm"], cache, first, -1, cfg=cfg, max_new_tokens=n + 1,
                             temperature=0.0, top_p=1.0, compute_dtype=bf, generator=None)
            torch.cuda.synchronize()

        steps(2)
        step_ms = []
        for _ in range(8):
            t0 = time.perf_counter()
            steps(1)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms = statistics.median(step_ms)
        log(f"phase 12 decode step at batch {EVAL_BATCH} (dense bf16): host {step_ms:.2f} ms "
            "(median of 8)")
        if profiled(lambda: steps(PROFILE_STEPS), out / "profile_decode_12.json"):
            decode_summary("12", out, step_ms)
        del cache, last

    # ---- beams: the best beam's prefix leads greedy's where beam search says ----
    recb, wallb = window("12 beams", run("beams", 2, questions[:2], num_beams=EVAL_BEAMS),
                         request(EVAL_NEW - 1, 2 * EVAL_BEAMS))
    for i, (rb, r1) in enumerate(zip(recb.rows(), rows1)):
        beam, greedy = (np.cumsum(seq_logprobs(params, cfg, *r1[:4], t)) for t in (rb[4], r1[4]))
        check_beam(i, rb[4], r1[4], beam, greedy)
    log(f"phase 12 beams: {EVAL_BEAMS} beams x 2 questions, {EVAL_NEW} tokens, host "
        f"{wallb * 1e3:.1f} ms")

    # ---- video: run_video_mme against generate on process_video_frames' pixels ----
    recv, wallv = window("12 video", lambda: video.run_video_mme(
        params, cfg, tok, video_qs, frames_root=str(root / "frames"),
        answers_file=str(root / "video.jsonl"), max_new_tokens=EVAL_NEW),
        request(EVAL_NEW - 1, 1))
    pix, mask = video.process_video_frames(video.load_frames(str(root / "frames" / "v0")),
                                           tile=cfg.vision.image_size,
                                           max_crops=1 + cfg.max_local_crops)
    rec_v = json.loads(open(root / "video.jsonl").read())
    for q, got, call in zip(video_qs, rec_v["questions"], recv.calls):
        ids_np = tokenizer_image_token(video.build_video_mme_prompt(
            q["question"], q["options"]), tok, return_tensors="np")
        ids, attn = harness.padded_batch([ids_np], 1, (len(ids_np) + 63) // 64 * 64, dev)
        toks = gen.generate(params, cfg, ids, attn, torch.from_numpy(pix[None]).to(dev),
                            torch.from_numpy(mask[None]).to(dev), max_new_tokens=EVAL_NEW,
                            temperature=0.0, compute_dtype=bf)
        if (toks.tolist() != call[4].tolist()
                or got["response"] != harness.decode_row(tok, toks, 0, cfg.eos_token_id)):
            raise AssertionError(f"phase 12 video {q['question_id']}: run_video_mme's answer "
                                 "is not generate's")
    log(f"phase 12 video: {int(mask.sum())} of {len(mask)} frame slots, {len(video_qs)} "
        f"questions equal to generate on process_video_frames' pixels; host "
        f"{wallv * 1e3 / len(video_qs):.1f} ms a question")

    # ---- MMBench: circular rounds ----
    recm, wallm = window("12 mmbench", lambda: benchmarks.run_mmbench(
        params, cfg, tok, str(root / "mmbench.tsv"), answers_file=str(root / "mmbench.jsonl"),
        conv_mode="llama3", all_rounds=True, max_new_tokens=EVAL_NEW),
        request(EVAL_NEW - 1, 1))
    mm = [json.loads(x) for x in open(root / "mmbench.jsonl")]
    if ([(r["question_id"], r["round_id"]) for r in mm]
            != [(str(i), k) for i in range(2) for k in range(4)]
            or mm[1]["options"] != ["green", "blue", "black", "red"]):
        raise AssertionError(f"phase 12 mmbench: rounds {[(r['question_id'], r['round_id']) for r in mm]}")
    log(f"phase 12 mmbench: 2 rows x 4 rotated rounds, host {wallm * 1e3 / len(mm):.1f} ms a "
        "round")

    # ---- the engine at the batched worker's defaults, plain and speculating ----
    for n, c in eval_engine(dev, cfg, params).items():
        counts[n] = counts.get(n, 0) + c

    # ---- the CLI and the verifier on a saved checkpoint (LLM cut for disk and time) ----
    cfg_c = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                             num_layers=EVAL_CKPT_LAYERS))
    d = root / "ckpt"
    t0 = time.perf_counter()
    ckpt.save_checkpoint(str(d), params, cfg_c)
    size = sum(f.stat().st_size for f in d.iterdir())
    log(f"phase 12 checkpoint: SliME-8B cut to {EVAL_CKPT_LAYERS} LLM layers at full width "
        f"(for disk and time only), {size / 2 ** 30:.2f} GiB written in "
        f"{time.perf_counter() - t0:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--model-path", str(d), "--question-file", str(root / "q.jsonl"),
            "--image-folder", str(root / "imgs"), "--answers-file",
            str(root / "cli" / "ans_{chunk}.jsonl"), "--num-chunks", "2", "--batch-size", "2",
            "--max-new-tokens", "8", "--device", str(dev)]
    t0 = time.perf_counter()
    for k in ("0", "1"):
        window(f"12 eval.cli chunk {k}", lambda: cli.main(argv + ["--chunk-idx", k],
                                                        tokenizer=tok))
    wall_cli = time.perf_counter() - t0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(argv + ["--merge", "--scorer", "textvqa", "--annotation-file",
                         str(root / "ann.json")])
    merged = [json.loads(x) for x in open(root / "cli" / "ans_merged.jsonl")]
    if [r["question_id"] for r in merged] != list(range(EVAL_QUESTIONS)):
        raise AssertionError(f"phase 12 eval.cli: merged {[r['question_id'] for r in merged]}")
    log(f"phase 12 eval.cli: 2 chunks of {EVAL_QUESTIONS // 2} in {wall_cli:.1f} s (loads "
        f"included), merged and scored: {printed.getvalue().splitlines()[-1]}")
    rcs = []
    for what, args in (("record", ["--record"]), ("check", [])):
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            window(f"12 verify {what}", lambda: rcs.append(verify.main(
                [str(d), "--skip-quant", "--device", str(dev)] + args)))
        log(f"phase 12 verify_released_weights {what}: rc {rcs[-1]} in "
            f"{time.perf_counter() - t0:.1f} s; " + "; ".join(
                x for x in printed.getvalue().splitlines() if x.startswith("[")))
    fp = d / "model.safetensors"
    sd = load_file(str(fp))
    g = torch.Generator().manual_seed(SEED)
    for k in sd:
        if "layers.0.self_attn.q_proj.weight" in k:
            sd[k] = sd[k] + 0.05 * torch.randn(sd[k].shape, generator=g).to(sd[k].dtype)
    save_file(sd, str(fp))
    del sd
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        window("12 verify corrupted", lambda: rcs.append(verify.main(
            [str(d), "--skip-quant", "--device", str(dev)])))
    log(f"phase 12 verify_released_weights, one corrupted q_proj: rc {rcs[-1]}; " + "; ".join(
        x for x in printed.getvalue().splitlines() if x.startswith("[")))
    if rcs != [0, 0, 1]:
        raise AssertionError(f"phase 12 verify_released_weights: rcs {rcs}, expected [0, 0, 1]")
    log(f"phase 12 wall {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def dense_fused_launches(llm, rows, sms):
    """K1-K3's launches over fused calls in bf16 on dense bf16 weights,
    ``rows`` {rows a call: calls} (decode steps at a batch or the engine's
    slots, fused chunks of at most 64 rows, verify chunks): each once a
    layer a call, on the instance its rule takes (``k1_route``, ``k2_route``,
    ``k3_route``), by record."""
    from slime_tpu_torch.ops import fused_mlp, fused_qkvo
    bf, D = torch.bfloat16, fused_qkvo.DENSE
    H, I = llm.hidden_size, llm.intermediate_size
    NQ, NKV = llm.num_heads * llm.head_dim, llm.num_kv_heads * llm.head_dim
    sfx = {"ring": "_dense_ring", "wgmma": "_dense_wgmma", "rows": "_dense"}
    out = {}
    for r, n in rows.items():
        for name, route in (("fused_qkv_decode", fused_qkvo.k2_route(r, bf, D, H, NQ, NKV, sms)),
                            ("fused_o_residual", fused_qkvo.k3_route(r, bf, D, NQ, H, sms)),
                            ("fused_mlp_decode", fused_mlp.k1_route(r, bf, D, H, I, sms))):
            if n:
                out[name + sfx[route]] = out.get(name + sfx[route], 0) + llm.num_layers * n
    return out


@contextlib.contextmanager
def named_projections():
    """K1's, K2's and K3's wrapper calls as profiler ranges ("K1", "K2",
    "K3") where llama's decode and chunk paths look them up
    (``trace_ranges`` reads them); the wrappers themselves, and their
    counts, unchanged."""
    from torch.profiler import record_function

    from slime_tpu_torch.models import llama
    names = ("fused_mlp_decode", "fused_qkv_decode", "fused_o_residual")
    real = [getattr(llama, n) for n in names]

    def named(tag, fn):
        def call(*a, **k):
            with record_function(tag):
                return fn(*a, **k)
        return call
    for n, tag, fn in zip(names, ("K1", "K2", "K3"), real):
        setattr(llama, n, named(tag, fn))
    try:
        yield
    finally:
        for n, fn in zip(names, real):
            setattr(llama, n, fn)


@contextlib.contextmanager
def dense_k3_before():
    """Dense bf16 K3's route as it stood before its tensor-core instance:
    row per warp where ``k3_route`` now says "wgmma" (phase 12's comparison
    of the 64-row chunk and an 8-slot tick); every other route as now."""
    from slime_tpu_torch.ops import fused_qkvo
    now = fused_qkvo.k3_route

    def before(B, dtype, fmt, NQ, H, sms):
        route = now(B, dtype, fmt, NQ, H, sms)
        return "rows" if fmt == fused_qkvo.DENSE and route == "wgmma" else route
    fused_qkvo.k3_route = before
    try:
        yield
    finally:
        fused_qkvo.k3_route = now


def kernel_shares(path, busy):
    """"K1 a ms, K2 b ms, K3 c ms (shares of ``busy``)" from a trace taken
    under ``named_projections``."""
    parts, _ = trace_ranges(path, ("K1", "K2", "K3"))
    return ", ".join(f"{k} {parts[k][0]:.3f} ms in {parts[k][1]} launches "
                     f"({parts[k][0] / busy if busy else 0.0:.3f} of it)"
                     for k in ("K1", "K2", "K3"))


def eval_engine(dev, cfg, params):
    """Phase 12's engine: ``BatchDecodeEngine`` at the batched worker's
    defaults (EVAL_SLOTS slots, cache_len 2048, the prefix cache) on phase
    12's dense bf16 SliME-8B (``cfg``'s depth), bf16, EVAL_ENGINE_TEXT
    prompts of random ids with EVAL_ENGINE_NEW greedy tokens each: plainly,
    then speculating (spec_k EVAL_SPEC_K, 8 rounds a dispatch) with phase
    9's random 0.6B dense bf16 draft (its widths take the non-fused
    decode). Launches asserted on the card: K1-K3 on the instances their
    rules take (their dense tensor-core instances, as many launches each,
    K3 never row per warp) once a layer in the 300-token prompt's 64-row
    fused chunk, in every 8-slot decode step and in every 40-row verify
    chunk. The plain
    engine's tokens held to ``generate``'s, the speculating engine's to
    the plain engine's, up to ``near_tie_rule``. Device times (profiler):
    the 64-row chunk and an 8-slot tick at k = 1, each in turns with dense
    K3 row per warp as before (``dense_k3_before``, uncounted), the tick at
    k = 8 (each tick beside its host time), a speculative tick's verify
    chunks, with K1's, K2's and K3's share of each. Returns the counted
    runs' launches."""
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import llama
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.serve.batch_engine import Request

    bf = torch.bfloat16
    out = Path(__file__).resolve().parent / "bench_out"
    out.mkdir(exist_ok=True)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    rng = np.random.default_rng(SEED + 42)
    prompts = [rng.integers(5, cfg.llm.vocab_size, (n,)) for n in EVAL_ENGINE_TEXT]
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    dparams, dcfg = draft_params(cfg, g, dev)
    common = dict(params=params, cfg=cfg, max_slots=EVAL_SLOTS, compute_dtype=bf, device=dev)
    verify_rows = EVAL_SLOTS * (EVAL_SPEC_K + 1)
    log(f"phase 12 engine: max_slots {EVAL_SLOTS}, cache_len 2048, bf16, dense LLM of "
        f"{cfg.llm.num_layers} layers; {len(prompts)} text prompts of {EVAL_ENGINE_TEXT} "
        f"tokens, {EVAL_ENGINE_NEW} greedy tokens each; speculation: spec_k {EVAL_SPEC_K}, "
        f"the random 0.6B dense bf16 draft, verify chunks of {verify_rows} rows")
    launches = {}

    def run(**kw):
        """Every prompt through tick() -> (engine, tokens, wall s, launches)."""
        eng = traced_engine(**common, **kw)
        torch.cuda.synchronize()
        reset_launch_counts()
        reqs = [eng.submit(Request(input_ids=p, max_new_tokens=EVAL_ENGINE_NEW))
                for p in prompts]
        t0 = time.perf_counter()
        for _ in range(4000):
            if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if any(s is not None for s in eng.slots):
            raise AssertionError("phase 12 engine: the engine did not finish its requests")
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        return eng, [drain(r) for r in reqs], wall, counts

    def fill_slots(eng):
        """EVAL_SLOTS long requests on the short prompts, admitted whole."""
        return [eng.submit(Request(input_ids=prompts[1 + i % (len(prompts) - 1)],
                                   max_new_tokens=200)) for i in range(EVAL_SLOTS)]

    def check_launches(tag, eng, counts, rounds=0):
        fused = {c: n for c, n in eng.chunk_rows.items() if c <= 64}
        calls = {EVAL_SLOTS: eng.decode_steps}
        for c, n in list(fused.items()) + [(verify_rows, rounds)]:
            calls[c] = calls.get(c, 0) + n
        want = dense_fused_launches(cfg.llm, calls, sms)
        wrong = {n: c for n, c in counts.items() if c != want.get(n, 0)}
        log(f"phase 12 {tag} launches: {json.dumps({n: c for n, c in counts.items() if c})} "
            f"({eng.decode_steps} decode steps at {EVAL_SLOTS} rows, chunks "
            f"{dict(sorted(eng.chunk_rows.items()))}, {rounds} verify chunks)")
        if 64 not in fused or (wrong and dev.type == "cuda"):
            raise AssertionError(f"phase 12 {tag} launches {wrong} (expected {want}); fused "
                                 f"chunks {fused}")
        tc = [counts.get(n + "_dense_wgmma", 0) for n in DENSE_WGMMA]
        if dev.type == "cuda" and (counts.get("fused_o_residual_dense", 0)
                                   or len(set(tc)) != 1 or not tc[0]):
            raise AssertionError(f"phase 12 {tag}: dense K2, K3, K1 on tensor cores {tc} "
                                 f"times, K3 row per warp "
                                 f"{counts.get('fused_o_residual_dense', 0)}: expected as "
                                 f"many tensor-core launches each and none row per warp")

    # ---- the plain engine, against generate ----
    eng, plain, wall, counts = run()
    n_tok = sum(map(len, plain))
    log(f"phase 12 plain engine: {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.2f} tok/s "
        f"aggregate, admissions included)")
    check_launches("plain engine", eng, counts)
    for p, got in zip(prompts, plain):
        ids = torch.from_numpy(p[None].astype(np.int64)).to(dev)
        want = gen.generate(params, cfg, ids, torch.ones_like(ids, dtype=torch.bool),
                            max_new_tokens=EVAL_ENGINE_NEW, temperature=0.0,
                            compute_dtype=bf)[0].tolist()
        near_tie_rule(f"engine, {len(p)}-token prompt", got, want,
                      plain_logits(params, cfg, p, want), cfg.eos_token_id, phase="12",
                      ref="generate's")

    # the 300-token prompt's 64-row fused chunk, traced
    with torch.no_grad(), fp32_accumulation():
        emb = llama.embed(params["llm"], torch.from_numpy(prompts[0].astype(np.int64)).to(
            dev)).to(bf)[None]
        tail = torch.nn.functional.pad(emb[:, 256:], (0, 0, 0, 64 - (emb.shape[1] - 256)))
        cache1 = llama.init_kv_cache(cfg.llm, 1, eng.cache_len, dtype=bf, device=dev)
        for _ in range(2):
            cache1["length"].fill_(256)
            eng._prefill_chunk(cache1, tail)
        torch.cuda.synchronize()
        for i, before in enumerate((False, True, True, False)):
            path = out / f"profile_eval_chunk_64_{i}.json"
            cache1["length"].fill_(256)
            with named_projections(), dense_k3_before() if before else contextlib.nullcontext():
                traced = profiled(lambda: eng._prefill_chunk(cache1, tail), path,
                                  start=lambda: cache1["length"].fill_(256))
            if traced:
                busy, n, _ = trace_device(path)
                log(f"phase 12 64-row fused chunk (dense"
                    + (", K3 row per warp as before its tensor-core instance" if before else "")
                    + f"): device busy {busy:.3f} ms, {n} launches; {kernel_shares(path, busy)}")
        del cache1

    # an 8-slot tick at k = 1 and k = 8, traced; at k = 1 in turns with
    # dense K3's route before its tensor-core instance (uncounted)
    busy_reqs = fill_slots(eng)
    eng.tick()
    for i, (k, before) in enumerate(((1, False), (1, True), (1, True), (1, False), (8, False))):
        eng._flush_inflight()
        eng.multi_step = k
        with dense_k3_before() if before else contextlib.nullcontext():
            for _ in range(3):
                eng.tick()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.tick()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall_ms = statistics.median(walls)
            eng._flush_inflight()

            def three_ticks():
                for _ in range(3):
                    eng.tick()
                eng._flush_inflight()

            path = out / f"profile_eval_tick_{i}.json"
            with named_projections():
                traced = profiled(three_ticks, path)
        if traced:
            busy, n, _ = trace_device(path)
            log(f"phase 12 tick, {EVAL_SLOTS} live slots, k = {k}"
                + (" (K3 row per warp as before its tensor-core instance)" if before else "")
                + f": host wall {wall_ms:.2f} ms (median of 5), device busy {busy / 3:.3f} ms "
                f"a tick, idle share {1 - busy / 3 / wall_ms:.3f}, {n / 3:.0f} launches a "
                f"tick; over 3 ticks {kernel_shares(path, busy)}")
    for r in busy_reqs:
        eng.cancel(r.request_id)
    eng.tick()
    eng._flush_inflight()
    del eng
    torch.cuda.empty_cache()

    # ---- speculating, against the plain engine ----
    eng, spec, wall, counts = run(draft_params=dparams, draft_cfg=dcfg, spec_k=EVAL_SPEC_K)
    st = dict(eng.spec_stats)
    n_tok = sum(map(len, spec))
    log(f"phase 12 speculating engine: {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.2f} tok/s "
        f"aggregate); {st.get('rounds', 0)} rounds in {st.get('dispatches', 0)} dispatches, "
        f"{st.get('accepted', 0)} proposals accepted of {EVAL_SPEC_K * st.get('slot_rounds', 0)}")
    if not st.get("rounds"):
        raise AssertionError("phase 12 speculating engine: no round ran")
    check_launches("speculating engine", eng, counts, st["rounds"])
    for p, got, want in zip(prompts, spec, plain):
        near_tie_rule(f"speculating engine, {len(p)}-token prompt", got, want,
                      plain_logits(params, cfg, p, want), cfg.eos_token_id, phase="12")

    # one speculative dispatch with every slot live, traced
    busy_reqs = fill_slots(eng)
    eng.tick()                                   # admissions
    eng.tick()                                   # a first dispatch
    r0, t0 = eng.spec_stats["rounds"], time.perf_counter()
    path = out / "profile_eval_spec_tick.json"
    with named_projections():
        traced = profiled(eng.tick, path)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if traced:
        R = max(eng.spec_stats["rounds"] - r0, 1)
        busy, n, _ = trace_device(path)
        parts, _ = trace_ranges(path, ("spec_draft", "spec_verify", "spec_ingest"))
        v_ms = parts["spec_verify"][0]
        log(f"phase 12 speculative tick, {EVAL_SLOTS} live slots, {R} rounds: device busy "
            f"{busy:.2f} ms ({wall_ms:.1f} ms host, the profiler's included); a verify chunk "
            f"({verify_rows} rows) {v_ms / R:.3f} ms on the device; over the {R} verify "
            f"chunks {kernel_shares(path, v_ms)}")
    for r in busy_reqs:
        eng.cancel(r.request_id)
    eng.tick()
    del eng, dparams
    torch.cuda.empty_cache()
    return launches


def check_beam(i, beam_toks, greedy_toks, beam, greedy):
    """Beam search's guarantee against greedy decoding, on teacher-forced
    prefix log-probs (``beam``, ``greedy``: cumulative, bf16, B = 1): with d
    the first step where the best beam parts from greedy's tokens, greedy's
    prefix either stays among the beams to the end (then the best beam's
    final score is at least greedy's) or is dropped at a step t >= d where
    every kept prefix, the best beam's ancestor included, scored at least
    greedy's. Either way the best beam's prefix leads greedy's at some step
    t >= d (within BEAM_SCORE_SLACK: another attention path's logits). A
    final score below greedy's is allowed: beam search does not promise
    more (3 beams ended below greedy on 2 of 40 random prompts, exactly, in
    fp32 on a CPU)."""
    d = next((j for j, (a, b) in enumerate(zip(beam_toks, greedy_toks)) if a != b), None)
    lead = None if d is None else max(range(d, len(beam)), key=lambda t: beam[t] - greedy[t])
    log(f"phase 12 beams, question {i}: best beam's log-prob {beam[-1]:.3f}, greedy's "
        f"{greedy[-1]:.3f}; "
        + ("the same tokens" if d is None else
           f"parts from greedy at step {d}; its prefix leads greedy's by "
           f"{beam[lead] - greedy[lead]:.3f} at step {lead}")
        + f" (teacher-forced at B = 1, slack {BEAM_SCORE_SLACK})")
    if d is not None and beam[lead] - greedy[lead] < -BEAM_SCORE_SLACK:
        raise AssertionError(f"phase 12 beams, question {i}: the best beam never leads "
                             f"greedy's prefix after step {d}")


def mixtral_config():
    """Phase 13's Mixtral-family SliME: Mixtral-8x7B at full width (the
    reference's llava_mixtral LLM, ``LLMConfig.mixtral_8x7b``) cut to
    MIXTRAL_LAYERS layers, with its BOS / EOS ids."""
    from slime_tpu_torch.config import LLMConfig, SliMEConfig
    llm = dataclasses.replace(LLMConfig.mixtral_8x7b(), num_layers=MIXTRAL_LAYERS)
    return SliMEConfig(llm=llm, bos_token_id=1, eos_token_id=2)


def mpt_config():
    """MPT-7B (``MPTConfig()``): d_model 4096, 32 layers, vocabulary 50432."""
    from slime_tpu_torch.models.mpt import MPTConfig
    return MPTConfig()


def mixtral_params(dev, cfg, seed=SEED):
    """SliME with ``cfg``'s MoE LLM in bf16 on the card from ``seed``, the
    LLM layers written into their stacked [L, ...] storage as each is drawn
    (a list and its stacked copy of the experts would not fit together)."""
    from slime_tpu_torch.models import llama, slime
    from slime_tpu_torch.params import map_leaves, named_leaves

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    L = cfg.llm.num_layers
    params = slime.init(dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=0)),
                        generator=g, device=dev, dtype=bf)
    stacked = None
    for i in range(L):
        lp = llama.init_layer(cfg.llm, generator=g, device=dev, dtype=bf)
        if stacked is None:
            stacked = map_leaves(lambda _, t: torch.empty((L,) + tuple(t.shape), dtype=t.dtype,
                                                          device=dev), lp)
        drawn = dict(named_leaves(lp))
        for path, t in named_leaves(stacked):
            t[i].copy_(drawn[path])
        del lp, drawn
    params["llm"]["layers"] = stacked
    return params


def routing(lp, x, cfg):
    """``_moe``'s expert choice for x [B, S, H]: (gate logits fp32, top-k ids)."""
    from slime_tpu_torch.models import layers, llama
    logits = layers.linear(lp["gate"], x).to(torch.float32)
    return logits, llama.top_k_stable(logits, cfg.num_experts_per_tok)[1]


def moe_layer_check(dev, cfg, params):
    """Phase 13's layer check on layer 0: ``_moe`` on MOE_TOKENS tokens at
    once (the sparse dispatch) against the same tokens in chunks of
    MOE_CHUNK (the dense masked path), in fp32 (within 1e-4) and bf16
    (within 8 bf16 ulps of the largest output); tokens whose top-k
    set differs between the two calls must be router near ties (their k-th
    and next gate logits within 2 ulps of the logits' type) and are left
    out. Then ``moe_ffn_sparse`` against a per-token loop (fp32, 1e-4)."""
    from slime_tpu_torch.models import llama
    from slime_tpu_torch.models.layers import fp32_accumulation, silu
    from slime_tpu_torch.ops.moe_dispatch import moe_ffn_sparse

    llm, H, K = cfg.llm, cfg.llm.hidden_size, cfg.llm.num_experts_per_tok
    lp = llama._layer(params["llm"]["layers"], 0)
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    x = torch.randn((1, MOE_TOKENS, H), generator=g, device=dev)
    chunks = range(0, MOE_TOKENS, MOE_CHUNK)
    with torch.no_grad(), fp32_accumulation():
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            sparse = llama._moe(lp, xd, llm)[0].float()
            dense = torch.cat([llama._moe(lp, xd[:, i:i + MOE_CHUNK], llm)[0]
                               for i in chunks], dim=1).float()
            logits, ti = routing(lp, xd, llm)
            ti_c = torch.cat([routing(lp, xd[:, i:i + MOE_CHUNK], llm)[1] for i in chunks], dim=1)
            same = (ti.sort(-1).values == ti_c.sort(-1).values).all(-1)[0]       # [T]
            top = logits[0].sort(-1, descending=True).values
            gap = top[:, K - 1] - top[:, K]
            eps = torch.finfo(dt).eps
            tie_ok = bool((gap[~same] <= 2 * eps * top[~same, K - 1].abs()).all())
            err = (sparse - dense)[0, same].abs().max().item() if bool(same.any()) else 0.0
            if dt == torch.float32:
                bound = 1e-4
            else:
                top_mag = dense[0, same].abs().max().item()
                bound = 8 * 2.0 ** (np.floor(np.log2(top_mag)) - 7)
            log(f"phase 13 _moe layer 0, {MOE_TOKENS} tokens sparse against {MOE_TOKENS // MOE_CHUNK}"
                f" dense chunks of {MOE_CHUNK}, {str(dt)[6:]}: max |diff| {err:.3g} (bound "
                f"{bound:.3g}) over {int(same.sum())} tokens; {int((~same).sum())} left out at "
                f"router near ties (gaps {[round(v, 6) for v in gap[~same].tolist()]})")
            if err > bound or not tie_ok:
                raise AssertionError(f"phase 13 _moe {dt}: sparse vs dense {err:.3g} > {bound:.3g}"
                                     f" or a routing change away from a near tie")
        # the sparse dispatch against its plain per-token loop, fp32
        E = llm.num_experts
        topi = torch.stack([torch.randperm(E, generator=g, device=dev)[:K]
                            for _ in range(MOE_TOKENS)])
        topw = torch.rand((MOE_TOKENS, K), generator=g, device=dev)
        ex = lp["experts"]
        x2 = x[0]
        got = moe_ffn_sparse(x2, ex["w1"], ex["w2"], ex["w3"], topi, topw)
        w1, w2, w3 = (ex[n].float() for n in ("w1", "w2", "w3"))
        want = torch.zeros_like(x2)
        for t in range(MOE_TOKENS):
            for j in topi[t].argsort().tolist():            # expert-ascending, as the combine
                e = int(topi[t, j])
                a = silu(w1[e] @ x2[t]) * (w3[e] @ x2[t])
                want[t] += topw[t, j] * (w2[e] @ a)
        del w1, w2, w3
        err = (got - want).abs().max().item()
        log(f"phase 13 moe_ffn_sparse against a per-token loop, {MOE_TOKENS} tokens, top "
            f"{K} of {E}, fp32: max |diff| {err:.3g} (bound 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"phase 13 moe_ffn_sparse vs per-token loop: {err:.3g}")


def count_syncs(fn):
    """(fn(), the host syncs it made: CUDA's sync debug mode warns at each),
    or (fn(), None) off the card."""
    import warnings
    if not torch.cuda.is_available():
        return fn(), None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


class RoutingTape:
    """``llama._moe``'s routing while installed (a context manager): the
    gate's fp32 logits and top-k ids by key, layer and sequence position.
    Each model call runs ``_moe`` once a layer, in order, so a call's layer
    is its count modulo the depth; at layer 0, ``rows(B, S)`` names each
    batch row's key (None: not recorded) and first position (an int or a
    0-d tensor)."""

    def __init__(self, n_layers, rows):
        self.n_layers, self.rows = n_layers, rows
        self.calls, self.cur, self.chunks = 0, None, {}

    def __enter__(self):
        from slime_tpu_torch.models import llama
        real = llama._moe

        def moe(lp, x, cfg, plan=None):
            out, (logits, topi) = real(lp, x, cfg, plan)
            layer = self.calls % self.n_layers
            if layer == 0:
                self.cur = self.rows(*x.shape[:2])
            self.calls += 1
            for b, (key, start) in enumerate(self.cur):
                if key is not None:
                    self.chunks.setdefault(key, []).append((layer, start, logits[b], topi[b]))
            return out, (logits, topi)
        self._restore = (llama, real)
        llama._moe = moe
        return self

    def __exit__(self, *exc):
        llama, real = self._restore
        llama._moe = real

    def table(self, key, n):
        """(gate logits [L, n, E], top-k ids [L, n, K]) of ``key`` at
        positions < n, numpy. A later call's rows overwrite an earlier
        one's (a decode step writes over the padding a prefill routed);
        raises where a (layer, position) was never routed."""
        L = self.n_layers
        logits = topi = None
        seen = np.zeros((L, n), bool)
        for layer, start, lg, ti in self.chunks.get(key, []):
            start = int(start)
            m = min(lg.shape[0], n - start)
            if m <= 0:
                continue
            if logits is None:
                logits = np.zeros((L, n, lg.shape[-1]), np.float32)
                topi = np.zeros((L, n, ti.shape[-1]), np.int64)
            logits[layer, start:start + m] = lg[:m].float().cpu().numpy()
            topi[layer, start:start + m] = ti[:m].cpu().numpy()
            seen[layer, start:start + m] = True
        if logits is None or not seen.all():
            raise AssertionError(f"routing tape: key {key} routed at {int(seen.sum())} of "
                                 f"{L * n} (layer, position) pairs")
        return logits, topi


def sequence_rows(key, n0):
    """``RoutingTape`` rows of one sequence (B = 1) of ``n0`` prompt
    positions: a call over S > 1 positions starts at 0 (a prefill or a full
    forward); each one-position call is the next decode step, from n0 on."""
    nxt = [n0]

    def rows(B, S):
        if S > 1:
            return [(key, 0)]
        nxt[0] += 1
        return [(key, nxt[0] - 1)]
    return rows


def engine_rows(eng):
    """``RoutingTape`` rows of ``eng``'s model calls, keyed by ``id`` of the
    request: a decode tick routes every live slot at its cached length, an
    admission chunk its request from the chunk's offset, a whole admission
    its request from 0."""
    whole = [None]
    real = eng._admit_whole

    def admit(req, *a, **k):
        whole[0] = req
        return real(req, *a, **k)
    eng._admit_whole = admit

    def rows(B, S):
        if S == 1:
            lengths = eng.cache["length"].clone()
            return [(None if sl is None else id(sl.req), lengths[b])
                    for b, sl in enumerate(eng.slots)]
        a = eng._admission
        if a is not None:
            return [(id(a["req"]), a["base"] + a["off"])]
        return [(id(whole[0]), 0)]
    return rows


def router_tie_rule(name, got, want, tapes, keys, n0, logits_at, phase="13"):
    """``got`` against ``want``, two runs' greedy tokens of one request of
    ``n0`` prompt positions, with each run's ``RoutingTape`` and its key
    there: equal, or parted at step j for a reason rounding explains. Step
    j's logits see positions 0 .. n0 - 1 + j; at each of them and every
    layer the runs' top-k sets are compared. Where none differs, the split
    must be a near tie of the logits (``logits_at(j)``: the two tokens'
    logits within ENGINE_TIE_ATOL). Where sets differ, every such flip in
    the first layer that has one (below it no routing differed, so its
    inputs differ by rounding only) must be a router near tie: in each run
    the gate logits of the expert it chose and of the one it dropped lie
    within ROUTER_TIE_ULPS bf16 ulps of the row's largest |logit|. Flips in
    later layers follow from it and are counted. Returns (step, the
    first flipping layer or None), or None when equal."""
    if got == want:
        log(f"phase {phase} {name}: {len(got)} tokens equal")
        return None
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    n = n0 + j
    lg_a, ti_a = tapes[0].table(keys[0], n)
    lg_b, ti_b = tapes[1].table(keys[1], n)
    flip = (np.sort(ti_a, -1) != np.sort(ti_b, -1)).any(-1)             # [L, n]
    head = (f"phase {phase} {name}: parts at step {j} (here {got[j]}, reference {want[j]}), "
            f"equal before it")
    if not flip.any():
        lg = logits_at(j)
        gap = float(lg[want[j]] - lg[got[j]])
        log(f"{head}; no routing differs at the {n} positions it sees in {flip.shape[0]} "
            f"layers; logit gap {gap:.4g} (near-tie bound {ENGINE_TIE_ATOL})")
        if not abs(gap) <= ENGINE_TIE_ATOL:
            raise AssertionError(f"phase {phase} {name}: parts at step {j} with no routing "
                                 f"change and no near tie (gap {gap:.4g})")
        return j, None
    per_layer = flip.sum(-1)
    l0 = int(np.nonzero(per_layer)[0][0])

    def ulp(row):
        return 2.0 ** (np.floor(np.log2(np.abs(row).max())) - 7)
    gaps = []
    for q in np.nonzero(flip[l0])[0].tolist():
        sa, sb = set(ti_a[l0, q].tolist()), set(ti_b[l0, q].tolist())
        only_a, only_b = sorted(sa - sb), sorted(sb - sa)
        ga = (lg_a[l0, q, only_a].min() - lg_a[l0, q, only_b].max()) / ulp(lg_a[l0, q])
        gb = (lg_b[l0, q, only_b].min() - lg_b[l0, q, only_a].max()) / ulp(lg_b[l0, q])
        gaps.append((q, float(ga), float(gb)))
    rows = ~flip[l0]
    ulps = 2.0 ** (np.floor(np.log2(np.abs(lg_a[l0]).max(-1))) - 7)           # [n]
    drift = float((np.abs(lg_a[l0] - lg_b[l0]).max(-1) / ulps)[rows].max()) if rows.any() else 0.0
    worst = max(max(ga, gb) for _, ga, gb in gaps)
    log(f"{head}; routing differs at {int(flip.sum())} (layer, position) pairs of "
        f"{flip.size}, by layer {per_layer.tolist()}; first at layer {l0}: "
        + ", ".join(f"position {q} gate gaps {ga:.3g} / {gb:.3g} ulps" for q, ga, gb in gaps[:6])
        + (f" (+{len(gaps) - 6} more)" if len(gaps) > 6 else "")
        + f"; worst {worst:.3g} (router near-tie bound {ROUTER_TIE_ULPS}); the layer's gate "
        f"logits elsewhere differ by {drift:.3g} ulps at most")
    if not worst <= ROUTER_TIE_ULPS:
        raise AssertionError(f"phase {phase} {name}: a routing at layer {l0} flipped at a gate "
                             f"gap of {worst:.3g} bf16 ulps, over {ROUTER_TIE_ULPS}")
    return j, l0


def forced_logits(params, cfg, ids, attn, pv, cm, tokens, dtype):
    """The logits [len(tokens), V] fp32 of one full forward (``dtype``
    compute) over the prefill's fused sequence with ``tokens`` written after
    its valid positions: row j predicts tokens[j] from the prompt and
    tokens[:j]."""
    from slime_tpu_torch.models import llama, slime
    from slime_tpu_torch.models.layers import fp32_accumulation

    with torch.no_grad(), fp32_accumulation():
        fused = slime.prepare_multimodal(params, cfg, ids, attn, pv, cm, compute_dtype=dtype)
        n0, n = int(fused.lengths[0]), len(tokens)
        if n0 + n > fused.embeds.shape[1]:
            raise AssertionError(f"the prompt fuses to {n0} positions: no room for {n} tokens")
        emb = fused.embeds.clone()
        emb[0, n0:n0 + n] = llama.embed(params["llm"], torch.tensor(tokens, device=ids.device)
                                        ).to(dtype)
        hidden, _ = llama.forward(params["llm"], emb, cfg.llm, positions=fused.positions,
                                  compute_dtype=dtype, return_hidden=True)
        return llama._lm_head(params["llm"], hidden[0, n0 - 1:n0 - 1 + n])


def mixtral_serve(dev, cfg, params):
    """Phase 13's serving: bench.py's query through ``generate`` (MOE_NEW
    greedy tokens, twice: the same tokens), its launches (K4 23 an encode,
    K5 one a layer a prefill, nothing else), the first MOE_FORWARD_TOKENS
    tokens against the argmax of a full forward teacher-forced on them (in
    bf16 equal up to ``router_tie_rule``'s near ties, the routing of both
    taped; in fp32 compute on the same weights, up to ``near_tie_rule``'s),
    and the prefill's and a decode step's times, host syncs and the MoE
    dispatch's share of the prefill. Returns the launches of the counted
    window."""
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import llama, slime
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.params import named_leaves

    bf = torch.bfloat16
    out_dir = Path(__file__).resolve().parent / "bench_out"
    out_dir.mkdir(exist_ok=True)
    cfg_run = dataclasses.replace(cfg, eos_token_id=-1)
    L = cfg.llm.num_layers
    vis = cfg.vision.num_layers + cfg.vision.select_layer + 1
    img, ids, attn, anyres = query(dev, cfg)
    crops, mask = anyres(img)

    def request():
        return gen.generate(params, cfg_run, ids, attn, crops[None], mask[None],
                            max_new_tokens=MOE_NEW, compute_dtype=bf)[0].tolist()

    request()                                                   # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    toks = request()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n0 = int(slime.prepare_multimodal(params, cfg_run, ids, attn, crops[None], mask[None],
                                      compute_dtype=bf).lengths[0])
    with RoutingTape(L, sequence_rows(0, n0)) as gen_tape:
        again = request()
    expect_launches("13 Mixtral request", counts, {"encoder_attention": vis, "flash_fwd": L})
    extra = {n: c for n, c in counts.items() if c and n not in ("encoder_attention", "flash_fwd")}
    if extra or toks != again or len(toks) != MOE_NEW or not all(
            0 <= t < cfg.llm.vocab_size for t in toks):
        raise AssertionError(f"phase 13 generate: off-path launches {extra}, repeats "
                             f"{toks == again}, {len(toks)} tokens")
    log(f"phase 13 Mixtral generate: {MOE_NEW} tokens in {wall * 1e3:.1f} ms host (one "
        f"request); repeats: True; tokens {toks[:12]}...")

    # the first tokens against a full forward teacher-forced on them: in
    # bf16 up to a router near tie (the two runs' routing taped: the sparse
    # dispatch's products see other row counts, and the decode steps take
    # the dense masked path), in fp32 compute (bf16 weights) up to a near
    # tie of the logits
    n = MOE_FORWARD_TOKENS
    for dt in (bf, torch.float32):
        want = toks if dt == bf else gen.generate(
            params, cfg_run, ids, attn, crops[None], mask[None], max_new_tokens=n,
            compute_dtype=dt)[0].tolist()
        with RoutingTape(L, sequence_rows(0, n0)) as fwd_tape:
            logits = forced_logits(params, cfg_run, ids, attn, crops[None], mask[None],
                                   want[:n], dt)
        name = f"Mixtral generate's first {n} tokens against full forwards, {str(dt)[6:]}"
        if dt == bf:
            router_tie_rule(name, logits.argmax(-1).tolist(), want[:n], (fwd_tape, gen_tape),
                            (0, 0), n0, lambda j: logits[j])
        else:
            near_tie_rule(name, want[:n], logits.argmax(-1).tolist(), logits, -1, phase="13",
                          ref="the argmax of the full forward")
        del logits, fwd_tape
    del gen_tape

    # the prefill and a decode step: times, syncs, the MoE dispatch's share
    with torch.no_grad(), fp32_accumulation():
        def prefill():
            return gen.prefill(params, cfg_run, ids, attn, crops[None], mask[None], bf)
        (last, kvs, lengths, S), pre_syncs = count_syncs(prefill)
        cache = llama.prefill_into_cache(
            llama.init_kv_cache(cfg.llm, 1, S + 64, dtype=bf, device=dev), kvs, lengths)
        del kvs
        tok = last.argmax(-1)

        def step():
            nonlocal cache
            lg, cache = llama.decode_step(params["llm"], cache, tok, cfg.llm, compute_dtype=bf)
            return lg
        step()
        _, step_syncs = count_syncs(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        step_host = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
        pre_host = host_ms(prefill)

        real = llama.moe_ffn_sparse

        def marked(*a):
            with torch.profiler.record_function("moe_dispatch"):
                return real(*a)
        path = out_dir / "profile_mixtral_prefill.json"
        llama.moe_ffn_sparse = marked
        try:
            traced = profiled(prefill, path)
        finally:
            llama.moe_ffn_sparse = real
        if traced:
            busy, launches, _ = trace_device(path)
            rng_ms, _ = trace_ranges(path, ["moe_dispatch"])
            share = rng_ms["moe_dispatch"][0] / busy
            log(f"phase 13 Mixtral prefill ({S} positions, {int(lengths[0])} valid, {L} layers):"
                f" host {pre_host:.1f} ms, device busy {busy:.2f} ms, {launches} launches; the "
                f"sparse MoE dispatch {rng_ms['moe_dispatch'][0]:.2f} ms of it ({share:.3f}); "
                f"host syncs {pre_syncs}")
        path = out_dir / "profile_mixtral_decode.json"
        if profiled(lambda: [step() for _ in range(PROFILE_STEPS)], path):
            busy, launches, by_name = trace_device(path)
            busy /= PROFILE_STEPS
            experts = sum(nbytes(t) for t in params["llm"]["layers"]["experts"].values())
            weights = sum(nbytes(t) for _, t in named_leaves(params["llm"]["layers"]))
            weights += nbytes(params["llm"]["lm_head"]["weight"])
            top = "; ".join(f"{ms / PROFILE_STEPS:.2f} ms {k[:50]}" for k, ms in
                            sorted(by_name.items(), key=lambda kv: -kv[1])[:4])
            log(f"phase 13 Mixtral decode step (B = 1, dense masked MoE): device {busy:.2f} ms,"
                f" host {step_host:.2f} ms, idle share {1 - busy / step_host:.3f}, "
                f"{launches / PROFILE_STEPS:.0f} launches, host syncs {step_syncs}; bytes bound: "
                f"experts {experts / 1e9:.2f} GB {experts / HBM_BPS * 1e3:.2f} ms, layers and "
                f"lm_head {weights / 1e9:.2f} GB {weights / HBM_BPS * 1e3:.2f} ms; largest: {top}")
        del cache, last
    return counts


def mixtral_engine(dev, cfg, params):
    """Phase 13's engine: 4 requests (bench.py's query twice, text prompts of
    ENGINE_TEXT tokens) through ``BatchDecodeEngine`` with an int8 KV pool,
    256-position admission chunks (the sparse dispatch) and k = 1 ticks (the
    dense masked MoE at B = 4). Each answer is held to ``generate``'s on an
    int8 cache: in fp32 compute (bf16 weights) up to a near tie of the
    logits; in bf16 (timed, launches counted: K4 per multimodal admission,
    K5 never) up to ``router_tie_rule``'s near ties, the routing of the
    engine and of each ``generate`` taped. Returns the bf16 run's
    launches."""
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import slime
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request

    bf, f32 = torch.bfloat16, torch.float32
    cfg_run = dataclasses.replace(cfg, eos_token_id=-1)
    vis = cfg.vision.num_layers + cfg.vision.select_layer + 1
    img, ids, attn, anyres = query(dev, cfg)
    crops, mask = anyres(img)
    with torch.no_grad(), fp32_accumulation():
        fused_len = int(slime.prepare_multimodal(params, cfg, ids, attn, crops[None],
                                                 mask[None], compute_dtype=bf).lengths[0])
    cache_len = -(-(fused_len + MOE_NEW + 1) // ENGINE_WINDOW) * ENGINE_WINDOW
    rng = np.random.default_rng(SEED + 13)
    text = [rng.integers(5, cfg.llm.vocab_size, (n,)) for n in ENGINE_TEXT]
    ids_np = ids[0].cpu().numpy()
    prompts = [("query A", ids_np, crops, mask), (f"text {ENGINE_TEXT[0]}", text[0], None, None),
               ("query B", ids_np, crops, mask), (f"text {ENGINE_TEXT[1]}", text[1], None, None)]

    def as_tensors(p):
        t = torch.from_numpy(p[1][None].astype(np.int64)).to(dev)
        return (t, torch.ones_like(t, dtype=torch.bool),
                None if p[2] is None else p[2][None], None if p[3] is None else p[3][None])

    def run(dtype):
        """The four requests through tick(), their routing taped -> (answers,
        launches, the tape, the requests' keys in it)."""
        eng = BatchDecodeEngine(params, cfg_run, max_slots=ENGINE_SLOTS, cache_len=cache_len,
                                compute_dtype=dtype, kv_quant=True, prefix_cache_mb=0,
                                device=dev)
        eng.multi_step = 1
        reqs = [Request(input_ids=p[1], pixel_values=p[2], crop_mask=p[3],
                        max_new_tokens=MOE_NEW) for p in prompts]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with RoutingTape(cfg.llm.num_layers, engine_rows(eng)) as tape:
            for r in reqs:
                eng.submit(r)
            for _ in range(4000):
                if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
                    break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        answers = [[t for c in r.stream() for t in c] for r in reqs]
        if not all(bool(torch.isfinite(eng.cache[n]).all()) for n in ("k_scale", "v_scale")):
            raise AssertionError("phase 13 engine: int8 pool scales not finite")
        ntok = sum(map(len, answers))
        log(f"phase 13 engine, {str(dtype)[6:]} (int8 KV pool, {ENGINE_SLOTS} slots, cache_len "
            f"{cache_len}, chunks of {eng.prefill_chunk_len}, k = 1): {ntok} tokens in "
            f"{wall:.3f} s ({ntok / wall:.2f} tok/s aggregate, admissions included), "
            f"{eng.decode_steps} decode steps; chunks by padded rows "
            f"{dict(sorted(eng.chunk_rows.items()))}; routing taped")
        return answers, counts, tape, [id(r) for r in reqs]

    answers, _, _, _ = run(f32)
    for p, got in zip(prompts, answers):
        args = as_tensors(p)
        want = gen.generate(params, cfg_run, *args, max_new_tokens=MOE_NEW, compute_dtype=f32,
                            kv_quant=True)[0].tolist()
        check_answer(f"{p[0]}, fp32", got, want,
                     lambda j: teacher_logits(params, cfg_run, *args, want, j, dtype=f32,
                                              kv_quant=True), phase="13")
    answers, counts, tape, keys = run(bf)
    expect_launches("13 engine, bfloat16", counts, {"encoder_attention": 2 * vis,
                                                    "flash_fwd": 0})
    for p, got, key in zip(prompts, answers, keys):
        args = as_tensors(p)
        n0 = fused_len if p[2] is not None else len(p[1])
        with RoutingTape(cfg.llm.num_layers, sequence_rows(0, n0)) as gen_tape:
            want = gen.generate(params, cfg_run, *args, max_new_tokens=MOE_NEW,
                                compute_dtype=bf, kv_quant=True)[0].tolist()
        router_tie_rule(f"{p[0]}, bf16 engine against bf16 generate (int8 cache)", got, want,
                        (tape, gen_tape), (key, 0), n0,
                        lambda j: teacher_logits(params, cfg_run, *args, want, j, dtype=bf,
                                                 kv_quant=True))
        del gen_tape
    del tape
    torch.cuda.empty_cache()
    return counts


def mixtral_train(dev, cfg, params):
    """Phase 13's training check: ``slime.loss_fn`` and its backward on
    MIXTRAL_TRAIN_LAYERS of the model's layers (copies, at full width), B =
    1, S = the model's 2048, bf16, remat, ``router_aux_loss_coef`` 0.02:
    the aux finite and positive, the gates' gradients non-zero, K5b and K5c
    once a layer, K5 twice (remat) and K4 once an encode. Returns the
    window's launches."""
    from slime_tpu_torch.models import slime
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.params import map_leaves

    n = MIXTRAL_TRAIN_LAYERS
    vis = cfg.vision.num_layers + cfg.vision.select_layer + 1
    tcfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=n,
                                                            router_aux_loss_coef=0.02))
    layers = map_leaves(lambda _, t: t[:n].clone().requires_grad_(True),
                        params["llm"]["layers"])
    tparams = dict(params, llm=dict(params["llm"], layers=layers))
    batch = train_batches(tcfg, np.random.default_rng(SEED + 23), 1, 1)[0]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with fp32_accumulation():
        loss, metrics = slime.loss_fn(tparams, tcfg, batch, training=True,
                                      generator=torch.Generator(device=dev).manual_seed(SEED),
                                      compute_dtype=torch.bfloat16, remat=True)
        loss.backward()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    aux = float(metrics["router_aux_loss"])
    gate = layers["gate"]["weight"].grad
    gate_norm = float(gate.float().norm()) if gate is not None else 0.0
    log(f"phase 13 Mixtral train step ({n} layers, B = 1, S = {batch['input_ids'].shape[1]}, "
        f"bf16, remat): loss {float(loss.detach()):.4f}, router_aux_loss {aux:.4f}, gate grad norm "
        f"{gate_norm:.4g}; host {wall:.1f} ms forward + backward; peak {peak:.2f} GiB")
    # remat recomputes each LLM layer's forward (K5 twice); the frozen tower
    # needs no backward, so no recompute (K4 once)
    expect_launches("13 train", counts, {"encoder_attention": vis, "flash_fwd": 2 * n,
                                         "flash_bwd_dkdv": n, "flash_bwd_dq": n})
    if not (np.isfinite(aux) and aux > 0 and gate_norm > 0 and np.isfinite(float(loss.detach()))):
        raise AssertionError(f"phase 13 train: loss {float(loss.detach())}, aux {aux}, gate grad "
                             f"{gate_norm}")
    del layers, tparams, gate
    return counts


def mpt_check(dev):
    """Phase 13's MPT: the model of ``mpt_config()`` at full width and depth
    in bf16 from a seed, ``forward`` on [1, MPT_SEQ] ids in bf16 and, on the
    same weights, in fp32: the argmax at every position equal up to a logged
    near tie (the fp32 logits of the two tokens within ENGINE_TIE_ATOL)."""
    from slime_tpu_torch.models import mpt
    from slime_tpu_torch.models.layers import fp32_accumulation

    mcfg = mpt_config()
    t0 = time.perf_counter()
    params = mpt.init(mcfg, generator=torch.Generator(device=dev).manual_seed(SEED + 31),
                      device=dev, dtype=torch.bfloat16)
    ids = torch.from_numpy(np.random.default_rng(SEED + 31).integers(
        0, mcfg.vocab_size, (1, MPT_SEQ))).to(dev)
    torch.cuda.synchronize()
    log(f"phase 13 MPT (d_model {mcfg.d_model}, {mcfg.n_layers} layers, vocabulary "
        f"{mcfg.vocab_size}, bf16) built in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad(), fp32_accumulation():
        bf_ms = host_ms(lambda: mpt.forward(params, ids, mcfg, compute_dtype=torch.bfloat16))
        lb = mpt.forward(params, ids, mcfg, compute_dtype=torch.bfloat16)[0]
        f32_ms = host_ms(lambda: mpt.forward(params, ids, mcfg), runs=1)
        lf = mpt.forward(params, ids, mcfg)[0]
    if not bool(torch.isfinite(lb).all() and torch.isfinite(lf).all()):
        raise AssertionError("phase 13 MPT: logits not finite")
    tb, tf = lb.argmax(-1), lf.argmax(-1)
    diff = (tb != tf).nonzero()[:, 0]
    gaps = (lf[diff, tf[diff]] - lf[diff, tb[diff]]).tolist()
    log(f"phase 13 MPT forward [1, {MPT_SEQ}]: bf16 {bf_ms:.1f} ms, fp32 {f32_ms:.1f} ms host; "
        f"top-1 equal at {MPT_SEQ - len(gaps)} of {MPT_SEQ} positions; where not, the fp32 "
        f"logit gap {max(gaps) if gaps else 0.0:.4g} at most (near-tie bound {ENGINE_TIE_ATOL}); "
        f"max |bf16 - fp32| logit {(lb - lf).abs().max().item():.4g}")
    if gaps and max(gaps) > ENGINE_TIE_ATOL:
        raise AssertionError(f"phase 13 MPT: bf16 top-1 parts from fp32 beyond a near tie "
                             f"({max(gaps):.4g})")
    del params, lb, lf


def sequential_scan(u, delta, A, B, C, D):
    """The selective scan's recurrence one position at a time."""
    h = torch.zeros(u.shape[0], u.shape[2], A.shape[1], device=u.device)
    ys = []
    for t in range(u.shape[1]):
        h = torch.exp(delta[:, t, :, None] * A) * h + (delta[:, t] * u[:, t])[..., None] \
            * B[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, C[:, t]))
    return torch.stack(ys, dim=1) + u * D[None, None]


def mamba_check(dev):
    """Phase 13's Mamba block at d_model MAMBA_SHAPE[2] on [MAMBA_SHAPE] in
    fp32: ``apply`` against the same block with its scan done one position
    at a time (within 1e-4), ``selective_scan`` against that loop, and
    causality (a late perturbation moves no earlier output)."""
    from slime_tpu_torch.models import mamba

    B, S, D = MAMBA_SHAPE
    p = mamba.init(d_model=D, generator=torch.Generator(device=dev).manual_seed(SEED + 37),
                   device=dev)
    x = torch.randn(MAMBA_SHAPE, generator=torch.Generator(device=dev).manual_seed(SEED + 38),
                    device=dev)
    with torch.no_grad():
        y = mamba.apply(p, x)
        ms = host_ms(lambda: mamba.apply(p, x))
        real = mamba.selective_scan
        mamba.selective_scan = sequential_scan
        try:
            y_seq = mamba.apply(p, x)
        finally:
            mamba.selective_scan = real
        x2 = x.clone()
        x2[:, S - 100] += 10.0
        y2 = mamba.apply(p, x2)
    err = (y - y_seq).abs().max().item()
    before = (y2[:, :S - 100] - y[:, :S - 100]).abs().max().item()
    after = (y2[:, S - 100:] - y[:, S - 100:]).abs().max().item()
    log(f"phase 13 Mamba block, d_model {D}, [{B}, {S}, {D}] fp32: {ms:.2f} ms host; against "
        f"the sequential scan max |diff| {err:.3g} (bound 1e-4); a perturbation at position "
        f"{S - 100} moves earlier outputs by {before:.3g}, later ones by {after:.3g}")
    if not (bool(torch.isfinite(y).all()) and err <= 1e-4 and before <= 1e-5 and after > 0):
        raise AssertionError(f"phase 13 Mamba: diff {err:.3g}, causal {before:.3g} / {after:.3g}")


def model_families_phase(dev):
    """Phase 13: the other model families. Mixtral-8x7B at full width cut
    to MIXTRAL_LAYERS layers (one layer's bf16 experts are 2.82 GB; 32
    layers hold 90.2 GB, over the card's 80 GB), bf16, stacked, seed 0:
    the MoE layer check, bench.py's query through ``generate`` and the
    engine, a training backward on 2 of its layers; then MPT-7B at full
    width and depth and the Mamba block. Returns the counted windows'
    launches."""
    from slime_tpu_torch.config import LLMConfig

    cfg = mixtral_config()
    t_phase = time.perf_counter()
    full = LLMConfig.mixtral_8x7b().num_layers
    experts = (cfg.llm.num_experts * 3 * cfg.llm.intermediate_size * cfg.llm.hidden_size * 2)
    log(f"phase 13 Mixtral-8x7B at full width, {cfg.llm.num_layers} of {full} layers: a "
        f"memory cut (bf16 experts {experts / 1e9:.2f} GB a layer, {full * experts / 1e9:.1f} "
        f"GB at {full} layers, over the card's 80 GB)")
    t0 = time.perf_counter()
    params = mixtral_params(dev, cfg)
    torch.cuda.synchronize()
    log(f"phase 13 Mixtral SliME built on {dev} in {time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    counts = {}
    moe_layer_check(dev, cfg, params)
    for part in (mixtral_serve, mixtral_engine, mixtral_train):
        for n, c in part(dev, cfg, params).items():
            counts[n] = counts.get(n, 0) + c
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    mpt_check(dev)
    torch.cuda.empty_cache()
    mamba_check(dev)
    torch.cuda.empty_cache()
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return counts


# phase 14: the mesh. Serving's answer length, the LoRA step's rows a rank
# and steps, the expert-parallel check's tokens and capacity (nothing dropped)
TP_NEW, MESH_LORA_ROWS, MESH_LORA_STEPS = 64, 2, 2
EP_TOKENS, EP_FACTOR = 2048, 4.0
# the sharded LoRA step against the one-process one. At one rank the mesh
# runs the one-process arithmetic: loss, grad norm and adapters within the
# one-process step's own repeat spread (0 where it repeats exactly). Across
# ranks the sums run in another order and bf16's backward through 32 layers
# carries it into Adam's first steps, which move an entry by the learning
# rate whatever the size of its gradient: these relative bounds, and the
# adapters' distance under this share of the distance they moved
MESH_LOSS_RTOL, MESH_NORM_RTOL, MESH_ADAPTER_SHARE = 1e-3, 1e-2, 0.25


def plain_generate(params, cfg, ids, attn, pv, cm, n, dtype=torch.bfloat16):
    """``generate``'s greedy tokens with the non-fused decode step (the
    single-card reference of the mesh, which runs non-fused as JAX's)."""
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import llama
    from slime_tpu_torch.models.layers import fp32_accumulation

    with torch.no_grad(), fp32_accumulation():
        logits, kvs, lengths, L = gen.prefill(params, cfg, ids, attn, pv, cm, dtype)
        cache = llama.prefill_into_cache(llama.init_kv_cache(cfg.llm, 1, L + n, dtype=dtype,
                                                             device=ids.device), kvs, lengths)
        del kvs
        toks = [int(logits[0].argmax())]
        for _ in range(n - 1):
            logits, cache = llama.decode_step(params["llm"], cache,
                                              torch.tensor([toks[-1]], device=ids.device),
                                              cfg.llm, compute_dtype=dtype, fused=False)
            toks.append(int(logits[0].argmax()))
    return toks


def mesh_serve(dev, cfg, params, mesh, say):
    """Phase 14 (a): bench.py's query through ``generate(mesh=...)`` and
    phase 8's four requests through the engine with ``mesh=``; -> launch
    counts of the counted windows (the generate request, the engine run)."""
    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import llama, slime
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.parallel.mesh import layer_list, local_bytes, shard_params
    from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request

    bf, lead = torch.bfloat16, mesh.rank == 0
    cfg_run = dataclasses.replace(cfg, eos_token_id=-1)
    NL, V = cfg.llm.num_layers, cfg.llm.vocab_size
    vis = cfg.vision.num_layers + cfg.vision.select_layer + 1
    img, ids, attn, anyres = query(dev, cfg)
    crops, mask = anyres(img)
    args = (ids, attn, crops[None], mask[None])
    want = plain_generate(params, cfg_run, *args, TP_NEW)
    sp = shard_params(mesh, layer_list(params))      # the serving entry points' layout
    torch.cuda.synchronize()
    say(f"phase 14 params sharded by the rule table, the LLM layers a list: "
        f"{local_bytes(sp) / 2 ** 30:.3f} GiB held by this rank (the whole tree "
        f"{local_bytes(params) / 2 ** 30:.3f} GiB); {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated on this card")

    def request(n=TP_NEW):
        return gen.generate(sp, cfg_run, *args, max_new_tokens=n, compute_dtype=bf, mesh=mesh)
    request(2)                                                      # warm
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = request()[0].tolist()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    t0 = time.perf_counter()
    request(1)
    torch.cuda.synchronize()
    ttft = (time.perf_counter() - t0) * 1e3
    if mesh.size == 1 and got != want:
        raise AssertionError(f"phase 14 generate(mesh): {got} != the unsharded non-fused {want}")
    if mesh.size > 1:
        check_answer("generate(mesh)", got, want, lambda j: teacher_logits(
            params, cfg_run, *args, want, j), phase="14")
    expect = {"encoder_attention": vis, "flash_fwd": NL,
              **{n + sfx: 0 for n in FUSED
                 for sfx in ("", "_ring", "_q4g_ring", "_dense", "_wgmma")}}
    wrong = {n: (counts[n], c) for n, c in expect.items() if counts[n] != c}
    if wrong and dev.type == "cuda":                  # the CPU counts nothing
        raise AssertionError(f"phase 14 generate(mesh) launches (got, want): {wrong}")
    say(f"phase 14 generate(mesh), bench.py's query, {TP_NEW} greedy tokens: "
        f"{'bit-equal to' if got == want else 'within the near-tie rule of'} the unsharded "
        f"non-fused generate; TTFT {ttft:.1f} ms, host wall {wall:.1f} ms, decode step "
        f"{(wall - ttft) / (TP_NEW - 1):.2f} ms (host wall); launches on this rank: K4 "
        f"{counts['encoder_attention']}, K5 {counts['flash_fwd']}, K1-K3 none")

    # one decode step at B = 1, traced: device and host ms, NCCL's share
    out = Path(__file__).resolve().parent / "bench_out"
    out.mkdir(exist_ok=True)
    with torch.no_grad(), fp32_accumulation(), mesh:
        _, kvs, lengths, L = gen.prefill(sp, cfg_run, *args, bf)
        cache = llama.prefill_into_cache(llama.init_kv_cache(cfg.llm, 1, L + 16, dtype=bf,
                                                             device=dev), kvs, lengths)
        del kvs
        tok = torch.tensor([got[0]], device=dev)

        def step():
            return llama.decode_step(sp["llm"], cache, tok, cfg.llm, compute_dtype=bf)
        step()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        path = out / f"trace_phase14_decode_rank{mesh.rank}.json"
        if profiled(step, path):
            busy, n_k, by = trace_device(path)
            nccl_ms, nccl_n = trace_kernel(path, "nccl")
            say(f"phase 14 decode step (B = 1, mesh of {mesh.size}): device busy {busy:.3f} ms, "
                f"host wall {statistics.median(walls):.3f} ms, {n_k} kernel launches; NCCL "
                f"kernels {nccl_n} launches, {nccl_ms:.4f} ms ({nccl_ms / max(busy, 1e-9):.4f} "
                f"of the busy time)")
    del cache

    # the engine on phase 8's four requests, under the mesh
    with torch.no_grad(), fp32_accumulation():
        fused_len = int(slime.prepare_multimodal(params, cfg, *args, compute_dtype=bf
                                                 ).lengths[0])
    cache_len = -(-(fused_len + N_NEW + 1) // ENGINE_WINDOW) * ENGINE_WINDOW
    rng = np.random.default_rng(SEED + 12)
    text = [rng.integers(5, V, (n,)) for n in ENGINE_TEXT]
    ids_np = ids[0].cpu().numpy()
    prompts = [("query A", ids_np, crops, mask), (f"text {ENGINE_TEXT[0]}", text[0], None, None),
               ("query B", ids_np, crops, mask), (f"text {ENGINE_TEXT[1]}", text[1], None, None)]

    def as_tensors(p):
        t = torch.from_numpy(p[1][None].astype(np.int64)).to(dev)
        return (t, torch.ones_like(t, dtype=torch.bool),
                None if p[2] is None else p[2][None], None if p[3] is None else p[3][None])

    def drive(eng):
        """Phase 8's script: two requests, two more at tick 4 -> the answers."""
        reqs = [Request(input_ids=p[1], pixel_values=p[2], crop_mask=p[3],
                        max_new_tokens=N_NEW) for p in prompts]
        for r in reqs[:2]:
            eng.submit(r)
        for tick in range(1, 4000):
            n = eng.tick()
            if tick == 4:
                for r in reqs[2:]:
                    eng.submit(r)
            if tick > 4 and n == 0 and eng.pending.empty() and eng._admission is None:
                break
        eng.stop()
        return [[t for c in r.stream() for t in c] for r in reqs]

    refs = {}
    if mesh.size > 1:               # generate(mesh) is a collective: every rank runs it
        for p in (prompts[0], prompts[1], prompts[3]):
            refs[p[1].size] = gen.generate(sp, cfg_run, *as_tensors(p), max_new_tokens=N_NEW,
                                           compute_dtype=bf, mesh=mesh)[0].tolist()
    engine_kw = dict(max_slots=ENGINE_SLOTS, cache_len=cache_len, compute_dtype=bf, device=dev)
    eng = BatchDecodeEngine(sp, cfg_run, mesh=mesh, **engine_kw)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    if not lead:
        eng.follow()
        return _add(counts, launch_counts())
    answers = drive(eng)
    torch.cuda.synchronize()
    ewall = time.perf_counter() - t0
    ecounts = launch_counts()
    say(f"phase 14 engine(mesh), phase 8's four requests: {sum(map(len, answers))} tokens in "
        f"{ewall:.3f} s, {eng.decode_steps} decode steps; K4 {ecounts['encoder_attention']}, "
        f"K5 {ecounts['flash_fwd']}, K1-K3 "
        f"{sum(ecounts[n + sfx] for n in FUSED for sfx in ('', '_wgmma'))}")
    if dev.type == "cuda" and (ecounts["encoder_attention"] != 2 * vis or any(
            ecounts[n + sfx] for n in FUSED
            for sfx in ("", "_ring", "_q4g_ring", "_dense", "_wgmma"))):
        raise AssertionError(f"phase 14 engine(mesh) launches: "
                             f"{ {n: c for n, c in ecounts.items() if c} }")
    if mesh.size == 1:
        # the plain engine on the same requests and settings, non-fused as
        # under the mesh (list layers): the same arithmetic, so equal tokens
        listed = {**params, "llm": {**params["llm"], "layers": [
            llama._layer(params["llm"]["layers"], i) for i in range(NL)]}}
        plain = drive(BatchDecodeEngine(listed, cfg_run, **engine_kw))
        if answers != plain:
            raise AssertionError(f"phase 14 engine(mesh) {answers} != the unsharded "
                                 f"non-fused engine's {plain}")
        say("phase 14 engine(mesh) answers equal the unsharded non-fused engine's token "
            "for token")
        return _add(counts, ecounts)
    for p, a in zip(prompts, answers):          # the teacher on this card alone
        ref = refs[p[1].size]
        check_answer(f"engine(mesh) {p[0]}", a, ref, lambda j, p=p, ref=ref: teacher_logits(
            params, cfg_run, *as_tensors(p), ref, j), phase="14")
    return _add(counts, ecounts)


def _add(a, b):
    return {n: a.get(n, 0) + b.get(n, 0) for n in set(a) | set(b)}


def mesh_lora(dev, cfg, params, world, say):
    """Phase 14 (b): a LoRA step of SliME-8B (int8 base) on the (1, world, 1)
    mesh against the one-process step on the same global batch; -> launch
    counts of the mesh steps."""
    from slime_tpu_torch.models import llama
    from slime_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from slime_tpu_torch.params import named_leaves
    from slime_tpu_torch.train import lora as lora_lib
    from slime_tpu_torch.train.optim import TrainConfig
    from slime_tpu_torch.train.step import init_lora_train_state, make_lora_train_step

    L = cfg.llm.num_layers
    base = {**params, "llm": {**params["llm"], "layers": [
        llama._layer(params["llm"]["layers"], i) for i in range(L)]}}
    lora = lora_lib.init_lora(base, generator=torch.Generator(device=dev).manual_seed(SEED + 3),
                              r=LORA_R, alpha=LORA_ALPHA)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_ratio=0.0, lr_schedule="constant",
                     total_steps=8)
    rows = MESH_LORA_ROWS * world
    batches = train_batches(cfg, np.random.default_rng(SEED + 14), MESH_LORA_STEPS, rows)
    put = lambda b: {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)  # noqa: E731
                     for k, v in b.items()}
    kw = dict(rank=LORA_R, alpha=LORA_ALPHA, compute_dtype=torch.bfloat16, remat=True)

    def run(mesh):
        b, state, tx = init_lora_train_state(base, lora, tc, mesh=mesh)
        step = make_lora_train_step(cfg, tc, tx, mesh=mesh, **kw)
        recs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        for batch in batches:
            bt = put(batch if mesh is None else shard_batch(mesh, batch))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b, bt)
            torch.cuda.synchronize()
            recs.append(((time.perf_counter() - t0) * 1e3, float(m["loss"]),
                         float(m["grad_norm"])))
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        adapters = state["params"]["adapters"]
        if mesh is not None:
            from slime_tpu_torch.parallel.mesh import unshard_params
            adapters = unshard_params(mesh, adapters)
        return recs, {p: t.detach().float().cpu() for p, t in named_leaves(adapters)}, counts, peak

    one, a1, _, peak1 = run(None)
    again, a1b, _, _ = run(None)              # the one-process step's own repeat
    mesh = make_mesh(1, world, 1)
    got, a2, counts, peak = run(mesh)
    start = {p: t.float().cpu() for p, t in named_leaves(lora["adapters"])}
    dist = lambda a, b: sum(float((a[p] - b[p]).norm() ** 2) for p in a) ** 0.5  # noqa: E731
    moved, spread, dist_ = dist(a1, start), dist(a1b, a1), dist(a2, a1)
    tokens = rows * cfg.tokenizer_model_max_length
    for i, ((ms1, l1, g1), (_, l1b, g1b), (ms2, l2, g2)) in enumerate(zip(one, again, got)):
        say(f"phase 14 LoRA step {i + 1} (SliME-8B int8 base, r {LORA_R}, S = "
            f"{cfg.tokenizer_model_max_length}, remat, {MESH_LORA_ROWS} rows a rank), mesh "
            f"(1,{world},1): loss {l2:.6f} (one process {l1:.6f}, again {l1b:.6f}), grad_norm "
            f"{g2:.6f} ({g1:.6f}, {g1b:.6f}), step {ms2:.1f} ms ({ms1:.1f}), "
            f"{tokens / ms2 * 1e3:.1f} tokens/s")
        if world == 1:
            ok = abs(l2 - l1) <= abs(l1b - l1) and abs(g2 - g1) <= abs(g1b - g1)
        else:
            ok = (abs(l2 - l1) <= MESH_LOSS_RTOL * abs(l1)
                  and abs(g2 - g1) <= MESH_NORM_RTOL * abs(g1))
        if not ok:
            raise AssertionError(f"phase 14 LoRA step {i + 1}: loss {l2} vs {l1} ({l1b}), "
                                 f"grad_norm {g2} vs {g1} ({g1b})")
    say(f"phase 14 LoRA adapters after {MESH_LORA_STEPS} steps: distance to the one-process "
        f"ones {dist_:.4g} (the one-process step against its repeat: {spread:.4g}), "
        f"{dist_ / max(moved, 1e-30):.4g} of the distance they moved ({moved:.4g}); peak "
        f"{peak:.2f} GiB on this rank (one process {peak1:.2f} GiB); launches: K5 "
        f"{counts['flash_fwd']}, K5b {counts['flash_bwd_dkdv']}, K5c "
        f"{counts['flash_bwd_dq']}, K4 {counts['encoder_attention']}")
    bound = spread if world == 1 else max(2 * spread, MESH_ADAPTER_SHARE * moved)
    if not (moved > 0 and dist_ <= bound):
        raise AssertionError(f"phase 14 LoRA adapters: {dist_} apart (bound {bound}), "
                             f"moved {moved}")
    if dev.type == "cuda" and not (counts["flash_bwd_dkdv"] and counts["flash_bwd_dq"]):
        raise AssertionError(f"phase 14 LoRA step: K5b/K5c not launched: {counts}")
    return counts


def mesh_moe(dev, mesh, say):
    """Phase 14 (c): ``moe_ffn_ep`` at Mixtral-8x7B's layer shapes against
    ``moe_dispatch.moe_ffn_sparse`` on the same tokens (this rank's)."""
    from slime_tpu_torch.config import LLMConfig
    from slime_tpu_torch.models.llama import top_k_stable
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.ops.moe_dispatch import moe_ffn_sparse
    from slime_tpu_torch.ops.moe_ep import moe_ffn_ep

    llm = LLMConfig.mixtral_8x7b()
    E, K, H, I = llm.num_experts, llm.num_experts_per_tok, llm.hidden_size, llm.intermediate_size
    n, m = mesh.shape["model"], mesh.coords["model"]
    El, Tl = E // n, EP_TOKENS // n
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    w1, w3 = (torch.randn((E, I, H), generator=g, device=dev, dtype=torch.bfloat16) * 0.02
              for _ in range(2))
    w2 = torch.randn((E, H, I), generator=g, device=dev, dtype=torch.bfloat16) * 0.02
    x = torch.randn((EP_TOKENS, H), generator=g, device=dev)[m * Tl:(m + 1) * Tl]
    topw, topi = top_k_stable(torch.randn((EP_TOKENS, E), generator=g, device=dev), K)
    topw, topi = torch.softmax(topw, -1)[m * Tl:(m + 1) * Tl], topi[m * Tl:(m + 1) * Tl]
    mine = slice(m * El, (m + 1) * El)
    with torch.no_grad(), fp32_accumulation():
        for dt in (torch.float32, torch.bfloat16):
            ws = [w.to(dt) for w in (w1, w2, w3)]
            xd = x.to(dt)
            got = moe_ffn_ep(xd, *(w[mine] for w in ws), topi, topw.to(dt), mesh=mesh,
                             capacity_factor=EP_FACTOR).float()
            want = moe_ffn_sparse(xd, *ws, topi, topw.to(dt)).float()
            err = (got - want).abs().max().item()
            bound = 1e-4 if dt == torch.float32 else \
                8 * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
            ms = cuda_ms(lambda: moe_ffn_ep(xd, *(w[mine] for w in ws), topi, topw.to(dt),
                                            mesh=mesh, capacity_factor=EP_FACTOR), runs=5)
            sparse_ms = cuda_ms(lambda: moe_ffn_sparse(xd, *ws, topi, topw.to(dt)), runs=5)
            say(f"phase 14 moe_ffn_ep (E={E}, K={K}, H={H}, I={I}, {Tl} tokens a rank, factor "
                f"{EP_FACTOR}, {str(dt)[6:]}) over {n} rank(s): max |diff| against "
                f"moe_ffn_sparse {err:.3g} (bound {bound:.3g}); {ms:.3f} ms (moe_ffn_sparse "
                f"{sparse_ms:.3f} ms)")
            if not err <= bound:
                raise AssertionError(f"phase 14 moe_ffn_ep {dt}: {err:.3g} > {bound:.3g}")
            del ws, got, want


# phase 14 (d): the composed step. The LLM's layers (a memory cut; the
# stages divide them), the global rows, micro-batches and steps; the positions
# a row at which pipeline_forward's top-1 is held to llama.forward's
COMPOSED_LAYERS = {3: 6}
COMPOSED_LAYERS_DEFAULT, COMPOSED_ROWS, COMPOSED_MICRO, COMPOSED_STEPS = 4, 4, 4, 2
COMPOSED_POSITIONS = 256


def composed_step(dev, cfg, world, say):
    """Phase 14 (d): the composed multimodal train step of SliME-8B (every
    width, the LLM cut to 4 of 32 layers, 6 at three ranks) on the (data,
    fsdp, model, pp) = (1, 1, 1, world) mesh, full-parameter bf16 with
    AdamW, n_micro = 4, 2 steps; at one rank step 1's loss within the
    one-process step's own repeat spread; ``pipeline_forward`` against
    ``llama.forward`` (top-1 up to near ties); -> launch counts of the
    composed steps."""
    from slime_tpu_torch.models import llama, slime
    from slime_tpu_torch.models.layers import fp32_accumulation
    from slime_tpu_torch.parallel import composed, memory_plan
    from slime_tpu_torch.parallel.mesh import make_mesh
    from slime_tpu_torch.parallel.pipeline import pipeline_forward
    from slime_tpu_torch.train.optim import TrainConfig, adamw
    from slime_tpu_torch.train.step import init_train_state, make_train_step

    t_part = time.perf_counter()
    n_layers = COMPOSED_LAYERS.get(world, COMPOSED_LAYERS_DEFAULT)
    ccfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=n_layers))
    S = ccfg.tokenizer_model_max_length
    params = slime.init(ccfg, generator=torch.Generator(device=dev).manual_seed(SEED + 20),
                        device=dev, dtype=torch.bfloat16)
    batch = train_batches(ccfg, np.random.default_rng(SEED + 21), 1, COMPOSED_ROWS)[0]
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    noise = {"gate": torch.randn((COMPOSED_ROWS, ccfg.vision.num_patches, 2), generator=g,
                                 device=dev),
             "select": torch.randn((COMPOSED_ROWS, ccfg.max_local_crops
                                    * ccfg.mm_resampler_dim), generator=g, device=dev)}
    kw = dict(compute_dtype=torch.bfloat16, remat=True)

    # the one-process full-parameter step, twice from the same state (its
    # repeat spread), freed before the composed state is built
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_ratio=0.0, lr_schedule="constant",
                     total_steps=8)
    ref = []
    for _ in range(2):
        state, tx = init_train_state(params, tc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = make_train_step(ccfg, tc, tx, **kw)(state, batch, noise=noise)
        ref.append((float(m["loss"]), (time.perf_counter() - t0) * 1e3))
        del state, tx, m
        gc_cuda()

    mesh = composed.make_composed_mesh(1, 1, 1, world)
    state = composed.init_composed_mm_train_state(params, adamw(TRAIN_LR), mesh=mesh)
    step = composed.make_composed_mm_train_step(ccfg, mesh=mesh, n_micro=COMPOSED_MICRO, **kw)
    cbatch, cnoise = composed.composed_batch(mesh, batch), composed.composed_batch(mesh, noise)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    recs = []
    for _ in range(COMPOSED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, cbatch, noise=cnoise)
        torch.cuda.synchronize()
        recs.append(((time.perf_counter() - t0) * 1e3, float(m["loss"]), float(m["grad_norm"])))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plans = {name: memory_plan.plan_mm(ccfg, n_pp=world, batch=COMPOSED_ROWS, seq=S,
                                       n_micro=COMPOSED_MICRO, **pkw)
             for name, pkw in (("JAX's layout: fp32 Adam and master", {}),
                               ("the port's: bf16 moments, no master",
                                dict(opt_bytes=2, master_fp32=False)))}
    tokens = COMPOSED_ROWS * S
    for i, (ms, loss, gn) in enumerate(recs):
        say(f"phase 14 composed step {i + 1} (SliME-8B, LLM {n_layers} of 32 layers, mesh "
            f"(data, fsdp, model, pp) = (1, 1, 1, {world}), {COMPOSED_ROWS} rows, S = {S}, "
            f"n_micro {COMPOSED_MICRO}, bf16, AdamW, remat): loss {loss:.6f}, grad_norm "
            f"{gn:.6f}, step {ms:.1f} ms, {tokens / ms * 1e3:.1f} tokens/s")
    say(f"phase 14 composed: one-process step 1 loss {ref[0][0]:.6f}, again {ref[1][0]:.6f} "
        f"({ref[0][1]:.1f} ms, {ref[1][1]:.1f} ms); peak {peak / 2 ** 30:.2f} GiB on this rank; "
        + "; ".join(f"plan_mm ({name}) {p.total / 2 ** 30:.2f} GiB ({p.per_category_gb})"
                    for name, p in plans.items())
        + f"; launches: K4 {counts['encoder_attention']}, K5 {counts['flash_fwd']}, K5b "
        f"{counts['flash_bwd_dkdv']}, K5c {counts['flash_bwd_dq']}")
    losses = [r[1] for r in recs]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 14 composed: losses {losses}")
    if world == 1 and not abs(losses[0] - ref[0][0]) <= abs(ref[1][0] - ref[0][0]):
        raise AssertionError(f"phase 14 composed step 1: loss {losses[0]} against the "
                             f"one-process {ref[0][0]} ({ref[1][0]})")
    if dev.type == "cuda" and not all(counts[n] for n in ("encoder_attention", "flash_fwd",
                                                         "flash_bwd_dkdv", "flash_bwd_dq")):
        raise AssertionError(f"phase 14 composed: K4, K5, K5b or K5c not launched: {counts}")
    del state, step
    gc_cuda()

    # pipeline_forward against llama.forward on the same weights and rows
    llm, lcfg = params["llm"], ccfg.llm
    ids = batch["input_ids"]
    rows = torch.arange(COMPOSED_ROWS, device=dev)[:, None]
    at = torch.linspace(0, ids.shape[1] - 1, COMPOSED_POSITIONS, device=dev).long()
    at = at[None].expand(COMPOSED_ROWS, -1)
    with torch.no_grad(), fp32_accumulation():
        embeds = llama.embed(llm, torch.where(ids < 0, 0, ids))
        want, _ = llama.forward(llm, embeds, lcfg, compute_dtype=torch.bfloat16,
                                return_hidden=True)
        got = pipeline_forward(llm, embeds, lcfg, mesh=make_mesh(1, 1, 1, n_pp=world),
                               n_micro=COMPOSED_MICRO, return_hidden=True)
        want_l = llama._lm_head(llm, want[rows, at])
        got_l = llama._lm_head(llm, got[rows, at])
    top2 = want_l.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = got_l.argmax(-1) != want_l.argmax(-1)
    worst = float(gap[differ].max()) if bool(differ.any()) else 0.0
    say(f"phase 14 pipeline_forward over {world} stage(s) against llama.forward ({n_layers} "
        f"layers, bf16, {COMPOSED_ROWS} x {ids.shape[1]}): top-1 equal at "
        f"{int((~differ).sum())} of {differ.numel()} positions, the others at top-2 gaps up "
        f"to {worst:.4f} (near-tie bound {ENGINE_TIE_ATOL}); hidden max |diff| "
        f"{float((got - want).abs().max()):.4g}")
    if worst > ENGINE_TIE_ATOL:
        raise AssertionError(f"phase 14 pipeline_forward: top-1 parts at a gap of {worst}")
    del params, got, want
    gc_cuda()
    say(f"phase 14 composed part: {time.perf_counter() - t_part:.1f} s")
    return counts


def gc_cuda():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def mesh_rank(rank, world, address, cfg):
    """Phase 14 on one rank of a ``world``-rank NCCL group; -> launch counts
    (rank 0 logs)."""
    import torch.distributed as dist

    from slime_tpu_torch.models import projector, sampler, vit
    from slime_tpu_torch.ops import _cuda
    from slime_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    _cuda.library()
    dist.init_process_group("nccl", init_method=address, world_size=world, rank=rank)
    say = log if rank == 0 else (lambda msg: None)
    try:
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(SEED)
        kw = dict(generator=g, device=dev, dtype=torch.bfloat16)
        params = {"vision": vit.init(cfg.vision, **kw), "projector": projector.init(cfg, **kw),
                  "sampler": sampler.init(cfg, **kw), "llm": int8_llm_params(cfg.llm, g, dev)}
        mesh = make_mesh(1, 1, world)
        say(f"phase 14 mesh (1, 1, {world}) over NCCL, {world} rank(s), one a card; phase 2's "
            f"int8 SliME-8B built in {time.perf_counter() - t0:.1f} s")
        counts = mesh_serve(dev, cfg, params, mesh, say)
        counts = _add(counts, mesh_lora(dev, cfg, params, world, say))
        del params
        torch.cuda.empty_cache()
        mesh_moe(dev, mesh, say)
        counts = _add(counts, composed_step(dev, cfg, world, say))
        dist.barrier()
        return counts
    finally:
        dist.destroy_process_group()


def _mesh_rank_main(rank, world, address, cfg, where):
    counts = mesh_rank(rank, world, address, cfg)
    if rank == 0:
        Path(where).write_text(json.dumps(counts))


def mesh_phase(dev, cfg):
    """Phase 14: the (data, fsdp, model) mesh over NCCL, one rank a card, at
    min(device_count, 4) ranks: tensor-parallel serving (generate and the
    engine), a sharded LoRA step and the expert-parallel dispatch. At one
    rank this process is rank 0 (the phase is the last: it destroys its
    group); at more, the ranks are spawned. -> rank 0's launch counts."""
    import gc
    import socket

    del dev
    gc.collect()                      # an earlier phase's cycles hold its tensors
    torch.cuda.empty_cache()
    world = min(torch.cuda.device_count(), 4)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    log(f"phase 14: world {world} (one NCCL rank a card); the arithmetic across 2 and 4 ranks "
        f"is held on the CPU over gloo against the JAX package (tests/test_torch_tp_serving.py, "
        f"test_torch_parallel_train.py, test_torch_moe_ep.py)")
    t0 = time.perf_counter()
    if world == 1:
        counts = mesh_rank(0, 1, address, cfg)
    else:
        import torch.multiprocessing as mp
        where = Path(__file__).resolve().parent / "bench_out" / "phase14_counts.json"
        where.parent.mkdir(exist_ok=True)
        mp.start_processes(_mesh_rank_main, args=(world, address, cfg, str(where)),
                           nprocs=world, start_method="spawn")
        counts = json.loads(where.read_text())
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return counts



def timed(walls, tag, fn, *args):
    """fn(*args), its wall time logged and kept in ``walls``."""
    t0 = time.perf_counter()
    out = fn(*args)
    walls.append((tag, time.perf_counter() - t0))
    log(f"{tag}: wall {walls[-1][1]:.1f} s")
    return out


def main():
    t_start = time.perf_counter()
    walls = []
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
    cut = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=CUT_LAYERS))
    walls.append(("phase 0 (checks, kernel build)", time.perf_counter() - t_start))

    record = timed(walls, "phase 1", kernel_phase, dev, cfg)
    launches = timed(walls, "phases 2, 3, 7-9 and the branches", serve_phases, dev, cfg)
    for tag, phase, args in (("phase 4", train_phase, (dev, cfg, fa)),
                             ("phases 5, 5b, 7", quantized_serve_phases, (dev, cfg)),
                             ("phase 6", context_parallel_phase, (dev, cfg)),
                             ("phase 10", train_cli_phase, (dev, cut)),
                             ("phase 11a", dpo_cli_phase, (dev, cut)),
                             ("phase 11b", opt8_phase, (dev, cut)),
                             ("phase 12", eval_phase, (dev, cut)),
                             ("phase 13", model_families_phase, (dev,)),
                             ("phase 14", mesh_phase, (dev, cfg))):      # 14 last
        torch.cuda.empty_cache()
        for name, n in timed(walls, tag, phase, *args).items():
            launches[name] += n
    log("wall time by phase: " + "; ".join(f"{tag} {sec:.1f} s" for tag, sec in walls)
        + f"; the whole script {time.perf_counter() - t_start:.1f} s")
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
