"""Phase 12 of ``chip_smoke.py`` (evaluation) on the CPU at
``SliMEConfig.tiny`` widths, with ``torch.cuda``'s synchronisation and
memory calls and the profiler stubbed and a small draft: its logic runs end
to end (the batch-4 and batch-1 answers, the beam check, the video and
MMBench drivers, the engine plain and speculating against generate and each
other, the eval CLI's chunks and merge, the verifier's record, check and
corrupted-weight failure), and it launches no kernel (the CPU takes every
kernel's plain version, so every count stays 0; the launch checks run on
the card only). Its dense bf16 K1-K3 launch counters are split off from the
row-per-warp int8 records by ``launch_counts``, and K1's and K2's dense
weight-ring calls (K3's too) from the row-per-warp dense ones and the
int8 ring's, K1's tensor-core calls from its int8 row-per-warp ones, and
K1's and K2's dense tensor-core calls from the int8 tensor-core ones."""
import pytest
import torch

import chip_smoke as cs
from slime_tpu_torch.config import SliMEConfig
from slime_tpu_torch.ops import fused_mlp, fused_qkvo

from .test_torch_eval import two_torch_threads  # noqa: F401


def test_eval_phase_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "profiled", lambda fn, path, start=None, tries=3: (fn(), False)[1])
    monkeypatch.setattr(cs, "DRAFT_LLM", dict(hidden_size=64, intermediate_size=128,
                                              num_layers=2, num_heads=4, num_kv_heads=2,
                                              head_dim=16, rope_theta=10000.0,
                                              max_position_embeddings=512))
    counts = cs.eval_phase(torch.device("cpu"), SliMEConfig.tiny())
    out = capsys.readouterr().out
    assert not any(counts.values())
    for line in ("phase 12 batch 4 against batch 1:", "phase 12 beams, question 1:",
                 "questions equal to generate on process_video_frames' pixels",
                 "phase 12 mmbench: 2 rows x 4 rotated rounds",
                 "phase 12 engine, 300-token prompt:", "phase 12 plain engine launches:",
                 "phase 12 speculating engine launches:",
                 "phase 12 speculating engine, 300-token prompt:",
                 "merged and scored: {'accuracy'", "verify_released_weights check: rc 0",
                 "one corrupted q_proj: rc 1"):
        assert line in out, line


@pytest.mark.parametrize("fn", [fused_qkvo.fused_qkv_decode, fused_qkvo.fused_o_residual,
                                fused_mlp.fused_mlp_decode])
def test_dense_counts_split_from_row_per_warp(fn, monkeypatch):
    """A dense bf16 launch lands in the ``_dense`` record only; an int8
    row-per-warp one in the plain record only."""
    name = fn.__name__
    cs.reset_launch_counts()
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    fused_qkvo.count(fn, x, fused_qkvo.DENSE)
    fused_qkvo.count(fn, x, fused_qkvo.INT8)
    fused_qkvo.count(fn, x.float(), fused_qkvo.DENSE)
    got = cs.launch_counts()
    cs.reset_launch_counts()
    assert (got[name + "_dense"], got[name], got[name + "_f32"]) == (1, 1, 1)
    assert sum(got.values()) == 3


@pytest.mark.parametrize("fn", [fused_qkvo.fused_qkv_decode, fused_mlp.fused_mlp_decode,
                                fused_qkvo.fused_o_residual])
def test_dense_ring_counts_split_from_the_int8_ring(fn):
    """A dense bf16 call on the weight ring lands in the ``_dense_ring``
    record only (not in ``_dense``, the row-per-warp dense instance, nor in
    ``_ring``, the int8 ring); an int8 ring call in ``_ring`` only."""
    name = fn.__name__
    cs.reset_launch_counts()
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    for fmt in (fused_qkvo.DENSE, fused_qkvo.INT8):
        fused_qkvo.count_ring(fn, fmt)
        fused_qkvo.count(fn, x, fmt)
    got = cs.launch_counts()
    cs.reset_launch_counts()
    assert (got[name + "_dense_ring"], got[name + "_ring"]) == (1, 1)
    assert sum(got.values()) == 2


def test_wgmma_counts_split_from_row_per_warp():
    """A K1 call on its tensor-core instance (int8 weights, bf16 x) lands in
    the ``fused_mlp_decode_wgmma`` record only, not in the int8
    row-per-warp record; a row-per-warp call in the plain record only."""
    fn = fused_mlp.fused_mlp_decode
    cs.reset_launch_counts()
    x = torch.zeros((20, 8), dtype=torch.bfloat16)
    fn.wgmma_launches += 1
    fused_qkvo.count(fn, x, fused_qkvo.INT8)
    fused_qkvo.count(fn, x, fused_qkvo.INT8)
    got = cs.launch_counts()
    cs.reset_launch_counts()
    assert (got["fused_mlp_decode_wgmma"], got["fused_mlp_decode"]) == (1, 1)
    assert sum(got.values()) == 2


@pytest.mark.parametrize("fn", [fused_qkvo.fused_qkv_decode, fused_mlp.fused_mlp_decode])
def test_dense_wgmma_counts_split_from_the_int8_wgmma(fn):
    """A dense bf16 call on the tensor-core instance lands in the
    ``_dense_wgmma`` record only (not in ``_wgmma``, the int8 one, nor in
    ``_dense``, the row-per-warp dense instance); an int8 one in
    ``_wgmma`` only."""
    name = fn.__name__
    cs.reset_launch_counts()
    x = torch.zeros((40, 8), dtype=torch.bfloat16)
    for fmt in (fused_qkvo.DENSE, fused_qkvo.INT8):
        fused_qkvo.count_route(fn, fmt, "wgmma")
        fused_qkvo.count(fn, x, fmt)
    got = cs.launch_counts()
    cs.reset_launch_counts()
    assert (got[name + "_dense_wgmma"], got[name + "_wgmma"]) == (1, 1)
    assert sum(got.values()) == 2
