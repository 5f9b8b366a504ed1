"""Phase 12 of ``chip_smoke.py`` (evaluation) on the CPU at
``SliMEConfig.tiny`` widths, with ``torch.cuda``'s synchronisation and
memory calls and the profiler stubbed: its logic runs end to end (the
batch-4 and batch-1 answers, the beam check, the video and MMBench drivers,
the eval CLI's chunks and merge, the verifier's record, check and
corrupted-weight failure), and it launches no kernel (the CPU takes every
kernel's plain version, so every count stays 0; the launch checks run on
the card only). Its dense bf16 K1-K3 launch counters are split off from the
row-per-warp int8 records by ``launch_counts``."""
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
    counts = cs.eval_phase(torch.device("cpu"), SliMEConfig.tiny())
    out = capsys.readouterr().out
    assert not any(counts.values())
    for line in ("phase 12 batch 4 against batch 1:", "phase 12 beams, question 1:",
                 "questions equal to generate on process_video_frames' pixels",
                 "phase 12 mmbench: 2 rows x 4 rotated rounds",
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
