"""``python -m slime_tpu_torch.parallel.dryrun --ranks N --backend gloo``: N CPU
ranks run a train step on the (1, N/2, 2) mesh, a tensor-parallel decode, the
pipeline's wavefront over N stages, the expert-parallel dispatch and the
sequence ring, each held to its single-process result inside the run, and at
8 ranks the composed multimodal train step on (data, fsdp, model, pp) = (1,
2, 2, 2); it exits 0 and rank 0 prints one line for each part."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("train step on mesh (1,{h},2)", "tensor-parallel decode", "pp wavefront over {n} stages",
         "expert-parallel dispatch", "sequence ring attention")


def _dryrun(ranks):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "SLIME_PLATFORM")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "slime_tpu_torch.parallel.dryrun",
                           "--ranks", str(ranks), "--backend", "gloo"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    prefix = f"dryrun({ranks}, gloo): "
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(prefix)]
    parts = [p.format(h=ranks // 2, n=ranks) for p in PARTS]
    if ranks % 8 == 0:
        parts.append(f"composed multimodal train step on mesh (data, fsdp, model, pp) = "
                     f"(1,{ranks // 4},2,2)")
    assert len(lines) == len(parts), proc.stdout
    for line, part in zip(lines, parts):
        assert part in line, line


def test_dryrun_four_gloo_ranks():
    _dryrun(4)


def test_dryrun_eight_gloo_ranks():
    """The composed multimodal part runs at 8 ranks (13 s alone)."""
    _dryrun(8)
