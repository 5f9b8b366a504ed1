"""``python -m slime_tpu_torch.parallel.dryrun --ranks 4 --backend gloo``: four
CPU ranks run a train step on the (1, 2, 2) mesh, a tensor-parallel decode,
the expert-parallel dispatch and the sequence ring, each held to its
single-process result inside the run; it exits 0 and rank 0 prints one line
for each part."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_four_gloo_ranks():
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "SLIME_PLATFORM")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "slime_tpu_torch.parallel.dryrun",
                           "--ranks", "4", "--backend", "gloo"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun(4, gloo): ")]
    assert len(lines) == 4, proc.stdout
    for line, part in zip(lines, ("train step on mesh (1,2,2)", "tensor-parallel decode",
                                  "expert-parallel dispatch", "sequence ring attention")):
        assert part in line, line
