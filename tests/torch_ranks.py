"""Run a test module's ``_worker`` as N ranks, one process each.

The parent saves the inputs to ``inputs.pt`` in a temporary directory and
starts the ranks (``python -c`` importing ``tests.<module>._worker`` with
argv ``[rank, world, address, directory, *args]``; the module must import
jax only inside its test functions and fixtures, since every rank imports
it). Each rank joins the group on a free localhost port (``join``: gloo),
runs, and saves its outputs to ``rank{r}.pt`` (``leave``). Past the timeout
every rank is killed and the test fails, so a hang cannot hold up the suite.

``start_ranks`` returns at once, so the parent can compute its reference
while the ranks run; ``run_ranks`` starts and waits.
"""
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 150.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """The running ranks of one world."""

    def __init__(self, module: str, world: int, where, procs):
        self.module, self.world, self.where, self.procs = module, world, where, procs

    def wait(self, timeout: float = RANK_TIMEOUT):
        """The ranks' outputs, by rank; fails if one exits non-zero or the
        world outlasts ``timeout`` seconds."""
        try:
            errs = [p.communicate(timeout=timeout)[1] for p in self.procs]
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.communicate()
            pytest.fail(f"{self.module} (world {self.world}) did not finish in {timeout} s")
        for r, (p, err) in enumerate(zip(self.procs, errs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-4000:]}"
        return [torch.load(os.path.join(self.where, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]

    def kill(self) -> None:
        """End the ranks that still run (a fixture's teardown)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def start_ranks(module: str, world: int, inputs, tmp_path, *, args=(), env=None) -> Ranks:
    """Start ``world`` ranks of ``tests.<module>._worker`` on ``inputs``
    (``args``: extra argv strings after the directory)."""
    torch.save(inputs, os.path.join(tmp_path, "inputs.pt"))
    full_env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "SLIME_PLATFORM")}
    full_env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **(env or {}))
    address = f"tcp://localhost:{free_port()}"
    code = f"import sys; from tests.{module} import _worker; _worker(sys.argv[1:])"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), address,
                               str(tmp_path), *map(str, args)], cwd=REPO, env=full_env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    return Ranks(module, world, str(tmp_path), procs)


def run_ranks(module: str, world: int, inputs, tmp_path, *, args=(), env=None,
              timeout=RANK_TIMEOUT):
    """The outputs of ``world`` ranks of ``tests.<module>._worker`` on
    ``inputs``, by rank."""
    return start_ranks(module, world, inputs, tmp_path, args=args, env=env).wait(timeout)


def join(argv):
    """In a rank: join the gloo group -> (rank, world, directory, inputs)."""
    rank, world, address, where = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=address, world_size=world, rank=rank)
    return rank, world, where, torch.load(os.path.join(where, "inputs.pt"),
                                          weights_only=False)


def leave(rank: int, where: str, out) -> None:
    """In a rank: save its outputs and leave the group."""
    dist.barrier()
    torch.save(out, os.path.join(where, f"rank{rank}.pt"))
    dist.destroy_process_group()
