"""Ring attention (context parallelism) in the port against the JAX package.

Seeded numpy inputs go through both packages on the CPU:

- the collective ring ``ops.ring_attention`` on n virtual ranks against JAX's
  ``ring_attention`` on a ``Mesh`` of n of the 8 virtual CPU devices, fp32 at
  JAX's own tolerance (2e-5 abs, 1e-4 rel), GQA and MHA, causal and not; and
  with bf16 v, where p is rounded to v's dtype before P.V;
- K9's plain version (``ring_attention_rdma`` on CPU tensors runs
  ``ring_attention_rdma_ref`` through the double-buffered protocol) against
  JAX's ``ring_attention_rdma(interpret=True)`` at the shapes of
  ``tests/test_ring_attention_rdma.py``, at 2e-5;
- the process-group form of both over gloo, with world sizes 2 and 4: each
  rank is a separate process that computes its shard; the gathered shards
  equal the virtual-rank result to 1e-6 (the arithmetic is the same);
- ``llama.forward(ring=...)`` against JAX's ``llama.forward(ring=(mesh,
  "sp"))`` and the port's forward without a ring, at JAX's
  ``test_llama_forward_with_ring`` config and tolerance (5e-4 abs, 1e-3 rel);
  with ``remat=True`` over list layers, and over a gloo group of 2.

The multi-process tests start their ranks as subprocesses (``python -c``
importing this module's ``_worker``; they import only torch, numpy and the
port: jax is imported inside the test functions), give them a rendezvous on a
free localhost port, and wait at most ``RANK_TIMEOUT`` seconds: past it every
rank is killed and the test fails, so a hang cannot hold up the suite.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import LLMConfig
from slime_tpu_torch.models import llama as tllama
from slime_tpu_torch.ops import ring_attention as tra
from slime_tpu_torch.ops import ring_attention_rdma as trd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_TOL = dict(atol=2e-5, rtol=1e-4)       # JAX's tests/test_ring_attention.py
RDMA_TOL = dict(atol=2e-5, rtol=2e-5)       # JAX's tests/test_ring_attention_rdma.py
LLAMA_TOL = dict(atol=5e-4, rtol=1e-3)      # JAX's test_llama_forward_with_ring
RANK_TIMEOUT = 120.0
LLAMA_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                num_heads=4, num_kv_heads=2, head_dim=8, rope_theta=10000.0,
                max_position_embeddings=256)


def _qkv(B, H, KVH, S, D, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, S, D)).astype(np.float32),
            r.standard_normal((B, KVH, S, D)).astype(np.float32),
            r.standard_normal((B, KVH, S, D)).astype(np.float32))


def _mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), **tol)


def _np(t):
    return t.detach().to(torch.float32).numpy()


# --------------------------------------------------------------------------
# (1) the collective ring, virtual ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 2, 64, 16), (1, 4, 4, 64, 16)], ids=["gqa", "mha"])
def test_ring_attention_matches_jax(n, causal, shape):
    from slime_tpu.ops.ring_attention import ring_attention as jring
    q, k, v = _qkv(*shape, seed=n + 10 * causal)
    want = jring(q, k, v, mesh=_mesh(n), causal=causal)
    got = tra.ring_attention(*map(torch.from_numpy, (q, k, v)), ring=n, causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(_np(got), want, RING_TOL)


def test_ring_attention_rounds_p_to_v_dtype():
    """q, k fp32 and v bf16: both packages round p to bf16 before P.V and
    sum in fp32. The fp32 scores are summed in another order, so a p that
    lies on a bf16 rounding boundary may round the other way: 8 of 16384
    outputs moved by up to 2e-4 (one bf16 ulp of p times |v|), the mean by
    8e-8. Keeping p in fp32 (K9's arithmetic) moves the mean by 2e-4, so the
    mean bound pins the rounding. All-bf16 inputs agree to one bf16 ulp."""
    import jax.numpy as jnp
    from slime_tpu.ops.ring_attention import ring_attention as jring
    q, k, v = _qkv(2, 8, 2, 64, 16, seed=3)
    mesh = _mesh(4)
    want = np.asarray(jring(q, k, jnp.asarray(v, jnp.bfloat16), mesh=mesh, causal=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = _np(tra.ring_attention(tq, tk, tv.to(torch.bfloat16), ring=4))
    assert np.abs(got - want).mean() < 1e-6 and np.abs(got - want).max() < 1e-3
    p_fp32 = trd.ring_attention_rdma_ref(tq, tk, tv.to(torch.bfloat16).float(), ring=4)
    assert np.abs(_np(p_fp32) - want).mean() > 1e-4

    want = jring(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), mesh=mesh, causal=True)
    got = tra.ring_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), ring=4)
    assert got.dtype == torch.bfloat16
    _close(_np(got), np.asarray(want, np.float32), dict(atol=1e-2, rtol=2 ** -7))


def test_ring_attention_rejects():
    q = torch.zeros((1, 4, 30, 8))
    with pytest.raises(ValueError):                   # 4 ranks do not divide S = 30
        tra.ring_attention(q, q, q, ring=4)
    with pytest.raises(ValueError):                   # KVH = 3 does not divide H = 4
        tra.ring_attention(q, q[:, :3], q[:, :3], ring=2)
    with pytest.raises(TypeError):
        tra.ring_attention(q, q, q, ring=True)


# --------------------------------------------------------------------------
# (2) K9's plain version against JAX's interpret-mode kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", [((1, 4, 2, 32, 16), True), ((1, 4, 2, 32, 16), False),
                                  ((2, 8, 4, 32, 32), True), ((1, 2, 2, 16, 8), True)],
                         ids=["gqa-causal", "gqa-full", "batch2", "mha"])
def test_ring_attention_rdma_matches_jax(case):
    from slime_tpu.ops.ring_attention_rdma import ring_attention_rdma as jrdma
    shape, causal = case
    q, k, v = _qkv(*shape, seed=sum(shape))
    want = jrdma(q, k, v, mesh=_mesh(4), causal=causal, interpret=True)
    before = trd.ring_attention_rdma.launches
    got = trd.ring_attention_rdma(*map(torch.from_numpy, (q, k, v)), ring=4, causal=causal)
    assert trd.ring_attention_rdma.launches == before     # CPU: the plain version
    _close(_np(got), want, RDMA_TOL)
    # the collective ring computes the same function
    _close(_np(tra.ring_attention(*map(torch.from_numpy, (q, k, v)), ring=4,
                                  causal=causal)), want, RDMA_TOL)


# --------------------------------------------------------------------------
# (3) the process-group form over gloo
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(argv):
    """One rank of a process group (run in a subprocess): argv = [job, rank,
    world, address, directory, backend]. Reads ``inputs.pt`` there, writes
    ``rank{r}.pt``. With ``nccl`` rank r works on card r."""
    job, rank, world, address, where, backend = argv
    rank, world = int(rank), int(world)
    import torch.distributed as dist

    from slime_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    dev = torch.device("cpu")
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    distributed.initialize(address, world, rank, backend=backend)
    assert (distributed.process_count(), distributed.process_index()) == (world, rank)
    assert distributed.is_main_process() == (rank == 0)
    data = torch.load(os.path.join(where, "inputs.pt"))
    group = dist.group.WORLD
    out = {}
    if job == "attention":
        q, k, v = (t.chunk(world, dim=2)[rank].to(dev) for t in data["qkv"])
        for causal in (True, False):
            before = trd.ring_attention_rdma.launches
            out[f"ring_{causal}"] = tra.ring_attention(q, k, v, ring=group, causal=causal).cpu()
            out[f"rdma_{causal}"] = trd.ring_attention_rdma(q, k, v, ring=group,
                                                            causal=causal).cpu()
            launched = world if dev.type == "cuda" else 0     # one per step on the card
            assert trd.ring_attention_rdma.launches == before + launched
    else:
        cfg = LLMConfig(**data["cfg"])
        emb = data["embeds"].chunk(world, dim=1)[rank]
        out["logits"], _ = tllama.forward(data["params"], emb, cfg, ring=group)
    distributed.barrier()
    torch.save(out, os.path.join(where, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _run_ranks(job, world, inputs, tmp_path, backend="gloo"):
    """Run ``world`` ranks of ``job`` on ``inputs``; their outputs, by rank.
    Kills every rank and fails past RANK_TIMEOUT."""
    torch.save(inputs, tmp_path / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "SLIME_PLATFORM")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    address = f"tcp://localhost:{_free_port()}"
    code = ("import sys; from tests.test_torch_ring_attention import _worker; "
            "_worker(sys.argv[1:])")
    procs = [subprocess.Popen([sys.executable, "-c", code, job, str(r), str(world), address,
                               str(tmp_path), backend], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        errs = [p.communicate(timeout=RANK_TIMEOUT)[1] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{job} over {backend} (world {world}) did not finish in "
                    f"{RANK_TIMEOUT} s")
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-3000:]}"
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_process_group_matches_virtual_ranks(world, tmp_path):
    q, k, v = map(torch.from_numpy, _qkv(2, 8, 2, 64, 16, seed=world))
    outs = _run_ranks("attention", world, {"qkv": (q, k, v)}, tmp_path)
    for causal in (True, False):
        want = {"ring": tra.ring_attention(q, k, v, ring=world, causal=causal),
                "rdma": trd.ring_attention_rdma(q, k, v, ring=world, causal=causal)}
        for name, w in want.items():
            got = torch.cat([o[f"{name}_{causal}"] for o in outs], dim=2)
            torch.testing.assert_close(got, w, atol=1e-6, rtol=0)


def test_distributed_single_process_is_a_no_op():
    from slime_tpu_torch.parallel import distributed
    distributed.initialize()                         # NUM_PROCESSES unset: nothing to do
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.is_main_process()
    assert distributed.local_batch_slice(8) == slice(0, 8)
    distributed.barrier()


# --------------------------------------------------------------------------
# (4) llama.forward(ring=...)
# --------------------------------------------------------------------------

_LLAMA = {}


def _llama_case():
    """JAX params, embeds and logits without and with the 4-rank ring, once
    per module; and the port's params from the same weights."""
    if not _LLAMA:
        import jax
        from slime_tpu.config import LLMConfig as JLLMConfig
        from slime_tpu.models import llama as jllama
        cfg = JLLMConfig(**LLAMA_KW)
        jp = jllama.init(jax.random.PRNGKey(0), cfg)
        ids = np.random.default_rng(0).integers(0, 64, (2, 64)).astype(np.int32)
        emb = jllama.embed(jp, jax.numpy.asarray(ids))
        plain, _ = jllama.forward(jp, emb, cfg)
        mesh = _mesh(4)
        with mesh:
            ring, _ = jllama.forward(jp, emb, cfg, ring=(mesh, "sp"))
        _LLAMA.update(params=bridge.from_jax_numpy(jax.device_get(jp), device="cpu"),
                      embeds=torch.from_numpy(np.array(emb)), plain=np.asarray(plain),
                      ring=np.asarray(ring))
    return _LLAMA


def test_llama_forward_ring_matches_jax():
    c = _llama_case()
    cfg = LLMConfig(**LLAMA_KW)
    got, _ = tllama.forward(c["params"], c["embeds"], cfg, ring=4)
    plain, _ = tllama.forward(c["params"], c["embeds"], cfg)
    _close(_np(got), c["ring"], LLAMA_TOL)
    _close(_np(got), c["plain"], LLAMA_TOL)
    _close(_np(got), _np(plain), LLAMA_TOL)
    with pytest.raises(ValueError):                  # packed sequences: not with a ring
        tllama.forward(c["params"], c["embeds"], cfg, ring=4,
                       segment_ids=torch.ones((2, 64), dtype=torch.int32))


def test_llama_forward_ring_remat():
    """remat=True over list layers keeps the ring (JAX's non-scan remat path
    drops it, ROADMAP Queue 3); the gradient through the ring equals the one
    through the forward without a ring."""
    c = _llama_case()
    cfg = LLMConfig(**LLAMA_KW)
    assert isinstance(c["params"]["layers"], list)
    grads = []
    for ring in (4, None):
        emb = c["embeds"].clone().requires_grad_()
        out, _ = tllama.forward(c["params"], emb, cfg, ring=ring, remat=True)
        if ring is not None:
            _close(_np(out), c["ring"], LLAMA_TOL)
        out.square().mean().backward()
        grads.append(emb.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-6, rtol=1e-4)


def test_llama_forward_ring_process_group(tmp_path):
    c = _llama_case()
    cfg = LLMConfig(**LLAMA_KW)
    outs = _run_ranks("llama", 2, {"params": c["params"], "embeds": c["embeds"],
                                   "cfg": LLAMA_KW}, tmp_path)
    got = torch.cat([o["logits"] for o in outs], dim=1)
    _close(_np(got), c["ring"], LLAMA_TOL)
    virtual, _ = tllama.forward(c["params"], c["embeds"], cfg, ring=2)
    torch.testing.assert_close(got, virtual, atol=1e-5, rtol=1e-5)
