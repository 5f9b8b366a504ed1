"""A multi-process dry run of the port's parallelism on tiny shapes.

Port of ``dryrun_multichip`` (``__graft_entry__.py:85-226``): N ranks, one
process each, run

- one full-parameter train step on the ``(1, N/2, 2)`` mesh (``(1, N, 1)``
  for odd N), its loss held to the single-process step's;
- a tensor-parallel ``generate(mesh=...)`` on ``(1, 1, N)``, its tokens held
  to the single-process ones;
- the pipeline's wavefront (``parallel.pipeline.pipeline_forward``) over N
  stages of an N-layer LLM at n_micro = N, held to the unsharded
  ``llama.forward``;
- the expert-parallel dispatch ``ops.moe_ep.moe_ffn_ep`` over the model
  axis, held to the dense oracle;
- the sequence ring ``ops.ring_attention`` over a process group, held to the
  plain attention;
- when 8 divides N, the composed multimodal train step
  (``parallel.composed``) of ``SliMEConfig.tiny()`` on the (data, fsdp,
  model, pp) = (1, N/4, 2, 2) mesh, 8 rows, n_micro = 4: its loss finite;

and rank 0 prints one line per part. Run it with gloo on the CPU:

    python -m slime_tpu_torch.parallel.dryrun --ranks 4 --backend gloo
    python -m slime_tpu_torch.parallel.dryrun --ranks 8 --backend gloo

or with NCCL, one rank per card (``--ranks`` at most the card count). It
starts the ranks itself (``torch.multiprocessing``), on a free localhost
port, and exits non-zero if any rank fails.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(cfg, B: int, S: int, rng):
    from ..config import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    MC, t = 1 + cfg.max_local_crops, cfg.vision.image_size
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int64)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    return {"input_ids": ids, "attention_mask": np.ones((B, S), bool),
            "pixel_values": rng.standard_normal((B, MC, 3, t, t)).astype(np.float32),
            "crop_mask": np.ones((B, MC), bool),
            "labels": np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids)}


def _train_part(dev, n: int, say):
    from ..config import SliMEConfig
    from ..models import slime
    from ..train.optim import TrainConfig
    from ..train.step import init_train_state, make_train_step
    from .mesh import make_mesh, shard_batch

    n_model = 2 if n % 2 == 0 else 1
    cfg = SliMEConfig.tiny()
    tc = TrainConfig(total_steps=4, learning_rate=1e-4, mm_projector_lr=1e-3)
    params = slime.init(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in _batch(cfg, n, 16, np.random.default_rng(0)).items()}
    noise = {"gate": torch.zeros((n, cfg.vision.num_patches, 2), device=dev),
             "select": torch.zeros((n, cfg.max_local_crops * cfg.mm_resampler_dim),
                                   device=dev)}
    state, tx = init_train_state(params, tc)
    _, want = make_train_step(cfg, tc, tx, compute_dtype=torch.float32)(
        state, batch, noise=noise)
    mesh = make_mesh(1, n // n_model, n_model, device=dev)
    state, tx = init_train_state(params, tc, mesh=mesh)
    step = make_train_step(cfg, tc, tx, compute_dtype=torch.float32, mesh=mesh)
    _, got = step(state, shard_batch(mesh, batch), noise=shard_batch(mesh, noise))
    loss, ref = float(got["loss"]), float(want["loss"])
    assert np.isfinite(loss) and abs(loss - ref) < 1e-4 * max(1.0, abs(ref)), (loss, ref)
    say(f"train step on mesh (1,{n // n_model},{n_model}): loss={loss:.6f} "
        f"(one process {ref:.6f}) grad_norm={float(got['grad_norm']):.6f}")


def _decode_part(dev, n: int, say):
    from ..config import SliMEConfig
    from ..generate import generate
    from ..models import slime
    from .mesh import make_mesh

    cfg = SliMEConfig.tiny()
    params = slime.init(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    ids = torch.from_numpy(np.random.default_rng(1).integers(5, cfg.llm.vocab_size, (1, 9))
                           ).to(dev)
    mask = torch.ones_like(ids, dtype=torch.bool)
    want = generate(params, cfg, ids, mask, max_new_tokens=4, eos_id=-1)
    got = generate(params, cfg, ids, mask, max_new_tokens=4, eos_id=-1,
                   mesh=make_mesh(1, 1, n, device=dev))
    assert torch.equal(got, want), (got, want)
    say(f"tensor-parallel decode on mesh (1,1,{n}): tokens {got[0].tolist()} "
        f"equal the one-process tokens")


def _pp_part(dev, n: int, say):
    from ..config import LLMConfig
    from ..models import llama
    from .mesh import make_mesh
    from .pipeline import pipeline_forward

    cfg = LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=n,
                    num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=64)
    params = llama.init(cfg, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (n, 8))).to(dev)
    with torch.no_grad():
        embeds = llama.embed(params, ids)
        want, _ = llama.forward(params, embeds, cfg)
        got = pipeline_forward(params, embeds, cfg, mesh=make_mesh(1, 1, 1, device=dev, n_pp=n),
                               n_micro=n)
    err = float((got - want).abs().max())
    assert err < 1e-5, err
    say(f"pp wavefront over {n} stages (n_micro {n}): max |err| vs llama.forward {err:.2e}")


def _composed_part(dev, n: int, say):
    from ..config import SliMEConfig
    from ..models import slime
    from ..train.optim import adamw
    from .composed import (composed_batch, init_composed_mm_train_state, make_composed_mesh,
                           make_composed_mm_train_step)

    cfg = SliMEConfig.tiny()
    params = slime.init(cfg, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    mesh = make_composed_mesh(1, n // 4, 2, 2, device=dev)
    state = init_composed_mm_train_state(params, adamw(1e-3), mesh=mesh)
    step = make_composed_mm_train_step(cfg, mesh=mesh, n_micro=4, compute_dtype=torch.float32)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in _batch(cfg, 8, 16, np.random.default_rng(3)).items()}
    state, m = step(state, composed_batch(mesh, batch),
                    generator=torch.Generator(device=dev).manual_seed(9 + dist.get_rank()))
    loss = float(m["loss"])
    assert np.isfinite(loss), loss
    say(f"composed multimodal train step on mesh (data, fsdp, model, pp) = "
        f"(1,{n // 4},2,2): loss={loss:.6f} grad_norm={float(m['grad_norm']):.6f}")


def _moe_part(dev, n: int, say):
    from ..ops.moe_ep import moe_ffn_ep
    from .mesh import make_mesh

    mesh = make_mesh(1, 1, n, device=dev)
    E, H, I, T = 2 * n, 16, 32, 8 * n
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.standard_normal((T, H)).astype(np.float32)).to(dev)
    w1, w2, w3 = (torch.from_numpy(r.standard_normal(s).astype(np.float32) * 0.1).to(dev)
                  for s in ((E, I, H), (E, H, I), (E, I, H)))
    topi = torch.from_numpy(r.integers(0, E, (T, 2))).to(dev)
    topw = torch.from_numpy(r.random((T, 2)).astype(np.float32)).to(dev)
    m, El, Tl = mesh.coords["model"], E // n, T // n
    rows, ex = slice(m * Tl, (m + 1) * Tl), slice(m * El, (m + 1) * El)
    out = moe_ffn_ep(x[rows], w1[ex], w2[ex], w3[ex], topi[rows], topw[rows],
                     mesh=mesh, capacity_factor=4.0)
    h = torch.einsum("th,eih->tei", x, w1)
    dense = torch.einsum("tei,ehi->teh", torch.nn.functional.silu(h)
                         * torch.einsum("th,eih->tei", x, w3), w2)
    wfull = torch.zeros((T, E), device=dev).scatter_add(1, topi, topw)
    want = torch.einsum("teh,te->th", dense, wfull)[rows]
    err = float((out - want).abs().max())
    assert err < 1e-4, err
    say(f"expert-parallel dispatch over {n} ranks (E={E}): max |err| vs dense {err:.2e}")


def _ring_part(dev, n: int, say):
    from ..ops.flash_attention import reference_attention
    from ..ops.ring_attention import ring_attention

    r = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 2, 4 * n, 16)).astype(np.float32)
                                ).to(dev) for _ in range(3))
    rank = dist.get_rank()
    part = slice(rank * 4, (rank + 1) * 4)
    out = ring_attention(q[:, :, part], k[:, :, part], v[:, :, part],
                         ring=dist.group.WORLD, causal=True)
    err = float((out - reference_attention(q, k, v, causal=True)[:, :, part]).abs().max())
    assert err < 1e-5, err
    say(f"sequence ring attention over {n} ranks: max |err| vs plain {err:.2e}")


def _rank(rank: int, n: int, backend: str, address: str) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=address, world_size=n, rank=rank)
    say = (lambda s: print(f"dryrun({n}, {backend}): {s}", flush=True)) if rank == 0 \
        else (lambda s: None)
    try:
        parts = [_train_part, _decode_part, _pp_part, _moe_part, _ring_part]
        if n % 8 == 0:
            parts.append(_composed_part)
        for part in parts:
            part(dev, n, say)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    args = ap.parse_args(argv)
    if args.backend == "nccl" and torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"--ranks {args.ranks} over NCCL needs as many cards; this "
                         f"machine has {torch.cuda.device_count()}")
    import torch.multiprocessing as mp
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    address = f"tcp://localhost:{_free_port()}"
    ctx = mp.start_processes(_rank, args=(args.ranks, args.backend, address),
                             nprocs=args.ranks, join=False, start_method="spawn")
    try:
        while not ctx.join():
            pass
    except Exception as e:  # noqa: BLE001 — a failed rank: report and exit non-zero
        print(f"dryrun failed: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
