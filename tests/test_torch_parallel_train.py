"""Sharded training in the port against the JAX package's single device.

Two gloo worlds run this file's jobs on the same inputs; the JAX side runs
once, in the parent, on one device, at ``SliMEConfig.tiny()`` in fp32:

- one full-parameter step at (1, 2, 1), (1, 1, 2) (world 2) and (2, 1, 2)
  (world 4) equals JAX's ``make_train_step``: the loss and every leaf
  after the update within 1e-5, with clipping active (``max_grad_norm``
  0.05); ``grad_norm`` equals the single-process port's (JAX's logged norm
  also counts the frozen leaves' gradients); frozen leaves (the tower, the
  pinned attention adapter of ``mm_learnable_gated = 0``) are bitwise
  unchanged;
- a LoRA step and a QLoRA step (NF4 base) at (1, 2, 1) and at (1, 1, 2)
  equal JAX's ``make_lora_train_step`` (at (1, 1, 2) each model rank meets
  only its part of every adapter's gradient);
- a tiny Mixtral step (4 experts, top 2, B * S = 64: the sparse dispatch;
  router aux loss 0.02) at (1, 1, 2) equals JAX's ``make_train_step``;
- a full-parameter DPO step at (1, 2, 1) (one pair a rank) equals JAX's
  ``make_dpo_train_step``;
- the trainer with ``gradient_accumulation_steps`` 2 at (1, 2, 1): two
  micro-steps, a train-state save, a new trainer that resumes and takes two
  more equal one sharded trainer's four micro-steps (the generator's state
  is part of the train state: each rank draws its rows' training noise);
  resuming that state on (1, 1, 2) raises.

The selection and gate noise are JAX's own draws (``_jax_noise``, as in
``test_torch_train.py``), split by rows like the batch. The parameters come
from the port's ``init`` as numpy; both worlds run while the JAX steps
compile.
"""
import dataclasses

import numpy as np
import pytest
import torch

from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX, SliMEConfig
from slime_tpu_torch.train import optim as toptim

from .torch_ranks import join, leave

LEAF_TOL = dict(rtol=1e-5, atol=1e-5)
# Adam's eps at 1e-6, as test_torch_lora_train.py's model steps: an entry whose
# gradient is near 0 then moves in proportion to it, not by the fp32 rounding
# of sums that the shards add in another order
TC = dict(learning_rate=1e-3, warmup_ratio=0.0, total_steps=8, lr_schedule="constant",
          max_grad_norm=0.05, mm_learnable_gated=0, adam_eps=1e-6)
B, S = 4, 16


def _cfg(moe=False):
    cfg = dataclasses.replace(SliMEConfig.tiny(), mm_learnable_gated=0, max_local_crops=1)
    if moe:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, num_experts=4, num_experts_per_tok=2, router_aux_loss_coef=0.02))
    return cfg


def _batch(cfg, seed, rows=B):
    r = np.random.default_rng(seed)
    t, MC = cfg.vision.image_size, 1 + cfg.max_local_crops
    ids = r.integers(5, cfg.llm.vocab_size, (rows, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    mask = np.ones((rows, S), bool)
    mask[1, 12:] = False
    labels = np.where((ids == IMAGE_TOKEN_INDEX) | ~mask, IGNORE_INDEX, ids).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "pixel_values": r.standard_normal((rows, MC, 3, t, t)).astype(np.float32),
            "crop_mask": np.ones((rows, MC), bool)}


def _pairs(cfg, seed, n=2):
    r = np.random.default_rng(seed)
    t, MC = cfg.vision.image_size, 1 + cfg.max_local_crops
    ids = r.integers(5, cfg.llm.vocab_size, (2 * n, S)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    ids[n:, :-6] = ids[:n, :-6]
    labels = np.full_like(ids, IGNORE_INDEX)
    labels[:, -6:] = ids[:, -6:]
    return {"input_ids": ids, "labels": labels, "attention_mask": np.ones((2 * n, S), bool),
            "pixel_values": r.standard_normal((n, MC, 3, t, t)).astype(np.float32),
            "crop_mask": np.ones((n, MC), bool)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _step_job(mesh, make, inp, key):
    """One mesh step of a ``case`` entry -> (loss, grad_norm, whole tree)."""
    from slime_tpu_torch.parallel.mesh import shard_batch, unshard_params
    state, step = make(mesh)
    batch = shard_batch(mesh, _t(inp[key]["batch"]))
    noise = shard_batch(mesh, inp[key]["noise"])
    state, m = step(state, batch, noise=noise)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": unshard_params(mesh, state["params"])}


def _worker(argv):
    from slime_tpu_torch.parallel.mesh import make_mesh, shard_params, unshard_params
    from slime_tpu_torch.train import dpo as tdpo
    from slime_tpu_torch.train.step import (init_lora_train_state, init_train_state,
                                            make_lora_train_step, make_train_step)
    from slime_tpu_torch.train.trainer import shard_pairs

    rank, world, where, inp = join(argv)
    cfg, tc = _cfg(), toptim.TrainConfig(**TC)
    fp = bridge.from_jax_numpy(inp["fp"], device="cpu")
    f32 = dict(compute_dtype=torch.float32)

    def full(params, cfg_=cfg):
        def make(mesh):
            state, tx = init_train_state(params, tc, mesh=mesh)
            return state, make_train_step(cfg_, tc, tx, mesh=mesh, **f32)
        return make

    out = {}
    shapes = [(1, 2, 1), (1, 1, 2)] if world == 2 else [(2, 1, 2)]
    for shape in shapes:
        out[("full", shape)] = _step_job(make_mesh(*shape, device="cpu"), full(fp), inp, "full")
    if world == 2:
        for key in ("lora", "qlora"):
            base = bridge.from_jax_numpy(inp[key]["params"], device="cpu")
            lora = bridge.from_jax_numpy(inp[key]["lora"], device="cpu")

            def make(mesh, base=base, lora=lora):
                b, state, tx = init_lora_train_state(base, lora, tc, mesh=mesh)
                step = make_lora_train_step(cfg, tc, tx, rank=4, alpha=8, mesh=mesh, **f32)
                return state, lambda s, bt, noise: step(s, b, bt, noise=noise)
            for shape in ((1, 2, 1), (1, 1, 2)):
                out[(key, shape)] = _step_job(make_mesh(*shape, device="cpu"), make, inp, key)
        moe = bridge.from_jax_numpy(inp["moe"]["params"], device="cpu")
        out["moe"] = _step_job(make_mesh(1, 1, 2, device="cpu"), full(moe, _cfg(moe=True)),
                               inp, "moe")
        # DPO: one pair a rank
        mesh = make_mesh(1, 2, 1, device="cpu")
        dtc = toptim.TrainConfig(learning_rate=1e-3, total_steps=10, lr_schedule="constant",
                                 adam_eps=1e-6)
        state, tx = init_train_state(fp, dtc, mesh=mesh)
        ref = shard_params(mesh, fp)
        step = tdpo.make_dpo_train_step(cfg, dtc, tx, tdpo.DPOConfig(), mesh=mesh, **f32)
        state, m = step(state, ref, _t(shard_pairs(mesh, inp["dpo"]["batch"])))
        out["dpo"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "params": unshard_params(mesh, state["params"])}
        out["accum"] = _accumulation(rank, where, fp, cfg, inp["accum"])
    leave(rank, where, out)


def _accumulation(rank, where, params, cfg, batches):
    """Sharded trainer: 2 micro-steps, save, resume, 2 more; the whole
    result, an uninterrupted sharded run's, and the refused resume."""
    import os

    from slime_tpu_torch.parallel.mesh import make_mesh
    from slime_tpu_torch.train.trainer import RunConfig, Trainer

    tc = toptim.TrainConfig(**{**TC, "gradient_accumulation_steps": 2,
                               "tune_mm_mlp_adapter": True})
    kw = dict(compute_dtype=torch.float32)
    out_dir = os.path.join(where, "accum")
    rc = RunConfig(output_dir=out_dir, save_steps=0, log_steps=1, prefetch_depth=0,
                   handle_preemption=False)
    mesh = make_mesh(1, 2, 1, device="cpu")
    tr = Trainer(params, cfg, tc, rc, mesh=mesh, **kw)
    tr.train(batches[:2])
    tr.save_state(2)
    tr = Trainer(params, cfg, tc, rc, mesh=mesh, **kw)
    resumed_at = tr.state["step"]
    tr.train(batches[2:])
    got = tr.params_host()
    straight = Trainer(params, cfg, tc, dataclasses.replace(
        rc, output_dir=os.path.join(where, "straight")), mesh=mesh, **kw)
    straight.train(batches)
    refused = None
    try:
        Trainer(params, cfg, tc, rc, mesh=make_mesh(1, 1, 2, device="cpu"), **kw)
    except ValueError as e:
        refused = str(e)
    return {"got": got, "want": straight.params_host(), "resumed_at": resumed_at,
            "refused": refused}


# ---------------------------------------------------------------------------
# The JAX side and the checks
# ---------------------------------------------------------------------------

def _jax_noise(rng, cfg, rows):
    import jax
    M = cfg.max_local_crops * cfg.mm_resampler_dim
    sel = [np.asarray(jax.random.normal(r, (M,))) for r in jax.random.split(rng, rows)]
    gate = np.asarray(jax.random.normal(rng, (rows, cfg.vision.num_patches, 2)))
    return {"gate": torch.from_numpy(np.array(gate)), "select": torch.from_numpy(np.stack(sel))}


@pytest.fixture(scope="module")
def case(request, tmp_path_factory):
    """-> (inputs, JAX's results, the running worlds). The parameters come
    from the port's ``init`` (JAX's key set and shapes, numpy leaves), so
    both worlds start before the JAX steps compile and run beside them."""
    import functools

    import jax
    import jax.numpy as jnp

    import slime_tpu.ops.encoder_attention as jea
    from slime_tpu.config import SliMEConfig as JCfg
    from slime_tpu.train import dpo as jdpo
    from slime_tpu.train import optim as joptim
    from slime_tpu.train import step as jstep
    from slime_tpu_torch.models import slime as tslime
    from slime_tpu_torch.ops.quantization import quantize_params
    from slime_tpu_torch.train import lora as tlora
    from slime_tpu_torch.train.step import init_train_state, make_train_step

    from .torch_ranks import start_ranks

    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jtc = joptim.TrainConfig(**TC)
    cfg = dataclasses.replace(JCfg.tiny(), mm_learnable_gated=0, max_local_crops=1)
    moe_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_experts=4, num_experts_per_tok=2, router_aux_loss_coef=0.02))
    tcfg = _cfg()
    init = lambda c, seed: tslime.init(  # noqa: E731
        c, generator=torch.Generator().manual_seed(seed), device="cpu")
    tfp = init(tcfg, 0)
    fp = bridge.to_jax_numpy(tfp)
    lora = bridge.to_jax_numpy(tlora.init_lora(
        tfp, generator=torch.Generator().manual_seed(1), r=4, alpha=8))
    lora["adapters"] = {k: {"A": v["A"], "B": np.full_like(v["B"], 0.01)}
                        for k, v in lora["adapters"].items()}
    nf4 = dict(fp, llm=dict(fp["llm"], layers=bridge.to_jax_numpy(
        quantize_params(tfp["llm"]["layers"], bits=4, min_size=4096))))
    assert "nf4" in nf4["llm"]["layers"][0]["q_proj"]["weight"]
    moe = bridge.to_jax_numpy(init(_cfg(moe=True), 4))
    rng = jax.random.PRNGKey(7)
    noise = _jax_noise(rng, tcfg, B)         # JAX's step draws the same from rng
    batches = {"full": _batch(tcfg, 1), "lora": _batch(tcfg, 2), "qlora": _batch(tcfg, 3),
               "moe": _batch(tcfg, 4)}
    inputs = {"fp": fp, "full": {"batch": batches["full"], "noise": noise},
              "lora": {"params": fp, "lora": lora, "batch": batches["lora"], "noise": noise},
              "qlora": {"params": nf4, "lora": lora, "batch": batches["qlora"],
                        "noise": noise},
              "moe": {"params": moe, "batch": batches["moe"], "noise": noise},
              "dpo": {"batch": _pairs(tcfg, 5)},
              "accum": [_batch(tcfg, 20 + i) for i in range(4)]}
    worlds = {w: start_ranks("test_torch_parallel_train", w, inputs,
                             tmp_path_factory.mktemp(f"world{w}")) for w in (2, 4)}
    request.addfinalizer(lambda: [ranks.kill() for ranks in worlds.values()])
    want = {}

    def one_step(state, step, batch):
        state, m = step(state, J(batch), rng)
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": jax.device_get(state["params"])}

    saved = jea.encoder_attention
    jea.encoder_attention = functools.partial(saved, interpret=True)
    try:
        # full parameter; the logged norm against the one-process port's
        state, tx = jstep.init_train_state(J(fp), jtc)
        want["full"] = one_step(state, jstep.make_train_step(cfg, jtc, tx,
                                                             compute_dtype=jnp.float32),
                                batches["full"])
        tc = toptim.TrainConfig(**TC)
        tstate, ttx = init_train_state(bridge.from_jax_numpy(fp, device="cpu"), tc)
        _, tm = make_train_step(tcfg, tc, ttx, compute_dtype=torch.float32)(
            tstate, _t(batches["full"]), noise=noise)
        want["full"]["port_norm"] = float(tm["grad_norm"])
        want["full"]["labels"] = dict(bridge.named_leaves(toptim.label_tree(fp, tc)))

        # LoRA and QLoRA (NF4 base)
        for key, base in (("lora", fp), ("qlora", nf4)):
            jbase, state, tx = jstep.init_lora_train_state(J(base), J(lora), jtc)
            step = jstep.make_lora_train_step(cfg, jtc, tx, rank=4, alpha=8,
                                              compute_dtype=jnp.float32)
            state, m = step(state, jbase, J(batches[key]), rng)
            want[key] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                         "params": jax.device_get(state["params"])}

        # Mixtral, sparse dispatch, router aux loss
        state, tx = jstep.init_train_state(J(moe), jtc)
        want["moe"] = one_step(state, jstep.make_train_step(moe_cfg, jtc, tx,
                                                            compute_dtype=jnp.float32),
                               batches["moe"])

        # DPO
        dtc = joptim.TrainConfig(learning_rate=1e-3, total_steps=10, lr_schedule="constant",
                                 adam_eps=1e-6)
        state, tx = jstep.init_train_state(J(fp), dtc)
        fn = jdpo.make_dpo_train_step(cfg, dtc, tx, jdpo.DPOConfig(), compute_dtype=jnp.float32)
        state, m = fn(state, J(fp), J(inputs["dpo"]["batch"]), jax.random.PRNGKey(0))
        want["dpo"] = {"loss": float(m["loss"]), "params": jax.device_get(state["params"])}
    finally:
        jea.encoder_attention = saved
    return inputs, want, worlds


def _same_tree(got, want, what):
    want = dict(bridge.named_leaves(want))
    n = 0
    for path, leaf in bridge.named_leaves(got):
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], **LEAF_TOL,
                                   err_msg=f"{what} {path}")
        n += 1
    assert n == len(want)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_steps_match_jax(case, world):
    inputs, want, worlds = case
    outs = worlds[world].wait()
    fp = dict(bridge.named_leaves(inputs["fp"]))
    w = want["full"]
    for r, o in enumerate(outs):
        for key in [k for k in o if isinstance(k, tuple) and k[0] == "full"]:
            got = o[key]
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5, err_msg=str(key))
            np.testing.assert_allclose(got["grad_norm"], w["port_norm"], rtol=1e-5)
            assert got["grad_norm"] > TC["max_grad_norm"]          # the step clipped
            _same_tree(got["params"], w["params"], str(key))
            for path, leaf in bridge.named_leaves(got["params"]):
                if w["labels"][path] == "frozen":
                    assert np.array_equal(leaf.numpy(), fp[path]), (key, path)
        if world == 4:
            continue
        for key in [("lora", (1, 2, 1)), ("lora", (1, 1, 2)), ("qlora", (1, 2, 1)),
                    ("qlora", (1, 1, 2)), "moe"]:
            name = key if key == "moe" else key[0]
            np.testing.assert_allclose(o[key]["loss"], want[name]["loss"], rtol=1e-5,
                                       err_msg=str(key))
            if key != "moe":      # JAX's moe norm also counts the frozen tower
                np.testing.assert_allclose(o[key]["grad_norm"], want[name]["grad_norm"],
                                           rtol=1e-5, err_msg=str(key))
            _same_tree(o[key]["params"], want[name]["params"], str(key))
        np.testing.assert_allclose(o["dpo"]["loss"], want["dpo"]["loss"], rtol=1e-5)
        _same_tree(o["dpo"]["params"], want["dpo"]["params"], "dpo")
        acc = o["accum"]
        assert acc["resumed_at"] == 2
        assert acc["refused"] is not None and "mesh" in acc["refused"]
        _same_tree(acc["got"], {p: t.numpy() for p, t in bridge.named_leaves(acc["want"])},
                   "accumulation")
