"""LoRA / QLoRA training, gradient accumulation and exact resume in the port,
against the JAX package at small widths in fp32 (mirrors
``tests/test_lora_train.py`` and
``tests/test_trainer.py::test_resume_from_state_checkpoint``).

- LoRA and QLoRA (int8 and NF4 base) steps through
  ``init_lora_train_state`` / ``make_lora_train_step`` from the carried
  params and adapters: the losses, the adapters and the extras after 2
  steps equal JAX's, and the base is untouched; the training noise is JAX's
  own draws, fed to the port's ``noise``;
- accumulation: ``optim.MultiSteps`` against ``optax.MultiSteps`` over 4
  micro-steps of random gradients (parameters unchanged on the mid steps,
  the schedule counting inner updates, the clipping of the mean), and a
  LoRA step with ``gradient_accumulation_steps=2`` over 4 batches;
- resume: LoRA and full-parameter ``Trainer`` runs interrupted by a
  train-state checkpoint in the middle of an accumulation window, resumed
  in a new trainer, equal the uninterrupted run (training noise from the
  generator included: its state is in the checkpoint); the asynchronous
  save and ``load_meta``;
- ``check_grad_accum_fit`` refuses what JAX's refuses, with an explicit
  budget.

Tolerance against JAX: losses 1e-4 relative; trained leaves 1e-4 relative
with an absolute floor of 5e-3 of the largest distance Adam can move a leaf
(lr per inner update). Adam's step has the size lr whatever the gradient's,
so an entry whose gradient is near zero carries the gradient's fp32
rounding (sums in another order, ~1e-5 of the leaf's largest gradient)
relative to itself into its step: with optax's eps of 1e-8, single entries
of the sampler moved 7% of a step apart. The model steps here run Adam with
eps = 1e-6 (both packages), so such an entry moves in proportion to its
gradient. The optimizer alone, on the same gradients, 1e-5 relative (1e-6
absolute), at the default eps.
Resumed runs equal uninterrupted ones exactly.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import slime_tpu.ops.encoder_attention as jea
from slime_tpu.config import SliMEConfig
from slime_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_tpu.models import slime as jslime
from slime_tpu.ops.quantization import quantize_params as jquantize
from slime_tpu.parallel import memory_plan as jmp
from slime_tpu.train import lora as jlora
from slime_tpu.train import optim as joptim
from slime_tpu.train import step as jstep
from slime_tpu_torch import params as bridge
from slime_tpu_torch.parallel import memory_plan as tmp_
from slime_tpu_torch.train import optim as toptim
from slime_tpu_torch.train import state_ckpt
from slime_tpu_torch.train import step as tstep
from slime_tpu_torch.train.trainer import RunConfig, Trainer

from .test_torch_train import _jax_noise

RTOL = 1e-4
ADAM_FLOOR = 5e-3


@pytest.fixture(scope="module")
def tiny():
    cfg = SliMEConfig.tiny()
    return cfg, jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))


@pytest.fixture
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


def _batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    t, MC = cfg.vision.image_size, 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    return {"input_ids": ids, "attention_mask": np.ones((B, S), bool),
            "pixel_values": rng.standard_normal((B, MC, 3, t, t)).astype(np.float32),
            "crop_mask": np.ones((B, MC), bool),
            "labels": np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids).astype(np.int32)}


def _qparams(params, bits):
    if bits is None:
        return params
    q = dict(params)
    q["llm"] = dict(params["llm"])
    q["llm"]["layers"] = jax.device_get(jquantize(params["llm"]["layers"], bits, min_size=0))
    return q


def _lora_state(params):
    st = jax.device_get(jlora.init_lora(jax.random.PRNGKey(1), params, r=4, alpha=8))
    r = np.random.default_rng(2)
    for p in sorted(st["adapters"]):      # a live adapter from the first step
        st["adapters"][p]["B"] = (r.standard_normal(st["adapters"][p]["B"].shape)
                                  * 0.05).astype(np.float32)
    return st


def _leaf_dict(tree):
    return dict(bridge.named_leaves(tree))


def _tc(**kw):
    return toptim.TrainConfig(**{**dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0,
                                        lr_schedule="constant", adam_eps=1e-6), **kw})


def _run_both(cfg, params, st, tc, batches):
    jtc = joptim.TrainConfig(**dataclasses.asdict(tc))
    base, state, tx = jstep.init_lora_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, st),
        jtc)
    jfn = jstep.make_lora_train_step(cfg, jtc, tx, rank=4, alpha=8, compute_dtype=jnp.float32)
    tp = bridge.from_jax_numpy(params, device="cpu")
    tbase, tstate, ttx = tstep.init_lora_train_state(
        tp, bridge.from_jax_numpy(st, device="cpu"), tc)
    tfn = tstep.make_lora_train_step(cfg, tc, ttx, rank=4, alpha=8,
                                     compute_dtype=torch.float32)
    for i, b in enumerate(batches):
        key = jax.random.PRNGKey(i)
        state, jm = jfn(state, base, jax.tree_util.tree_map(jnp.asarray, b), key)
        tstate, tm = tfn(tstate, tbase, {k: torch.from_numpy(v) for k, v in b.items()},
                         noise=_jax_noise(key, cfg, b["input_ids"].shape[0]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL,
                                   err_msg=f"step {i}")
    want = _leaf_dict(jax.device_get(state["params"]))
    got = _leaf_dict(tstate["params"])
    assert set(got) == set(want)
    updates = len(batches) // tc.gradient_accumulation_steps
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], rtol=RTOL,
                                   atol=ADAM_FLOOR * tc.learning_rate * updates, err_msg=path)
    return tp, tbase, tstate


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_lora_steps_match_jax(tiny, jax_kernel_attention, bits):
    cfg, params = tiny
    qp = _qparams(params, bits)
    st = _lora_state(qp)
    tp, tbase, tstate = _run_both(cfg, qp, st, _tc(), [_batch(cfg, seed=s) for s in (0, 1)])
    moved = [p for p, leaf in _leaf_dict(tstate["params"]).items()
             if not np.array_equal(leaf.detach().numpy(), _leaf_dict(
                 {"adapters": st["adapters"], "extras": {k: qp[k] for k in
                                                         ("projector", "sampler")}})[p])]
    assert any(p.startswith("adapters/") for p in moved)
    assert any(p.startswith("extras/projector") for p in moved)
    for path, leaf in bridge.named_leaves(tbase):
        assert not leaf.requires_grad and leaf.grad is None, path
        np.testing.assert_array_equal(bridge.to_jax_numpy(leaf), _leaf_dict(qp)[path])


def test_lora_accumulation_matches_jax(tiny, jax_kernel_attention):
    cfg, params = tiny
    _run_both(cfg, params, _lora_state(params), _tc(gradient_accumulation_steps=2),
              [_batch(cfg, seed=s) for s in range(4)])


def _opt_params(seed):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)   # noqa: E731
    return {"adapters": {"llm/layers/0/q_proj": {"A": f(2, 5), "B": f(4, 2)}},
            "extras": {"projector": {"w": f(3, 4), "norm": {"weight": f(4)}}}}


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_multisteps_matches_optax(schedule):
    """optim.MultiSteps over make_lora_optimizer's groups against
    optax.MultiSteps(every_k_schedule=2) over JAX's: 6 micro-steps, the
    extras' gradients large enough to clip."""
    tc = toptim.TrainConfig(learning_rate=3e-2, mm_projector_lr=5e-2, weight_decay=0.1,
                            total_steps=4, warmup_ratio=0.25, max_grad_norm=1.0,
                            lr_schedule=schedule, gradient_accumulation_steps=2)
    jtc = joptim.TrainConfig(**dataclasses.asdict(tc))
    p = _opt_params(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tx, jlabels = joptim.make_lora_optimizer(jp, jtc)
    opt_state = tx.init(jp)
    tp = bridge.map_leaves(lambda _, t: t.clone().requires_grad_(True),
                           bridge.from_jax_numpy(p, device="cpu"))
    ttx, tlabels = toptim.make_lora_optimizer(tp, tc)
    assert isinstance(ttx, toptim.MultiSteps) and tlabels == jlabels
    r = np.random.default_rng(1)
    for step in range(6):
        grads = jax.tree_util.tree_map(lambda x: r.standard_normal(x.shape).astype(np.float32),
                                       p)
        grads["extras"] = jax.tree_util.tree_map(lambda g: g * 5.0, grads["extras"])
        flat = _leaf_dict(grads)
        before = {k: v.detach().clone() for k, v in _leaf_dict(tp).items()}
        for path, leaf in bridge.named_leaves(tp):
            leaf.grad = torch.from_numpy(flat[path].copy())
        gnorm = ttx.step()
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(grads)), rtol=1e-6)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        want = _leaf_dict(jax.device_get(jp))
        assert ttx.mini_step == int(opt_state.mini_step)
        assert ttx.gradient_step == int(opt_state.gradient_step)
        for path, leaf in bridge.named_leaves(tp):
            if step % 2 == 0:
                assert torch.equal(leaf.detach(), before[path]), (step, path)
            np.testing.assert_allclose(leaf.detach().numpy(), want[path], rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {step} {path}")


def _train(cfg, params, tc, rc, batches, lora=None):
    tr = Trainer(params, cfg, tc, rc, compute_dtype=torch.float32, lora=lora,
                 generator=torch.Generator().manual_seed(rc.seed))
    tr.train(batches)
    return tr


@pytest.mark.parametrize("mode", ["lora", "full"])
def test_resume_equals_uninterrupted(tiny, tmp_path, mode):
    """5 micro-steps with accumulation 2, uninterrupted, against 3 steps
    (saved at step 3, in the middle of a window) and a new trainer that
    resumes from state-3 and takes steps 4-5. The training noise (gate and
    selection) is drawn from the trainer's generator."""
    cfg, params = tiny
    tp = bridge.from_jax_numpy(params, device="cpu")
    lora = (bridge.from_jax_numpy(_lora_state(params), device="cpu") if mode == "lora"
            else None)
    tc = _tc(gradient_accumulation_steps=2, total_steps=6)
    batches = [_batch(cfg, seed=s) for s in range(5)]

    def rc(name, **kw):
        return RunConfig(output_dir=str(tmp_path / name), log_steps=1, prefetch_depth=0,
                         handle_preemption=False, **kw)
    whole = _train(cfg, tp, tc, rc("whole", save_steps=0, max_steps=5), batches, lora)
    first = _train(cfg, tp, tc, rc("cut", save_steps=3, max_steps=3), batches[:3], lora)
    assert first.state["step"] == 3 and state_ckpt.load_meta(
        str(tmp_path / "cut" / "state-3")) == {"step": 3}
    resumed = Trainer(tp, cfg, tc, rc("cut", save_steps=0, max_steps=5),
                      compute_dtype=torch.float32, lora=lora,
                      generator=torch.Generator().manual_seed(123))
    assert resumed.state["step"] == 3 and resumed.tx.mini_step == 1
    resumed.train(batches[3:])
    assert resumed.state["step"] == 5
    for (path, a), (_, b) in zip(bridge.named_leaves(whole.params),
                                 bridge.named_leaves(resumed.params)):
        assert torch.equal(a, b), path
    assert torch.equal(whole.generator.get_state(), resumed.generator.get_state())
    recs = lambda n: [json.loads(x) for x in (tmp_path / n / "metrics.jsonl")  # noqa: E731
                      .read_text().splitlines()]
    assert [r["loss"] for r in recs("whole")] == [r["loss"] for r in recs("cut")]


def test_async_save_roundtrip(tmp_path):
    state = {"step": 3, "params": {"w": torch.ones((4, 4))}, "g": torch.Generator()}
    p = str(tmp_path / "state-3")
    state_ckpt.save_train_state(p, state, extra={"step": 3}, async_save=True)
    state_ckpt.wait_for_saves()
    target = {"step": 0, "params": {"w": torch.zeros((4, 4))}, "g": torch.Generator()}
    back = state_ckpt.restore_train_state(p, target=target)
    assert back["step"] == 3 and float(target["params"]["w"].sum()) == 16.0
    assert state_ckpt.load_meta(p) == {"step": 3}
    assert state_ckpt.latest_checkpoint(str(tmp_path)) == p


@pytest.mark.parametrize("steps,hbm,used", [(1, 10, 10), (2, None, None), (2, 10 ** 9, 0),
                                            (4, 2 * 10 ** 5, 10 ** 4), (4, 10 ** 5, 5 * 10 ** 4),
                                            (8, 10 ** 6, 8 * 10 ** 5)])
def test_grad_accum_fit_refuses_what_jax_refuses(steps, hbm, used):
    tree = {"a": np.zeros((100, 100), np.float32), "b": np.zeros((7,), np.float32),
            "c": {"d": np.zeros((3, 5, 2), np.float32)}}
    kw = dict(hbm_bytes=hbm, used_bytes=used)
    try:
        want = jmp.check_grad_accum_fit(tree, steps, **kw)
    except ValueError:
        with pytest.raises(ValueError, match="accumulator"):
            tmp_.check_grad_accum_fit(bridge.from_jax_numpy(tree, device="cpu"), steps, **kw)
    else:
        assert tmp_.check_grad_accum_fit(bridge.from_jax_numpy(tree, device="cpu"), steps,
                                         **kw) == want
    assert tmp_.grad_accum_bytes(bridge.from_jax_numpy(tree, device="cpu"), 2) == \
        jmp.grad_accum_bytes(tree, 2)


def test_trainer_lora_mode_saves_and_merges(tiny, tmp_path):
    """Trainer(lora=...): the loss falls over 6 steps, the save writes the
    reference's LoRA layout, and params_host is the merged tree."""
    from slime_tpu_torch.train import lora as tlora
    cfg, params = tiny
    tp = bridge.from_jax_numpy(params, device="cpu")
    lora = tlora.init_lora(tp, generator=torch.Generator().manual_seed(1), r=4, alpha=8)
    tr = _train(cfg, tp, _tc(total_steps=6), RunConfig(output_dir=str(tmp_path), save_steps=0,
                                                       log_steps=2, max_steps=6),
                [_batch(cfg) for _ in range(6)], lora)
    recs = [json.loads(x) for x in open(tr.metrics_file)]
    assert recs[-1]["loss"] < recs[0]["loss"], recs
    tr.save(str(tmp_path / "save"))
    for f in ("adapter_model.bin", "adapter_config.json", "non_lora_trainables.bin",
              "config.json"):
        assert (tmp_path / "save" / f).exists(), f
    merged = tr.params_host()
    trained = tr.state["params"]
    want = tlora.merge({**tp, **trained["extras"]},
                       {"rank": 4, "alpha": 8, "adapters": trained["adapters"]})
    for (path, a), (_, b) in zip(bridge.named_leaves(merged), bridge.named_leaves(want)):
        assert torch.equal(a, b.detach()), path
    assert not torch.equal(merged["llm"]["layers"][0]["q_proj"]["weight"],
                           tp["llm"]["layers"][0]["q_proj"]["weight"])
