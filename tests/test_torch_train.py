"""The staged-pretraining path against the JAX package, at small widths in fp32.

- ``slime.loss_fn`` and the gradients of each stage's trainable leaves for
  stages 1, 2 and 3 and for the packed text-only branch, vs JAX's
  ``slime.loss_fn`` under ``jax.value_and_grad``. The global view has 576
  patches (336-px images), so the gated projector's attention adapter runs.
  Stage 3's selection and gate noise are JAX's own draws (from the keys
  ``encode_images`` splits), fed to the port's ``noise`` argument;
- the optimizer over 3 steps vs optax: labels, per-group clipping, the
  schedules, the decay mask, frozen leaves untouched (parameters of about 1
  to 1e-5 relative with a 1e-6 floor: Adam's normalisation divides fp32
  rounding by the gradient's own size);
- the slice: stages 1 and 2 through the port's ``Trainer`` vs JAX's
  ``make_train_step``, 2 steps each, from the same params and batches.

JAX's ViT attention runs its Pallas kernel in interpret mode, the semantics
the port's kernel and plain version keep. Tolerance 1e-4 relative for
losses, gradients and trained leaves (fp32 sums in another order through
two stages of model and optimizer).
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
from slime_tpu.config import LLMConfig, SliMEConfig, VisionConfig
from slime_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_tpu.models import slime as jslime
from slime_tpu.train import optim as joptim
from slime_tpu.train import step as jstep
from slime_tpu_torch import params as bridge
from slime_tpu_torch.models import slime as tslime
from slime_tpu_torch.ops import flash_attention as tfa
from slime_tpu_torch.train import optim as toptim
from slime_tpu_torch.train import step as tstep
from slime_tpu_torch.train.trainer import RunConfig, Trainer, run_stage

B, S_TEXT, CROPS = 2, 24, 2
RTOL, ATOL = 1e-4, 1e-6


def _cfg():
    return SliMEConfig(
        llm=LLMConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                      max_position_embeddings=1024),
        vision=VisionConfig(image_size=336, patch_size=14, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2),
        mm_resampler_dim=4, seperator=7, tokenizer_model_max_length=640,
        bos_token_id=1, eos_token_id=2, max_local_crops=CROPS)


STAGES = {
    1: (dict(use_global_only=True, mm_learnable_gated=0),
        dict(tune_mm_mlp_adapter=True, mm_learnable_gated=0)),
    2: (dict(use_global_only=True, mm_learnable_gated=1),
        dict(tune_mm_mlp_adapter=True, mm_learnable_gated=1)),
    3: (dict(use_local_only=True), dict(tune_mm_mlp_adapter=True)),
}


def _stage(cfg, n, **tc_kw):
    cfg_kw, tc_base = STAGES[n]
    tc = toptim.TrainConfig(total_steps=4, learning_rate=1e-3, warmup_ratio=0.25,
                            **{**tc_base, **tc_kw})
    return dataclasses.replace(cfg, **cfg_kw), tc


def _batch(seed):
    r = np.random.default_rng(seed)
    ids = r.integers(5, 256, (B, S_TEXT)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    mask = np.ones((B, S_TEXT), bool)
    mask[1, 18:] = False
    labels = np.where((ids == IMAGE_TOKEN_INDEX) | ~mask, IGNORE_INDEX, ids).astype(np.int32)
    crop_mask = np.ones((B, 1 + CROPS), bool)
    crop_mask[1, -1] = False
    pix = r.integers(0, 255, (B, 1 + CROPS, 3, 336, 336)).astype(np.uint8)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "pixel_values": pix, "crop_mask": crop_mask}


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    p = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    p["projector"]["w_gate"] = np.random.default_rng(1).standard_normal(
        (cfg.mm_hidden_size, 2)).astype(np.float32)
    return cfg, p


@pytest.fixture
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_noise(rng, cfg, batch_size):
    """The draws JAX's encode_images makes from ``rng`` in training: the
    global view's gate noise and, per sample, the selection noise."""
    M = cfg.max_local_crops * cfg.mm_resampler_dim
    sel = [np.asarray(jax.random.normal(r, (M,))) for r in jax.random.split(rng, batch_size)]
    gate = np.asarray(jax.random.normal(rng, (batch_size, cfg.vision.num_patches, 2)))
    return {"gate": torch.from_numpy(np.array(gate)),
            "select": torch.from_numpy(np.stack(sel))}


def _leaf_dict(tree):
    return dict(bridge.named_leaves(tree))


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_loss_and_trainable_gradients_match_jax(setup, jax_kernel_attention, stage):
    cfg, p = setup
    scfg, tc = _stage(cfg, stage)
    batch = _batch(stage)
    rng = jax.random.PRNGKey(11)
    jp = jax.tree_util.tree_map(jnp.asarray, p)

    def jloss(adapters):
        return jslime.loss_fn({**jp, **adapters}, scfg, jax.tree_util.tree_map(
            jnp.asarray, batch), training=True, rng=rng)[0]

    want_loss, want_g = jax.value_and_grad(jloss)(
        {"projector": jp["projector"], "sampler": jp["sampler"]})
    want_g = _leaf_dict(jax.device_get(want_g))

    tp = bridge.from_jax_numpy(p, device="cpu")
    labels = _leaf_dict(toptim.label_tree(tp, tc))
    for path, leaf in bridge.named_leaves(tp):
        leaf.requires_grad_(labels[path] != "frozen")
    loss, metrics = tslime.loss_fn(tp, scfg, _t(batch), training=True,
                                   noise=_jax_noise(rng, cfg, B))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    trained = [path for path, lab in labels.items() if lab != "frozen"]
    assert trained and all(path.startswith(("projector/", "sampler/")) for path in trained)
    moving = 0
    for path, leaf in bridge.named_leaves(tp):
        if labels[path] == "frozen":
            assert leaf.grad is None, path
            continue
        got = leaf.grad.numpy() if leaf.grad is not None else np.zeros(leaf.shape, np.float32)
        np.testing.assert_allclose(got, want_g[path], rtol=RTOL, atol=ATOL, err_msg=path)
        moving += bool(np.abs(want_g[path]).max() > 0)
    assert moving > 0


@pytest.mark.parametrize("remat", [False, True])
def test_forward_remat_matches_jax(setup, jax_kernel_attention, monkeypatch, remat):
    """slime.forward(remat=...) with the vision tower and the projector
    trainable (so the tower runs under autograd) against JAX's
    slime.forward(remat=...): the logits and the gradients of both. remat
    reaches every running ViT block and every LLM layer (counted here), as
    slime.py:116 passes it down, and changes no number."""
    from slime_tpu_torch.models import llama as tllama
    from slime_tpu_torch.models import vit as tvit
    cfg, p = setup
    batch = _batch(7)
    args = ("input_ids", "attention_mask", "pixel_values", "crop_mask")
    jp = jax.tree_util.tree_map(jnp.asarray, p)

    def jfwd(trainable):
        return jslime.forward({**jp, **trainable}, cfg,
                              *(jnp.asarray(batch[k]) for k in args), remat=remat)[0]

    out, vjp = jax.vjp(jfwd, {"vision": jp["vision"], "projector": jp["projector"]})
    cot = np.random.default_rng(8).standard_normal(out.shape).astype(np.float32)
    want_g = _leaf_dict(jax.device_get(vjp(jnp.asarray(cot))[0]))

    tp = bridge.from_jax_numpy(p, device="cpu")
    for path, leaf in bridge.named_leaves(tp):
        leaf.requires_grad_(path.startswith(("vision/", "projector/")))
    calls = {"vit": 0, "llama": 0}
    for name, mod in (("vit", tvit), ("llama", tllama)):
        real = mod.checkpoint

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, "checkpoint", counted)
    tb = _t(batch)
    logits, _ = tslime.forward(tp, cfg, *(tb[k] for k in args), remat=remat)
    logits.backward(torch.from_numpy(cot))
    runs = tvit._layers_run(cfg.vision)
    assert calls == ({"vit": runs, "llama": cfg.llm.num_layers} if remat
                     else {"vit": 0, "llama": 0})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(out), rtol=RTOL, atol=1e-5)
    for path, leaf in bridge.named_leaves(tp):
        if not path.startswith(("vision/", "projector/")):
            continue
        got = leaf.grad.numpy() if leaf.grad is not None else np.zeros(leaf.shape, np.float32)
        want = want_g[path]
        # fp32 sums over the 576-patch views in another order: a floor of
        # 1e-5 of the leaf's largest entry, and 1e-6 for gradients that are
        # zero but for rounding (k_proj's bias)
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=max(1e-5 * np.abs(want).max(), 1e-6), err_msg=path)


def test_packed_text_only_loss_and_gradients_match_jax(setup):
    cfg, p = setup
    r = np.random.default_rng(5)
    S = 40
    seg = np.zeros((B, S), np.int32)
    seg[0, :15], seg[0, 15:33] = 1, 2
    seg[1, :26], seg[1, 26:38] = 1, 2
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        for sid in (1, 2):
            idx = np.where(seg[b] == sid)[0]
            pos[b, idx] = np.arange(len(idx))
    ids = r.integers(5, 256, (B, S)).astype(np.int32)
    batch = {"input_ids": ids, "labels": np.where(seg > 0, ids, IGNORE_INDEX).astype(np.int32),
             "segment_ids": seg, "positions": pos}
    jp = jax.tree_util.tree_map(jnp.asarray, p)

    def jloss(llm):
        return jslime.loss_fn({**jp, "llm": llm}, cfg, jax.tree_util.tree_map(
            jnp.asarray, batch), training=True)

    (want_loss, want_m), want_g = jax.value_and_grad(jloss, has_aux=True)(jp["llm"])
    want_g = _leaf_dict(jax.device_get(want_g))
    tp = bridge.from_jax_numpy(p, device="cpu")
    for _, leaf in bridge.named_leaves(tp["llm"]):
        leaf.requires_grad_(True)
    loss, m = tslime.loss_fn(tp, cfg, _t(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    assert int(m["n_target_tokens"]) == int(want_m["n_target_tokens"])
    np.testing.assert_allclose(float(m["packing_efficiency"]),
                               float(want_m["packing_efficiency"]), rtol=1e-6)
    for path, leaf in bridge.named_leaves(tp["llm"]):
        np.testing.assert_allclose(leaf.grad.numpy(), want_g[path], rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def _opt_params(seed):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)   # noqa: E731
    return {"vision": {"w": f(4, 3)},
            "projector": {"projection": {"layers": [{"weight": f(5, 4), "bias": f(5)}]},
                          "attn": {"ln_q": {"weight": f(4)}}},
            "sampler": {"post_qformer": {"kv_proj": {"weight": f(3, 4)}}},
            "llm": {"norm": {"weight": f(5)}, "embed_tokens": f(6, 5)}}


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_optimizer_matches_optax(schedule):
    """Three steps: the projector/sampler group (mm_projector_lr) is clipped
    (its gradients are large), the LLM group is not; weight decay only on
    ndim >= 2 leaves without "norm" in the path; the vision tower frozen."""
    tc = toptim.TrainConfig(learning_rate=3e-2, mm_projector_lr=5e-2, weight_decay=0.1,
                            total_steps=5, warmup_ratio=0.4, max_grad_norm=1.0,
                            lr_schedule=schedule)
    jtc = joptim.TrainConfig(**dataclasses.asdict(tc))
    p = _opt_params(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tx, jlabels = joptim.make_optimizer(jp, jtc)
    opt_state = tx.init(jp)
    assert toptim.label_tree(p, tc) == jlabels
    state, ttx = tstep.init_train_state(bridge.from_jax_numpy(p, device="cpu"), tc)
    r = np.random.default_rng(1)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: r.standard_normal(x.shape).astype(np.float32), p)
        grads["projector"] = jax.tree_util.tree_map(lambda g: g * 5.0, grads["projector"])
        flat = _leaf_dict(grads)
        for path, leaf in bridge.named_leaves(state["params"]):
            if leaf.requires_grad:
                leaf.grad = torch.from_numpy(flat[path].copy())
        assert toptim.make_schedule(tc, 5e-2)(step) == pytest.approx(
            float(joptim.make_schedule(jtc, 5e-2)(step)), rel=1e-6)
        gnorm = ttx.step()
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        want = _leaf_dict(jax.device_get(jp))
        trained = [g for (path, g) in bridge.named_leaves(grads)
                   if not path.startswith("vision/")]
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(trained)),
                                   rtol=1e-6)
        for path, leaf in bridge.named_leaves(state["params"]):
            np.testing.assert_allclose(leaf.detach().numpy(), want[path], rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {step} {path}")
    assert torch.equal(state["params"]["vision"]["w"], torch.from_numpy(p["vision"]["w"]))


def test_trainer_stages_match_jax_train_step(setup, jax_kernel_attention, tmp_path):
    """Stage 1, then stage 2 from stage 1's result, through ``run_stage`` vs
    JAX's ``make_train_step``: 2 steps each; the losses and every leaf after
    each stage (the frozen ones bitwise unchanged)."""
    cfg, p = setup
    jparams, tparams = p, bridge.from_jax_numpy(p, device="cpu")
    for stage, expect in ((1, "projector/projection/"), (2, "projector/attn/")):
        scfg, tc = _stage(cfg, stage)
        batches = [_batch(10 * stage + i) for i in range(2)]
        jtc = joptim.TrainConfig(**dataclasses.asdict(tc))
        state, tx = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, jparams), jtc)
        jstep_fn = jstep.make_train_step(scfg, jtc, tx, compute_dtype=jnp.float32)
        want_losses = []
        for i, b in enumerate(batches):
            state, m = jstep_fn(state, jax.tree_util.tree_map(jnp.asarray, b),
                                jax.random.PRNGKey(i))
            want_losses.append(float(m["loss"]))
        jparams = jax.device_get(state["params"])

        out = tmp_path / f"stage{stage}"
        before = _leaf_dict(tparams)
        tparams, _ = run_stage(tparams, scfg, tc,
                               RunConfig(output_dir=str(out), save_steps=0, log_steps=1),
                               batches, compute_dtype=torch.float32)
        recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
        np.testing.assert_allclose([r["loss"] for r in recs], want_losses, rtol=RTOL)
        want = _leaf_dict(jparams)
        labels = _leaf_dict(toptim.label_tree(tparams, tc))
        for path, leaf in bridge.named_leaves(tparams):
            if labels[path] == "frozen":
                assert leaf is before[path] or torch.equal(leaf, before[path]), path
            np.testing.assert_allclose(leaf.detach().numpy(), want[path], rtol=RTOL,
                                       atol=ATOL, err_msg=f"stage {stage} {path}")
        moved = [path for path, leaf in bridge.named_leaves(tparams)
                 if not torch.equal(leaf, before[path])]
        assert moved and all(path.startswith(expect) for path in moved), moved


def test_trainer_refuses_what_is_not_ported(setup, tmp_path):
    cfg, p = setup
    scfg, tc = _stage(cfg, 1)
    tp = bridge.from_jax_numpy(p, device="cpu")
    with pytest.raises(NotImplementedError):
        Trainer(tp, scfg, tc, RunConfig(output_dir=str(tmp_path)), lora={"rank": 4})
    (tmp_path / "state-3").mkdir()
    with pytest.raises(NotImplementedError):
        Trainer(tp, scfg, tc, RunConfig(output_dir=str(tmp_path)))


def test_flash_attention_use_kernel_on_cpu_raises():
    q = torch.zeros((1, 2, 128, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, use_kernel=True)
