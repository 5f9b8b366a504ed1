"""Vision side of the slice against the JAX package, in fp32: the ViT, the
gated projector (MoE branch at 576 tokens), the sampler's compression and
top-p selection, and device anyres preprocessing.

The config is narrow (hidden 256, 4 heads of 64, 3 layers of which 2 run)
but keeps ``image_size=336, patch_size=14``, so a view has 576 tokens and the
gated projector takes its MoE branch. JAX's ViT attention runs the Pallas
kernel in interpret mode (what it runs on a TPU), so both sides compute the
kernel's clamped softmax. Tolerances: 1e-5 relative for module math, exact
for masks.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slime_tpu.ops.encoder_attention as jea
from slime_tpu.config import LLMConfig, SliMEConfig, VisionConfig
from slime_tpu.data.image_ops import make_device_anyres_fn as j_anyres
from slime_tpu.models import projector as jproj
from slime_tpu.models import sampler as jsamp
from slime_tpu.models import slime as jslime
from slime_tpu.models import vit as jvit
from slime_tpu_torch import params as bridge
from slime_tpu_torch.data.image_ops import make_device_anyres_fn as t_anyres
from slime_tpu_torch.models import projector as tproj
from slime_tpu_torch.models import sampler as tsamp
from slime_tpu_torch.models import vit as tvit

RTOL, ATOL = 1e-5, 1e-5


def _cfg():
    return SliMEConfig(
        llm=LLMConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                      max_position_embeddings=1024),
        vision=VisionConfig(image_size=336, patch_size=14, hidden_size=256,
                            intermediate_size=512, num_layers=3, num_heads=4),
        mm_resampler_dim=4, seperator=7, tokenizer_model_max_length=700,
        bos_token_id=1, eos_token_id=2)


@pytest.fixture(scope="module")
def params():
    p = jax.device_get(jslime.init(jax.random.PRNGKey(0), _cfg()))
    r = np.random.default_rng(0)
    # non-zero gate weights so the MoE mixture is not a plain average
    p["projector"]["w_gate"] = r.standard_normal((256, 2)).astype(np.float32)
    return p


@pytest.fixture
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_vit_apply(params, jax_kernel_attention):
    cfg = _cfg()
    px = np.random.default_rng(1).standard_normal((2, 3, 336, 336)).astype(np.float32)
    want = jvit.apply(jax.tree_util.tree_map(jnp.asarray, params["vision"]),
                      jnp.asarray(px), cfg.vision)
    got = tvit.apply(bridge.from_jax_numpy(params["vision"], device="cpu"), torch.from_numpy(px),
                     cfg.vision)
    assert got.shape == (2, 576, 256)
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("tokens,learnable", [(576, -1), (4, -1), (576, 0), (576, 1)])
def test_gated_projector(params, tokens, learnable):
    cfg = dataclasses.replace(_cfg(), mm_learnable_gated=learnable)
    x = np.random.default_rng(2).standard_normal((2, tokens, 256)).astype(np.float32)
    want = jproj.apply(jax.tree_util.tree_map(jnp.asarray, params["projector"]),
                       jnp.asarray(x), cfg=cfg)
    got = tproj.apply(bridge.from_jax_numpy(params["projector"], device="cpu"),
                      torch.from_numpy(x), cfg=cfg)
    _close(got, want)


def test_sampler_compress(params):
    cfg = _cfg()
    x = np.random.default_rng(3).standard_normal((3, 576, 256)).astype(np.float32)
    want = jsamp.compress(jax.tree_util.tree_map(jnp.asarray, params["sampler"]),
                          jnp.asarray(x), cfg=cfg)
    got = tsamp.compress(bridge.from_jax_numpy(params["sampler"], device="cpu"),
                         torch.from_numpy(x), cfg=cfg)
    _close(got, want)


@pytest.mark.parametrize("topp", [0.9, 0.3])
def test_sampler_select(topp):
    cfg = dataclasses.replace(_cfg(), mm_resampler_topp=topp)
    r = np.random.default_rng(4)
    B, M, Lt, D = 2, 28, 11, 64
    local = r.standard_normal((B, M, D)).astype(np.float32)
    text = r.standard_normal((B, Lt, D)).astype(np.float32)
    tmask = np.ones((B, Lt), bool)
    tmask[1, 7:] = False
    valid = np.ones((B, M), bool)
    valid[0, 20:] = False
    got_keep, got_p = tsamp.select({}, *map(torch.from_numpy, (local, text, tmask, valid)),
                                   cfg=cfg)
    for b in range(B):
        keep, p = jsamp.select({}, *map(jnp.asarray, (local[b], text[b], tmask[b],
                                                      valid[b])), cfg=cfg)
        np.testing.assert_array_equal(got_keep[b].numpy(), np.asarray(keep))
        _close(got_p[b], p)
    assert 0 < int(got_keep.sum()) < int(valid.sum())


def test_device_anyres():
    img = np.random.default_rng(5).integers(0, 255, (672, 500, 3), dtype=np.uint8)
    jc, jm = j_anyres((672, 500))(jnp.asarray(img))
    tc, tm = t_anyres((672, 500), device="cpu")(torch.from_numpy(img))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(tc, jc, atol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_vit_apply_gradients_match_jax(params, jax_kernel_attention, monkeypatch, remat):
    """vit.apply under autograd against jax.vjp of JAX's vit.apply with the
    same ``remat``: the features and the gradients of the pixels and of
    every parameter. remat checkpoints each running block (counted here)
    and changes no number."""
    cfg = _cfg()
    r = np.random.default_rng(6)
    px = r.standard_normal((1, 3, 336, 336)).astype(np.float32)
    cot = r.standard_normal((1, 576, 256)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params["vision"])
    out, vjp = jax.vjp(lambda p, x: jvit.apply(p, x, cfg.vision, remat=remat), jp,
                       jnp.asarray(px))
    want_p, want_x = vjp(jnp.asarray(cot))
    want_p = dict(bridge.named_leaves(jax.device_get(want_p)))

    tp = bridge.from_jax_numpy(params["vision"], device="cpu")
    for _, leaf in bridge.named_leaves(tp):
        leaf.requires_grad_(True)
    tx = torch.from_numpy(px).requires_grad_()
    calls = []
    real = tvit.checkpoint
    monkeypatch.setattr(tvit, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tvit.apply(tp, tx, cfg.vision, remat=remat)
    got.backward(torch.from_numpy(cot))
    assert len(calls) == (tvit._layers_run(cfg.vision) if remat else 0)
    _close(got.detach(), out, atol=1e-4)
    # gradients sum over 576 positions (and 588 pixels a patch) in another
    # order: 1e-4 relative, with a floor of 1e-5 of the leaf's largest entry
    # and 1e-6 (k_proj's bias gradient is zero but for rounding: the softmax
    # ignores a shift of every key by one vector)
    _close(tx.grad, want_x, rtol=1e-4, atol=1e-5 * np.abs(np.asarray(want_x)).max())
    for path, leaf in bridge.named_leaves(tp):
        g = leaf.grad.numpy() if leaf.grad is not None else np.zeros(leaf.shape, np.float32)
        np.testing.assert_allclose(g, want_p[path], rtol=1e-4,
                                   atol=max(1e-5 * np.abs(want_p[path]).max(), 1e-6),
                                   err_msg=path)
