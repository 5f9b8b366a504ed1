"""The model's other branches against the JAX package, at ``SliMEConfig.tiny``
widths in fp32 (the counterparts of ``tests/test_multi_image.py`` and of
``tests/test_fusion.py``'s identity, unpad and spatial tests):

- ``prepare_multimodal_multi``: two images in two samples, one image equal to
  the single-image path, more images than sentinels, an image with no valid
  crop;
- the identity resampler's flat and 'unpad' merges, and the sampler path's
  'spatial' merge (``local_token_perm``), through ``encode_images``;
- ``init``'s key sets and shapes (``image_newline``, no sampler without one,
  the qformer selector and projectors);
- the ``identity``, ``qformer`` and ``qformer_text`` projectors and the
  ``qformer`` selector, alone and through ``encode_images``;
- the host functions ``spatial_local_perm``, ``unpad_token_order``,
  ``process_naive_image_host`` and ``process_images_host``.

JAX's ViT attention runs its Pallas kernel in interpret mode, as the other
port tests run it. Tolerance: exact where the code gathers, scatters or
computes on the host (token orders, masks, labels, lengths, crops, the
newline rows); 1e-5 (relative and absolute) where it computes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import slime_tpu.ops.encoder_attention as jea
from slime_tpu.config import SliMEConfig
from slime_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_tpu.data import image_ops as jimg
from slime_tpu.models import projector as jproj
from slime_tpu.models import resampler as jres
from slime_tpu.models import sampler as jsamp
from slime_tpu.models import slime as jslime
from slime_tpu_torch import params as bridge
from slime_tpu_torch.data import image_ops as timg
from slime_tpu_torch.models import projector as tproj
from slime_tpu_torch.models import resampler as tres
from slime_tpu_torch.models import sampler as tsamp
from slime_tpu_torch.models import slime as tslime

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tiny models' ops are too small to gain from more threads, and the
    suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return dataclasses.replace(SliMEConfig.tiny(), **kw)


def _params(cfg, seed=0):
    p = jax.device_get(jslime.init(jax.random.PRNGKey(seed), cfg))
    return p, bridge.from_jax_numpy(p, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    jp, tp = _params(cfg)
    return cfg, jp, tp


def _t(x):
    return torch.from_numpy(np.array(x))


def _multi_batch(cfg, B=2, S=18, N=2, sent_at=((3, 9), (5, 12)), seed=0, n_crops=3):
    rng = np.random.default_rng(seed)
    t, MC = cfg.vision.image_size, 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    for b in range(B):
        for p in sent_at[b]:
            if p >= 0:
                ids[b, p] = IMAGE_TOKEN_INDEX
    labels = np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids).astype(np.int32)
    cmask = np.zeros((B, N, MC), bool)
    cmask[:, :, :n_crops] = True
    return {"input_ids": ids, "attention_mask": np.ones((B, S), bool),
            "pixel_values": rng.standard_normal((B, N, MC, 3, t, t)).astype(np.float32),
            "crop_mask": cmask, "labels": labels}


def _fused_equal(t, j):
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    np.testing.assert_array_equal(t.attn_mask.numpy(), np.asarray(j.attn_mask))
    np.testing.assert_array_equal(t.positions.numpy(), np.asarray(j.positions))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_allclose(t.embeds.numpy(), np.asarray(j.embeds), **TOL)


def _multi(cfg, jp, tp, batch, max_len):
    args = ("input_ids", "attention_mask", "pixel_values", "crop_mask", "labels")
    j = jslime.prepare_multimodal_multi(jp, cfg, *(jnp.asarray(batch[k]) for k in args),
                                        max_len=max_len)
    t = tslime.prepare_multimodal_multi(tp, cfg, *(_t(batch[k]) for k in args),
                                        max_len=max_len)
    return t, j


@pytest.mark.parametrize("case", ["two_images", "more_images_than_sentinels",
                                  "an_image_without_crops", "truncated"])
def test_prepare_multimodal_multi_matches_jax(tiny, case):
    cfg, jp, tp = tiny
    max_len = 256
    if case == "two_images":
        batch = _multi_batch(cfg)
    elif case == "more_images_than_sentinels":
        batch = _multi_batch(cfg, B=1, sent_at=((4, -1),))
    elif case == "an_image_without_crops":
        batch = _multi_batch(cfg)
        batch["crop_mask"][1, 1] = False
    else:                                   # the splice's overflow row
        batch, max_len = _multi_batch(cfg, seed=1), 40
    t, j = _multi(cfg, jp, tp, batch, max_len)
    _fused_equal(t, j)
    if case == "truncated":
        assert int(t.lengths.max()) == max_len


def test_one_image_through_the_multi_splice_is_the_single_path(tiny):
    cfg, _, tp = tiny
    b = _multi_batch(cfg, B=1, N=1, sent_at=((4,),))
    multi = tslime.prepare_multimodal_multi(
        tp, cfg, _t(b["input_ids"]), _t(b["attention_mask"]), _t(b["pixel_values"]),
        _t(b["crop_mask"]), _t(b["labels"]), max_len=200)
    single = tslime.prepare_multimodal(
        tp, cfg, _t(b["input_ids"]), _t(b["attention_mask"]), _t(b["pixel_values"][:, 0]),
        _t(b["crop_mask"][:, 0]), _t(b["labels"]), max_len=200)
    for a, c in zip(multi, single):
        assert torch.equal(a, c)


def _single_batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    t, MC = cfg.vision.image_size, 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    cmask = np.ones((B, MC), bool)
    cmask[1, 3:] = False
    return {"input_ids": ids, "attention_mask": np.ones((B, S), bool),
            "pixel_values": rng.standard_normal((B, MC, 3, t, t)).astype(np.float32),
            "crop_mask": cmask,
            "labels": np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids).astype(np.int32)}


def _encode(cfg, jp, tp, b, **kw):
    args = ("pixel_values", "crop_mask", "input_ids", "attention_mask")
    je, jv = jslime.encode_images(jp, cfg, *(jnp.asarray(b[k]) for k in args),
                                  **{k: jax.tree_util.tree_map(jnp.asarray, v)
                                     for k, v in kw.items()})
    te, tv = tslime.encode_images(tp, cfg, *(_t(b[k]) for k in args),
                                  **{k: jax.tree_util.tree_map(_t, v) for k, v in kw.items()})
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    return te, tv


IDENTITY = dict(mm_resampler_type="identity", mm_projector_type="mlp2x_gelu")


def test_identity_resampler_flat_merge_matches_jax():
    cfg = _cfg(**IDENTITY)
    jp, tp = _params(cfg, 1)
    assert "sampler" not in tp
    b = _single_batch(cfg)
    te, tv = _encode(cfg, jp, tp, b)
    P, MC = cfg.vision.num_patches, 1 + cfg.max_local_crops
    assert te.shape[1] == MC * P == tslime.image_token_budget(cfg)
    assert (tv.reshape(2, MC, P).any(-1).numpy() == b["crop_mask"]).all()
    args = ("input_ids", "attention_mask", "pixel_values", "crop_mask", "labels")
    j = jslime.prepare_multimodal(jp, cfg, *(jnp.asarray(b[k]) for k in args))
    t = tslime.prepare_multimodal(tp, cfg, *(_t(b[k]) for k in args))
    _fused_equal(t, j)


@pytest.mark.parametrize("size", [(800, 400), (100, 400), (400, 410)])
def test_identity_resampler_unpad_merge_matches_jax(size):
    cfg = _cfg(**IDENTITY, mm_patch_merge_type="spatial_unpad")
    jp, tp = _params(cfg, 2)
    assert tp["image_newline"].shape == (cfg.hidden_size,)
    b = _single_batch(cfg)
    P, g = cfg.vision.num_patches, cfg.vision.num_patches_per_side
    cols, rows = 2, 1
    budget = (1 + cfg.max_local_crops) * P + rows * g
    src, valid = jimg.unpad_token_order(cols, rows, g, size, budget)
    tsrc, tvalid = timg.unpad_token_order(cols, rows, g, size, budget)
    np.testing.assert_array_equal(tsrc, src)
    np.testing.assert_array_equal(tvalid, valid)
    unpad = (np.stack([src] * 2), np.stack([valid] * 2))
    te, _ = _encode(cfg, jp, tp, b, unpad_order=unpad)
    assert te.shape[1] == P + budget
    # every newline slot is the learned row, every other slot a projected local token
    newline = tp["image_newline"]
    for k in np.flatnonzero(src < 0)[:4]:
        assert torch.equal(te[0, P + k], newline)


def test_spatial_merge_matches_jax(tiny):
    cfg, jp, tp = tiny
    b = _single_batch(cfg)
    dim, g = cfg.mm_resampler_dim, int(np.sqrt(cfg.mm_resampler_dim))
    n_local = cfg.max_local_crops * dim
    perm = np.stack([jimg.spatial_local_perm(2, 2, g, n_local),
                     jimg.spatial_local_perm(3, 1, g, n_local)])
    for cols, rows in ((2, 2), (3, 1), (1, 2)):
        np.testing.assert_array_equal(timg.spatial_local_perm(cols, rows, g, n_local),
                                      jimg.spatial_local_perm(cols, rows, g, n_local))
    te, _ = _encode(cfg, jp, tp, b, local_token_perm=perm)
    flat, _ = tslime.encode_images(tp, cfg, _t(b["pixel_values"]), _t(b["crop_mask"]),
                                   _t(b["input_ids"]), _t(b["attention_mask"]))
    # the local block is a permutation of the flat merge's rows, exactly
    P = cfg.vision.num_patches
    idx = torch.from_numpy(perm[0]).long()
    assert torch.equal(te[0, P + 1:], flat[0, P + 1:][idx])


@pytest.mark.parametrize("merge", ["flat", "spatial_unpad"])
@pytest.mark.parametrize("resampler", ["cosine", "qformer", "identity"])
def test_init_key_sets_and_shapes_match_jax(merge, resampler):
    cfg = _cfg(mm_resampler_type=resampler, mm_patch_merge_type=merge,
               mm_projector_type="mlp2x_gelu" if resampler == "identity" else "gated")
    j = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    t = tslime.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    want = {p: tuple(np.shape(x)) for p, x in bridge.named_leaves(j)}
    got = {p: tuple(x.shape) for p, x in bridge.named_leaves(t)}
    assert got == want
    assert ("image_newline" in t) == (merge == "spatial_unpad")
    assert ("sampler" in t) == (resampler != "identity")


@pytest.mark.parametrize("ptype", ["identity", "qformer", "qformer_text"])
def test_projectors_match_jax(ptype):
    cfg = _cfg(mm_projector_type=ptype)
    jp = jax.device_get(jproj.init(jax.random.PRNGKey(3), cfg))
    tp = bridge.from_jax_numpy(jp, device="cpu")
    t = tproj.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert ({p: tuple(x.shape) for p, x in bridge.named_leaves(t)}
            == {p: tuple(np.shape(x)) for p, x in bridge.named_leaves(jp)})
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, cfg.vision.num_patches, cfg.mm_hidden_size)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if ptype == "qformer_text":
        text = rng.standard_normal((3, 7, cfg.hidden_size)).astype(np.float32)
        mask = np.ones((3, 7), bool)
        mask[1, 4:] = False
        kw_j = dict(text_embedding=jnp.asarray(text), text_mask=jnp.asarray(mask))
        kw_t = dict(text_embedding=_t(text), text_mask=_t(mask))
        with pytest.raises(ValueError):
            tproj.apply(tp, _t(x), cfg=cfg)
    want = np.asarray(jproj.apply(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x),
                                  cfg=cfg, **kw_j))
    got = tproj.apply(tp, _t(x), cfg=cfg, **kw_t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if ptype == "identity":
        assert torch.equal(got, _t(x))


def test_resampler_with_text_matches_jax():
    jp = jax.device_get(jres.init(jax.random.PRNGKey(5), grid_size=3, embed_dim=16,
                                  num_heads=2, llm_hidden_size=24, with_text=True))
    tp = bridge.from_jax_numpy(jp, device="cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    text = rng.standard_normal((2, 5, 24)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    want = jres.apply_with_text(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x),
                                jnp.asarray(text), jnp.asarray(mask), num_heads=2)
    got = tres.apply_with_text(tp, _t(x), _t(text), _t(mask), num_heads=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_qformer_selector_matches_jax():
    cfg = _cfg(mm_resampler_type="qformer", mm_resampler_temp=0.7, mm_resampler_topp=0.6)
    jp = jax.device_get(jsamp.init(jax.random.PRNGKey(7), cfg))
    tp = bridge.from_jax_numpy(jp, device="cpu")
    rng = np.random.default_rng(8)
    B, M, Lt = 3, 12, 9
    local = rng.standard_normal((B, M, cfg.hidden_size)).astype(np.float32)
    text = rng.standard_normal((B, Lt, cfg.hidden_size)).astype(np.float32)
    tmask = np.ones((B, Lt), bool)
    tmask[0, 6:] = False
    tvalid = np.ones((B, M), bool)
    tvalid[2, 8:] = False
    jpj = jax.tree_util.tree_map(jnp.asarray, jp)
    keep_j, probs_j = jax.vmap(lambda lf, te, tm, tv: jsamp.select(
        jpj, lf, te, tm, tv, cfg=cfg))(*(jnp.asarray(a) for a in (local, text, tmask, tvalid)))
    keep_t, probs_t = tsamp.select(tp, _t(local), _t(text), _t(tmask), _t(tvalid), cfg=cfg)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), **TOL)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


def test_qformer_selector_through_encode_images_matches_jax():
    cfg = _cfg(mm_resampler_type="qformer")
    jp, tp = _params(cfg, 9)
    assert "selector" in tp["sampler"]
    _encode(cfg, jp, tp, _single_batch(cfg, seed=3))


def test_unpad_token_order_drops_padding():
    for args in ((2, 1, 4, (100, 400), 200), (1, 2, 3, (900, 300), 60),
                 (2, 2, 2, (640, 480), 5)):
        src, valid = timg.unpad_token_order(*args)
        jsrc, jvalid = jimg.unpad_token_order(*args)
        np.testing.assert_array_equal(src, jsrc)
        np.testing.assert_array_equal(valid, jvalid)
    src, valid = timg.unpad_token_order(2, 1, 4, (100, 400), 200)
    assert sum(1 for i in range(200) if valid[i] and src[i] >= 0) < 2 * 16


@pytest.mark.parametrize("mode", ["anyres", "pad", "pad_then_devide", "square"])
def test_process_images_host_matches_jax(mode):
    rng = np.random.default_rng(10)
    imgs = [Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
            for w, h in ((500, 300), (300, 700))]
    t = timg.process_images_host(imgs, mode)
    j = jimg.process_images_host(imgs, mode)
    assert t[2] == j[2]
    np.testing.assert_array_equal(t[0], j[0])
    if j[1] is None:
        assert t[1] is None
    else:
        np.testing.assert_array_equal(t[1], j[1])
