"""Composed (data, fsdp, model) x pp parallelism in the port against the JAX
package.

- ``stacked_param_pspec`` gives JAX's spec for every stacked leaf (dense and
  MoE layers) on four meshes, and JAX's test's three assertions on
  (1, 2, 2, 2).
- One gloo world of 4 ranks runs this file's ``_worker``: two composed text
  steps (``init_composed_train_state`` / ``make_composed_train_step``,
  ``optim.adamw(1e-3, eps=1e-6)``, n_micro = 4) on the meshes (data, fsdp, model, pp)
  = (1, 1, 2, 2) and (1, 2, 1, 2), each held to JAX's single-device step
  (``llama.forward``, the token-mean cross entropy, ``optax.adamw``, the same):
  both losses, the grad norms and every leaf after step 2 within 1e-5; then
  one composed multimodal step (``SliMEConfig.tiny()``, 8 rows, n_micro = 4)
  on (1, 1, 2, 2) with JAX's own noise draws, held to JAX's
  ``make_composed_mm_train_step`` on a (1, 1, 2, 2) mesh of 4 of the virtual
  devices (the loss, the grad norm and every leaf after the step within
  1e-5; the tower moved).

JAX's encoder attention runs in interpret mode (the kernel's clamped
softmax, which the port's plain version computes). Both optimizers are
optax's adamw with eps 1e-6 (as ``test_torch_parallel_train.py``'s steps): at
eps 1e-8 an entry whose gradient is near 0 moves by up to the learning rate
in the direction of the fp32 rounding of sums that the fsdp shards add in
another order (one down_proj entry of 32768 parts by 1.8e-5 at (1, 2, 1, 2)).
"""
import numpy as np
import pytest
import torch

from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import IGNORE_INDEX, IMAGE_TOKEN_INDEX, LLMConfig, SliMEConfig

from .torch_ranks import join, leave

TOL = dict(rtol=1e-5, atol=1e-5)
LR, EPS = 1e-3, 1e-6
TEXT_MESHES = [(1, 1, 2, 2), (1, 2, 1, 2)]        # (data, fsdp, model, pp)


def _cfg(**kw):
    return LLMConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=4,
                     num_heads=4, num_kv_heads=2, head_dim=16, max_position_embeddings=128,
                     **kw)


def _text_batch(seed=0):
    r = np.random.default_rng(seed)
    ids = r.integers(4, 128, (8, 16)).astype(np.int32)
    labels = ids.copy()
    labels[2, 9:] = IGNORE_INDEX
    return {"input_ids": ids, "labels": labels}


def _mm_batch(cfg, B=8, S=24):
    r = np.random.default_rng(0)
    MC, t = 1 + cfg.max_local_crops, cfg.vision.image_size
    ids = r.integers(8, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    return {"input_ids": ids, "attention_mask": np.ones((B, S), bool),
            "pixel_values": r.standard_normal((B, MC, 3, t, t)).astype(np.float32),
            "crop_mask": np.ones((B, MC), bool),
            "labels": np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids).astype(np.int32)}


def _t(tree):
    return {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v)
            for k, v in tree.items()}


def _whole(mesh, state, keys):
    from slime_tpu_torch.parallel.mesh import unshard_params
    return {k: {p: t.detach() for p, t in bridge.named_leaves(unshard_params(mesh, state[k]))}
            for k in keys}


def _worker(argv):
    from slime_tpu_torch.parallel import composed
    from slime_tpu_torch.train.optim import adamw

    rank, world, where, inp = join(argv)
    out = {}
    text = bridge.from_jax_numpy(inp["text"], device="cpu")
    for shape in TEXT_MESHES:
        mesh = composed.make_composed_mesh(*shape, device="cpu")
        state = composed.init_composed_train_state(text, adamw(LR, eps=EPS), mesh=mesh)
        step = composed.make_composed_train_step(_cfg(), mesh=mesh, n_micro=4)
        batch = composed.composed_batch(mesh, _t(inp["text_batch"]))
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[shape] = {"metrics": metrics, **_whole(mesh, state, ("stacked", "head"))}
    mesh = composed.make_composed_mesh(1, 1, 2, 2, device="cpu")
    state = composed.init_composed_mm_train_state(
        bridge.from_jax_numpy(inp["mm"], device="cpu"), adamw(LR, eps=EPS), mesh=mesh)
    step = composed.make_composed_mm_train_step(SliMEConfig.tiny(), mesh=mesh, n_micro=4,
                                                compute_dtype=torch.float32)
    state, m = step(state, composed.composed_batch(mesh, _t(inp["mm_batch"])),
                    noise=composed.composed_batch(mesh, inp["noise"]))
    out["mm"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                 **_whole(mesh, state, ("stacked", "head", "vision"))}
    leave(rank, where, out)


def _jax_noise(rng, cfg, rows):
    import jax
    M = cfg.max_local_crops * cfg.mm_resampler_dim
    sel = [np.asarray(jax.random.normal(r, (M,))) for r in jax.random.split(rng, rows)]
    gate = np.asarray(jax.random.normal(rng, (rows, cfg.vision.num_patches, 2)))
    return {"gate": torch.from_numpy(np.array(gate)), "select": torch.from_numpy(np.stack(sel))}


@pytest.fixture(scope="module")
def case(request, tmp_path_factory):
    """-> (JAX's results, the running world of 4)."""
    import functools

    import jax
    import jax.numpy as jnp
    import optax

    import slime_tpu.ops.encoder_attention as jea
    from slime_tpu.models import llama as jllama
    from slime_tpu.parallel import composed as jcomposed
    from slime_tpu_torch.models import llama as tllama
    from slime_tpu_torch.models import slime as tslime

    from .torch_ranks import start_ranks

    text = bridge.to_jax_numpy(tllama.init(_cfg(), generator=torch.Generator().manual_seed(0),
                                           device="cpu"))
    mm_cfg = SliMEConfig.tiny()
    mm = bridge.to_jax_numpy(tslime.init(mm_cfg, generator=torch.Generator().manual_seed(1),
                                         device="cpu"))
    key = jax.random.PRNGKey(7)
    mm_batch = _mm_batch(mm_cfg)
    inputs = {"text": text, "text_batch": _text_batch(), "mm": mm, "mm_batch": mm_batch,
              "noise": _jax_noise(key, mm_cfg, 8)}
    ranks = start_ranks("test_torch_composed", 4, inputs, tmp_path_factory.mktemp("composed"))
    request.addfinalizer(ranks.kill)
    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    cfg = _cfg()

    def loss_fn(p, b):                       # JAX's test's single-device oracle
        logits = jllama.forward(p, jllama.embed(p, b["input_ids"]), cfg)[0]
        labels = b["labels"][:, 1:]
        valid = labels != IGNORE_INDEX
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(logp, jnp.where(valid, labels, 0)[..., None], -1)[..., 0]
        return jnp.sum(jnp.where(valid, nll, 0.0)) / jnp.maximum(jnp.sum(valid), 1)

    tx = optax.adamw(LR, eps=EPS)
    p, opt = J(text), tx.init(J(text))
    vg = jax.jit(jax.value_and_grad(loss_fn))
    metrics = []
    for _ in range(2):
        loss, g = vg(p, J(inputs["text_batch"]))
        metrics.append((float(loss), float(optax.global_norm(g))))
        upd, opt = tx.update(g, opt, p)
        p = optax.apply_updates(p, upd)
    p = jax.device_get(p)
    want = {"text": {"metrics": metrics,
                     "stacked": dict(bridge.named_leaves(jllama.stack_layers(p["layers"]))),
                     "head": dict(bridge.named_leaves(
                         {k: v for k, v in p.items() if k != "layers"}))}}

    saved = jea.encoder_attention
    jea.encoder_attention = functools.partial(saved, interpret=True)
    try:
        from slime_tpu.config import SliMEConfig as JCfg
        mesh = jcomposed.make_composed_mesh(1, 1, 2, 2, devices=jax.devices()[:4])
        state = jcomposed.init_composed_mm_train_state(J(mm), tx, mesh=mesh)
        step = jcomposed.make_composed_mm_train_step(JCfg.tiny(), tx, mesh=mesh, n_micro=4,
                                                     compute_dtype=jnp.float32)
        state, m = step(state, jcomposed.composed_batch(mesh, J(mm_batch)), key)
        state = jax.device_get(state)
        want["mm"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      **{k: dict(bridge.named_leaves(state[k]))
                         for k in ("stacked", "head", "vision")}}
    finally:
        jea.encoder_attention = saved
    want["mm_start"] = dict(bridge.named_leaves({k: v for k, v in mm.items() if k != "llm"}))
    return want, ranks


def _same(got, want, what):
    assert set(got) == set(want), what
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(want[path]), **TOL,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("shape", [
    (1, 2, 2, 2), (1, 1, 2, 2), (1, 2, 1, 2), (1, 1, 4, 2)], ids=lambda s: "x".join(map(str, s)))
def test_stacked_pspec_equals_jax(shape):
    import jax

    from slime_tpu.models import llama as jllama
    from slime_tpu.parallel import composed as jcomposed
    from slime_tpu_torch.parallel import composed

    jmesh = jcomposed.make_composed_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])
    sizes = dict(zip(("data", "fsdp", "model", "pp"), shape))
    n = 0
    for cfg in (_cfg(), _cfg(num_experts=4, num_experts_per_tok=2)):
        stacked = jax.eval_shape(lambda k, c=cfg: jcomposed.stack_layers(
            {"layers": jllama.init(k, c)["layers"]}), jax.random.PRNGKey(0))
        specs = jax.tree_util.tree_map_with_path(
            lambda path, leaf: (jcomposed.mesh_lib._path_str(path), leaf.shape,
                                tuple(jcomposed.stacked_param_pspec(path, leaf, jmesh))),
            stacked)
        for path, leaf_shape, want in jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3
                and isinstance(x[0], str)):
            assert composed.stacked_param_pspec(path, leaf_shape, sizes) == want, (path, want)
            n += 1
    assert n == 19                   # 9 dense leaves, 10 MoE ones
    if shape == (1, 2, 2, 2):                    # tests/test_composed.py's assertions
        assert composed.stacked_param_pspec("q_proj/weight", (4, 64, 64), sizes) == \
            ("pp", "model", "fsdp")
        assert composed.stacked_param_pspec("o_proj/weight", (4, 64, 64), sizes) == \
            ("pp", "fsdp", "model")
        assert composed.stacked_param_pspec("input_layernorm/weight", (4, 64), sizes) == \
            ("pp",)


@pytest.mark.parametrize("shape", TEXT_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_composed_text_step_matches_jax(case, shape):
    want, ranks = case
    w = want["text"]
    for o in ranks.wait():
        got = o[shape]
        np.testing.assert_allclose(got["metrics"], w["metrics"], rtol=1e-5)
        _same(got["stacked"], w["stacked"], f"{shape} stacked")
        _same(got["head"], w["head"], f"{shape} head")
    assert w["metrics"][1][0] < w["metrics"][0][0]


def test_composed_mm_step_matches_jax(case):
    want, ranks = case
    w = want["mm"]
    for o in ranks.wait():
        got = o["mm"]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], w["grad_norm"], rtol=1e-5)
        for k in ("stacked", "head", "vision"):
            _same(got[k], w[k], f"mm {k}")
        tower = "vision/layers/0/q_proj/weight"
        if tower not in got["vision"]:
            tower = next(p for p in got["vision"] if p.startswith("vision/layers/0/"))
        assert not np.allclose(got["vision"][tower].numpy(), want["mm_start"][tower])
