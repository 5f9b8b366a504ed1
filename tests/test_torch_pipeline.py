"""The pipeline's wavefront in the port against the JAX package.

Two gloo worlds (2 and 4 ranks, one stage each) run this file's ``_worker``
on the same seeded inputs (the port's ``llama.init`` as numpy at JAX's
pipeline test config: 8 layers, hidden 32, B = 8, S = 16, fp32); JAX runs in
the parent on a ("pp",) mesh of as many of its 8 virtual CPU devices:

- ``pipeline_forward`` at n_micro = n and 2n, on every stage, equals JAX's
  ``pipeline_forward`` and JAX's ``llama.forward`` within 1e-5; with
  ``return_hidden`` (n_micro = n) it equals JAX's hidden states;
- two steps of ``make_pp_train_step`` with ``optim.adamw(1e-3)`` (n_micro =
  2n) equal JAX's with ``optax.adamw(1e-3)``: the losses and grad norms,
  and every leaf after step 2 (the stages' layers joined in stage order, the
  head on every stage) within 1e-5;
- a batch that n_micro does not divide and layers that the stages do not
  divide raise, where JAX's asserts do.
"""
import numpy as np
import pytest
import torch

from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import IGNORE_INDEX, LLMConfig

from .torch_ranks import join, leave

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, LR = 8, 16, 1e-3


def _cfg(num_layers=8):
    return LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                     num_layers=num_layers, num_heads=4, num_kv_heads=2, head_dim=8,
                     rope_theta=10000.0, max_position_embeddings=128)


def _worker(argv):
    from slime_tpu_torch.models import llama
    from slime_tpu_torch.parallel import pipeline as pl
    from slime_tpu_torch.parallel.mesh import make_mesh
    from slime_tpu_torch.train.optim import adamw

    rank, world, where, inp = join(argv)
    cfg = _cfg()
    params = bridge.from_jax_numpy(inp["params"], device="cpu")
    ids = torch.from_numpy(inp["ids"])
    mesh = make_mesh(1, 1, 1, device="cpu", n_pp=world)
    out = {}
    with torch.no_grad():
        embeds = llama.embed(params, ids)
        for n_micro in (world, 2 * world):
            out[("logits", n_micro)] = pl.pipeline_forward(params, embeds, cfg, mesh=mesh,
                                                           n_micro=n_micro)
        out["hidden"] = pl.pipeline_forward(params, embeds, cfg, mesh=mesh, n_micro=world,
                                            return_hidden=True)
    state = pl.init_pp_train_state(params, adamw(LR), mesh=mesh)
    step = pl.make_pp_train_step(cfg, mesh=mesh, n_micro=2 * world)
    batch = {"input_ids": ids, "labels": torch.from_numpy(inp["labels"])}
    out["metrics"] = []
    for _ in range(2):
        state, m = step(state, batch)
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    out["stacked"] = {p: t.detach() for p, t in bridge.named_leaves(state["stacked"])}
    out["head"] = {p: t.detach() for p, t in bridge.named_leaves(state["head"])}
    leave(rank, where, out)


@pytest.fixture(scope="module")
def case(request, tmp_path_factory):
    """-> (JAX's results by world, the running worlds)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from slime_tpu.models import llama as jllama
    from slime_tpu.parallel import pipeline as jpl
    from slime_tpu_torch.models import llama as tllama

    from .torch_ranks import start_ranks

    params = bridge.to_jax_numpy(tllama.init(_cfg(), generator=torch.Generator().manual_seed(0),
                                             device="cpu"))
    r = np.random.default_rng(0)
    ids = r.integers(0, 64, (B, S)).astype(np.int32)
    labels = ids.copy()
    labels[1, 10:] = IGNORE_INDEX
    labels[5, :4] = IGNORE_INDEX
    inputs = {"params": params, "ids": ids, "labels": labels}
    worlds = {n: start_ranks("test_torch_pipeline", n, inputs, tmp_path_factory.mktemp(f"pp{n}"))
              for n in (2, 4)}
    request.addfinalizer(lambda: [w.kill() for w in worlds.values()])

    cfg = _cfg()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    embeds = jllama.embed(jp, jnp.asarray(ids))
    want = {"forward": np.asarray(jllama.forward(jp, embeds, cfg)[0])}
    for n in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("pp",))
        w = {("logits", m): np.asarray(jpl.pipeline_forward(jp, embeds, cfg, mesh=mesh,
                                                            n_micro=m))
             for m in (n, 2 * n)}
        w["hidden"] = np.asarray(jpl.pipeline_forward(jp, embeds, cfg, mesh=mesh, n_micro=n,
                                                      return_hidden=True))
        tx = optax.adamw(LR)
        state = jpl.init_pp_train_state(jp, tx, mesh=mesh)
        step = jpl.make_pp_train_step(cfg, tx, mesh=mesh, n_micro=2 * n)
        batch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}
        w["metrics"] = []
        for _ in range(2):
            state, m = step(state, batch)
            w["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
        w["stacked"] = dict(bridge.named_leaves(jax.device_get(state["stacked"])))
        w["head"] = dict(bridge.named_leaves(jax.device_get(state["head"])))
        want[n] = w
    return want, worlds


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_forward_matches_jax(case, world):
    want, worlds = case
    outs = worlds[world].wait()
    for rank, o in enumerate(outs):
        for n_micro in (world, 2 * world):
            got = o[("logits", n_micro)].numpy()
            np.testing.assert_allclose(got, want[world][("logits", n_micro)], **TOL,
                                       err_msg=f"rank {rank} n_micro {n_micro}")
            np.testing.assert_allclose(got, want["forward"], **TOL)
        np.testing.assert_allclose(o["hidden"].numpy(), want[world]["hidden"], **TOL,
                                   err_msg=f"rank {rank} hidden")


@pytest.mark.parametrize("world", [2, 4])
def test_pp_train_step_matches_jax(case, world):
    want, worlds = case
    outs = worlds[world].wait()
    w = want[world]
    for o in outs:
        np.testing.assert_allclose(o["metrics"], w["metrics"], rtol=1e-5)
        for path, leaf in o["head"].items():
            np.testing.assert_allclose(leaf.numpy(), w["head"][path], **TOL, err_msg=path)
    assert w["metrics"][1][0] < w["metrics"][0][0]
    for path, want_leaf in w["stacked"].items():
        joined = torch.cat([o["stacked"][path] for o in outs]).numpy()
        np.testing.assert_allclose(joined, want_leaf, **TOL, err_msg=path)


def test_bad_shapes_raise():
    """n_micro = 3 on 8 rows and 6 layers on 4 stages raise before any send
    (a mesh of one process with four stages), as JAX's asserts do."""
    import jax
    from jax.sharding import Mesh as JMesh

    from slime_tpu.models import llama as jllama
    from slime_tpu.parallel import pipeline as jpl
    from slime_tpu_torch.models import llama as tllama
    from slime_tpu_torch.parallel import pipeline as tpl
    from slime_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(1, 1, 1, device="cpu", n_pp=4)
    jmesh = JMesh(np.asarray(jax.devices()[:4]), ("pp",))
    for layers, n_micro in ((8, 3), (6, None)):
        cfg = _cfg(layers)
        params = tllama.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        embeds = torch.zeros((B, S, cfg.hidden_size))
        with pytest.raises(ValueError):
            tpl.pipeline_forward(params, embeds, cfg, mesh=mesh, n_micro=n_micro)
        jp = jax.tree_util.tree_map(jax.numpy.asarray, bridge.to_jax_numpy(params))
        with pytest.raises(AssertionError):
            jpl.pipeline_forward(jp, jax.numpy.zeros((B, S, cfg.hidden_size)), cfg,
                                 mesh=jmesh, n_micro=n_micro)
    with pytest.raises(ValueError):
        tpl.init_pp_train_state(tllama.init(_cfg(6), generator=torch.Generator().manual_seed(0),
                                            device="cpu"), lambda leaves: None, mesh=mesh)
    # the inverse of stack_layers
    params = tllama.init(_cfg(), generator=torch.Generator().manual_seed(0), device="cpu")
    layers = tpl.unstack_layers(tpl.stack_layers(params), 8)
    for a, b in zip(layers, params["layers"]):
        for (pa, ta), (pb, tb) in zip(bridge.named_leaves(a), bridge.named_leaves(b)):
            assert pa == pb and torch.equal(ta, tb)
