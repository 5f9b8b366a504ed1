"""Expert-parallel dispatch (``ops.moe_ep.moe_ffn_ep``) on gloo worlds of 2 and 4.

Every rank holds T/n tokens and E/n experts (E = 4); the dense oracle (every
expert on every token, weighted by the top-k routing; fp32) runs in the
parent on the whole batch:

- at a generous capacity (factor 8) nothing is dropped and the output equals
  the oracle within 1e-5;
- at a tight one (factor 0.5, C = 8, routing skewed to expert 0) the picks
  each rank drops are exactly those of JAX's ``_dispatch_indices`` on its
  tokens, and the output equals the oracle with those picks' weights zeroed;
- the gradients of the tokens, the combine weights and each rank's experts
  through both all-to-alls equal the oracle's (generous capacity), 1e-5.
"""
import numpy as np
import pytest
import torch

from .torch_ranks import join, leave, start_ranks

E, K, H, I, T = 4, 2, 16, 24, 64
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    topi = r.integers(0, E, (T, K))
    topi[: T // 2, 0] = 0                                # skewed: expert 0 overflows
    topi[:, 1] = np.where(topi[:, 1] == topi[:, 0], (topi[:, 0] + 1) % E, topi[:, 1])
    f = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))  # noqa: E731
    return {"x": f(T, H), "w1": f(E, I, H) * 0.2, "w2": f(E, H, I) * 0.2,
            "w3": f(E, I, H) * 0.2, "topi": torch.from_numpy(topi),
            "topw": torch.from_numpy(r.random((T, K)).astype(np.float32))}


def _oracle(d, weights=None):
    """The dense top-k MoE SwiGLU FFN; ``weights`` [T, K] overrides topw."""
    x, topi = d["x"], d["topi"]
    topw = d["topw"] if weights is None else weights
    h1 = torch.einsum("th,eih->tei", x, d["w1"])
    h3 = torch.einsum("th,eih->tei", x, d["w3"])
    y = torch.einsum("tei,ehi->teh", torch.nn.functional.silu(h1) * h3, d["w2"])
    w = torch.zeros((T, E)).scatter_add(1, topi, topw)
    return torch.einsum("teh,te->th", y, w)


def _worker(argv):
    from slime_tpu_torch.ops.moe_ep import _dispatch_indices, moe_ffn_ep
    from slime_tpu_torch.parallel.mesh import make_mesh

    rank, world, where, d = join(argv)
    mesh = make_mesh(1, 1, world, device="cpu")
    Tl, El = T // world, E // world
    rows, ex = slice(rank * Tl, (rank + 1) * Tl), slice(rank * El, (rank + 1) * El)
    loc = {k: (d[k][ex] if k.startswith("w") else d[k][rows]).clone().requires_grad_(
        k != "topi") for k in ("x", "w1", "w2", "w3", "topi", "topw")}
    out = {}
    y = moe_ffn_ep(loc["x"], loc["w1"], loc["w2"], loc["w3"], loc["topi"], loc["topw"],
                   mesh=mesh, capacity_factor=8.0)
    (y * d["probe"][rows]).sum().backward()
    out["generous"] = y.detach()
    out["grads"] = {k: v.grad for k, v in loc.items() if k != "topi"}
    with torch.no_grad():
        out["tight"] = moe_ffn_ep(loc["x"], loc["w1"], loc["w2"], loc["w3"], loc["topi"],
                                  loc["topw"], mesh=mesh, capacity_factor=0.5)
    out["keep"] = _dispatch_indices(loc["topi"], E, 8)[1]
    leave(rank, where, out)


@pytest.fixture(scope="module")
def worlds(request, tmp_path_factory):
    """world -> (its inputs, its running ranks); both worlds start at once."""
    out = {}
    for world in (2, 4):
        d = _inputs(world)
        d["probe"] = torch.from_numpy(np.random.default_rng(9).standard_normal((T, H))
                                      .astype(np.float32))
        out[world] = (d, start_ranks("test_torch_moe_ep", world, d,
                                     tmp_path_factory.mktemp(f"world{world}")))
    request.addfinalizer(lambda: [ranks.kill() for _, ranks in out.values()])
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_moe_ep_matches_oracle_and_jax_drops(worlds, world):
    import jax.numpy as jnp

    from slime_tpu.ops.moe_ep import _dispatch_indices as j_dispatch

    d, ranks = worlds[world]
    outs = ranks.wait()
    Tl, El = T // world, E // world
    want = _oracle(d)
    keeps = []
    for r, o in enumerate(outs):
        rows = slice(r * Tl, (r + 1) * Tl)
        torch.testing.assert_close(o["generous"], want[rows], **TOL)
        _, jkeep = j_dispatch(jnp.asarray(d["topi"][rows].numpy()),
                              jnp.asarray(d["topw"][rows].numpy()), E, 8)
        np.testing.assert_array_equal(o["keep"].numpy(), np.asarray(jkeep))
        keeps.append(o["keep"])
    keep = torch.cat(keeps)
    assert not bool(keep.all())                         # the tight capacity drops
    dropped = _oracle(d, torch.where(keep, d["topw"], 0.0))
    torch.testing.assert_close(torch.cat([o["tight"] for o in outs]), dropped, **TOL)

    leaves = {k: d[k].clone().requires_grad_(True) for k in ("x", "w1", "w2", "w3", "topw")}
    (_oracle({**d, **leaves}) * d["probe"]).sum().backward()
    for k, leaf in leaves.items():
        got = torch.cat([o["grads"][k] for o in outs])
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), **TOL, err_msg=k)
