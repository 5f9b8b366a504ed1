"""The port's ``(data, fsdp, model)`` mesh against the JAX package's rule table.

- For every leaf of ``SliMEConfig.tiny()``'s tree (the port's ``init``,
  whose key set and shapes are JAX's), of the SliME-8B tree and of a
  LLaMA-70B LLM tree (both built as shapes, no weights allocated), of the
  int8 / per-row q4 / q4g / NF4 quantized LLM layers at 8B width and of a
  LoRA adapter tree, ``mesh.param_pspec`` equals JAX's ``param_pspec`` on
  meshes of (1, 1, 2), (1, 2, 2), (2, 2, 2) and (1, 8, 1) (virtual CPU
  devices), divisibility prunes included.
- On 4 gloo ranks at (1, 2, 2): ``shard_params`` then ``unshard_params``
  gives back every tensor bit for bit; the bytes a rank holds equal the sum
  of its specs' local shapes; the ranks' coordinates are data-major and the
  axis groups hold the ranks JAX's device grid puts on each axis; the batch
  rows each rank takes are JAX's ``shard_batch`` blocks.
- ``shard_kv_cache`` splits the kv heads over ``model``, and keeps the
  cache whole when the model axis does not divide them.
"""
import numpy as np
import pytest
import torch

from slime_tpu_torch.parallel import mesh as tmesh

from .torch_ranks import join, leave, run_ranks

MESHES = [(1, 1, 2), (1, 2, 2), (2, 2, 2), (1, 8, 1)]


def _sizes(shape):
    return dict(zip(tmesh.AXES, shape))


@pytest.fixture(scope="module")
def trees():
    """name -> JAX tree (arrays or ShapeDtypeStructs)."""
    import dataclasses

    import jax

    from slime_tpu.config import LLMConfig, SliMEConfig
    from slime_tpu.models import llama as jllama
    from slime_tpu.models import slime as jslime
    from slime_tpu.ops.quantization import quantize_params
    from slime_tpu_torch import params as bridge
    from slime_tpu_torch.config import SliMEConfig as TCfg
    from slime_tpu_torch.models import slime as tslime
    from slime_tpu_torch.train import lora as tlora

    key = jax.random.PRNGKey(0)
    # the tiny tree from the port's init: JAX's key set and shapes, no compiles
    ttiny = tslime.init(TCfg.tiny(), generator=torch.Generator().manual_seed(0), device="cpu")
    tiny = bridge.to_jax_numpy(ttiny)
    big = jax.eval_shape(lambda k: jslime.init(k, SliMEConfig.slime_8b()), key)
    llm70 = jax.eval_shape(lambda k: {"llm": jllama.init(k, LLMConfig.llama3_70b())}, key)
    two = dataclasses.replace(LLMConfig.llama3_8b(), num_layers=2)
    layers = jax.eval_shape(lambda k: jllama.init(k, two)["layers"], key)
    out = {"tiny": tiny, "slime_8b": big, "llama_70b": llm70}
    for name, kw in (("int8", dict(bits=8)), ("q4", dict(bits=4, scheme="absmax")),
                     ("q4g", dict(bits=4, scheme="group")), ("nf4", dict(bits=4))):
        out[name] = {"llm": {"layers": jax.eval_shape(
            lambda p, kw=kw: quantize_params(p, **kw), layers)}}
    lora = tlora.init_lora(ttiny, generator=torch.Generator().manual_seed(1), r=4, alpha=8)
    out["lora"] = {"adapters": bridge.to_jax_numpy(lora["adapters"])}
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_specs_equal_jax(trees, shape):
    import jax
    from jax.sharding import Mesh

    from slime_tpu.parallel import mesh as jmesh

    jm = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), jmesh.AXES)
    n_split = 0
    for name, tree in trees.items():
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            want = tuple(jmesh.param_pspec(path, leaf, jm))
            got = tmesh.param_pspec(jmesh._path_str(path), leaf.shape, _sizes(shape))
            assert got == want, (name, jmesh._path_str(path), leaf.shape, got, want)
            n_split += any(a is not None for a in got)
    assert n_split > 100        # the rules do split leaves on every mesh


def test_quantized_leaves_follow_the_base_rule():
    """The packed tensor takes the base weight's spec; the scale only its
    out-dim axis (mesh.py:130-135)."""
    s = _sizes((1, 2, 2))
    path = "llm/layers/3/o_proj/weight"
    assert tmesh.param_pspec(path + "/q4g", (4096, 2048), s) == ("fsdp", "model")
    assert tmesh.param_pspec(path + "/scale", (4096, 32), s) == ("fsdp", None)
    assert tmesh.param_pspec("llm/layers/q_proj/weight", (32, 4096, 4096), s) == ()
    assert tmesh.param_pspec("llm/norm/weight", (4096,), s) == ()


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    return {"llm": {"embed_tokens": r(16, 8), "norm": {"weight": r(8)},
                    "lm_head": {"weight": {"q": torch.randint(-127, 127, (16, 8),
                                                              dtype=torch.int8, generator=g),
                                           "scale": r(16, 1)}},
                    "layers": [{"q_proj": {"weight": r(8, 8), "bias": r(8)},
                                "o_proj": {"weight": r(8, 6)},
                                "down_proj": {"weight": r(8, 5)}}]},
            "projector": {"mlp": {"weight": r(6, 4)}},
            "vision": {"position_embedding": r(3, 8)}}


def _worker(argv):
    import torch.distributed as dist

    from slime_tpu_torch.params import named_leaves

    rank, world, where, inp = join(argv)
    mesh = tmesh.make_mesh(1, 2, 2, device="cpu")
    tree = inp["tree"]
    local = tmesh.shard_params(mesh, tree)
    back = tmesh.unshard_params(mesh, local)
    out = {"back": back, "bytes": tmesh.local_bytes(local), "coords": mesh.coords,
           "specs": {p: tmesh.spec_of(t) for p, t in named_leaves(local)},
           "on_mesh": tmesh.on_mesh(local, mesh), "rows": tmesh.batch_rows(mesh, 8),
           "groups": {a: sorted(dist.get_process_group_ranks(mesh.group(a)))
                      for a in ("data", "fsdp", "model", "dp")}}
    leave(rank, where, out)


def test_shard_unshard_round_trip(tmp_path):
    from slime_tpu_torch.params import named_leaves
    tree = _tree(0)
    outs = run_ranks("test_torch_mesh", 4, {"tree": tree}, tmp_path)
    want = dict(named_leaves(tree))
    for r, o in enumerate(outs):
        d, f, m = tmesh.rank_coords(r, 1, 2, 2)
        assert o["coords"] == {"data": d, "fsdp": f, "model": m}
        assert o["on_mesh"]
        for path, t in named_leaves(o["back"]):
            assert t.dtype == want[path].dtype and torch.equal(t, want[path]), path
        held = 0
        for path, spec in o["specs"].items():
            shape = list(want[path].shape)
            for dim, ax in enumerate(spec):
                if ax is not None:
                    shape[dim] //= 2
            held += int(np.prod(shape)) * want[path].element_size()
        assert o["bytes"] == held
        # JAX's device grid reshape(1, 2, 2): model pairs, fsdp pairs
        assert o["groups"]["model"] == [r - m, r - m + 1]
        assert o["groups"]["fsdp"] == sorted([m, m + 2])
        assert o["groups"]["data"] == [r]
        assert o["groups"]["dp"] == sorted([m, m + 2])
        assert o["rows"] == slice(4 * f, 4 * f + 4)
    assert outs[0]["specs"]["llm/embed_tokens"] == ("model", "fsdp")
    assert outs[0]["specs"]["llm/layers/0/down_proj/weight"] == ("fsdp", None)   # 5 % 2
    assert outs[0]["specs"]["llm/lm_head/weight/scale"] == ("model", None)


def test_kv_heads_follow_the_model_axis():
    """The rule the cache and the attention views share: kv heads split
    over ``model`` only when it divides them (mesh.py:249-253)."""
    from slime_tpu_torch.config import LLMConfig
    from slime_tpu_torch.parallel.mesh import Mesh, kv_heads_local, shard_kv_cache
    cfg = LLMConfig.tiny()
    assert kv_heads_local(cfg.num_kv_heads, Mesh(1, 1, 2)) == 1
    assert kv_heads_local(cfg.num_kv_heads, Mesh(1, 1, 4)) == 2
    assert kv_heads_local(cfg.num_kv_heads, None) == 2
    cache = {"k": torch.arange(2 * 3 * 4 * 2 * 5).reshape(1, 2, 12, 2, 5).float(),
             "length": torch.zeros(2, dtype=torch.int32)}
    cache["v"] = -cache["k"]
    half = shard_kv_cache(Mesh(1, 1, 2, rank=1), cache)
    torch.testing.assert_close(half["k"], cache["k"][:, :, :, 1:])
    assert half["length"] is cache["length"]
    whole = shard_kv_cache(Mesh(1, 1, 4, rank=3), cache)
    assert whole["k"] is cache["k"]
