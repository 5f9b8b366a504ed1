"""Fused decode kernels and the decode step: the port's plain versions against
the JAX Pallas kernels in interpret mode (dense, int8 and q4g weights), and
the port's ``decode_step`` against JAX's ``decode_step(..., fused=True)``
and ``decode_step(..., fused=False)`` (fp32, int8, per-row q4, NF4 and a
mixed q4g/q4 tree, which takes the non-fused path by itself).

Inputs come from one seeded numpy generator and run in fp32 through both
packages, at a non-zero layer index of a 2-layer stack. Tolerance 1e-5
relative: the same rounding points, fp32 sums in another order. q4g needs
contractions that are multiples of 256, so its cases run at hidden 256.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.config import LLMConfig
from slime_tpu.models import llama as jllama
from slime_tpu.ops import fused_mlp as jmlp
from slime_tpu.ops import fused_qkvo as jqkvo
from slime_tpu.ops.quantization import quantize_params, quantize_weight
from slime_tpu_torch import params as bridge
from slime_tpu_torch.models import llama as tllama
from slime_tpu_torch.ops import fused_mlp as tmlp
from slime_tpu_torch.ops import fused_qkvo as tqkvo
from slime_tpu_torch.ops import quantization as tquant

RTOL, ATOL = 1e-5, 1e-5


def _cfg(fmt="fp32"):
    if fmt in ("q4g", "mixed"):       # contractions of 256; mixed: down's in 384
        return LLMConfig(vocab_size=96, hidden_size=256,
                         intermediate_size=384 if fmt == "mixed" else 512,
                         num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                         max_position_embeddings=64)
    return LLMConfig(vocab_size=96, hidden_size=64, intermediate_size=256,
                     num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                     max_position_embeddings=64)


def _H(fmt):
    return _cfg(fmt).hidden_size


def _layers(fmt, seed=0):
    """Stacked JAX layer dict (numpy leaves) with random norms; fmt 'fp32'
    (dense), 'int8' (per-row int8 on all seven projections) or a
    ``quantize_params`` int4 scheme: 'q4' (absmax), 'nf4' (default), 'q4g'
    and 'mixed' (group; down's in 384 falls back to per-row q4)."""
    cfg = _cfg(fmt)
    r = np.random.default_rng(seed)
    p = jax.device_get(jllama.init(jax.random.PRNGKey(seed), cfg))
    for lp in p["layers"]:
        for n in ("input_layernorm", "post_attention_layernorm"):
            lp[n]["weight"] = (1 + 0.1 * r.standard_normal(cfg.hidden_size)
                               ).astype(np.float32)
        if fmt == "int8":
            for n in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                      "up_proj", "down_proj"):
                lp[n]["weight"] = jax.device_get(quantize_weight(lp[n]["weight"], 8))
    if fmt in ("q4", "nf4", "q4g", "mixed"):
        scheme = {"q4": "absmax", "nf4": "default"}.get(fmt, "group")
        p["layers"] = jax.device_get(quantize_params(p["layers"], 4, min_size=1024,
                                                     scheme=scheme))
    p["layers"] = jax.device_get(jllama.stack_layers(p["layers"]))
    return p


def _x(B, H, seed):
    return np.random.default_rng(seed).standard_normal((B, H)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
@pytest.mark.parametrize("B", [1, 4])
def test_qkv_ref_matches_jax_kernel(fmt, B):
    layers = _layers(fmt)["layers"]
    x = _x(B, _H(fmt), seed=B)
    want = jqkvo.fused_qkv_decode(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, layers), 1, eps=1e-5, interpret=True)
    got = tqkvo.fused_qkv_decode_ref(torch.from_numpy(x),
                                     bridge.from_jax_numpy(layers, device="cpu"), 1, eps=1e-5)
    for t, j in zip(got, want):
        _close(t, j)


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
@pytest.mark.parametrize("B", [1, 4])
def test_o_residual_ref_matches_jax_kernel(fmt, B):
    layers = _layers(fmt)["layers"]
    attn, x = _x(B, _H(fmt), seed=10 + B), _x(B, _H(fmt), seed=20 + B)
    want = jqkvo.fused_o_residual(jnp.asarray(attn), jnp.asarray(x),
                                  jax.tree_util.tree_map(jnp.asarray, layers), 1,
                                  interpret=True)
    got = tqkvo.fused_o_residual_ref(torch.from_numpy(attn), torch.from_numpy(x),
                                     bridge.from_jax_numpy(layers, device="cpu"), 1)
    _close(got, want)


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
@pytest.mark.parametrize("B", [1, 4])
def test_mlp_ref_matches_jax_kernel(fmt, B):
    layers = _layers(fmt)["layers"]
    x = _x(B, _H(fmt), seed=30 + B)
    want = jmlp.fused_mlp_decode(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, layers), 1, eps=1e-5, block_inter=128, interpret=True)
    got = tmlp.fused_mlp_decode_ref(torch.from_numpy(x),
                                    bridge.from_jax_numpy(layers, device="cpu"), 1, eps=1e-5)
    _close(got, want)


def test_cpu_dispatch_takes_the_plain_versions():
    layers = bridge.from_jax_numpy(_layers("int8")["layers"], device="cpu")
    x = torch.from_numpy(_x(2, 64, seed=5))
    counts = (tqkvo.fused_qkv_decode.launches, tqkvo.fused_o_residual.launches,
              tmlp.fused_mlp_decode.launches)
    for a, b in zip(tqkvo.fused_qkv_decode(x, layers, 0),
                    tqkvo.fused_qkv_decode_ref(x, layers, 0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(tqkvo.fused_o_residual(x, x, layers, 0),
                               tqkvo.fused_o_residual_ref(x, x, layers, 0),
                               rtol=0, atol=0)
    torch.testing.assert_close(tmlp.fused_mlp_decode(x, layers, 0),
                               tmlp.fused_mlp_decode_ref(x, layers, 0),
                               rtol=0, atol=0)
    assert counts == (tqkvo.fused_qkv_decode.launches,
                      tqkvo.fused_o_residual.launches,
                      tmlp.fused_mlp_decode.launches)


def test_unported_weight_format_raises():
    """NF4 has no fused kernel (decode runs it through the non-fused path)."""
    layers = bridge.from_jax_numpy(_layers("int8")["layers"], device="cpu")
    layers["q_proj"] = {"weight": tquant.quantize_weight_nf4(
        torch.ones((2, 64, 64)))}
    with pytest.raises(NotImplementedError):
        tqkvo.fused_qkv_decode(torch.zeros(1, 64), layers, 0)


def _decode_both(fmt, j_fused, t_fused, B=2):
    """Three decode steps through both packages from one random cache;
    greedy tokens from JAX's logits feed both."""
    cfg = _cfg(fmt)
    p = _layers(fmt, seed=3)
    r = np.random.default_rng(4)
    T, KVH, hd = 24, cfg.num_kv_heads, cfg.head_dim
    k0 = (r.standard_normal((2, B, T, KVH, hd)) * 0.3).astype(np.float32)
    v0 = (r.standard_normal((2, B, T, KVH, hd)) * 0.3).astype(np.float32)
    lengths = (np.array([3, 9], np.int32) if B == 2
               else r.integers(1, T - 4, B).astype(np.int32))
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
              "length": jnp.asarray(lengths)}
    tcache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
              "length": torch.from_numpy(lengths.copy())}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = bridge.from_jax_numpy(p, device="cpu")
    toks = (np.array([5, 17], np.int32) if B == 2
            else r.integers(0, cfg.vocab_size, B).astype(np.int32))
    for _ in range(3):
        jl, jcache = jllama.decode_step(jp, jcache, jnp.asarray(toks), cfg,
                                        fused=j_fused)
        tl, tcache = tllama.decode_step(tp, tcache, torch.from_numpy(toks).long(),
                                        cfg, fused=t_fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
        toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
def test_decode_step_matches_jax_fused(fmt):
    """The port's automatic choice (fused=None) takes the fused structure for
    these formats, as JAX's fused=True."""
    assert tllama._fused_auto_ok(bridge.from_jax_numpy(_layers(fmt)["layers"],
                                                       device="cpu"))
    _decode_both(fmt, True, None)


@pytest.mark.parametrize("fmt", ["int8", "q4g"])
def test_decode_step_fused_past_64_rows(fmt):
    """B = 65, one row past the decode kernels' former limit: the automatic
    choice still takes the fused path (as JAX does at any B) and matches
    JAX's ``_decode_step_fused`` with its kernels in interpret mode."""
    _decode_both(fmt, True, None, B=65)


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4", "nf4", "mixed"])
def test_decode_step_matches_jax_unfused(fmt):
    """fused=False on both sides: each layer through ``layers.linear``. The
    automatic choice makes the same call where no fused kernel can serve the
    MLP (per-row q4, NF4, mixed formats)."""
    layers = bridge.from_jax_numpy(_layers(fmt)["layers"], device="cpu")
    auto = tllama._fused_auto_ok(layers)
    assert auto == (fmt in ("fp32", "int8"))
    _decode_both(fmt, False, None if not auto else False)


def test_decode_step_unfused_takes_list_layers():
    """The non-fused path also runs on a list of layers; fused=True raises
    there."""
    cfg = _cfg()
    p = jax.device_get(jllama.init(jax.random.PRNGKey(5), cfg))
    tp = bridge.from_jax_numpy(p, device="cpu")
    cache = tllama.init_kv_cache(cfg, 1, 8, device="cpu")
    logits, cache = tllama.decode_step(tp, cache, torch.tensor([3]), cfg, fused=False)
    assert logits.shape == (1, cfg.vocab_size) and int(cache["length"][0]) == 1
    with pytest.raises(ValueError):
        tllama.decode_step(tp, cache, torch.tensor([3]), cfg, fused=True)
