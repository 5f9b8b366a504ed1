"""The port's MoE block (``ops/moe_dispatch.py``, ``models/llama.py`` ``_moe``,
``_router_aux``, ``top_k_stable``) against the JAX package's on the same inputs (the
counterpart of ``tests/test_moe_dispatch.py``), on the CPU:

- ``moe_ffn_sparse`` at (T, E, K) = (40, 8, 2), (64, 4, 1), (33, 3, 3) and
  with experts that receive no token, in fp32 and bf16;
- ``_moe`` on both sides of its switch (B * S = 16: dense masked; 64:
  sparse), fp32 and bf16, and with bf16 activations over fp32 weights (JAX
  promotes the products to fp32); the sparse path against the dense one on
  the same tokens;
- forced top-k ties (equal gate rows) pick JAX's experts, the lower index
  first, on both paths;
- ``_router_aux`` equals JAX's, and a balanced routing gives about top_k.

Tolerance: fp32 2e-5 absolute (the sparse path against the dense one 2e-5,
as JAX's test); bf16 bit for bit (the dense path's silu is JAX's logistic
expansion, ``layers.silu``: x * sigmoid(x) rounded once
differs from it in about a quarter of the bf16 values, and the difference
grows through the expert sums far past an ulp of the output); the aux loss
1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.config import LLMConfig as JCfg
from slime_tpu.models import llama as jllama
from slime_tpu.ops.moe_dispatch import moe_ffn_sparse as jsparse
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import LLMConfig
from slime_tpu_torch.models import llama as tllama
from slime_tpu_torch.models.layers import silu
from slime_tpu_torch.ops.moe_dispatch import moe_ffn_sparse

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, dtype):
    if dtype == "bf16":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


def _sparse_inputs(rng, T, E, K, H=16, I=24, topi=None):
    x = rng.standard_normal((T, H)).astype(np.float32)
    w1 = rng.standard_normal((E, I, H)).astype(np.float32) * 0.2
    w2 = rng.standard_normal((E, H, I)).astype(np.float32) * 0.2
    w3 = rng.standard_normal((E, I, H)).astype(np.float32) * 0.2
    if topi is None:
        topi = np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(np.int32)
    topw = rng.random((T, K)).astype(np.float32)
    return x, w1, w2, w3, topi, topw


def _both_sparse(args, dtype):
    tdt, jdt = DTYPES[dtype]
    want = jsparse(*(jnp.asarray(a).astype(jdt) if a.dtype == np.float32 else jnp.asarray(a)
                     for a in args))
    got = moe_ffn_sparse(*(torch.from_numpy(a).to(tdt) if a.dtype == np.float32
                           else torch.from_numpy(a) for a in args))
    assert got.dtype == tdt
    return got, want


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("T,E,K", [(40, 8, 2), (64, 4, 1), (33, 3, 3)])
def test_sparse_matches_jax(T, E, K, dtype):
    args = _sparse_inputs(np.random.default_rng(T + E + K), T, E, K)
    _check(*_both_sparse(args, dtype), dtype)


def test_sparse_empty_expert():
    """Only experts 0 and 1 get tokens (some tokens twice, as JAX's test):
    the other experts contribute exactly nothing."""
    rng = np.random.default_rng(5)
    topi = rng.integers(0, 2, (48, 2)).astype(np.int32)
    args = _sparse_inputs(rng, 48, 6, 2, H=8, I=12, topi=topi)
    got, want = _both_sparse(args, "fp32")
    _check(got, want, "fp32")
    x, w1, w2, w3, _, topw = (torch.from_numpy(a) for a in args)
    w1[2:], w2[2:], w3[2:] = 1e6, 1e6, 1e6          # unused experts: no effect
    torch.testing.assert_close(moe_ffn_sparse(x, w1, w2, w3, torch.from_numpy(topi), topw),
                               got, rtol=0, atol=0)


def _layer(E=4, K=2, H=16, seed=0):
    jcfg = JCfg(vocab_size=64, hidden_size=H, intermediate_size=32, num_layers=1,
                num_heads=2, num_kv_heads=2, head_dim=8, num_experts=E,
                num_experts_per_tok=K)
    p = jax.device_get(jllama.init(jax.random.PRNGKey(seed), jcfg))["layers"][0]
    return jcfg, LLMConfig(**dataclasses.asdict(jcfg)), p


def _both_moe(p, x, jcfg, cfg, dtype, weight_dtype=None):
    tdt, jdt = DTYPES[dtype]
    wt, wj = DTYPES[weight_dtype or dtype]
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(wj), p)
    tp = bridge.from_jax_numpy(p, device="cpu", dtype=wt)
    want, jaux = jllama._moe(jp, jnp.asarray(x).astype(jdt), jcfg)
    got, (logits, topi) = tllama._moe(tp, torch.from_numpy(x).to(tdt), cfg)
    taux = tllama._router_aux(logits, topi, cfg.num_experts)
    assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(want.dtype)]
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    return got, want


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("S", [8, 32], ids=["dense_16_tokens", "sparse_64_tokens"])
def test_moe_matches_jax(S, dtype):
    jcfg, cfg, p = _layer()
    x = np.random.default_rng(S).standard_normal((2, S, 16)).astype(np.float32)
    _check(*_both_moe(p, x, jcfg, cfg, dtype), dtype)


@pytest.mark.parametrize("S", [8, 32], ids=["dense", "sparse"])
def test_moe_bf16_over_fp32_weights_matches_jax(S):
    """bf16 activations, fp32 experts: JAX's products promote to fp32 (the
    sparse path returns fp32, the dense one rounds each product to bf16)."""
    jcfg, cfg, p = _layer(seed=1)
    x = np.random.default_rng(S + 1).standard_normal((2, S, 16)).astype(np.float32)
    got, want = _both_moe(p, x, jcfg, cfg, "bf16", weight_dtype="fp32")
    np.testing.assert_array_equal(_np(got), _np(want))


def test_moe_sparse_equals_dense():
    """The same 64 tokens through the sparse path at once and through the
    dense path in chunks of 16 (JAX's ``test_moe_layer_sparse_equals_dense``)."""
    _, cfg, p = _layer()
    lp = bridge.from_jax_numpy(p, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 32, 16)).astype(np.float32))
    sparse = tllama._moe(lp, x, cfg)[0]
    dense = torch.cat([tllama._moe(lp, x[:, i:i + 8], cfg)[0] for i in range(0, 32, 8)], dim=1)
    torch.testing.assert_close(sparse, dense, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("S", [8, 32], ids=["dense", "sparse"])
def test_topk_ties_pick_jax_experts(S):
    """Gate rows 0 = 1 = 2: every token has three equal logits, of which the
    top 2 take one or two; JAX's top_k (and the port's) takes the lower
    indices, so expert 2 is never chosen."""
    jcfg, cfg, p = _layer(seed=2)
    g = np.array(p["gate"]["weight"])
    g[1], g[2] = g[0], g[0]
    p["gate"]["weight"] = g
    x = np.random.default_rng(4).standard_normal((2, S, 16)).astype(np.float32)
    logits = torch.from_numpy(x) @ torch.from_numpy(g).T
    _, ti = tllama.top_k_stable(logits, 2)
    _, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert 2 not in ti.numpy()
    for dtype in ("fp32", "bf16"):
        _check(*_both_moe(p, x, jcfg, cfg, dtype), dtype)


def test_router_aux_matches_jax():
    E, K = 8, 2
    logits = np.random.default_rng(6).standard_normal((2, 20, E)).astype(np.float32)
    _, ti = tllama.top_k_stable(torch.from_numpy(logits), K)
    _, ji = jax.lax.top_k(jnp.asarray(logits), K)
    want = float(jllama._router_aux(jnp.asarray(logits), ji, E))
    np.testing.assert_allclose(float(tllama._router_aux(torch.from_numpy(logits), ti, E)),
                               want, rtol=1e-6)


def test_router_aux_balanced_is_about_top_k():
    """Each expert first choice of an equal share of tokens: the loss is
    about top_k (HF's normalisation; JAX's test bounds it by 2 K + 1)."""
    E, K = 8, 2
    bal = torch.from_numpy(np.tile(np.eye(E, dtype=np.float32), (1, 16, 1))[:, :E] * 10)
    _, ti = tllama.top_k_stable(bal, K)
    aux = float(tllama._router_aux(bal, ti, E))
    assert abs(aux) < 2 * K + 1
    np.testing.assert_allclose(aux, float(jllama._router_aux(
        jnp.asarray(bal.numpy()), jax.lax.top_k(jnp.asarray(bal.numpy()), K)[1], E)), rtol=1e-6)


def test_silu_is_jax_silu_in_bf16():
    h = torch.from_numpy((np.random.default_rng(7).standard_normal(4096) * 4).astype(np.float32))
    want = jax.nn.silu(jnp.asarray(h.numpy()).astype(jnp.bfloat16))
    np.testing.assert_array_equal(_np(silu(h.bfloat16())), _np(want))
