"""The port's MPT decoder (``slime_tpu_torch/models/mpt.py``) against the
JAX package's (``slime_tpu/models/mpt.py``) on the CPU:

- ``alibi_slopes`` for 4, 12 (not a power of two) and 32 heads;
- ``attention_bias`` square and with an offset;
- ``init``'s keys, shapes and dtypes;
- ``forward`` logits on ``MPTConfig.tiny()`` at B = 2, S = 20, fp32 and
  bf16 compute, from JAX's params;
- ``convert_hf`` on a state dict with HF ``MptForCausalLM``'s key names
  (numpy, with and without LayerNorm biases) equals JAX's tree.

Tolerance: slopes one fp32 ulp, 2^-23 relative (a float raised to fp32
powers: XLA's pow and torch's part by an ulp on one of MPT-7B's 32 slopes;
the 4- and 12-head slopes are equal); the bias equal; fp32 logits 1e-5 absolute (sums in another order); bf16 logits 2e-2
absolute (bf16 activations rounded after each product, in another order);
converted trees equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.models import mpt as jmpt
from slime_tpu_torch import params as bridge
from slime_tpu_torch.models import mpt as tmpt

CFG, JCFG = tmpt.MPTConfig.tiny(), jmpt.MPTConfig.tiny()


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jmpt.init(jax.random.PRNGKey(0), JCFG))


@pytest.mark.parametrize("n", [4, 12, 32])
def test_alibi_slopes_match_jax(n):
    got = tmpt.alibi_slopes(n, device="cpu")
    want = np.asarray(jmpt.alibi_slopes(n))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -23, atol=0)
    assert bool((got[:-1] > 0).all())


@pytest.mark.parametrize("S,offset", [(9, 0), (7, 5)])
def test_attention_bias_matches_jax(S, offset):
    got = tmpt.attention_bias(CFG, S, offset, device="cpu")
    want = np.asarray(jmpt.attention_bias(JCFG, S, offset))
    assert got.shape == want.shape == (1, CFG.n_heads, S, offset + S)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_layout_matches_jax(params):
    got = dict(bridge.named_leaves(tmpt.init(CFG, generator=torch.Generator().manual_seed(0),
                                             device="cpu")))
    want = dict(bridge.named_leaves(params))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and got[k].dtype == torch.float32, k


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_matches_jax(params, dtype):
    tdt, jdt, atol = {"fp32": (torch.float32, jnp.float32, 1e-5),
                      "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}[dtype]
    ids = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 20))
    want = np.asarray(jmpt.forward(jax.tree_util.tree_map(jnp.asarray, params),
                                   jnp.asarray(ids), JCFG, compute_dtype=jdt))
    got = tmpt.forward(bridge.from_jax_numpy(params, device="cpu"), torch.from_numpy(ids),
                       CFG, compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (2, 20, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def _hf_state_dict(rng, biases):
    D, F = CFG.d_model, CFG.expansion_ratio * CFG.d_model
    sd = {"transformer.wte.weight": rng.standard_normal((CFG.vocab_size, D)),
          "transformer.norm_f.weight": rng.standard_normal(D)}
    for i in range(CFG.n_layers):
        b = f"transformer.blocks.{i}."
        sd.update({b + "norm_1.weight": rng.standard_normal(D),
                   b + "attn.Wqkv.weight": rng.standard_normal((3 * D, D)),
                   b + "attn.out_proj.weight": rng.standard_normal((D, D)),
                   b + "norm_2.weight": rng.standard_normal(D),
                   b + "ffn.up_proj.weight": rng.standard_normal((F, D)),
                   b + "ffn.down_proj.weight": rng.standard_normal((D, F))})
        if biases:
            sd[b + "norm_1.bias"] = rng.standard_normal(D)
            sd[b + "norm_2.bias"] = rng.standard_normal(D)
    if biases:
        sd["transformer.norm_f.bias"] = rng.standard_normal(D)
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("biases", [True, False])
def test_convert_hf_matches_jax(biases):
    sd = _hf_state_dict(np.random.default_rng(2), biases)
    got = dict(bridge.named_leaves(tmpt.convert_hf(sd, CFG)))
    want = dict(bridge.named_leaves(jmpt.convert_hf(sd, JCFG)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)
    logits = tmpt.forward(bridge.from_jax_numpy(tmpt.convert_hf(sd, CFG), device="cpu"),
                          torch.zeros((1, 3), dtype=torch.long), CFG)
    assert bool(torch.isfinite(logits).all())
