"""The quantized matmuls' plain versions and the port's ``layers.linear``
against the JAX package.

- ``quant_matmul_ref`` (K6: per-row ``q4`` and int8) and
  ``quant_matmul_q4g_ref`` (K7: group-128 ``q4g``) against JAX's Pallas
  kernels in interpret mode, in fp32 and bf16, with ragged row and output
  counts;
- the port's CPU ``linear`` against JAX's CPU ``layers.linear`` for per-row
  q4, grouped q4, q4g and NF4 (on the CPU both dequantize and matmul), and
  the CPU wrappers taking the plain versions without counting a launch.

Tolerances: fp32 1e-5 relative and absolute (the same exact products,
fp32 sums in another order); bf16 outputs one bf16 ulp (2^-7 relative)
plus 1e-6, and after a bias one ulp of the largest output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.models import layers as JL
from slime_tpu.ops import quant_matmul as jqm
from slime_tpu.ops import quantization as JQ
from slime_tpu_torch.models import layers as TL
from slime_tpu_torch.ops import quant_matmul as tqm
from slime_tpu_torch.ops import quantization as TQ

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-6)}


def _data(M, N, K, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((M, K)).astype(np.float32),
            (r.standard_normal((N, K)) * 0.05).astype(np.float32))


def _inputs(x, qw_j, dtype):
    """The same x and weight dict for both packages, x in ``dtype``."""
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = {k: torch.from_numpy(np.array(v)) for k, v in qw_j.items()}
    return jx, tx, tw


def _close(t, j, dtype, atol=None):
    assert str(t.dtype) == f"torch.{dtype}"
    rtol, floor = TOL[dtype]
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=rtol, atol=floor if atol is None else atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M,N,K", [(1, 256, 256), (37, 320, 512)])
def test_k6_plain_matches_jax_kernel(dtype, bits, M, N, K):
    x, w = _data(M, N, K, seed=M + bits)
    qw = JQ.quantize_weight(jnp.asarray(w), bits)
    jx, tx, tw = _inputs(x, qw, dtype)
    want = jqm.quant_matmul(jx, qw, block_out=128, block_rows=32, interpret=True)
    _close(tqm.quant_matmul_ref(tx, tw), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,K,bk", [(3, 256, 512, 512), (40, 384, 1024, 512),
                                      (5, 320, 768, 768)])
def test_k7_plain_matches_jax_kernel(dtype, M, N, K, bk):
    x, w = _data(M, N, K, seed=N)
    qw = JQ.quantize_weight_q4g(jnp.asarray(w), group=128)
    jx, tx, tw = _inputs(x, qw, dtype)
    want = jqm.quant_matmul_q4g(jx, qw, block_out=128, block_in=bk, interpret=True)
    _close(tqm.quant_matmul_q4g_ref(tx, tw), want, dtype)


def _fmt(w, kind):
    if kind == "q4":
        return JQ.quantize_weight(w, 4)
    if kind == "q4_group":
        return JQ.quantize_weight(w, 4, group=64)
    if kind == "q4g":
        return JQ.quantize_weight_q4g(w, group=128)
    return JQ.quantize_weight_nf4(w, group=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["q4", "q4_group", "q4g", "nf4"])
def test_cpu_linear_matches_jax_linear(dtype, kind):
    """JAX on the CPU rounds the dequantized weight to x's dtype and runs
    one dot; the port on the CPU does the same, whatever the format."""
    x, w = _data(6, 192, 256, seed=9)
    b = np.random.default_rng(10).standard_normal(192).astype(np.float32)
    qw = _fmt(jnp.asarray(w), kind)
    jx, tx, tw = _inputs(x.reshape(2, 3, 256), qw, dtype)
    want = JL.linear({"weight": qw, "bias": jnp.asarray(b)}, jx)
    got = TL.linear({"weight": tw, "bias": torch.from_numpy(b)}, tx)
    assert got.shape == (2, 3, 192)
    # the bias is added after the rounding to x's dtype: in bf16 a sum that
    # cancels keeps the one-ulp difference of its larger term
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    _close(got, want, dtype, atol=TOL[dtype][0] * scale if dtype == "bfloat16" else None)


def test_cpu_wrappers_take_the_plain_versions():
    x, w = _data(4, 128, 256, seed=2)
    tx = torch.from_numpy(x)
    q4 = TQ.quantize_weight(torch.from_numpy(w), 4)
    q8 = TQ.quantize_weight(torch.from_numpy(w), 8)
    q4g = TQ.quantize_weight_q4g(torch.from_numpy(w))
    counts = (tqm.quant_matmul.q4_launches, tqm.quant_matmul.int8_launches,
              tqm.quant_matmul_q4g.launches)
    for qw in (q4, q8):
        torch.testing.assert_close(tqm.quant_matmul(tx, qw), tqm.quant_matmul_ref(tx, qw),
                                   rtol=0, atol=0)
    torch.testing.assert_close(tqm.quant_matmul_q4g(tx, q4g),
                               tqm.quant_matmul_q4g_ref(tx, q4g), rtol=0, atol=0)
    assert counts == (tqm.quant_matmul.q4_launches, tqm.quant_matmul.int8_launches,
                      tqm.quant_matmul_q4g.launches)
    with pytest.raises(ValueError):        # K6 takes per-row scales only
        tqm.quant_matmul_ref(tx, TQ.quantize_weight(torch.from_numpy(w), 4, group=64))


def test_plain_versions_scale_after_the_exact_dot():
    """K6 applies the per-row scale to the fp32 sum of exact integer
    products; K7 scales each group's partial sum (not the weight)."""
    x = np.ones((1, 256), np.float32)
    w = np.zeros((2, 256), np.float32)
    w[0, :128], w[0, 128:] = 0.7, -0.07            # group scales 0.1 and 0.01
    w[1] = 0.35
    q4g = TQ.quantize_weight_q4g(torch.from_numpy(w))
    y = tqm.quant_matmul_q4g_ref(torch.from_numpy(x), q4g)
    s = q4g["scale"]
    want0 = np.float32(np.float32(128 * 7) * s[0, 0].item()) + np.float32(
        np.float32(128 * -7) * s[0, 1].item())
    assert y[0, 0].item() == pytest.approx(float(want0), rel=1e-6)
    q4 = TQ.quantize_weight(torch.from_numpy(w), 4)
    y = tqm.quant_matmul_ref(torch.from_numpy(x), q4)
    assert y[0, 1].item() == pytest.approx(256 * 7 * q4["scale"][1, 0].item(), rel=1e-6)
