"""The port's Mamba block (``slime_tpu_torch/models/mamba.py``) against the
JAX package's (``slime_tpu/models/mamba.py``) and against a sequential
recurrence (the oracle of ``tests/test_mamba.py``), on the CPU in fp32:

- ``scan`` (the doubling scan) and ``selective_scan`` against JAX's
  ``associative_scan`` and the sequential loop, at S = 1, 12 and 37 (not a
  power of two);
- ``_depthwise_conv`` against JAX's and against ``conv1d`` with left padding;
- ``init``'s keys and shapes; ``apply`` at d_model = 16 against JAX's;
- the block is causal (a late perturbation moves no earlier output) and
  its gradients are finite and equal JAX's.

Tolerance: the scans 1e-4 (as JAX's test; the doubling scan sums in
another order than XLA's tree); the block and its gradients 1e-5 absolute;
``init``'s ``A_log`` one fp32 ulp (torch's log against XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.models import mamba as jmamba
from slime_tpu_torch import params as bridge
from slime_tpu_torch.models import mamba as tmamba


def _sequential_scan(u, delta, A, B, C, D):
    Bsz, S, Cdim = u.shape
    h = np.zeros((Bsz, Cdim, A.shape[1]))
    out = np.zeros_like(u)
    for t in range(S):
        dA = np.exp(np.einsum("bc,cn->bcn", delta[:, t], A))
        dBu = np.einsum("bc,bn,bc->bcn", delta[:, t], B[:, t], u[:, t])
        h = dA * h + dBu
        out[:, t] = np.einsum("bcn,bn->bc", h, C[:, t])
    return out + u * D[None, None]


def _scan_inputs(S, seed=0, B=2, C=8, N=4):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, C)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((B, S, C)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((C, N))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    D = np.ones((C,), np.float32)
    return u, delta, A, Bm, Cm, D


@pytest.mark.parametrize("S", [1, 12, 37])
def test_selective_scan_matches_jax_and_sequential(S):
    args = _scan_inputs(S)
    got = tmamba.selective_scan(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, _sequential_scan(*args), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jmamba.selective_scan(*map(jnp.asarray, args))),
                               atol=1e-4, rtol=1e-4)


def test_depthwise_conv_matches_jax_and_conv1d():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    got = tmamba._depthwise_conv(*map(torch.from_numpy, (x, w, b)), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmamba._depthwise_conv(
        *map(jnp.asarray, (x, w, b)), 4)), atol=1e-6, rtol=0)
    conv = torch.nn.functional.conv1d(
        torch.nn.functional.pad(torch.from_numpy(x).transpose(1, 2), (3, 0)),
        torch.from_numpy(w)[:, None], torch.from_numpy(b), groups=6).transpose(1, 2)
    torch.testing.assert_close(got, conv, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def block():
    p = jax.device_get(jmamba.init(jax.random.PRNGKey(0), d_model=16))
    return p, bridge.from_jax_numpy(p, device="cpu")


def test_init_layout_matches_jax(block):
    got = dict(bridge.named_leaves(tmamba.init(d_model=16, generator=torch.Generator(),
                                               device="cpu")))
    want = dict(bridge.named_leaves(block[0]))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
    np.testing.assert_allclose(got["A_log"].numpy(), want["A_log"], rtol=2 ** -23, atol=0)


def test_apply_matches_jax(block):
    x = np.random.default_rng(4).standard_normal((2, 10, 16)).astype(np.float32)
    want = np.asarray(jmamba.apply(jax.tree_util.tree_map(jnp.asarray, block[0]),
                                   jnp.asarray(x)))
    got = tmamba.apply(block[1], torch.from_numpy(x))
    assert got.shape == (2, 10, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_block_is_causal(block):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 10, 16)).astype(np.float32))
    y1 = tmamba.apply(block[1], x)
    x2 = x.clone()
    x2[0, 7] = 99.0
    y2 = tmamba.apply(block[1], x2)
    torch.testing.assert_close(y1[0, :7], y2[0, :7], atol=1e-5, rtol=0)
    assert not torch.allclose(y1[0, 7:], y2[0, 7:])


def test_block_gradients_finite_and_match_jax(block):
    x = np.random.default_rng(6).standard_normal((2, 8, 16)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, block[0])
    want = dict(bridge.named_leaves(jax.device_get(jax.jit(jax.grad(
        lambda p: jnp.sum(jmamba.apply(p, jnp.asarray(x)) ** 2)))(jp))))
    tp = bridge.from_jax_numpy(block[0], device="cpu")
    for _, leaf in bridge.named_leaves(tp):
        leaf.requires_grad_(True)
    (tmamba.apply(tp, torch.from_numpy(x)) ** 2).sum().backward()
    for path, leaf in bridge.named_leaves(tp):
        assert bool(torch.isfinite(leaf.grad).all()), path
        w = np.asarray(want[path])
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=path)
