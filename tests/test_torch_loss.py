"""Chunked next-token cross entropy: the port against ``slime_tpu.ops.loss``.

Seeded fp32 hidden states, head and labels (some IGNORE_INDEX); the sum of
the NLL, the valid count and the gradient with respect to x, for a chunk
that divides S, one that does not (the padded tail) and one dense
projection (chunk=None). Tolerance 1e-5 relative: fp32 sums in another
order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.constants import IGNORE_INDEX
from slime_tpu.ops import loss as jloss
from slime_tpu_torch.ops import loss as tloss

B, S, HID, V = 2, 24, 16, 97


def _inputs(seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, HID)).astype(np.float32)
    w = (r.standard_normal((V, HID)) * 0.5).astype(np.float32)
    labels = r.integers(0, V, (B, S)).astype(np.int32)
    labels[r.random((B, S)) < 0.3] = IGNORE_INDEX
    return x, w, labels


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("chunk", [8, 10, None])
def test_chunked_cross_entropy_matches_jax(chunk, shift):
    x, w, labels = _inputs(seed=chunk or 0)

    def jax_sum(xx):
        return jloss.chunked_cross_entropy(xx, {"weight": jnp.asarray(w)},
                                           jnp.asarray(labels), chunk=chunk,
                                           shift=shift)

    (want_sum, want_n), vjp = jax.vjp(jax_sum, jnp.asarray(x))
    want_dx = vjp((jnp.float32(1.0), np.zeros((), jax.dtypes.float0)))[0]

    tx = torch.from_numpy(x).requires_grad_()
    got_sum, got_n = tloss.chunked_cross_entropy(
        tx, {"weight": torch.from_numpy(w)}, torch.from_numpy(labels),
        chunk=chunk, shift=shift)
    got_sum.backward()
    assert int(got_n) == int(want_n) and got_n.dtype == torch.int32
    np.testing.assert_allclose(float(got_sum.detach()), float(want_sum), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-6)


def test_chunked_cross_entropy_int8_head_matches_jax():
    """An int8 per-row lm_head dict, dequantized inside each chunk."""
    from slime_tpu.ops.quantization import quantize_weight
    x, w, labels = _inputs(seed=5)
    qw = quantize_weight(jnp.asarray(w))
    want_sum, want_n = jloss.chunked_cross_entropy(
        jnp.asarray(x), {"weight": qw}, jnp.asarray(labels), chunk=8)
    got_sum, got_n = tloss.chunked_cross_entropy(
        torch.from_numpy(x),
        {"weight": {k: torch.from_numpy(np.array(v)) for k, v in qw.items()}},
        torch.from_numpy(labels), chunk=8)
    assert int(got_n) == int(want_n)
    np.testing.assert_allclose(float(got_sum), float(want_sum), rtol=1e-5)


def test_chunked_ce_mean_matches_jax():
    x, w, labels = _inputs(seed=3)
    want = jloss.chunked_ce_mean(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                 chunk=8)
    got = tloss.chunked_ce_mean(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(labels), chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_chunks_are_recomputed_in_the_backward(monkeypatch):
    """Each chunk is a checkpoint region: its NLL runs once in the forward
    and once more in the backward (no [B, S, V] logits are kept)."""
    x, w, labels = _inputs(seed=4)
    calls = []
    dense = tloss._dense_nll
    monkeypatch.setattr(tloss, "_dense_nll",
                        lambda *a: calls.append(a[0].shape) or dense(*a))
    tx = torch.from_numpy(x).requires_grad_()
    total, _ = tloss.chunked_cross_entropy(tx, torch.from_numpy(w),
                                           torch.from_numpy(labels), chunk=8)
    assert len(calls) == S // 8
    total.backward()
    assert len(calls) == 2 * (S // 8) and calls[0] == (B, 8, HID)
