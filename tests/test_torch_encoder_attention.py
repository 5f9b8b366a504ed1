"""Encoder attention: the port's plain version against the JAX Pallas kernel
run in interpret mode (the kernel's own semantics: clamp instead of a row max,
bf16-rounded clamped scores, l rounded to bf16).

fp32 inputs, so both sides round at the same points: tolerance 1e-5 relative
(fp32 sums in another order). S = 577 covers the ragged tail of the TPU
kernel's 128-row block. The gradients go against ``jax.vjp`` of the same
call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.ops import encoder_attention as jea
from slime_tpu_torch.ops import encoder_attention as tea


def _qkv(B, S, H, D, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("S", [128, 577])
def test_ref_matches_jax_kernel_interpret(S):
    q, k, v = _qkv(2, S, 4, 64, seed=S)
    want = jea.encoder_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = tea.encoder_attention_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_ref_bf16_within_one_ulp_of_jax_kernel():
    q, k, v = _qkv(2, 577, 4, 64, seed=1)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jea.encoder_attention(*jb, interpret=True).astype(jnp.float32))
    got = tea.encoder_attention_ref(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)])
    # bf16 outputs: one bf16 ulp (2^-8 relative) from fp32 sums in another order
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=2 ** -8, atol=2 ** -10)


def test_cpu_dispatch_takes_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(1, 50, 2, 32, seed=2))
    before = tea.encoder_attention.launches
    out = tea.encoder_attention(q, k, v, scale=0.3)
    torch.testing.assert_close(out, tea.encoder_attention_ref(q, k, v, scale=0.3),
                               rtol=0, atol=0)
    assert tea.encoder_attention.launches == before


@pytest.mark.parametrize("S", [50, 577])
def test_gradients_match_jax_vjp(S):
    """K4's backward as JAX has it: the gradient of the stabilized softmax
    (JAX recomputes through _xla_attention), not of the clamped form."""
    q, k, v = _qkv(2, S, 2, 32, seed=10 + S)
    g = np.random.default_rng(S).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jea.encoder_attention(a, b, c, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tea.encoder_attention(tq, tk, tv).backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _bf16_view(shape, offset=0):
    """A bf16 [B, S, H, D] view into a flat buffer, starting ``offset``
    elements in (the buffer itself is 16-byte aligned)."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 64, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    return flat[offset:offset + n].view(shape)


def _packed_qkv(offset=0):
    """q/k/v as views of one packed [2, 577, 3 * 16 * 64] projection."""
    qkv = _bf16_view((2, 577, 3 * 16 * 64), offset)
    return [t.reshape(2, 577, 16, 64) for t in qkv.split(16 * 64, dim=-1)]


# name: (q/k/v, accepted) for the kernel's input rule (kernel_input_error)
K4_INPUTS = {
    "clip_l": (lambda: [_bf16_view((8, 577, 16, 64))] * 3, True),
    "packed_qkv_view": (_packed_qkv, True),
    "head_dim_40": (lambda: [_bf16_view((1, 64, 2, 40))] * 3, True),
    "misaligned_view": (lambda: _packed_qkv(offset=1), True),
    "stride_not_16_bytes": (lambda: [_bf16_view((1, 64, 3, 44))[..., :40]] * 3, True),
    "seq_1025": (lambda: [_bf16_view((1, 1025, 2, 64))] * 3, False),
    "head_dim_136": (lambda: [_bf16_view((1, 64, 2, 136))] * 3, False),
    "fp32": (lambda: [torch.zeros((1, 64, 2, 64))] * 3, True),
    "mixed_dtypes": (lambda: [torch.zeros((1, 64, 2, 64))] + [_bf16_view((1, 64, 2, 64))] * 2,
                     False),
}


@pytest.mark.parametrize("case", list(K4_INPUTS))
def test_kernel_input_rule(case):
    """What K4 takes, decided from shapes and dtypes alone: bf16 or fp32
    (one dtype). TMA reads q/k/v through tensor maps; a view whose data or
    strides are not 16-byte aligned is copied into a fresh tensor first, so
    every layout is taken."""
    make, accepted = K4_INPUTS[case]
    err = tea.kernel_input_error(*make())
    assert (err is None) == accepted, err


# [B, S, H, D]: CLIP-L's shape, then S = 1025, D = 136 and D = 20 (JAX's
# three hard limits), S = 1024 and S = 896 over the VMEM estimate, S = 896 at
# one head a program under it, and short shapes
RULE_SHAPES = [(8, 577, 16, 64), (1, 1025, 2, 64), (1, 64, 2, 136), (1, 64, 2, 20),
               (1, 1024, 2, 64), (1, 896, 4, 128), (1, 896, 3, 64), (2, 100, 4, 128),
               (1, 64, 2, 40)]


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("shape", RULE_SHAPES)
def test_kernel_rule_is_jax_rule(shape, dtype, monkeypatch):
    """``takes_kernel``, the port's routing of CUDA tensors, is JAX's
    automatic choice with "on a TPU" read as "on the card": JAX's
    encoder_attention, told that its backend is a TPU, calls its kernel for
    exactly the shapes the rule sends to K4 and _xla_attention for the rest,
    in either dtype."""
    calls = []
    monkeypatch.delenv("SLIME_USE_PALLAS_ATTN", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jea, "_enc", lambda q, *a: calls.append("kernel") or q)
    monkeypatch.setattr(jea, "_xla_attention", lambda q, *a: calls.append("xla") or q)
    q = jnp.zeros(shape, dtype)
    jea.encoder_attention(q, q, q)
    assert calls == ["kernel" if tea.takes_kernel(shape) else "xla"]
    assert tea.takes_kernel(shape) == (shape in (RULE_SHAPES[0], RULE_SHAPES[6],
                                                 RULE_SHAPES[7], RULE_SHAPES[8]))
