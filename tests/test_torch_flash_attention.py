"""Causal flash attention (K5): the port against the JAX package.

Seeded fp32 inputs at H=4, KVH=2, D=16 (and D=256 and 384: the kernels take
every multiple of 128). JAX's Pallas kernels run in
interpret mode with 32-row blocks, so several tiles, a ragged tail and a
wholly masked first tile occur. Two paths of the port are held to them: the
``_Flash`` autograd function (on CPU tensors its steps take the kernels'
plain versions ``flash_fwd_ref`` / ``flash_bwd_ref``, with delta computed as
on the card) and ``flash_attention``'s CPU path (``reference_attention``
under autograd). Tolerance 1e-5 abs / 1e-5 rel: fp32 sums in another order.

For a ragged S, JAX's interpret-mode dK is NaN (the dK/dV kernel reads the
lse/delta block past S without zeroing it, and p = 0 times NaN stays NaN),
so there the port's dK is held to ``jax.vjp`` of JAX's reference_attention.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.ops import flash_attention as jfa
from slime_tpu_torch.ops import flash_attention as tfa

H, KVH, D = 4, 2, 16
BLOCK = 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, S, seed, d=D):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, S, d)).astype(np.float32)
    k = r.standard_normal((B, KVH, S, d)).astype(np.float32)
    v = r.standard_normal((B, KVH, S, d)).astype(np.float32)
    g = r.standard_normal((B, H, S, d)).astype(np.float32)
    return q, k, v, g


def _segments(B, S, kind):
    if kind is None:
        return None
    seg = np.zeros((B, S), np.int32)
    if kind == "first_tile_masked":          # segment 2 fills exactly the second tile
        seg[:, :BLOCK] = 1
        seg[:, BLOCK:2 * BLOCK] = 2
    else:                                    # three packed segments and a zero tail
        seg[:, :20] = 1
        seg[:, 20:50] = 2
        seg[:, 50:S - 6] = 3
    return seg


CASES = {
    # name: (B, S, causal, segments, head dim)
    "causal": (2, 64, True, None, D),
    "noncausal": (1, 64, False, None, D),
    "ragged": (1, 80, True, None, D),
    "ragged_noncausal": (2, 70, False, None, D),
    "segments": (2, 96, True, "packed", D),
    "segments_noncausal": (1, 96, False, "packed", D),
    "first_tile_masked": (1, 64, True, "first_tile_masked", D),
    # D = 256 at S a multiple of the block (JAX's ragged-S NaN, ROADMAP Queue 3)
    "causal_d256": (1, 64, True, None, 256),
    "noncausal_d256": (1, 64, False, None, 256),
    "segments_d256": (1, 96, True, "packed", 256),
    # D = 384, which the kernels now take (FFMA tiles over 128-column chunks)
    "causal_d384": (1, 64, True, None, 384),
    "noncausal_d384": (1, 64, False, None, 384),
    "segments_d384": (1, 96, True, "packed", 384),
}


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """JAX's forward and gradients for ``case`` (shared by both port paths)."""
    B, S, causal, kind, d = CASES[case]
    q, k, v, g = _inputs(B, S, seed=len(case), d=d)
    seg = _segments(B, S, kind)
    jseg = None if seg is None else jnp.asarray(seg)

    def kernel(a, b, c):
        return jfa.flash_attention_interpret(a, b, c, causal=causal, block_q=BLOCK,
                                             block_k=BLOCK, segment_ids=jseg)

    def plain(a, b, c):
        return jfa.reference_attention(a, b, c, causal=causal, segment_ids=jseg)

    args = tuple(map(jnp.asarray, (q, k, v)))
    out, vjp = jax.vjp(kernel, *args)
    grads = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    if q.shape[2] % BLOCK:
        grads[1] = np.asarray(jax.vjp(plain, *args)[1](jnp.asarray(g))[1])
    return np.asarray(out), grads


def _torch_case(path, q, k, v, g, causal, seg):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tseg = None if seg is None else torch.from_numpy(seg)
    if path == "autograd_fn":
        out = tfa._Flash.apply(tq, tk, tv, tseg, causal, 1.0 / np.sqrt(q.shape[-1]))
    else:
        out = tfa.flash_attention(tq, tk, tv, causal=causal, segment_ids=tseg)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("path", ["autograd_fn", "flash_attention"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_jax(case, path):
    B, S, causal, kind, d = CASES[case]
    q, k, v, g = _inputs(B, S, seed=len(case), d=d)
    seg = _segments(B, S, kind)
    want_out, want_grads = _jax_case(case)
    before = (tfa.flash_attention.fwd_launches, tfa.flash_attention.dkdv_launches,
              tfa.flash_attention.dq_launches)
    got_out, got_grads = _torch_case(path, q, k, v, g, causal, seg)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    for got, want, name in zip(got_grads, want_grads, ("dq", "dk", "dv")):
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    # CPU tensors never launch a kernel
    assert (tfa.flash_attention.fwd_launches, tfa.flash_attention.dkdv_launches,
            tfa.flash_attention.dq_launches) == before


@pytest.mark.parametrize("case", ["causal", "ragged", "segments", "first_tile_masked",
                                  "causal_d256", "segments_d256", "causal_d384"])
def test_fwd_ref_lse_matches_jax_kernel(case):
    B, S, causal, kind, d = CASES[case]
    q, k, v, _ = _inputs(B, S, seed=3, d=d)
    seg = _segments(B, S, kind)
    out, lse = jfa._fwd(*map(jnp.asarray, (q, k, v)),
                        None if seg is None else jnp.asarray(seg),
                        scale=1.0 / np.sqrt(d), causal=causal, block_q=BLOCK,
                        block_k=BLOCK, interpret=True)
    got_out, got_lse = tfa.flash_fwd_ref(
        *map(torch.from_numpy, (q, k, v)), causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse).transpose(0, 2, 1), **TOL)


@pytest.mark.parametrize("case", ["causal", "noncausal", "segments",
                                  "causal_d256", "noncausal_d256",
                                  "causal_d384", "noncausal_d384", "segments_d384"])
def test_bwd_ref_matches_jax_kernels(case):
    """flash_bwd_ref from the saved lse and delta vs JAX's two backward
    kernels, given the same (out, lse) from JAX's forward kernel."""
    B, S, causal, kind, d = CASES[case]
    q, k, v, g = _inputs(B, S, seed=5, d=d)
    seg = _segments(B, S, kind)
    jseg = None if seg is None else jnp.asarray(seg)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kw = dict(scale=1.0 / np.sqrt(d), causal=causal, block_q=BLOCK, block_k=BLOCK,
              interpret=True)
    out, lse = jfa._fwd(jq, jk, jv, jseg, **kw)
    want = jfa._bwd_impl(jq, jk, jv, out, lse, jnp.asarray(g), jseg, **kw)
    out_t = torch.from_numpy(np.array(out))
    g_t = torch.from_numpy(g)
    delta = (g_t * out_t).sum(-1)
    got = tfa.flash_bwd_ref(*map(torch.from_numpy, (q, k, v)), g_t,
                            torch.from_numpy(np.array(lse)).transpose(1, 2),
                            delta, causal=causal,
                            segment_ids=None if seg is None else torch.from_numpy(seg))
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_auto_rule_takes_the_plain_path_on_cpu():
    """use_kernel=None is JAX's rule on the card only: a CPU tensor at S=2048
    takes reference_attention, bit for bit."""
    r = np.random.default_rng(0)
    q = torch.from_numpy(r.standard_normal((1, 2, 2048, 128)).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((1, 1, 2048, 128)).astype(np.float32))
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    assert not tfa._auto_kernel(q, True)
    torch.testing.assert_close(tfa.flash_attention(q, k, k),
                               tfa.reference_attention(q, k, k), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_d256_on_cpu_takes_the_plain_path(dtype):
    """A CPU tensor at D = 256 takes reference_attention, bit for bit, and
    launches nothing; use_kernel=True raises (the kernels have no CPU mode)."""
    r = np.random.default_rng(1)
    q = torch.from_numpy(r.standard_normal((1, 2, 256, 256)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(r.standard_normal((1, 1, 256, 256)).astype(np.float32)).to(dtype)
    before = tfa.flash_attention.fwd_d256_launches
    torch.testing.assert_close(tfa.flash_attention(q, k, k), tfa.reference_attention(q, k, k),
                               rtol=0, atol=0)
    assert tfa.flash_attention.fwd_d256_launches == before
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, k, use_kernel=True)


def _bhsd_view(shape, dtype=torch.bfloat16, offset=0, pad=0):
    """A [B, H, S, D] view in [B, S, H, D + pad] storage, ``offset`` elements
    into a 16-byte aligned buffer (llama's projections are such views)."""
    B, Hh, S, d = shape
    n = B * S * Hh * (d + pad)
    flat = torch.zeros(n + 64, dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    return flat[offset:offset + n].view(B, S, Hh, d + pad)[..., :d].transpose(1, 2)


# name: (q, k, v, accepted) for the kernels' input rule (kernel_input_error)
K5_INPUTS = {
    "d128": (lambda: (_bhsd_view((1, 4, 64, 128)),) + (_bhsd_view((1, 2, 64, 128)),) * 2,
             True),
    "d256": (lambda: (_bhsd_view((1, 4, 64, 256)),) + (_bhsd_view((1, 2, 64, 256)),) * 2,
             True),
    "d256_fp32": (lambda: (_bhsd_view((1, 4, 64, 256), torch.float32),) * 3, True),
    "d384": (lambda: (_bhsd_view((1, 2, 64, 384)),) * 3, True),
    "d512_fp32": (lambda: (_bhsd_view((1, 2, 64, 512), torch.float32),) * 3, True),
    "d320": (lambda: (_bhsd_view((1, 2, 64, 320)),) * 3, False),
    "d64": (lambda: (_bhsd_view((1, 2, 64, 64)),) * 3, False),
    "misaligned": (lambda: (_bhsd_view((1, 2, 64, 128), offset=4),) * 3, True),
    "stride_not_16_bytes": (lambda: (_bhsd_view((1, 2, 64, 128), pad=4),) * 3, True),
    "mixed_dtypes": (lambda: (_bhsd_view((1, 2, 64, 128), torch.float32),)
                     + (_bhsd_view((1, 2, 64, 128)),) * 2, False),
    "kvh_3_of_4": (lambda: (_bhsd_view((1, 4, 64, 128)),) + (_bhsd_view((1, 3, 64, 128)),) * 2,
                   False),
}


@pytest.mark.parametrize("case", list(K5_INPUTS))
def test_kernel_input_rule(case):
    """What K5-K5c take, decided from shapes and dtypes alone: D a multiple
    of 128 (JAX's rule sends every such D to its kernels) and one dtype. Any
    layout: a view TMA cannot read (misaligned, or strides not 16-byte
    multiples) is copied into a fresh tensor before the launch."""
    make, accepted = K5_INPUTS[case]
    err = tfa.kernel_input_error(*make())
    assert (err is None) == accepted, err
