"""The int8 KV cache, ``prefill_chunk`` and per-slot sampling: the port
against the JAX package.

- ``quantize_kv`` byte for byte (zero heads included, fp32 and bf16 input);
- ``decode_step`` over an int8 cache, with and without ``window``, fused
  and not, against JAX's (its fused kernels in interpret mode);
- ``prefill_chunk`` non-fused on float and int8 caches at per-row offsets
  (B = 2, C = 5), and fused for dense, int8 and q4g weights against JAX's
  interpret-mode fused chunk; the automatic choice against JAX's rule with
  JAX told its backend is a TPU;
- ``sample_token(top_k)`` and ``sample_token_dynamic``: greedy rows exact,
  each filter's kept set equal to a numpy model of JAX's chain, JAX's draws
  over 256 keys inside the port's kept set;
- the engine's host-sampled first token: JAX's token and logprob entries for
  the same seed and logits.

Same seeded numpy inputs through both packages in fp32. Tolerance 1e-5
relative (1e-6 absolute floor) on logits and caches: the same rounding
points, fp32 sums in another order; int8 cache values and tokens equal.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu import generate as jgen
from slime_tpu.config import LLMConfig
from slime_tpu.models import llama as jllama
from slime_tpu.ops.quantization import quantize_params, quantize_weight
from slime_tpu.serve.batch_engine import BatchDecodeEngine as JEngine
from slime_tpu.serve.batch_engine import Request as JRequest
from slime_tpu_torch import generate as tgen
from slime_tpu_torch import params as bridge
from slime_tpu_torch.models import llama as tllama
from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine as TEngine
from slime_tpu_torch.serve.batch_engine import Request as TRequest

RTOL, ATOL = 1e-5, 1e-6
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _cfg(fmt="fp32"):
    if fmt == "q4g":                  # q4g needs contractions of 256
        return LLMConfig(vocab_size=96, hidden_size=256, intermediate_size=512,
                         num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                         max_position_embeddings=128)
    return LLMConfig(vocab_size=96, hidden_size=64, intermediate_size=256,
                     num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                     max_position_embeddings=128)


def _params(fmt="fp32", seed=0):
    """JAX LLM params (numpy leaves, stacked layers) with random norms; fmt
    'fp32', 'int8' (per-row int8 projections) or 'q4g'."""
    cfg = _cfg(fmt)
    r = np.random.default_rng(seed)
    p = jax.device_get(jllama.init(jax.random.PRNGKey(seed), cfg))
    for lp in p["layers"]:
        for n in ("input_layernorm", "post_attention_layernorm"):
            lp[n]["weight"] = (1 + 0.1 * r.standard_normal(cfg.hidden_size)).astype(np.float32)
        if fmt == "int8":
            for n in PROJ:
                lp[n]["weight"] = jax.device_get(quantize_weight(lp[n]["weight"], 8))
    if fmt == "q4g":
        p["layers"] = jax.device_get(quantize_params(p["layers"], 4, min_size=1024,
                                                     scheme="group"))
    p["layers"] = jax.device_get(jllama.stack_layers(p["layers"]))
    return p


def _caches(cfg, quantized, B=2, T=48, lengths=(3, 20), seed=1):
    """The same random cache for both packages; an int8 one is JAX's
    quantize_kv of the float one."""
    r = np.random.default_rng(seed)
    shape = (cfg.num_layers, B, T, cfg.num_kv_heads, cfg.head_dim)
    k0, v0 = ((r.standard_normal(shape) * 0.3).astype(np.float32) for _ in range(2))
    j = {"k": k0, "v": v0}
    if quantized:
        (kq, ks), (vq, vs) = (jax.device_get(jllama.quantize_kv(jnp.asarray(a)))
                              for a in (k0, v0))
        j = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    j["length"] = np.asarray(lengths, np.int32)
    t = {n: torch.from_numpy(np.array(a)) for n, a in j.items()}
    return {n: jnp.asarray(a) for n, a in j.items()}, t


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def _same_cache(tc, jc):
    for n in jc:
        if jc[n].dtype in (jnp.int8, jnp.int32):
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]), err_msg=n)
        else:
            _close(tc[n], jc[n])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    x = (np.random.default_rng(0).standard_normal((3, 7, 2, 32)) * 2).astype(np.float32)
    x[0, 1, 0] = 0.0                  # one zero head: scale 1, values 0
    x[2] = 0.0                        # whole zero rows
    jq, js = jllama.quantize_kv(jnp.asarray(x, dtype=getattr(jnp, dtype)))
    tq, ts = tllama.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 1, 0] == 1.0 and bool((ts[2] == 1.0).all())


def test_init_kv_cache_quantized_layout():
    cfg = _cfg()
    j = jllama.init_kv_cache(cfg, 3, 16, quantized=True)
    t = tllama.init_kv_cache(cfg, 3, 16, device="cpu", quantized=True)
    assert t.keys() == j.keys() and tllama.cache_quantized(t)
    for n in j:
        assert tuple(t[n].shape) == j[n].shape, n
        np.testing.assert_array_equal(t[n].numpy(), np.asarray(j[n]))
    assert t["k"].dtype == torch.int8 and t["k_scale"].dtype == torch.float32


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("window", [None, 32])
def test_decode_step_int8_cache_matches_jax(window, fused):
    """Three decode steps over an int8 cache; greedy tokens from JAX's
    logits feed both."""
    cfg, p = _cfg(), _params("int8", seed=2)
    jc, tc = _caches(cfg, quantized=True)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), bridge.from_jax_numpy(p, device="cpu")
    toks = np.array([5, 17], np.int32)
    for _ in range(3):
        jl, jc = jllama.decode_step(jp, jc, jnp.asarray(toks), cfg, window=window,
                                    fused=fused)
        tl, tc = tllama.decode_step(tp, tc, torch.from_numpy(toks).long(), cfg,
                                    window=window, fused=fused)
        _close(tl, jl)
        toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    _same_cache(tc, jc)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 40])
def test_prefill_chunk_matches_jax(quantized, window):
    """A 5-position chunk appended at each row's own length (3 and 20), then
    a second chunk: logits [B, C, V] and the caches."""
    cfg, p = _cfg(), _params("fp32", seed=3)
    jc, tc = _caches(cfg, quantized)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), bridge.from_jax_numpy(p, device="cpu")
    r = np.random.default_rng(4)
    for _ in range(2):
        chunk = (r.standard_normal((2, 5, cfg.hidden_size)) * 0.3).astype(np.float32)
        jl, jc = jllama.prefill_chunk(jp, jc, jnp.asarray(chunk), cfg, window=window,
                                      fused=False)
        tl, tc = tllama.prefill_chunk(tp, tc, torch.from_numpy(chunk), cfg, window=window)
        assert tuple(tl.shape) == (2, 5, cfg.vocab_size) and tl.dtype == torch.float32
        _close(tl, jl)
    _same_cache(tc, jc)


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
def test_prefill_chunk_fused_matches_jax(fmt):
    """fused=True on both sides: the chunk's [B * C, H] rows through K1-K3
    (their plain versions here, JAX's Pallas kernels in interpret mode), on
    an int8 cache for int8 weights and a float one otherwise."""
    cfg, p = _cfg(fmt), _params(fmt, seed=5)
    jc, tc = _caches(cfg, quantized=fmt == "int8", lengths=(7, 2))
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), bridge.from_jax_numpy(p, device="cpu")
    chunk = (np.random.default_rng(6).standard_normal((2, 5, cfg.hidden_size)) * 0.3
             ).astype(np.float32)
    jl, jc = jllama.prefill_chunk(jp, jc, jnp.asarray(chunk), cfg, fused=True)
    tl, tc = tllama.prefill_chunk(tp, tc, torch.from_numpy(chunk), cfg, fused=True)
    _close(tl, jl)
    _same_cache(tc, jc)


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
@pytest.mark.parametrize("B,C", [(1, 8), (1, 64), (1, 65), (2, 32), (2, 33), (4, 16),
                                 (1, 256)])
def test_chunk_rule_is_jax_rule(fmt, B, C, monkeypatch):
    """``chunk_takes_fused`` is JAX's automatic choice with "single-device
    TPU" read as "a CUDA device": JAX's prefill_chunk, told its backend is a
    TPU, takes its fused chunk for exactly the shapes the port's rule sends
    to K1-K3 on the card; on the CPU the port never does."""
    p = _params(fmt)
    cfg = _cfg(fmt)
    calls = []

    def stop(tag):
        def f(*a, **k):
            calls.append(tag)
            raise StopIteration
        return f
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jllama, "_prefill_chunk_fused", stop("fused"))
    monkeypatch.setattr(jllama, "rope_table", stop("plain"))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    with pytest.raises(StopIteration):
        jllama.prefill_chunk(jp, {"k": jnp.zeros((1, B, 8, 1, 1)),
                                  "length": jnp.zeros((B,), jnp.int32)},
                             jnp.zeros((B, C, cfg.hidden_size)), cfg)
    layers = bridge.from_jax_numpy(p, device="cpu")["layers"]
    shape = (B, C, cfg.hidden_size)
    assert calls == ["fused" if tllama.chunk_takes_fused(shape, "cuda", layers) else "plain"]
    assert tllama.chunk_takes_fused(shape, "cuda", layers) == (B * C <= 64)
    assert not tllama.chunk_takes_fused(shape, "cpu", layers)


# ------------------------------------------------------------------ sampling

def _logits(B=6, V=40, seed=7):
    # distinct, well-spaced values: no filter boundary sits on a rounding tie
    r = np.random.default_rng(seed)
    return np.stack([r.permutation(V) * 0.37 - 6.0 for _ in range(B)]).astype(np.float32)


def _np_kept(row, temp, top_p, top_k, min_p):
    """Numpy model of JAX's chain (generate.py:50-96) for one row: the tokens
    a draw can return."""
    V = row.size
    x = row / max(temp, 1e-6)
    s = np.sort(x)[::-1]
    keep = np.ones(V, bool)
    if top_k > 0:
        keep &= x >= s[min(top_k, V) - 1]
        s = np.where(np.arange(V) < top_k, s, -np.inf)
    p = np.exp(s - s[0])
    p /= p.sum()
    idx = int(np.sum(np.cumsum(p) - p < top_p)) - 1
    if top_p < 1.0:
        keep &= x >= s[idx]
    if min_p > 0.0:
        rp = np.where(keep, np.exp(x - x[keep].max()), 0.0)
        rp /= rp.sum()
        keep &= ~(rp < min_p * rp.max())
    return keep


# per row: (temperature, top_p, top_k, min_p)
KNOBS = [(0.0, 0.5, 3, 0.1), (1.0, 1.0, 0, 0.0), (0.7, 1.0, 5, 0.0),
         (1.3, 0.6, 0, 0.0), (1.0, 1.0, 0, 0.3), (0.9, 0.8, 12, 0.05)]


def test_sample_token_dynamic_kept_sets_and_greedy():
    logits = _logits()
    temp, top_p, top_k, min_p = (np.array(c, np.float32) for c in zip(*KNOBS))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    filt = tgen.dynamic_filter(t(logits), t(temp), t(top_p), t(top_k), t(min_p))
    for b, knobs in enumerate(KNOBS):
        want = _np_kept(logits[b], *knobs)
        np.testing.assert_array_equal(torch.isfinite(filt[b]).numpy(), want, err_msg=str(b))
    g = torch.Generator().manual_seed(0)
    draws = [tgen.sample_token_dynamic(t(logits), t(temp), t(top_p), t(top_k), t(min_p),
                                       generator=g) for _ in range(200)]
    assert all(int(d[0]) == int(np.argmax(logits[0])) for d in draws)   # greedy row
    for b in range(1, len(KNOBS)):
        got = {int(d[b]) for d in draws}
        assert got <= set(np.flatnonzero(_np_kept(logits[b], *KNOBS[b]))), b
    # JAX's draws over 256 keys fall inside the port's kept sets
    jl = jnp.asarray(logits)
    jargs = [jnp.asarray(a) for a in (temp, top_p, top_k, min_p)]
    for key in range(256):
        tok = np.asarray(jgen.sample_token_dynamic(jax.random.PRNGKey(key), jl, jargs[0],
                                                   jargs[1], top_k=jargs[2],
                                                   min_p=jargs[3]))
        for b in range(len(KNOBS)):
            assert bool(torch.isfinite(filt[b, tok[b]])), (key, b)
    # top_k / min_p None leave those filters out
    f2 = tgen.dynamic_filter(t(logits), t(temp), t(top_p))
    for b, (tp_, pp, _, _) in enumerate(KNOBS):
        np.testing.assert_array_equal(torch.isfinite(f2[b]).numpy(),
                                      _np_kept(logits[b], tp_, pp, 0, 0.0))


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (6, 0.5), (0, 0.5)])
def test_sample_token_top_k(top_k, top_p):
    logits = _logits(B=2, V=12)
    g = torch.Generator().manual_seed(1)
    seen = [set(), set()]
    for _ in range(300):
        tok = tgen.sample_token(torch.from_numpy(logits), temperature=1.0, top_p=top_p,
                                top_k=top_k, generator=g)
        for b in (0, 1):
            seen[b].add(int(tok[b]))
    for key in range(256):
        tok = np.asarray(jgen.sample_token(jax.random.PRNGKey(key), jnp.asarray(logits),
                                           temperature=1.0, top_p=top_p, top_k=top_k))
        for b in (0, 1):
            assert _np_kept(logits[b], 1.0, top_p, top_k, 0.0)[tok[b]], (key, b)
    for b in (0, 1):
        assert seen[b] == set(np.flatnonzero(_np_kept(logits[b], 1.0, top_p, top_k, 0.0)))
    greedy = tgen.sample_token(torch.from_numpy(logits), top_k=top_k)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(
        jgen.sample_token(None, jnp.asarray(logits), top_k=top_k)))


def _first_token_stub(engine_cls, seed, V):
    stub = types.SimpleNamespace(_np_rng=np.random.default_rng(seed), _vocab_size=V)
    stub._prompt_presence = lambda req: engine_cls._prompt_presence(stub, req)
    return stub


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.0, logprobs=3),
    dict(temperature=0.7, top_k=20, logprobs=2),
    dict(temperature=1.1, top_p=0.8, min_p=0.05, repetition_penalty=1.3, logprobs=4),
    dict(temperature=0.9, top_k=30, top_p=0.9, min_p=0.02, repetition_penalty=0.8,
         presence_penalty=0.5)])
def test_first_token_matches_jax(knobs):
    """Same seed, same logits rows, one request after another: the port's
    host sampler draws JAX's tokens and writes JAX's logprob entries."""
    V = 64
    r = np.random.default_rng(8)
    jstub, tstub = _first_token_stub(JEngine, 11, V), _first_token_stub(TEngine, 11, V)
    for i in range(12):
        ids = r.integers(0, V, (10,)).astype(np.int32)
        row = (r.standard_normal(V) * 2).astype(np.float32)
        jreq, treq = JRequest(input_ids=ids, **knobs), TRequest(input_ids=ids, **knobs)
        jtok, _ = JEngine._first_token(jstub, jreq, row)
        ttok = TEngine._first_token(tstub, treq, row)
        assert ttok == jtok, i
        assert treq.logprob_entries == jreq.logprob_entries
