"""The port's continuous-batching engine (``slime_tpu_torch.serve``): the
counterparts of ``tests/test_batch_engine.py``, ``test_kv_quant.py``'s
engine test and ``test_prefix_cache.py``'s exactness tests, on the CPU at
``SliMEConfig.tiny()`` with the JAX package's random params carried across by
``params.from_jax_numpy`` (layers stacked).

The engine's greedy tokens must equal ``generate``'s for the same prompt,
token for token, whatever the batching, chunking, decode windows, overlap,
KV pool or prefix-cache hits did. One test holds the whole slice to the JAX
package: three staggered requests against JAX's ``generate`` on the same
params. fp32 throughout; tokens are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu import generate as jgen
from slime_tpu.config import SliMEConfig as JCfg
from slime_tpu.models import llama as jllama
from slime_tpu.models import slime as jslime
from slime_tpu_torch import generate as tgen
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import IMAGE_TOKEN_INDEX, SliMEConfig
from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request


@pytest.fixture(scope="module")
def setup():
    p = jax.device_get(jslime.init(jax.random.PRNGKey(0), JCfg.tiny()))
    p["llm"]["layers"] = jax.device_get(jllama.stack_layers(p["llm"]["layers"]))
    return SliMEConfig.tiny(), bridge.from_jax_numpy(p, device="cpu"), p


def _engine(setup, **kw):
    cfg, params, _ = setup
    kw.setdefault("max_slots", 4)
    kw.setdefault("cache_len", 128)
    kw.setdefault("prefix_cache_mb", 0)
    return BatchDecodeEngine(params, cfg, device="cpu", **kw)


def _ids(cfg, rng, S):
    return rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)


def _ref(setup, ids, n, pixel_values=None, crop_mask=None, **kw):
    """The port's greedy ``generate`` for one prompt (tests/test_torch_slice.py
    holds it to JAX's)."""
    cfg, params, _ = setup
    ids_t = torch.from_numpy(ids[None].astype(np.int64))
    px = None if pixel_values is None else torch.from_numpy(pixel_values[None])
    cm = None if crop_mask is None else torch.from_numpy(crop_mask[None])
    return tgen.generate(params, cfg, ids_t, torch.ones_like(ids_t, dtype=torch.bool), px,
                         cm, max_new_tokens=n, eos_id=-1, **kw)[0].tolist()


def _drain(req):
    return [t for chunk in req.stream() for t in chunk]


def _run(eng, reqs, ticks=200):
    for r in reqs:
        eng.submit(r)
    for _ in range(ticks):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    return [_drain(r) for r in reqs]


def _mm(cfg, rng, pre=2, post=5):
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = np.concatenate([_ids(cfg, rng, pre), [IMAGE_TOKEN_INDEX], _ids(cfg, rng, post)]
                         ).astype(np.int32)
    return ids, rng.standard_normal((MC, 3, t, t)).astype(np.float32), np.ones((MC,), bool)


def test_batched_matches_single(setup):
    cfg = setup[0]
    rng = np.random.default_rng(0)
    ids = [_ids(cfg, rng, 5 + 2 * i) for i in range(3)]
    got = _run(_engine(setup), [Request(input_ids=i, max_new_tokens=6) for i in ids])
    assert got == [_ref(setup, i, 6) for i in ids]


def test_engine_matches_jax_generate(setup):
    """The slice against the JAX package: three requests, the third
    submitted while the first two decode, each equal to JAX's greedy
    generate on the same params."""
    cfg, _, jp = setup
    jcfg = JCfg.tiny()
    rng = np.random.default_rng(13)
    ids = [_ids(cfg, rng, S) for S in (6, 11, 9)]
    want = [np.asarray(jgen.generate(jp, jcfg, jnp.asarray(i[None]),
                                     jnp.ones((1, i.size), bool), max_new_tokens=12,
                                     eos_id=-1))[0].tolist() for i in ids]
    eng = _engine(setup)
    reqs = [Request(input_ids=i, max_new_tokens=12) for i in ids]
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    for _ in range(3):
        eng.tick()
    got = _run(eng, reqs[2:])
    assert [_drain(reqs[0]), _drain(reqs[1])] + got == want


def test_top_p_tiny_equals_greedy(setup):
    """top_p -> 0 keeps only the most likely token (the exclusive-cum rule
    keeps the cutoff token), so sampling emits the greedy sequence, the
    host-sampled first token included."""
    cfg = setup[0]
    ids = _ids(cfg, np.random.default_rng(9), 6)

    def run(**kw):
        return _run(_engine(setup, max_slots=2, seed=5),
                    [Request(input_ids=ids, max_new_tokens=7, **kw)])[0]
    greedy = run()
    assert run(temperature=0.8, top_p=1e-9) == greedy and len(greedy) == 7


def test_sampling_knobs_repeat_per_seed(setup):
    """Filters, penalties and logprobs on the in-graph path: tokens in range,
    the same seed gives the same tokens, logprob entries one per token."""
    cfg = setup[0]
    ids = _ids(cfg, np.random.default_rng(10), 7)
    knobs = dict(temperature=0.9, top_k=20, top_p=0.9, min_p=0.02,
                 repetition_penalty=1.2, presence_penalty=0.3, frequency_penalty=0.1,
                 logprobs=3)

    def run(seed):
        req = Request(input_ids=ids, max_new_tokens=9, **knobs)
        return _run(_engine(setup, max_slots=2, seed=seed), [req])[0], req
    (a, ra), (b, _) = run(3), run(3)
    assert a == b and len(a) == 9 and all(0 <= t < cfg.llm.vocab_size for t in a)
    assert len(ra.logprob_entries) == 9
    assert all(e["logprob"] <= 0 and len(e["top"]) == 3 for e in ra.logprob_entries)


def test_greedy_logprobs(setup):
    """Greedy logprobs: each token is its step's top alternative, and the
    packed floats come back as log-probabilities."""
    cfg = setup[0]
    req = Request(input_ids=_ids(cfg, np.random.default_rng(14), 6), max_new_tokens=10,
                  logprobs=2)
    got = _run(_engine(setup, max_slots=2), [req])[0]
    assert len(req.logprob_entries) == len(got) == 10
    for tok, e in zip(got, req.logprob_entries):
        assert e["top"][0][0] == tok and abs(e["top"][0][1] - e["logprob"]) < 1e-6
        assert e["top"][0][1] >= e["top"][1][1] and e["logprob"] <= 0


def test_metrics_summary(setup):
    cfg = setup[0]
    eng = _engine(setup, max_slots=2, cache_len=96)
    assert eng.metrics_summary() == {"completed": 0}
    rng = np.random.default_rng(21)
    for _ in range(2):
        _run(eng, [Request(input_ids=_ids(cfg, rng, 6), max_new_tokens=4)])
    m = eng.metrics_summary()
    assert m["completed"] == 2 and m["tokens"] == 8
    assert m["ttft_p50_s"] >= 0 and m["decode_tok_s_per_req"] > 0


def test_slot_reuse(setup):
    cfg = setup[0]
    rng = np.random.default_rng(1)
    ids = [_ids(cfg, rng, 6) for _ in range(6)]
    got = _run(_engine(setup), [Request(input_ids=i, max_new_tokens=3) for i in ids])
    assert got == [_ref(setup, i, 3) for i in ids]


def test_multimodal_request(setup):
    """A multimodal request beside a text one: the fusion runs at
    admission, and both match generate."""
    cfg = setup[0]
    rng = np.random.default_rng(2)
    ids, px, cm = _mm(cfg, rng)
    text = _ids(cfg, rng, 7)
    got = _run(_engine(setup, cache_len=256),
               [Request(input_ids=ids, pixel_values=px, crop_mask=cm, max_new_tokens=4),
                Request(input_ids=text, max_new_tokens=4)])
    assert got == [_ref(setup, ids, 4, px, cm), _ref(setup, text, 4)]


def test_chunked_admission_matches_single(setup):
    """A long prompt admitted in 8-position chunks (the padded tail
    included) decodes as generate does."""
    cfg = setup[0]
    eng = _engine(setup, max_slots=2, cache_len=96)
    eng.prefill_chunk_len = 8
    ids = _ids(cfg, np.random.default_rng(7), 21)
    assert _run(eng, [Request(input_ids=ids, max_new_tokens=5)])[0] == _ref(setup, ids, 5)
    assert eng.chunk_rows == {8: 3}


def test_window_bucketing_exact(setup):
    """Short prompts in a 1024-position pool read only the first 256 cache
    positions per step; tokens do not change."""
    cfg = setup[0]
    eng = _engine(setup, cache_len=1024)
    rng = np.random.default_rng(7)
    ids = [_ids(cfg, rng, 6 + i) for i in range(3)]
    got = _run(eng, [Request(input_ids=i, max_new_tokens=5) for i in ids])
    assert int(max(eng._host_len)) < 256 <= eng.cache_len
    assert got == [_ref(setup, i, 5) for i in ids]


def test_overlapped_decode_exact(setup):
    """The overlapped tick (one dispatch in flight, the previous one read
    while the next runs) drops and repeats no token across flushes: budget
    40 >> multi_step, a second request mid-stream, retirement at the end."""
    cfg = setup[0]
    rng = np.random.default_rng(11)
    ids1, ids2 = _ids(cfg, rng, 7), _ids(cfg, rng, 9)
    eng = _engine(setup, max_slots=2, cache_len=256)
    r1 = eng.submit(Request(input_ids=ids1, max_new_tokens=40))
    for _ in range(4):
        eng.tick()
    assert eng._inflight is not None, "overlap did not engage"
    got2 = _run(eng, [Request(input_ids=ids2, max_new_tokens=24)])[0]
    assert eng._inflight is None
    assert _drain(r1) == _ref(setup, ids1, 40)
    assert got2 == _ref(setup, ids2, 24)


def test_multi_step_change_in_flight(setup):
    """A dispatch is read in its own layout: changing ``multi_step`` while
    one is in flight (as a tuning caller may) changes no token."""
    cfg = setup[0]
    ids = _ids(cfg, np.random.default_rng(17), 8)
    eng = _engine(setup, max_slots=2, cache_len=256)
    req = eng.submit(Request(input_ids=ids, max_new_tokens=30, logprobs=1))
    for k in (8, 8, 3, 1, 5):
        eng.multi_step = k
        eng.tick()
    for _ in range(100):
        if eng.tick() == 0:
            break
    assert _drain(req) == _ref(setup, ids, 30)
    assert len(req.logprob_entries) == 30


def test_cancel_active_slot_frees_capacity(setup):
    cfg = setup[0]
    rng = np.random.default_rng(11)
    eng = _engine(setup)
    long_req = eng.submit(Request(input_ids=_ids(cfg, rng, 6), max_new_tokens=64))
    for _ in range(3):
        eng.tick()
    assert any(s is not None and s.req is long_req for s in eng.slots)
    eng.cancel(long_req.request_id)
    eng.tick()
    assert not any(s is not None and s.req is long_req for s in eng.slots)
    assert long_req.cancelled and len(_drain(long_req)) < 64
    nxt = Request(input_ids=_ids(cfg, rng, 5), max_new_tokens=3)
    assert len(_run(eng, [nxt])[0]) == 3 and not nxt.cancelled


def test_cancel_pending_request_never_admits(setup):
    cfg = setup[0]
    rng = np.random.default_rng(12)
    eng = _engine(setup)
    fill = [Request(input_ids=_ids(cfg, rng, 6), max_new_tokens=32)
            for _ in range(eng.max_slots)]
    queued = Request(input_ids=_ids(cfg, rng, 6), max_new_tokens=32)
    for r in fill + [queued]:
        eng.submit(r)
    for _ in range(6):
        eng.tick()
    eng.cancel(queued.request_id)
    for r in fill:
        eng.cancel(r.request_id)
    for _ in range(10):
        if eng.tick() == 0 and eng.pending.empty():
            break
    assert queued.cancelled and _drain(queued) == []
    assert all(s is None for s in eng.slots)


def test_start_stop_serves_a_request(setup):
    cfg = setup[0]
    ids = _ids(cfg, np.random.default_rng(15), 6)
    eng = _engine(setup)
    eng.start()
    try:
        got = _drain(eng.submit(Request(input_ids=ids, max_new_tokens=5)))
    finally:
        eng.stop()
    assert got == _ref(setup, ids, 5)


def test_engine_kv_quant(setup):
    """The int8 pool: int8 cache, generate(kv_quant=True)'s tokens, and the
    float generate's first token (the prefill does not read the cache)."""
    cfg = setup[0]
    eng = _engine(setup, max_slots=2, cache_len=64, kv_quant=True)
    assert eng.cache["k"].dtype == torch.int8 and "k_scale" in eng.cache
    ids = _ids(cfg, np.random.default_rng(4), 6)
    got = _run(eng, [Request(input_ids=ids, max_new_tokens=8)])[0]
    assert got == _ref(setup, ids, 8, kv_quant=True)
    assert got[0] == _ref(setup, ids, 1)[0]


def test_refusals_and_unserved_requests(setup):
    """A one-process mesh serves the plain engine's tokens (tensor
    parallelism is ported; ``test_torch_tp_serving.py`` runs it on several
    ranks); a draft without its config raises; an adapter
    that is not stacked [L, ...] is refused; requests naming an
    unregistered grammar or adapter fail, as JAX fails an unknown id;
    params elsewhere than the engine's device raise."""
    cfg, params, _ = setup
    with pytest.raises(ValueError):
        BatchDecodeEngine(params, cfg, device="cpu", draft_params=params)
    from slime_tpu_torch.parallel.mesh import make_mesh
    ids = _ids(cfg, np.random.default_rng(17), 6)
    one = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128, device="cpu",
                            prefix_cache_mb=0, mesh=make_mesh(device="cpu"))
    assert _run(one, [Request(input_ids=ids, max_new_tokens=5)]) == \
        _run(_engine(setup), [Request(input_ids=ids, max_new_tokens=5)])
    eng = _engine(setup)
    with pytest.raises(ValueError, match="stacked"):
        eng.register_adapter({"rank": 2, "alpha": 2, "adapters": {"llm/layers/0/q_proj": {
            "A": torch.zeros((2, cfg.llm.hidden_size)),
            "B": torch.zeros((cfg.llm.hidden_size, 2))}}})
    ids = _ids(cfg, np.random.default_rng(16), 5)
    bad = [Request(input_ids=ids, grammar_id=0), Request(input_ids=ids, adapter_id=1),
           Request(input_ids=ids, prefix_id="unknown"),
           Request(input_ids=_ids(cfg, np.random.default_rng(0), 130))]
    assert _run(eng, bad) == [[], [], [], []]
    with pytest.raises(ValueError):
        BatchDecodeEngine(params, cfg, device="meta")


# ------------------------------------------------------------ prefix cache

def test_prefix_cache_hit_emits_identical_tokens(setup):
    cfg = setup[0]
    ids = _ids(cfg, np.random.default_rng(0), 40)
    eng = _engine(setup, max_slots=2, prefix_cache_mb=512, prefix_block=16)
    first = _run(eng, [Request(input_ids=ids, max_new_tokens=6)])[0]
    assert eng.prefix_cache_stats()["inserted_blocks"] == 2
    second = _run(eng, [Request(input_ids=ids, max_new_tokens=6)])[0]
    st = eng.prefix_cache_stats()
    assert st["hits"] == 1 and st["matched_tokens"] == 32
    assert second == first == _ref(setup, ids, 6)


def test_prefix_cache_partial_hit_diverging_suffix(setup):
    cfg = setup[0]
    rng = np.random.default_rng(1)
    ids1 = _ids(cfg, rng, 40)
    ids2 = ids1.copy()
    ids2[33:] = _ids(cfg, rng, 7)
    eng = _engine(setup, max_slots=2, prefix_cache_mb=512, prefix_block=16)
    _run(eng, [Request(input_ids=ids1, max_new_tokens=4)])
    got = _run(eng, [Request(input_ids=ids2, max_new_tokens=6)])[0]
    assert eng.prefix_cache_stats()["matched_tokens"] == 32
    assert got == _ref(setup, ids2, 6)


def test_prefix_cache_hit_skips_prefill(setup):
    """A full hit prefills only the suffix: one 16-position chunk instead of
    three."""
    cfg = setup[0]
    ids = _ids(cfg, np.random.default_rng(2), 48)
    eng = _engine(setup, max_slots=2, prefix_cache_mb=512, prefix_block=16)
    eng.prefill_chunk_len = 16
    _run(eng, [Request(input_ids=ids, max_new_tokens=3)])
    assert eng.chunk_rows == {16: 3}
    _run(eng, [Request(input_ids=ids, max_new_tokens=3)])
    assert eng.chunk_rows == {16: 4}


def test_prefix_cache_quantized_pool_hit_exact(setup):
    cfg = setup[0]
    ids = _ids(cfg, np.random.default_rng(3), 40)

    def run(mb):
        eng = _engine(setup, max_slots=2, kv_quant=True, prefix_cache_mb=mb,
                      prefix_block=16)
        a = _run(eng, [Request(input_ids=ids, max_new_tokens=5)])[0]
        b = _run(eng, [Request(input_ids=ids, max_new_tokens=5)])[0]
        return a, b, eng
    a, b, eng = run(512)
    assert eng.prefix_cache_stats()["hits"] == 1 and a == b
    assert run(0)[:2] == (a, a)


def test_explicit_prefix_matches_full_prompt(setup):
    """register_prefix + suffix-only admission gives the tokens of the
    concatenated prompt, for suffixes shorter and longer than the chunk, and
    never touches the automatic cache."""
    cfg = setup[0]
    rng = np.random.default_rng(7)
    eng = _engine(setup, prefix_cache_mb=512, prefix_block=8)
    prefix = _ids(cfg, rng, 9)
    pid = eng.register_prefix(prefix)
    eng.prefill_chunk_len = 8
    for S in (4, 20):
        suffix = _ids(cfg, rng, S)
        got = _run(eng, [Request(input_ids=suffix, max_new_tokens=6, prefix_id=pid)])[0]
        assert got == _ref(setup, np.concatenate([prefix, suffix]), 6), S
    st = eng.prefix_cache_stats()
    assert st["inserted_blocks"] == 0 and st["hits"] == 0


def test_prefix_with_multimodal_suffix(setup):
    cfg = setup[0]
    rng = np.random.default_rng(9)
    eng = _engine(setup, cache_len=256)
    prefix = _ids(cfg, rng, 6)
    pid = eng.register_prefix(prefix)
    sfx, px, cm = _mm(cfg, rng)
    got = _run(eng, [Request(input_ids=sfx, pixel_values=px, crop_mask=cm,
                             max_new_tokens=4, prefix_id=pid)])[0]
    assert got == _ref(setup, np.concatenate([prefix, sfx]), 4, px, cm)


def test_multimodal_prefix_cache_hit_exact(setup):
    """Turn 2 of an image chat (turn 1's prompt + more text, same image)
    reuses the fused identity prefix, and both turns emit a cache-free
    engine's tokens; a text prompt sharing the pre-image text hits too."""
    cfg = setup[0]
    rng = np.random.default_rng(5)
    ids1, px, cm = _mm(cfg, rng, pre=10, post=12)
    ids2 = np.concatenate([ids1, _ids(cfg, rng, 9)])
    eng = _engine(setup, max_slots=2, cache_len=256, prefix_cache_mb=512, prefix_block=8)
    out1 = _run(eng, [Request(input_ids=ids1, pixel_values=px, crop_mask=cm,
                              max_new_tokens=4)])[0]
    assert eng.prefix_cache_stats()["inserted_blocks"] > 0
    out2 = _run(eng, [Request(input_ids=ids2, pixel_values=px, crop_mask=cm,
                              max_new_tokens=5)])[0]
    st = eng.prefix_cache_stats()
    assert st["hits"] == 1 and st["matched_tokens"] >= 8 + cfg.vision.num_patches
    text = np.concatenate([ids1[:10], _ids(cfg, rng, 6)])
    out3 = _run(eng, [Request(input_ids=text, max_new_tokens=3)])[0]
    assert eng.prefix_cache_stats()["hits"] == 2
    assert out1 == _ref(setup, ids1, 4, px, cm)
    assert out2 == _ref(setup, ids2, 5, px, cm)
    assert out3 == _ref(setup, text, 3)
