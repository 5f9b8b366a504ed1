"""Speculative rounds in the port's engine (``draft_params``): the spec
tests of ``tests/test_batch_engine.py`` on the CPU at ``SliMEConfig.tiny()``,
target and an unrelated draft from the JAX package's random params through
``params.from_jax_numpy``.

Whatever the draft, greedy speculation emits the plain engine's tokens:
one slot, two slots batched in one round, a request joining mid-stream
(plain ticks interleave and reseed the draft), a multimodal request (the
draft sees pad in place of the image), a decode window smaller than the
pool, and a perfect draft (every proposal accepted). One test holds the
port's speculating engine to JAX's on the same params. fp32; tokens exact.
"""
import jax
import numpy as np
import pytest

from slime_tpu.config import SliMEConfig as JCfg
from slime_tpu.models import llama as jllama
from slime_tpu.models import slime as jslime
from slime_tpu.serve.batch_engine import BatchDecodeEngine as JEngine
from slime_tpu.serve.batch_engine import Request as JRequest
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import IMAGE_TOKEN_INDEX, SliMEConfig
from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request


def _jparams(seed):
    p = jax.device_get(jslime.init(jax.random.PRNGKey(seed), JCfg.tiny()))
    p["llm"]["layers"] = jax.device_get(jllama.stack_layers(p["llm"]["layers"]))
    return p


@pytest.fixture(scope="module")
def spec_setup():
    jt, jd = _jparams(0), _jparams(7)
    return (SliMEConfig.tiny(), bridge.from_jax_numpy(jt, device="cpu"),
            bridge.from_jax_numpy(jd, device="cpu"), jt, jd)


def _engines(spec_setup, max_slots=2, cache_len=128, draft=None, **kw):
    cfg, params, dparams, _, _ = spec_setup
    mk = lambda **extra: BatchDecodeEngine(params, cfg, max_slots=max_slots,  # noqa: E731
                                           cache_len=cache_len, device="cpu",
                                           prefix_cache_mb=0, **extra)
    return mk(), mk(draft_params=dparams if draft is None else draft, draft_cfg=cfg,
                    spec_k=3, **kw)


def _drain(req):
    return [t for chunk in req.stream() for t in chunk]


def _ticks(eng, n=100):
    for _ in range(n):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break


def _ids(cfg, rng, S):
    return rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 3])
def test_spec_engine_exact_vs_plain(spec_setup, seed):
    cfg = spec_setup[0]
    ids = _ids(cfg, np.random.default_rng(seed), 7)
    outs = []
    for eng in _engines(spec_setup):
        req = eng.submit(Request(input_ids=ids, max_new_tokens=10))
        _ticks(eng)
        outs.append(_drain(req))
    assert outs[1] == outs[0] and len(outs[0]) == 10
    # rounds take every token but the last (a budget of 1 takes a plain step)
    assert eng.spec_stats["slot_rounds"] == 8 and eng.decode_steps == 1


def test_spec_engine_multimodal_draft_is_text_only(spec_setup):
    cfg = spec_setup[0]
    rng = np.random.default_rng(2)
    ids = _ids(cfg, rng, 6)
    ids[1] = IMAGE_TOKEN_INDEX
    MC, t = 1 + cfg.max_local_crops, cfg.vision.image_size
    pix = rng.standard_normal((MC, 3, t, t)).astype(np.float32)
    cmask = np.ones((MC,), bool)
    outs = []
    for eng in _engines(spec_setup):
        req = eng.submit(Request(input_ids=ids, pixel_values=pix, crop_mask=cmask,
                                 max_new_tokens=8))
        _ticks(eng)
        outs.append(_drain(req))
    assert outs[1] == outs[0]
    assert eng.spec_stats["draft_prefills"] == 1


def test_spec_engine_batched_multi_slot(spec_setup):
    """Two greedy requests draft and verify in the same rounds; per-slot
    acceptance and rollback are independent."""
    cfg = spec_setup[0]
    rng = np.random.default_rng(4)
    ids = [_ids(cfg, rng, 5), _ids(cfg, rng, 6)]
    outs = []
    for eng in _engines(spec_setup):
        reqs = [eng.submit(Request(input_ids=i, max_new_tokens=6)) for i in ids]
        _ticks(eng)
        outs.append([_drain(r) for r in reqs])
    assert outs[1] == outs[0]
    assert eng.spec_stats["slot_rounds"] > eng.spec_stats["rounds"]


def test_spec_engine_staggered_admission(spec_setup):
    """A slot speculates alone, a second request joins (plain steps
    interleave and invalidate the first draft), then both speculate;
    budgets differ so one retires rounds before the other."""
    cfg = spec_setup[0]
    rng = np.random.default_rng(11)
    ids1, ids2 = _ids(cfg, rng, 6), _ids(cfg, rng, 4)
    outs = []
    for eng in _engines(spec_setup, max_slots=3, spec_rounds=4):
        r1 = eng.submit(Request(input_ids=ids1, max_new_tokens=14))
        eng.tick()
        eng.tick()
        r2 = eng.submit(Request(input_ids=ids2, max_new_tokens=5))
        _ticks(eng)
        outs.append((_drain(r1), _drain(r2)))
    assert outs[1] == outs[0]
    assert eng.spec_stats["draft_prefills"] >= 2


def test_spec_engine_windowed_exact(spec_setup):
    """Rounds with a decode window smaller than the pool (cache_len 1024,
    256-position window) stay exact."""
    cfg = spec_setup[0]
    ids = _ids(cfg, np.random.default_rng(11), 7)
    outs = []
    for eng in _engines(spec_setup, cache_len=1024):
        req = eng.submit(Request(input_ids=ids, max_new_tokens=10))
        _ticks(eng)
        outs.append(_drain(req))
    assert outs[1] == outs[0] and len(outs[0]) >= 1
    assert int(max(eng._host_len)) + eng.spec_rounds * 4 + 2 < 256


def test_spec_engine_perfect_draft_accepts_all(spec_setup):
    """The target as its own draft: every proposal accepted, K + 1 tokens a
    round, the plain engine's tokens."""
    cfg, params = spec_setup[:2]
    ids = _ids(cfg, np.random.default_rng(6), 6)
    outs = []
    for eng in _engines(spec_setup, draft=params):
        req = eng.submit(Request(input_ids=ids, max_new_tokens=13))
        _ticks(eng)
        outs.append(_drain(req))
    st = eng.spec_stats
    assert outs[1] == outs[0]
    assert st["accepted"] == 3 * st["slot_rounds"] == 9     # 12 tokens, 3 rounds of 4


def test_spec_engine_eos_mid_round(spec_setup):
    """An EOS inside an accepted run ends the request there, as the plain
    engine ends it."""
    import dataclasses

    cfg, params, dparams = spec_setup[:3]
    ids = _ids(cfg, np.random.default_rng(8), 7)
    plain = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128, device="cpu",
                              prefix_cache_mb=0)
    free = plain.submit(Request(input_ids=ids, max_new_tokens=12))
    _ticks(plain)
    toks = _drain(free)
    cfg_e = dataclasses.replace(cfg, eos_token_id=toks[5])
    outs = []
    for draft in (None, params):
        eng = BatchDecodeEngine(params, cfg_e, max_slots=2, cache_len=128, device="cpu",
                                prefix_cache_mb=0, draft_params=draft,
                                draft_cfg=cfg if draft is not None else None, spec_k=3)
        req = eng.submit(Request(input_ids=ids, max_new_tokens=12))
        _ticks(eng)
        outs.append(_drain(req))
    assert outs[0] == outs[1] == toks[:toks.index(toks[5])]
    assert all(s is None for s in eng.slots)


def test_spec_engine_matches_jax_spec_engine(spec_setup):
    """The slice against the JAX package: two staggered greedy requests
    through both speculating engines on the same params and draft."""
    cfg, params, dparams, jt, jd = spec_setup
    rng = np.random.default_rng(13)
    ids = [_ids(cfg, rng, 6), _ids(cfg, rng, 9)]

    def run(eng, req_cls):
        r1 = eng.submit(req_cls(input_ids=ids[0], max_new_tokens=12))
        eng.tick()
        r2 = eng.submit(req_cls(input_ids=ids[1], max_new_tokens=9))
        _ticks(eng)
        return _drain(r1), _drain(r2)
    jcfg = JCfg.tiny()
    want = run(JEngine(jt, jcfg, max_slots=2, cache_len=128, draft_params=jd, draft_cfg=jcfg,
                       spec_k=3), JRequest)
    eng = _engines(spec_setup)[1]
    assert run(eng, Request) == want
    assert eng.spec_stats["dispatches"] >= 1
