"""Speculative decoding in the port (``serve/speculative.py``): the
counterparts of ``tests/test_speculative.py`` and ``tests/test_spec_sampling.py``
on the CPU at ``SliMEConfig.tiny()``, params from the JAX package through
``params.from_jax_numpy``.

- Greedy: the host loop and the device loop emit the target's own greedy
  tokens (the port's ``generate``, held to JAX's elsewhere) for perfect and
  unrelated drafts, respect the budget, emit the bonus token of a fully
  accepted round, and equal JAX's ``speculative_generate`` and its
  acceptance rate. Tokens exact, fp32.
- Sampled: ``warp_probs`` equals JAX's at 1e-6; ``rejection_round``'s first
  token is distributed as the target's p (total variation < 0.02 and a
  chi-square test at p > 1e-3 over 60000 draws, for close, far and uniform
  drafts); its acceptance follows the draft's quality; one-hot rows reduce
  exactly to the longest-matching-prefix rule. The torch generator's draws
  are not JAX's, so sampled tokens are held by distribution.
- The engine's sampled rounds: every token in the target's teacher-forced
  nucleus, and a greedy slot beside a sampled one emits the plain engine's
  tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.config import SliMEConfig as JCfg
from slime_tpu.models import llama as jllama
from slime_tpu.models import slime as jslime
from slime_tpu.serve import speculative as jspec
from slime_tpu_torch import generate as tgen
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import SliMEConfig
from slime_tpu_torch.models import llama
from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request
from slime_tpu_torch.serve.speculative import (rejection_round, speculative_generate,
                                               speculative_generate_device, warp_probs)


def _jparams(seed):
    p = jax.device_get(jslime.init(jax.random.PRNGKey(seed), JCfg.tiny()))
    p["llm"]["layers"] = jax.device_get(jllama.stack_layers(p["llm"]["layers"]))
    return p


@pytest.fixture(scope="module")
def models():
    jt, jd = _jparams(0), _jparams(42)
    target = bridge.from_jax_numpy(jt, device="cpu")
    bad = bridge.from_jax_numpy(jd, device="cpu")
    return SliMEConfig.tiny(), target, bad, jt, jd


def _ids(cfg, seed, S):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(5, cfg.llm.vocab_size, (1, S)).astype(np.int64))


def _ref(cfg, params, ids, n):
    toks = tgen.generate(params, cfg, ids, torch.ones_like(ids, dtype=torch.bool),
                         max_new_tokens=n)
    return tgen.trim_at_eos(toks, cfg.eos_token_id)[0]


@pytest.mark.parametrize("K", [2, 4])
def test_exactness_with_perfect_draft(models, K):
    cfg, target, _, _, _ = models
    ids = _ids(cfg, 0, 7)
    got, rate = speculative_generate(target, cfg, target, cfg, ids, K=K, max_new_tokens=12)
    assert tgen.trim_at_eos(got, cfg.eos_token_id)[0] == _ref(cfg, target, ids, 12)
    assert rate > 0.9


def test_exactness_with_bad_draft(models):
    cfg, target, bad, _, _ = models
    ids = _ids(cfg, 1, 6)
    got, rate = speculative_generate(target, cfg, bad, cfg, ids, K=3, max_new_tokens=10)
    assert tgen.trim_at_eos(got, cfg.eos_token_id)[0] == _ref(cfg, target, ids, 10), rate


def test_budget_respected(models):
    cfg, target, _, _, _ = models
    got, _ = speculative_generate(target, cfg, target, cfg, _ids(cfg, 2, 5), K=4,
                                  max_new_tokens=7)
    assert got.shape[1] <= 7


def test_full_acceptance_emits_bonus(models):
    """A perfect draft emits K + 1 tokens a round: acceptance 1.0."""
    cfg, target, _, _, _ = models
    ids = _ids(cfg, 3, 7)
    got, rate = speculative_generate(target, cfg, target, cfg, ids, K=3, max_new_tokens=12)
    got_t = tgen.trim_at_eos(got, cfg.eos_token_id)[0]
    assert got_t == _ref(cfg, target, ids, 12)
    if len(got_t) == 12:
        assert rate == 1.0


def test_device_loop_matches_host_loop(models, monkeypatch):
    """The device loop (its end read every round, or every 3) emits the
    host loop's tokens and acceptance rate."""
    from slime_tpu_torch.serve import speculative
    cfg, target, bad, _, _ = models
    ids = _ids(cfg, 4, 6)
    ref = _ref(cfg, target, ids, 10)
    for K, every in ((2, 1), (3, 3)):
        monkeypatch.setattr(speculative, "ROUNDS_PER_SYNC", every)
        host, hrate = speculative_generate(target, cfg, bad, cfg, ids, K=K, max_new_tokens=10)
        got, rate = speculative_generate_device(target, cfg, bad, cfg, ids, K=K,
                                                max_new_tokens=10)
        assert tgen.trim_at_eos(got, cfg.eos_token_id)[0] == ref, (K, every)
        np.testing.assert_array_equal(got, host)
        assert rate == hrate


def test_device_loop_full_acceptance(models):
    cfg, target, _, _, _ = models
    ids = _ids(cfg, 5, 7)
    got, rate = speculative_generate_device(target, cfg, target, cfg, ids, K=3,
                                            max_new_tokens=12)
    got_t = tgen.trim_at_eos(got, cfg.eos_token_id)[0]
    assert got_t == _ref(cfg, target, ids, 12) and got.shape[1] <= 12
    if len(got_t) == 12:
        assert rate == 1.0


def test_eos_cut_matches_jax(models):
    """An EOS inside an accepted run ends the output after it, in both loops,
    as in JAX's: the target's 4th greedy token is made the EOS id."""
    cfg, target, bad, jt, jd = models
    ids = _ids(cfg, 6, 7)
    eos = _ref(cfg, target, ids, 8)[3]
    for fn in (speculative_generate, speculative_generate_device):
        got, _ = fn(target, cfg, target, cfg, ids, K=3, max_new_tokens=12, eos_id=eos)
        want, _ = getattr(jspec, fn.__name__)(jt, JCfg.tiny(), jt, JCfg.tiny(),
                                              jnp.asarray(ids.numpy().astype(np.int32)),
                                              K=3, max_new_tokens=12, eos_id=eos)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got[0, -1] == eos


def test_matches_jax_speculative_generate(models):
    """The port's host and device loops against JAX's on the same params:
    the same tokens and the same acceptance rate."""
    cfg, target, bad, jt, jd = models
    jcfg = JCfg.tiny()
    ids = _ids(cfg, 7, 6)
    jids = jnp.asarray(ids.numpy().astype(np.int32))
    for fn in (speculative_generate, speculative_generate_device):
        got, rate = fn(target, cfg, bad, cfg, ids, K=3, max_new_tokens=10)
        want, jrate = getattr(jspec, fn.__name__)(jt, jcfg, jd, jcfg, jids, K=3,
                                                  max_new_tokens=10)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert rate == jrate


# ------------------------------------------------------------------ sampled

def test_warp_probs_matches_jax():
    """Greedy, nucleus and plain-temperature rows, [B, V] and [B, K+1, V],
    against JAX's warp_probs at 1e-6."""
    rng = np.random.default_rng(2)
    for shape in ((3, 12), (3, 5, 40)):
        logits = (rng.standard_normal(shape) * 2).astype(np.float32)
        temps = np.asarray([0.0, 1.0, 0.7], np.float32)
        tps = np.asarray([1.0, 0.6, 1.0], np.float32)
        got = warp_probs(torch.from_numpy(logits), torch.from_numpy(temps),
                         torch.from_numpy(tps)).numpy()
        want = np.asarray(jspec.warp_probs(jnp.asarray(logits), jnp.asarray(temps),
                                           jnp.asarray(tps)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert np.abs(got[0].sum(-1) - 1).max() < 1e-6


def _tv(counts, p):
    return 0.5 * np.abs(counts / counts.sum() - p).sum()


@pytest.mark.parametrize("qshape", ["close", "far", "uniform"])
def test_first_token_distribution_exact(qshape):
    """The first emitted token is distributed as p_0, for good and bad
    drafts: total variation and a chi-square test over 60000 draws."""
    from scipy.stats import chisquare

    V, K, B, N = 16, 3, 500, 60_000
    rng = np.random.default_rng({"close": 1, "far": 2, "uniform": 3}[qshape])
    logits_p = rng.standard_normal((V,)).astype(np.float32) * 1.5
    p = np.exp(logits_p - logits_p.max())
    p /= p.sum()
    if qshape == "close":
        q = p * np.exp(rng.standard_normal(V) * 0.2)
    elif qshape == "far":
        q = np.exp(rng.standard_normal(V))
    else:
        q = np.ones(V)
    q = (q / q.sum()).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    p_rows = torch.from_numpy(p.astype(np.float32)).expand(B, K + 1, V)
    q_rows = torch.from_numpy(q).expand(B, K, V)
    counts = np.zeros(V)
    for _ in range(N // B):
        props = torch.multinomial(q_rows.reshape(-1, V), 1, generator=g).reshape(B, K)
        toks, _ = rejection_round(g, props.to(torch.int32), q_rows, p_rows)
        np.add.at(counts, toks[:, 0].numpy(), 1)
    assert _tv(counts, p) < 0.02, qshape
    p64 = p.astype(np.float64) / p.sum(dtype=np.float64)
    assert chisquare(counts, p64 * counts.sum()).pvalue > 1e-3, qshape


def test_acceptance_rate_scales_with_draft_quality():
    V, K, B = 16, 4, 2048
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(V)).astype(np.float32)
    p_rows = torch.from_numpy(p).expand(B, K + 1, V)
    g = torch.Generator().manual_seed(1)

    def run(q):
        q_rows = torch.from_numpy(q.astype(np.float32)).expand(B, K, V)
        props = torch.multinomial(q_rows.reshape(-1, V), 1, generator=g).reshape(B, K)
        return float(rejection_round(g, props.to(torch.int32), q_rows, p_rows)[1]
                     .float().mean())
    assert run(p) > K * 0.95
    bad = np.zeros(V, np.float32)
    bad[np.argsort(p)[:4]] = 0.25
    assert run(bad) < 1.5


def test_greedy_rows_reduce_to_prefix_matching():
    V, K, B = 8, 3, 4
    props = torch.tensor([[1, 2, 3], [1, 1, 3], [4, 4, 4], [0, 0, 0]], dtype=torch.int32)
    tgt = np.array([[1, 2, 3, 5], [1, 2, 3, 5], [4, 4, 0, 6], [7, 1, 2, 3]])
    q_rows = torch.zeros((B, K, V))
    p_rows = torch.zeros((B, K + 1, V))
    for b in range(B):
        for i in range(K):
            q_rows[b, i, int(props[b, i])] = 1.0
        for i in range(K + 1):
            p_rows[b, i, tgt[b, i]] = 1.0
    toks, acc = rejection_round(torch.Generator().manual_seed(0), props, q_rows, p_rows)
    assert acc.tolist() == [3, 1, 2, 0]
    for b in range(B):
        a = int(acc[b])
        assert toks[b, :a].tolist() == props[b, :a].tolist()
        assert int(toks[b, a]) == tgt[b, a]


# ------------------------------------------------------------ engine level

def _drain(req):
    return [t for chunk in req.stream() for t in chunk]


def _run(eng, reqs, ticks=120):
    for r in reqs:
        eng.submit(r)
    for _ in range(ticks):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    return [_drain(r) for r in reqs]


def _spec_engine(models, **kw):
    cfg, target, _, _, _ = models
    draft = bridge.from_jax_numpy(_jparams(7), device="cpu")
    return BatchDecodeEngine(target, cfg, max_slots=2, cache_len=128, device="cpu",
                             prefix_cache_mb=0, draft_params=draft, draft_cfg=cfg,
                             spec_k=3, **kw)


def test_sampled_spec_tokens_stay_in_nucleus(models):
    """A sampled request takes the speculative rounds, and each token lies in
    the nucleus of the target's warped distribution at its step."""
    cfg, target, _, _, _ = models
    ids = np.random.default_rng(0).integers(5, cfg.llm.vocab_size, (6,)).astype(np.int32)
    top_p = 0.8
    eng = _spec_engine(models, seed=5)
    got = _run(eng, [Request(input_ids=ids, max_new_tokens=8, temperature=1.0,
                             top_p=top_p)])[0]
    assert eng.spec_stats["dispatches"] >= 1 and len(got) == 8
    full = torch.from_numpy(np.concatenate([ids, np.asarray(got, np.int32)])[None]
                            .astype(np.int64))
    logits = llama.forward(target["llm"], llama.embed(target["llm"], full),
                           cfg.llm)[0][0].double().numpy()
    for j, tok in enumerate(got):
        row = logits[len(ids) - 1 + j]
        order = np.argsort(row)[::-1]
        pr = np.exp(row[order] - row[order][0])
        pr /= pr.sum()
        assert tok in set(order[(np.cumsum(pr) - pr) < top_p].tolist()), (j, tok)


def test_mixed_greedy_and_sampled_spec_batch(models):
    """A greedy slot beside a sampled one in the sampling rounds emits the
    plain engine's greedy tokens (one-hot rows reduce to prefix matching)."""
    cfg, target, _, _, _ = models
    rng = np.random.default_rng(1)
    ids_g = rng.integers(5, cfg.llm.vocab_size, (7,)).astype(np.int32)
    ids_s = rng.integers(5, cfg.llm.vocab_size, (7,)).astype(np.int32)
    plain = BatchDecodeEngine(target, cfg, max_slots=2, cache_len=128, device="cpu",
                              prefix_cache_mb=0)
    ref = _run(plain, [Request(input_ids=ids_g, max_new_tokens=8)])[0]
    eng = _spec_engine(models)
    out_g, out_s = _run(eng, [Request(input_ids=ids_g, max_new_tokens=8),
                              Request(input_ids=ids_s, max_new_tokens=8, temperature=0.9)])
    assert out_g == ref and len(out_s) >= 1
    assert eng.spec_stats["dispatches"] >= 1
