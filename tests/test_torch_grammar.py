"""Constrained decoding in the port's engine (``register_grammar``, the
grammar mask and automaton in ``_decode`` / ``_step_k``, the host-masked
first token): the counterparts of ``tests/test_constrained_decode.py`` on
the CPU at ``SliMEConfig.tiny()``, with the JAX package's random params
carried across by ``params.from_jax_numpy``, over the port's own copy of
``serve/grammar.py``.

Outputs must match the registered regex greedy and sampled, over multi-step
dispatches, beside free slots (whose tokens stay the grammar-free engine's),
for choices and JSON schemas; an unknown grammar id fails its request, not
the engine. One test holds the port's constrained greedy tokens to JAX's
engine on the same params. fp32; tokens compared exactly.
"""
import json
import re

import jax
import numpy as np
import pytest

from slime_tpu.config import SliMEConfig as JCfg
from slime_tpu.models import llama as jllama
from slime_tpu.models import slime as jslime
from slime_tpu.serve import grammar as jgrammar
from slime_tpu.serve.batch_engine import BatchDecodeEngine as JEngine
from slime_tpu.serve.batch_engine import Request as JRequest
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import SliMEConfig
from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request
from slime_tpu_torch.serve.grammar import (choices_regex, compile_regex, compile_token_dfa,
                                           json_schema_regex)


@pytest.fixture(scope="module")
def setup():
    p = jax.device_get(jslime.init(jax.random.PRNGKey(0), JCfg.tiny()))
    p["llm"]["layers"] = jax.device_get(jllama.stack_layers(p["llm"]["layers"]))
    return SliMEConfig.tiny(), bridge.from_jax_numpy(p, device="cpu"), p


def _vocab(cfg):
    """Printable byte-string tokens, id i -> alphabet[i % 18], EOS "</s>"
    (test_constrained_decode.py's vocabulary)."""
    alphabet = [b"a", b"b", b"c", b"d", b"0", b"1", b"2", b".", b",",
                b" ", b"yes", b"no", b'"', b"{", b"}", b":", b"n", b"-"]
    vocab = [alphabet[i % len(alphabet)] for i in range(cfg.llm.vocab_size)]
    vocab[cfg.eos_token_id] = b"</s>"
    return vocab


def _engine(setup, **kw):
    cfg, params, _ = setup
    return BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128, device="cpu",
                             prefix_cache_mb=0, **kw)


def _run(eng, reqs, ticks=120):
    for r in reqs:
        eng.submit(r)
    for _ in range(ticks):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    return [[t for chunk in r.stream() for t in chunk] for r in reqs]


def _render(vocab, toks):
    return b"".join(vocab[t] for t in toks)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_output_matches_regex(setup, temperature):
    cfg = setup[0]
    vocab = _vocab(cfg)
    pat = r"(yes|no)(,[ ]?(yes|no)){2}"
    eng = _engine(setup)
    gid = eng.register_grammar(compile_token_dfa(pat, vocab, eos_id=cfg.eos_token_id))
    rng = np.random.default_rng(0)
    for _ in range(3):
        ids = rng.integers(5, cfg.llm.vocab_size, (10,)).astype(np.int32)
        got = _run(eng, [Request(input_ids=ids, max_new_tokens=24, temperature=temperature,
                                 grammar_id=gid)])[0]
        text = _render(vocab, got).decode("latin1")
        # the grammar completed, or the budget ran out on a live DFA path
        if re.fullmatch(pat, text) is None:
            assert len(got) == 24, text
            dfa, s = compile_regex(pat), 0
            for b in text.encode():
                s = int(dfa.trans[s, b])
                assert s >= 0, text


def test_multi_step_dispatch_respects_grammar(setup):
    """k > 1 decode dispatches (an idle engine) thread the automaton
    through their steps."""
    cfg = setup[0]
    vocab = _vocab(cfg)
    eng = _engine(setup)
    gid = eng.register_grammar(compile_token_dfa(r"[ab]{8}", vocab, eos_id=cfg.eos_token_id))
    got = _run(eng, [Request(input_ids=np.arange(5, 15).astype(np.int32), max_new_tokens=12,
                             temperature=0.7, grammar_id=gid)])[0]
    assert re.fullmatch(r"[ab]{8}", _render(vocab, got).decode())
    assert eng.decode_steps < 12          # some dispatch ran several steps


def test_mixed_constrained_and_free_slots(setup):
    """A constrained and a free slot in one batched step: the free slot's
    tokens are the grammar-free engine's."""
    cfg = setup[0]
    vocab = _vocab(cfg)
    rng = np.random.default_rng(3)
    ids_free = rng.integers(5, cfg.llm.vocab_size, (9,)).astype(np.int32)
    ids_con = rng.integers(5, cfg.llm.vocab_size, (9,)).astype(np.int32)
    ref = _run(_engine(setup), [Request(input_ids=ids_free, max_new_tokens=6)])[0]
    eng = _engine(setup)
    gid = eng.register_grammar(compile_token_dfa(r"[cd]{4}", vocab, eos_id=cfg.eos_token_id))
    free, con = _run(eng, [Request(input_ids=ids_free, max_new_tokens=6),
                           Request(input_ids=ids_con, max_new_tokens=10, grammar_id=gid)])
    assert free == ref
    assert re.fullmatch(r"[cd]{4}", _render(vocab, con).decode())


def test_choices_and_json_schema_roundtrip(setup):
    cfg = setup[0]
    vocab = _vocab(cfg)
    eng = _engine(setup)
    gid = eng.register_grammar(compile_token_dfa(choices_regex(["yes", "no"]), vocab,
                                                 eos_id=cfg.eos_token_id))
    ids = np.arange(5, 12).astype(np.int32)
    got = _run(eng, [Request(input_ids=ids, max_new_tokens=8, grammar_id=gid)])[0]
    assert _render(vocab, got) in (b"yes", b"no")
    schema = {"type": "object", "properties": {
        "a": {"enum": ["yes", "no"]}, "n": {"type": "integer"}}}
    gid2 = eng.register_grammar(compile_token_dfa(json_schema_regex(schema), vocab,
                                                  eos_id=cfg.eos_token_id))
    assert (gid, gid2) == (0, 1)
    got = _run(eng, [Request(input_ids=ids, max_new_tokens=40, grammar_id=gid2)])[0]
    obj = json.loads(_render(vocab, got).decode())
    assert obj["a"] in ("yes", "no") and isinstance(obj["n"], int)


def test_invalid_grammar_id_fails_request_not_engine(setup):
    cfg = setup[0]
    eng = _engine(setup)
    req = eng.submit(Request(input_ids=np.arange(5, 12).astype(np.int32), max_new_tokens=4,
                             grammar_id=7))
    for _ in range(10):
        eng.tick()
    assert req.out_queue.get(timeout=10) is None
    ok = _run(eng, [Request(input_ids=np.arange(5, 12).astype(np.int32), max_new_tokens=3)])
    assert len(ok[0]) == 3
    with pytest.raises(ValueError):
        eng.register_grammar(compile_token_dfa("a", [b"a"] * 7))


def test_grammar_tables_layout(setup):
    """The combined tables: state 0 passes everything, a stuck state allows
    EOS alone, EOS leads to state 0, offsets are cumulative; uploaded to the
    device at registration."""
    cfg = setup[0]
    vocab = _vocab(cfg)
    eng = _engine(setup)
    assert eng._g_allowed.shape == (1, cfg.llm.vocab_size) and bool(eng._g_allowed.all())
    tds = [compile_token_dfa(p, vocab, eos_id=cfg.eos_token_id) for p in ("ab", "yes|no")]
    for td in tds:
        eng.register_grammar(td)
    S = [td.allowed.shape[0] for td in tds]
    assert eng._g_offsets == [1, 1 + S[0]]
    assert tuple(eng._g_allowed.shape) == (1 + sum(S), cfg.llm.vocab_size)
    np.testing.assert_array_equal(eng._g_allowed.numpy(), eng._g_allowed_h)
    np.testing.assert_array_equal(eng._g_nxt.numpy(), eng._g_nxt_h)
    eos = cfg.eos_token_id
    assert (eng._g_nxt_h[:, eos] == 0).all()
    assert (eng._g_allowed_h.any(axis=1)).all()


def test_constrained_greedy_equals_jax_engine(setup):
    """The slice against the JAX package: a constrained and a free request
    through both engines on the same params, greedy: the same tokens."""
    cfg, _, jp = setup
    vocab = _vocab(cfg)
    pat = r"(yes|no|ab)(,[ ]?[a-d0-2]{1,3}){2,3}"
    rng = np.random.default_rng(5)
    ids = [rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32) for S in (8, 11)]
    jeng = JEngine(jp, JCfg.tiny(), max_slots=2, cache_len=128)
    jgid = jeng.register_grammar(jgrammar.compile_token_dfa(pat, vocab,
                                                            eos_id=cfg.eos_token_id))
    want = _run(jeng, [JRequest(input_ids=ids[0], max_new_tokens=14, grammar_id=jgid),
                       JRequest(input_ids=ids[1], max_new_tokens=9)])
    eng = _engine(setup)
    gid = eng.register_grammar(compile_token_dfa(pat, vocab, eos_id=cfg.eos_token_id))
    got = _run(eng, [Request(input_ids=ids[0], max_new_tokens=14, grammar_id=gid),
                     Request(input_ids=ids[1], max_new_tokens=9)])
    assert got == want
    assert re.fullmatch(pat, _render(vocab, got[0]).decode()) or len(got[0]) == 14
