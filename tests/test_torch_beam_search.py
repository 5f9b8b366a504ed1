"""``generate.beam_search`` against the JAX package's, at ``SliMEConfig.tiny``
widths in fp32 (the counterpart of ``tests/test_beam_search.py``):

- the tokens equal JAX's ``beam_search`` for K = 1, 2, 3, with a text prompt
  and with an image, and with an EOS that some beams reach (frozen beams,
  the length penalty);
- ``num_beams=1`` equals greedy ``generate``;
- the best beam's joint log-prob is at least the greedy sequence's;
- ties in the log-probs (a zero ``lm_head``: every logit 0) resolve to the
  lower index, as ``jax.lax.top_k`` resolves them, in the seed and in the
  top K over K*V.

JAX's ViT attention runs its Pallas kernel in interpret mode. Tolerance:
tokens exact; the log-prob comparison with a 1e-4 margin, as JAX's test.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slime_tpu.ops.encoder_attention as jea
from slime_tpu import generate as jgen
from slime_tpu.config import SliMEConfig
from slime_tpu.constants import IMAGE_TOKEN_INDEX
from slime_tpu.models import llama as jllama
from slime_tpu.models import slime as jslime
from slime_tpu_torch import generate as tgen
from slime_tpu_torch import params as bridge
from slime_tpu_torch.models import llama as tllama


@pytest.fixture(autouse=True)
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tiny models' ops are too small to gain from more threads, and the
    suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = SliMEConfig.tiny()
    p = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    p["llm"]["layers"] = jax.device_get(jllama.stack_layers(p["llm"]["layers"]))
    return cfg, p


def _inputs(cfg, image, seed=0, B=1, S=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    pv = cm = None
    if image:
        ids[:, 1] = IMAGE_TOKEN_INDEX
        t, MC = cfg.vision.image_size, 1 + cfg.max_local_crops
        pv = rng.standard_normal((B, MC, 3, t, t)).astype(np.float32)
        cm = np.ones((B, MC), bool)
        cm[:, 3:] = False
    return ids, np.ones((B, S), bool), pv, cm


def _both(cfg, p, ids, mask, pv, cm, **kw):
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    j = jgen.beam_search(jp, cfg, jnp.asarray(ids), jnp.asarray(mask),
                         None if pv is None else jnp.asarray(pv),
                         None if cm is None else jnp.asarray(cm), **kw)
    tp = bridge.from_jax_numpy(p, device="cpu")
    t = tgen.beam_search(tp, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                         None if pv is None else torch.from_numpy(pv),
                         None if cm is None else torch.from_numpy(cm), **kw)
    return t.numpy(), np.asarray(j)


@pytest.mark.parametrize("image", [False, True], ids=["text", "image"])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_beam_search_matches_jax(setup, K, image):
    cfg, p = setup
    ids, mask, pv, cm = _inputs(cfg, image, seed=K)
    got, want = _both(cfg, p, ids, mask, pv, cm, num_beams=K, max_new_tokens=5, eos_id=-1)
    assert got.shape == (1, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("length_penalty", [0.0, 1.3])
def test_beam_search_with_finished_beams_matches_jax(setup, length_penalty):
    """EOS is the greedy answer's second token: beams finish, freeze and are
    ranked by the length penalty (at 0 a finished beam stops losing score
    and wins)."""
    cfg, p = setup
    ids, mask, _, _ = _inputs(cfg, False, seed=11, B=2)
    tp = bridge.from_jax_numpy(p, device="cpu")
    greedy = tgen.generate(tp, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                           max_new_tokens=3, eos_id=-1).numpy()
    eos = int(greedy[0, 1])
    got, want = _both(cfg, p, ids, mask, None, None, num_beams=3, max_new_tokens=6,
                      eos_id=eos, length_penalty=length_penalty)
    np.testing.assert_array_equal(got, want)
    if length_penalty == 0.0:
        assert (got[0] == eos).any()


def test_beam1_equals_greedy(setup):
    cfg, p = setup
    ids, mask, _, _ = _inputs(cfg, False, seed=1, B=2)
    tp = bridge.from_jax_numpy(p, device="cpu")
    ref = tgen.generate(tp, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                        max_new_tokens=5, eos_id=-1)
    got = tgen.beam_search(tp, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                           num_beams=1, max_new_tokens=5, eos_id=-1)
    assert torch.equal(got, ref)


def test_beam_score_at_least_greedy(setup):
    cfg, p = setup
    tp = bridge.from_jax_numpy(p, device="cpu")
    ids, mask, _, _ = _inputs(cfg, False, seed=2, S=5)
    steps = 4

    def seq_logprob(toks):
        seq = torch.from_numpy(np.concatenate([ids[0], toks]).astype(np.int64))[None]
        emb = tllama.embed(tp["llm"], seq)
        lg, _ = tllama.forward(tp["llm"], emb, cfg.llm)
        lp = torch.log_softmax(lg.to(torch.float32)[0], dim=-1)
        return sum(float(lp[ids.shape[1] - 1 + i, int(t)]) for i, t in enumerate(toks))

    greedy = tgen.generate(tp, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                           max_new_tokens=steps, eos_id=-1)[0].numpy()
    beam = tgen.beam_search(tp, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                            num_beams=4, max_new_tokens=steps, eos_id=-1)[0].numpy()
    assert seq_logprob(beam) >= seq_logprob(greedy) - 1e-4


def test_tie_resolves_to_the_lower_id_as_jax(setup):
    """A zero lm_head: every logit is exactly 0, so the seed and every step
    choose among exact ties over K*V; JAX's top_k takes the lowest indices,
    and so does the port. ``top_k_stable`` against ``jax.lax.top_k`` on rows
    with ties."""
    cfg, p = setup
    p = jax.tree_util.tree_map(np.array, p)
    p["llm"]["lm_head"]["weight"][:] = 0.0
    ids, mask, _, _ = _inputs(cfg, False, seed=4)
    got, want = _both(cfg, p, ids, mask, None, None, num_beams=3, max_new_tokens=4,
                      eos_id=-1)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()
    x = np.random.default_rng(5).integers(0, 4, (6, 40)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 7)
    tv, ti = tgen.top_k_stable(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
