"""A Mixtral-family LLM (MoE layers: E = 4 experts, top 2, 2 layers) through
the port's entry points, against the JAX package on the same params and
inputs, on the CPU in fp32 (the counterparts of ``test_moe_dispatch.py``'s
forward, ``test_generate.py::test_moe_greedy_matches_full_forward`` and the
MoE branch of every LLM entry point):

- ``llama.forward`` logits and router aux at B = 2, S = 12 (B * S = 24: the
  dense masked MoE) and S = 20 (40: the sparse dispatch), with list and
  stacked layers and with ``remat``;
- the gradient of a loss through ``forward`` (logits and aux) on every
  leaf, the gates included, with and without ``remat``;
- ``decode_step`` and ``prefill_chunk`` (a dense chunk, then a sparse one at
  per-row offsets) over a float and an int8 KV cache; ``fused=True`` raises;
- ``generate``'s greedy tokens (a text prompt and an image prompt) equal
  JAX's and those of repeated full forwards; ``beam_search`` with 2 beams
  equals JAX's;
- the engine (``serve.batch_engine``, 2 slots, 16-position chunks, float and
  int8 pools) gives each of 3 requests ``generate``'s tokens;
- ``serve.speculative``'s host and device loops with the MoE target and a
  dense draft equal JAX's tokens and acceptance rate.

JAX's side runs once per case in module-scoped fixtures. Tolerance: logits
1e-4 absolute, the aux 1e-5 relative, gradients 1e-4 of each leaf's largest
entry (fp32 sums in another order); tokens exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slime_tpu.ops.encoder_attention as jea
from slime_tpu import generate as jgen
from slime_tpu.config import SliMEConfig as JCfg
from slime_tpu.constants import IMAGE_TOKEN_INDEX
from slime_tpu.models import llama as jllama
from slime_tpu.models import slime as jslime
from slime_tpu.serve import speculative as jspec
from slime_tpu_torch import generate as tgen
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import SliMEConfig
from slime_tpu_torch.models import llama as tllama
from slime_tpu_torch.serve import speculative as tspec
from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request

ATOL = 1e-4


def _moe_cfg(cls):
    cfg = cls.tiny()
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_experts=4, num_experts_per_tok=2))


JCFG, CFG = _moe_cfg(JCfg), _moe_cfg(SliMEConfig)


@pytest.fixture(autouse=True)
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """JAX SliME params (numpy) with list layers, and with stacked ones."""
    p = jax.device_get(jslime.init(jax.random.PRNGKey(3), JCFG))
    stacked = dict(p, llm=dict(p["llm"], layers=jax.device_get(
        jllama.stack_layers(p["llm"]["layers"]))))
    return p, stacked


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return bridge.from_jax_numpy(tree, device="cpu")


def _ids(B, S, seed):
    return np.random.default_rng(seed).integers(5, CFG.llm.vocab_size, (B, S)).astype(np.int32)


def _loss_jax(p, emb, cfg):
    logits, _, aux = jllama.forward(p, emb, cfg, return_aux=True)
    return jnp.mean(logits ** 2) + 0.1 * aux


@pytest.fixture(scope="module")
def jax_forward(model):
    """JAX's logits and aux for each S, and its gradient at S = 20."""
    llm = _jx(model[0]["llm"])
    fwd = jax.jit(lambda p, ids: jllama.forward(p, jllama.embed(p, ids), JCFG.llm,
                                                return_aux=True))
    out = {}
    for S in (12, 20):
        logits, _, aux = fwd(llm, jnp.asarray(_ids(2, S, S)))
        out[S] = (np.asarray(logits), float(aux))
    ids = jnp.asarray(_ids(2, 20, 20))
    grads = jax.jit(jax.grad(lambda p: _loss_jax(p, jllama.embed(p, ids), JCFG.llm)))(llm)
    return out, jax.device_get(grads)


@pytest.mark.parametrize("layout", ["list", "stacked", "remat"])
@pytest.mark.parametrize("S", [12, 20], ids=["dense_moe", "sparse_moe"])
def test_forward_matches_jax(model, jax_forward, S, layout):
    p = model[1] if layout == "stacked" else model[0]
    llm = _t(p["llm"])
    if layout == "remat":
        for leaf in bridge.named_leaves(llm):
            leaf[1].requires_grad_(True)
    emb = tllama.embed(llm, torch.from_numpy(_ids(2, S, S)))
    logits, kv, aux = tllama.forward(llm, emb, CFG.llm, return_aux=True,
                                     remat=layout == "remat")
    want, want_aux = jax_forward[0][S]
    assert kv is None and aux.shape == ()
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), want_aux, rtol=1e-5)
    assert 0 < float(aux.detach()) < 2 * CFG.llm.num_experts_per_tok + 1


def test_forward_without_aux_keeps_its_two_outputs(model):
    llm = _t(model[0]["llm"])
    out = tllama.forward(llm, tllama.embed(llm, torch.from_numpy(_ids(1, 6, 0))), CFG.llm)
    assert len(out) == 2


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax(model, jax_forward, remat):
    llm = _t(model[0]["llm"])
    for _, leaf in bridge.named_leaves(llm):
        leaf.requires_grad_(True)
    emb = tllama.embed(llm, torch.from_numpy(_ids(2, 20, 20)))
    logits, _, aux = tllama.forward(llm, emb, CFG.llm, return_aux=True, remat=remat)
    (torch.mean(logits ** 2) + 0.1 * aux).backward()
    want = dict(bridge.named_leaves(jax_forward[1]))
    got = dict(bridge.named_leaves(llm))
    assert set(got) == set(want)
    for path, leaf in got.items():
        w = np.asarray(want[path])
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=path)
    gate = got["layers/0/gate/weight"].grad
    assert float(gate.abs().sum()) > 0


def _caches(quantized, B=2, T=48):
    j = jllama.init_kv_cache(JCFG.llm, B, T, quantized=quantized)
    t = tllama.init_kv_cache(CFG.llm, B, T, device="cpu", quantized=quantized)
    return j, t


@pytest.fixture(scope="module")
def jax_cached(model):
    """JAX's logits of a prefill, then 3 decode steps; and of a dense chunk
    (B * C = 8) followed by a sparse one (B * C = 40) at per-row offsets;
    over a float and an int8 cache."""
    llm = _jx(model[1]["llm"])
    ids = _ids(2, 7, 5)
    steps = _ids(2, 3, 6)
    chunks = (_ids(2, 4, 7), _ids(2, 20, 8))
    forward = jax.jit(lambda p, e: jllama.forward(p, e, JCFG.llm, return_kv=True))
    decode = jax.jit(lambda p, c, t: jllama.decode_step(p, c, t, JCFG.llm))
    chunk = jax.jit(lambda p, c, e: jllama.prefill_chunk(p, c, e, JCFG.llm))
    out = {}
    for q in (False, True):
        cache, _ = _caches(q)
        logits, kvs = forward(llm, jllama.embed(llm, jnp.asarray(ids)))
        cache = jllama.prefill_into_cache(cache, kvs, jnp.asarray([7, 5], jnp.int32))
        dec = []
        for i in range(3):
            lg, cache = decode(llm, cache, jnp.asarray(steps[:, i]))
            dec.append(np.asarray(lg))
        cache, _ = _caches(q)
        cache = dict(cache, length=jnp.asarray([0, 3], jnp.int32))
        chk = []
        for c in chunks:
            lg, cache = chunk(llm, cache, jllama.embed(llm, jnp.asarray(c)))
            chk.append(np.asarray(lg))
        out[q] = (dec, chk, jax.device_get(cache))
    return ids, steps, chunks, out


@pytest.mark.parametrize("quantized", [False, True], ids=["float_cache", "int8_cache"])
def test_decode_step_matches_jax(model, jax_cached, quantized):
    ids, steps, _, out = jax_cached
    llm = _t(model[1]["llm"])
    _, cache = _caches(quantized)
    logits, kvs = tllama.forward(llm, tllama.embed(llm, torch.from_numpy(ids)), CFG.llm,
                                 return_kv=True)
    cache = tllama.prefill_into_cache(cache, kvs, torch.tensor([7, 5], dtype=torch.int32))
    for i in range(3):
        lg, cache = tllama.decode_step(llm, cache, torch.from_numpy(steps[:, i]).long(),
                                       CFG.llm)
        np.testing.assert_allclose(lg.numpy(), out[quantized][0][i], atol=ATOL, rtol=0,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("quantized", [False, True], ids=["float_cache", "int8_cache"])
def test_prefill_chunk_matches_jax(model, jax_cached, quantized):
    _, _, chunks, out = jax_cached
    llm = _t(model[1]["llm"])
    _, cache = _caches(quantized)
    cache["length"] = torch.tensor([0, 3], dtype=torch.int32)
    for i, c in enumerate(chunks):
        lg, cache = tllama.prefill_chunk(llm, cache, tllama.embed(llm, torch.from_numpy(c)),
                                         CFG.llm)
        np.testing.assert_allclose(lg.numpy(), out[quantized][1][i], atol=ATOL, rtol=0,
                                   err_msg=f"chunk {i}")
    want = out[quantized][2]
    np.testing.assert_array_equal(cache["length"].numpy(), want["length"])
    if quantized:
        np.testing.assert_array_equal(cache["k"].numpy()[:, :, :24], want["k"][:, :, :24])


@pytest.mark.parametrize("entry", ["decode_step", "prefill_chunk"])
def test_fused_true_raises(model, entry):
    llm = _t(model[1]["llm"])
    _, cache = _caches(False)
    with pytest.raises(ValueError, match="dense-MLP only"):
        if entry == "decode_step":
            tllama.decode_step(llm, cache, torch.tensor([5, 6]), CFG.llm, fused=True)
        else:
            tllama.prefill_chunk(llm, cache, torch.zeros((2, 3, CFG.llm.hidden_size)),
                                 CFG.llm, fused=True)
    assert not tllama.chunk_takes_fused((2, 3, CFG.llm.hidden_size), "cuda",
                                        llm["layers"])


def _image_prompt(seed=9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, CFG.llm.vocab_size, (1, 7)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    t, MC = CFG.vision.image_size, 1 + CFG.max_local_crops
    pv = rng.standard_normal((1, MC, 3, t, t)).astype(np.float32)
    cm = np.ones((1, MC), bool)
    cm[:, 3:] = False
    return ids, pv, cm


@pytest.fixture(scope="module")
def jax_tokens(model):
    """JAX's greedy tokens for a text batch and an image prompt, and its
    2-beam search on each."""
    jp = _jx(model[1])
    text = _ids(2, 6, 11)
    ids, pv, cm = _image_prompt()
    out = {"text": np.asarray(jgen.generate(jp, JCFG, jnp.asarray(text),
                                            jnp.ones(text.shape, bool), max_new_tokens=5,
                                            eos_id=-1)),
           "image": np.asarray(jgen.generate(jp, JCFG, jnp.asarray(ids),
                                             jnp.ones(ids.shape, bool), jnp.asarray(pv),
                                             jnp.asarray(cm), max_new_tokens=5, eos_id=-1))}
    for name, args in (("text", (text[:1], None, None)), ("image", (ids, pv, cm))):
        i, p_, c = args
        out["beam_" + name] = np.asarray(jgen.beam_search(
            jp, JCFG, jnp.asarray(i), jnp.ones(i.shape, bool),
            None if p_ is None else jnp.asarray(p_), None if c is None else jnp.asarray(c),
            num_beams=2, max_new_tokens=6))
    return text, out


def _generate(tp, ids, pv=None, cm=None, n=5):
    ids = torch.from_numpy(ids).long()
    return tgen.generate(tp, CFG, ids, torch.ones_like(ids, dtype=torch.bool),
                         None if pv is None else torch.from_numpy(pv),
                         None if cm is None else torch.from_numpy(cm),
                         max_new_tokens=n, eos_id=-1).numpy()


@pytest.mark.parametrize("prompt", ["text", "image"])
def test_generate_matches_jax(model, jax_tokens, prompt):
    text, want = jax_tokens
    tp = _t(model[1])
    got = _generate(tp, text) if prompt == "text" else _generate(tp, *_image_prompt())
    np.testing.assert_array_equal(got, want[prompt])


def test_generate_equals_repeated_full_forwards(model, jax_tokens):
    """The decode loop (dense MoE at B = 2, one position a step) emits the
    argmax of a full forward over the prompt and the tokens so far (the
    sparse MoE from B * S = 32 on)."""
    text, _ = jax_tokens
    tp = _t(model[1])
    toks = _generate(tp, text, n=6)
    seq = torch.from_numpy(text).long()
    for t in range(6):
        logits, _ = tllama.forward(tp["llm"], tllama.embed(tp["llm"], seq), CFG.llm)
        nxt = logits[:, -1].argmax(dim=-1)
        np.testing.assert_array_equal(toks[:, t], nxt.numpy(), err_msg=f"step {t}")
        seq = torch.cat([seq, nxt[:, None]], dim=1)


@pytest.mark.parametrize("prompt", ["text", "image"])
def test_beam_search_matches_jax(model, jax_tokens, prompt):
    text, want = jax_tokens
    tp = _t(model[1])
    ids, pv, cm = (text[:1], None, None) if prompt == "text" else _image_prompt()
    ids = torch.from_numpy(ids).long()
    got = tgen.beam_search(tp, CFG, ids, torch.ones_like(ids, dtype=torch.bool),
                           None if pv is None else torch.from_numpy(pv),
                           None if cm is None else torch.from_numpy(cm),
                           num_beams=2, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want["beam_" + prompt])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float_pool", "int8_pool"])
def test_engine_matches_generate(model, kv_quant):
    """Three requests on 2 slots, the third submitted while the first two
    decode: the 40- and 33-token prompts are admitted in 16-position chunks
    (B * C = 16: the dense MoE), where ``generate`` prefills them in one
    forward (the sparse dispatch); decode ticks run the dense MoE at B = 2.
    Each answer equals ``generate``'s on the same pool kind."""
    tp = _t(model[1])
    rng = np.random.default_rng(21)
    prompts = [rng.integers(5, CFG.llm.vocab_size, (n,)).astype(np.int32) for n in (40, 9, 33)]
    eng = BatchDecodeEngine(tp, CFG, max_slots=2, cache_len=96, device="cpu",
                            prefix_cache_mb=0, kv_quant=kv_quant)
    eng.prefill_chunk_len = 16
    reqs = [Request(input_ids=p, max_new_tokens=6) for p in prompts]
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    for _ in range(3):
        eng.tick()
    eng.submit(reqs[2])
    for _ in range(200):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    got = [[t for c in r.stream() for t in c] for r in reqs]
    ids = [torch.from_numpy(p[None]).long() for p in prompts]
    want = [tgen.generate(tp, CFG, i, torch.ones_like(i, dtype=torch.bool), max_new_tokens=6,
                          eos_id=-1, kv_quant=kv_quant)[0].tolist() for i in ids]
    assert got == want


@pytest.mark.parametrize("loop", ["speculative_generate", "speculative_generate_device"])
def test_speculative_matches_jax(model, loop):
    """The MoE target verifies a dense draft's K = 3 proposals in one
    4-position chunk (the dense masked MoE) each round."""
    jd = jax.device_get(jslime.init(jax.random.PRNGKey(42), JCfg.tiny()))
    jd["llm"]["layers"] = jax.device_get(jllama.stack_layers(jd["llm"]["layers"]))
    ids = _ids(1, 6, 7)
    got, rate = getattr(tspec, loop)(_t(model[1]), CFG, _t(jd), SliMEConfig.tiny(),
                                     torch.from_numpy(ids).long(), K=3, max_new_tokens=10)
    want, jrate = getattr(jspec, loop)(_jx(model[1]), JCFG, _jx(jd), JCfg.tiny(),
                                       jnp.asarray(ids), K=3, max_new_tokens=10)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert rate == jrate
