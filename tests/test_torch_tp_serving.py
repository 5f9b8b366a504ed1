"""Tensor-parallel serving in the port against the JAX package's single card.

One world of 2 ranks and one of 4 (gloo, ``(1, 1, tp)`` meshes) run every
job of this file on the same inputs; the JAX side runs once, in the parent,
on one device:

- ``generate(mesh=...)`` on a text prompt (fp32, float cache), a multimodal
  one (int8 LLM layers, int8 KV cache) and a text prompt on q4g layers
  (hidden 256: o_proj's 128 local columns at tp 2 are no whole q4g block,
  so its pair gathers; down_proj's split) equals JAX's ``generate``
  token for token; every rank returns the same tokens, also sampled (there
  against the port's single-process draw). At tp 4 the tiny model's 2 kv
  heads do not split: attention and the KV cache stay whole on every rank;
- the engine with ``mesh=`` (four requests, chunked admission, a grammar-
  constrained one, then speculative rounds with a draft) equals JAX's
  unsharded engine token for token; with a LoRA adapter (``register_adapter``,
  a request on it), a shared prefix (``register_prefix``) and a prompt
  repeated into the automatic prefix cache it equals the port's unsharded
  engine;
- ``checkpoint.load_for_serving(mesh=...)``, what ``--tensor-parallel``
  loads, keeps the LLM layers a list and each rank only its shard: the
  bytes a rank holds equal the sum of its shards' sizes under JAX's
  ``param_pspec`` for that tree, as do those of an engine given stacked
  layers;
- ``batched_worker`` with ``mesh`` (``--tensor-parallel 2``) on that loaded
  tree: rank 0 serves HTTP, rank 1 follows; two streamed requests get the
  unsharded worker's text (world 2 only);
- the W8A8 tower (``--quantize-vision``, K8's plain version here) equals the
  unsharded tower: its out_proj / fc2 run whole on gathered rows.

The parameters come from the port's ``init`` as numpy, so both worlds run
while JAX compiles. JAX's ViT attention runs its Pallas kernel in interpret
mode, as the other slice tests do. Tolerances: tokens exact; the tower within 2e-5.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from slime_tpu_torch import checkpoint as tckpt
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import IMAGE_TOKEN_INDEX, SliMEConfig
from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request

from .torch_ranks import join, leave

TOWER_TOL = dict(atol=2e-5, rtol=2e-5)


def _q4g_cfg():
    cfg = SliMEConfig.tiny()
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, hidden_size=256, intermediate_size=512, head_dim=64))


def _requests(cfg, Request):
    """The engine script: (tick at which it is submitted, request); greedy,
    since JAX's in-graph draws come from its own generator."""
    r = np.random.default_rng(11)
    ids = lambda n: r.integers(5, cfg.llm.vocab_size, (n,)).astype(np.int32)  # noqa: E731
    return [(0, Request(input_ids=ids(21), max_new_tokens=6)),       # chunked admission
            (0, Request(input_ids=ids(5), max_new_tokens=5, grammar_id=0)),
            (2, Request(input_ids=ids(7), max_new_tokens=7)),
            (30, Request(input_ids=ids(6), max_new_tokens=12))]      # speculates alone


def _adapter(cfg, seed=4, r=4):
    """A random stacked adapter over q/k/v/o and gate/up (numpy)."""
    g = np.random.default_rng(seed)
    L, H, I, hd = (cfg.llm.num_layers, cfg.llm.hidden_size, cfg.llm.intermediate_size,
                   cfg.llm.head_dim)
    outs = {"q_proj": cfg.llm.num_heads * hd, "k_proj": cfg.llm.num_kv_heads * hd,
            "v_proj": cfg.llm.num_kv_heads * hd, "o_proj": H, "gate_proj": I, "up_proj": I}
    ins = {p: H for p in outs} | {"o_proj": cfg.llm.num_heads * hd}
    return {"rank": r, "alpha": r, "adapters": {
        f"llm/layers/{p}": {"A": (g.standard_normal((L, r, ins[p])) * 0.1).astype(np.float32),
                            "B": (g.standard_normal((L, outs[p], r)) * 0.1).astype(np.float32)}
        for p in outs}}


def _drive_extras(eng, cfg, Request):
    """An adapter request, a shared-prefix request, a prompt twice (the
    second from the automatic prefix cache); the tokens of each."""
    aid = eng.register_adapter(bridge.from_jax_numpy(_adapter(cfg), device="cpu"))
    r = np.random.default_rng(21)
    ids = lambda n: r.integers(5, cfg.llm.vocab_size, (n,)).astype(np.int32)  # noqa: E731
    pid = eng.register_prefix(ids(9))
    again = ids(13)
    script = [(0, Request(input_ids=ids(6), max_new_tokens=5, adapter_id=aid)),
              (0, Request(input_ids=ids(4), max_new_tokens=5, prefix_id=pid)),
              (1, Request(input_ids=again, max_new_tokens=5)),
              (12, Request(input_ids=again, max_new_tokens=5))]
    reqs = []
    for tick in range(100):
        for t, req in script:
            if t == tick:
                reqs.append(eng.submit(req))
        n = eng.tick()
        if tick > 12 and n == 0 and eng.pending.empty() and eng._admission is None:
            break
    return [[t for chunk in q.stream() for t in chunk] for q in reqs]


def _extras_engine(params, cfg, **kw):
    return BatchDecodeEngine(params, cfg, max_slots=2, cache_len=128, device="cpu",
                             prefix_cache_mb=8, prefix_block=4, **kw)


def _vocab(cfg):
    alphabet = [b"a", b"b", b"c", b"d", b"0", b"1", b"2", b".", b",", b" ",
                b"yes", b"no"]
    vocab = [alphabet[i % len(alphabet)] for i in range(cfg.llm.vocab_size)]
    vocab[cfg.eos_token_id] = b"</s>"
    return vocab


def _drive(eng, cfg, Request, grammar):
    """Run the engine script; the tokens of each request."""
    eng.prefill_chunk_len = 8
    eng.register_grammar(grammar)
    script = _requests(cfg, Request)
    reqs = []
    for tick in range(200):
        for t, req in script:
            if t == tick:
                reqs.append(eng.submit(req))
        n = eng.tick()
        if tick > 30 and n == 0 and eng.pending.empty() and eng._admission is None:
            break
    return [[t for chunk in r.stream() for t in chunk] for r in reqs]


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _worker(argv):
    from slime_tpu_torch import checkpoint as ckpt
    from slime_tpu_torch.generate import generate
    from slime_tpu_torch.models import vit
    from slime_tpu_torch.parallel.mesh import local_bytes, make_mesh
    from slime_tpu_torch.serve.grammar import choices_regex, compile_token_dfa

    rank, world, where, inp = join(argv)
    mesh = make_mesh(1, 1, world, device="cpu")
    cfg, cfg4 = SliMEConfig.tiny(), _q4g_cfg()
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    out = {}
    fp = bridge.from_jax_numpy(inp["fp"], device="cpu")
    p8 = bridge.from_jax_numpy(inp["int8"], device="cpu")
    p4 = bridge.from_jax_numpy(inp["q4g"], device="cpu")
    ids, attn = t(inp["text_ids"]).long(), t(inp["text_attn"])
    mm = [t(inp[k]) for k in ("mm_ids", "mm_attn", "mm_px", "mm_cm")]
    mm[0] = mm[0].long()
    out["text"] = generate(fp, cfg, ids, attn, max_new_tokens=6, eos_id=-1, mesh=mesh)
    out["mm_int8"] = generate(p8, cfg, *mm, max_new_tokens=6, eos_id=-1, kv_quant=True,
                              mesh=mesh)
    out["q4g"] = generate(p4, cfg4, ids, attn, max_new_tokens=6, eos_id=-1, mesh=mesh)
    out["sampled"] = generate(fp, cfg, ids, attn, max_new_tokens=6, eos_id=-1,
                              temperature=1.0, generator=torch.Generator().manual_seed(5),
                              mesh=mesh)

    # the engine: rank 0 drives the script, the others follow
    dfa = compile_token_dfa(choices_regex(["yes", "no"]), _vocab(cfg), eos_id=cfg.eos_token_id)
    eng = BatchDecodeEngine(fp, cfg, max_slots=2, cache_len=128, device="cpu",
                            prefix_cache_mb=0, draft_params=fp, draft_cfg=cfg, spec_k=3,
                            mesh=mesh)
    eng.prefill_chunk_len = 8          # the host settings are every rank's
    out["engine_bytes"] = local_bytes(eng.params)
    if rank == 0:
        out["engine"] = _drive(eng, cfg, Request, dfa)
        out["spec_dispatches"] = eng.spec_stats["dispatches"]
        eng.stop()
    else:
        eng.follow()
    eng = _extras_engine(fp, cfg, mesh=mesh)
    if rank == 0:
        out["extras"] = _drive_extras(eng, cfg, Request)
        out["prefix_hits"] = eng.prefix_cache_stats()
        eng.stop()
    else:
        eng.follow()

    # the W8A8 tower
    tower = vit.quantize_tower(fp["vision"], cfg.vision)
    px = mm[2][0].to(torch.float32)
    out["tower"] = vit.apply(tower, px, cfg.vision)
    with mesh:
        out["tower_tp"] = vit.apply(tower, px, cfg.vision)

    # what --tensor-parallel loads
    loaded = ckpt.load_for_serving(inp["ckpt"], device="cpu", dtype=torch.float32, cfg=cfg,
                                   mesh=mesh)
    out["loaded_bytes"] = local_bytes(loaded)
    out["loaded_list"] = isinstance(loaded["llm"]["layers"], list)
    if world == 2:
        out["http"] = _http(rank, mesh, fp, loaded, cfg)
    leave(rank, where, out)


def _http(rank, mesh, params, loaded, cfg):
    """Two streamed requests through the unsharded worker on ``params``
    (rank 0 alone), then through the tensor-parallel one on the sharded
    ``loaded``; rank 1 follows the second."""
    import threading

    import requests

    from slime_tpu_torch.serve.batched_worker import BatchedWorker, build_server
    from slime_tpu_torch.serve.protocol import iter_stream_response

    from .toy_tokenizer import ToyTokenizer

    if rank != 0:
        BatchDecodeEngine(loaded, cfg, max_slots=4, cache_len=128, device="cpu",
                          prefix_cache_mb=0, mesh=mesh).follow()
        return None
    tok = ToyTokenizer()
    tok("hello world what is in the picture tell me a story")
    bodies = [{"prompt": "hello world what is", "max_new_tokens": 6, "temperature": 0.0},
              {"prompt": "tell me a story", "max_new_tokens": 5, "temperature": 0.0}]
    texts = []
    for m, p in ((None, params), (mesh, loaded)):
        worker = BatchedWorker(controller_addr=None, worker_addr=None, model_name="tiny",
                               params=p, cfg=cfg, tokenizer=tok, max_slots=4,
                               cache_len=128, compute_dtype=torch.float32, register=False,
                               prefix_cache_mb=0, device="cpu", mesh=m)
        srv = build_server(worker, "localhost", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://localhost:{srv.port}/worker_generate_stream"
        got = [None, None]

        def ask(i):
            got[i] = [c["text"] for c in iter_stream_response(
                requests.post(url, json=bodies[i], stream=True, timeout=120))]
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        srv.shutdown()
        worker.engine.stop()
        texts.append([g[-1] for g in got])
    return texts


# ---------------------------------------------------------------------------
# The JAX side and the checks
# ---------------------------------------------------------------------------

def _shard_bytes(tree, tp):
    """Bytes one rank of a (1, 1, tp) mesh holds of ``tree`` (numpy leaves)
    under JAX's ``param_pspec``."""
    import jax
    from jax.sharding import Mesh

    from slime_tpu.parallel import mesh as jmesh

    jm = Mesh(np.asarray(jax.devices()[:tp]).reshape(1, 1, tp), jmesh.AXES)
    total = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        split = 1
        for ax in jmesh.param_pspec(path, leaf, jm):
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                split *= jm.shape[a]
        total += leaf.nbytes // split
    return total


@pytest.fixture(scope="module")
def case(request, tmp_path_factory):
    """-> (inputs, JAX's results, the running worlds). The parameters come
    from the port's ``init`` and ``quantize_params`` (JAX's key set, shapes
    and formats, numpy leaves), so both worlds start before JAX's generate
    and engine compile and run beside them."""
    import jax
    import jax.numpy as jnp

    import slime_tpu.ops.encoder_attention as jea
    from slime_tpu import generate as jgen
    from slime_tpu.config import SliMEConfig as JCfg
    from slime_tpu.serve import grammar as jgrammar
    from slime_tpu.serve.batch_engine import BatchDecodeEngine as JEngine
    from slime_tpu.serve.batch_engine import Request as JRequest
    from slime_tpu_torch.models import llama as tllama
    from slime_tpu_torch.models import slime as tslime
    from slime_tpu_torch.ops.quantization import quantize_params

    from .torch_ranks import start_ranks

    jcfg = JCfg.tiny()
    j4 = dataclasses.replace(jcfg, llm=dataclasses.replace(
        jcfg.llm, hidden_size=256, intermediate_size=512, head_dim=64))
    cfg = SliMEConfig.tiny()

    def init(c, seed):
        return tslime.init(c, generator=torch.Generator().manual_seed(seed), device="cpu")

    def stacked(p, layers=None):
        layers = p["llm"]["layers"] if layers is None else layers
        return bridge.to_jax_numpy({**p, "llm": {**p["llm"],
                                                 "layers": tllama.stack_layers(layers)}})

    tbase = init(cfg, 0)
    ckpt_dir = str(tmp_path_factory.mktemp("tp_ckpt"))
    tckpt.save_checkpoint(ckpt_dir, tbase, cfg)
    loaded = bridge.to_jax_numpy(tckpt.load_pretrained(ckpt_dir, cfg=cfg))
    fp = stacked(tbase)
    p8 = stacked(tbase, quantize_params(tbase["llm"]["layers"], bits=8, min_size=1024))
    tb4 = init(_q4g_cfg(), 1)
    p4 = stacked(tb4, quantize_params(tb4["llm"]["layers"], bits=4, min_size=1024,
                                      scheme="group"))
    assert "q4g" in p4["llm"]["layers"]["down_proj"]["weight"]

    r = np.random.default_rng(3)
    ids = r.integers(5, 512, (2, 10)).astype(np.int32)
    attn = np.ones((2, 10), bool)
    attn[1, 7:] = False
    mm_ids = r.integers(5, 512, (1, 12)).astype(np.int32)
    mm_ids[0, 2] = IMAGE_TOKEN_INDEX
    t = jcfg.vision.image_size
    px = r.standard_normal((1, 1 + jcfg.max_local_crops, 3, t, t)).astype(np.float32)
    cm = np.ones((1, 1 + jcfg.max_local_crops), bool)
    cm[0, 5:] = False
    inputs = {"fp": fp, "int8": p8, "q4g": p4, "text_ids": ids, "text_attn": attn,
              "mm_ids": mm_ids, "mm_attn": np.ones((1, 12), bool), "mm_px": px, "mm_cm": cm,
              "ckpt": ckpt_dir}
    worlds = {w: start_ranks("test_torch_tp_serving", w, inputs,
                             tmp_path_factory.mktemp(f"world{w}")) for w in (2, 4)}
    request.addfinalizer(lambda: [ranks.kill() for ranks in worlds.values()])
    J = lambda p: jax.tree_util.tree_map(jnp.asarray, p)  # noqa: E731

    saved = jea.encoder_attention
    jea.encoder_attention = functools.partial(saved, interpret=True)
    try:
        gen = functools.partial(jgen.generate, max_new_tokens=6, eos_id=-1, use_pallas=False)
        want = {"text": np.asarray(gen(J(fp), jcfg, jnp.asarray(ids), jnp.asarray(attn))),
                "mm_int8": np.asarray(gen(J(p8), jcfg, jnp.asarray(mm_ids),
                                          jnp.ones((1, 12), bool), jnp.asarray(px),
                                          jnp.asarray(cm), kv_quant=True)),
                "q4g": np.asarray(gen(J(p4), j4, jnp.asarray(ids), jnp.asarray(attn)))}
        dfa = jgrammar.compile_token_dfa(jgrammar.choices_regex(["yes", "no"]), _vocab(cfg),
                                         eos_id=jcfg.eos_token_id)
        eng = JEngine(J(fp), jcfg, max_slots=2, cache_len=128, prefix_cache_mb=0,
                      draft_params=J(fp), draft_cfg=jcfg, spec_k=3)
        want["engine"] = _drive(eng, cfg, JRequest, dfa)
    finally:
        jea.encoder_attention = saved
    want["bytes"] = {tp: _shard_bytes(loaded, tp) for tp in (2, 4)}
    want["engine_bytes"] = {tp: _shard_bytes(bridge.to_jax_numpy(tbase), tp) for tp in (2, 4)}
    return inputs, want, worlds


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_serving_matches_jax(case, world):
    from slime_tpu_torch.generate import generate
    from slime_tpu_torch.parallel.mesh import Mesh, kv_heads_local

    inputs, want, worlds = case
    outs = worlds[world].wait()
    fp = bridge.from_jax_numpy(inputs["fp"], device="cpu")
    ids = torch.from_numpy(inputs["text_ids"]).long()
    sampled = generate(fp, SliMEConfig.tiny(), ids, torch.from_numpy(inputs["text_attn"]),
                       max_new_tokens=6, eos_id=-1, temperature=1.0,
                       generator=torch.Generator().manual_seed(5))
    for r, o in enumerate(outs):
        for k in ("text", "mm_int8", "q4g"):
            np.testing.assert_array_equal(o[k].numpy(), want[k], err_msg=f"{k} rank {r}")
        torch.testing.assert_close(o["sampled"], sampled, rtol=0, atol=0)
        torch.testing.assert_close(o["tower_tp"], o["tower"], **TOWER_TOL)
        assert o["loaded_list"]
        assert o["loaded_bytes"] == want["bytes"][world], r
        assert o["engine_bytes"] == want["engine_bytes"][world], r
    assert outs[0]["engine"] == want["engine"]
    assert outs[0]["spec_dispatches"] >= 1
    plain = _extras_engine(fp, SliMEConfig.tiny())
    assert outs[0]["extras"] == _drive_extras(plain, SliMEConfig.tiny(), Request)
    # the same hits; each rank's cache holds its kv heads' bytes
    got_stats, want_stats = outs[0]["prefix_hits"], plain.prefix_cache_stats()
    split = 2 // kv_heads_local(2, Mesh(1, 1, world))
    assert got_stats == {**want_stats, "bytes": want_stats["bytes"] // split}
    assert outs[0]["extras"][3] == outs[0]["extras"][2] and all(outs[0]["extras"])
    assert all(len(toks) > 0 for toks in want["engine"])
    if world == 2:
        plain, sharded = outs[0]["http"]
        assert sharded == plain and all(plain)
