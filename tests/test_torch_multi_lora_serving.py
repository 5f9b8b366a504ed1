"""Multi-LoRA serving in the port's engine (mirrors
``tests/test_multi_lora_serving.py``): one base model, per-request adapters
in one batch.

A slot with adapter a emits what the model with a merged into its weights
emits (``generate``; one case against JAX's ``generate`` on JAX's merge);
base slots batched with adapter slots emit the base output; after the last
adapter slot frees, decode returns to the base path; an unknown adapter
fails its request; ``stack_adapter_state`` puts per-layer factors at their
rows. Beyond the JAX tests: ``BatchedWorker.load_adapter`` from a PEFT
directory written by ``checkpoint.save_lora_checkpoint``, the engine's
layer layouts (list and stacked), and ``lora_view_builds``, which shows the
gathered ``lora_b`` view is rebuilt when the slot->adapter map changes and
never per decode step.

Tolerance: none; greedy tokens are equal (fp32 on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.config import SliMEConfig
from slime_tpu.generate import generate as jgenerate
from slime_tpu.models import slime as jslime
from slime_tpu.train import lora as jlora
from slime_tpu_torch import params as bridge
from slime_tpu_torch.generate import generate
from slime_tpu_torch.models import llama
from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request
from slime_tpu_torch.train import lora as tlora


@pytest.fixture(scope="module")
def setup():
    cfg = SliMEConfig.tiny()
    jp = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    return cfg, jp, bridge.from_jax_numpy(jp, device="cpu")


def _mk_adapter(cfg, seed, scale=0.1, r=4, projs=None):
    """A random stacked adapter over q/k/v/o + gate/up (numpy), live enough
    to change the answers."""
    rng = np.random.default_rng(seed)
    L, H, I, hd = (cfg.llm.num_layers, cfg.llm.hidden_size, cfg.llm.intermediate_size,
                   cfg.llm.head_dim)
    outs = {"q_proj": cfg.llm.num_heads * hd, "k_proj": cfg.llm.num_kv_heads * hd,
            "v_proj": cfg.llm.num_kv_heads * hd, "o_proj": H, "gate_proj": I, "up_proj": I}
    ins = {"q_proj": H, "k_proj": H, "v_proj": H, "o_proj": cfg.llm.num_heads * hd,
           "gate_proj": H, "up_proj": H}
    return {"rank": r, "alpha": r, "adapters": {
        f"llm/layers/{p}": {
            "A": (rng.standard_normal((L, r, ins[p])) * scale).astype(np.float32),
            "B": (rng.standard_normal((L, outs[p], r)) * scale).astype(np.float32)}
        for p in (projs or outs)}}


def _unstacked(state):
    adapters = {}
    for spath, ab in state["adapters"].items():
        prefix, proj = spath.rsplit("/", 1)
        for li in range(np.shape(ab["A"])[0]):
            adapters[f"{prefix}/{li}/{proj}"] = {k: np.asarray(v)[li] for k, v in ab.items()}
    return {**state, "adapters": adapters}


def _stacked_params(tp):
    return {**tp, "llm": {**tp["llm"], "layers": llama.stack_layers(tp["llm"]["layers"])}}


def _ref(cfg, tp, ids, n, state=None):
    p = tp if state is None else tlora.apply_to_params(
        tp, bridge.from_jax_numpy(_unstacked(state), device="cpu"))
    out = generate(_stacked_params(p), cfg, torch.from_numpy(ids[None]),
                   torch.ones((1, len(ids)), dtype=torch.bool), max_new_tokens=n, eos_id=-1)
    return out[0].tolist()


def _engine(cfg, params, **kw):
    return BatchDecodeEngine(params, cfg, device="cpu", prefix_cache_mb=0,
                             **{**dict(max_slots=2, cache_len=96), **kw})


def _drive(eng, reqs, ticks=150):
    for r in reqs:
        eng.submit(r)
    for _ in range(ticks):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    outs = []
    for r in reqs:
        out = []
        while True:
            got = r.out_queue.get(timeout=10)
            if got is None:
                break
            out.extend(got)
        outs.append(out)
    return outs


def _ids(cfg, seed, n):
    return np.random.default_rng(seed).integers(5, cfg.llm.vocab_size, (n,)).astype(np.int32)


@pytest.mark.parametrize("layout", ["list", "stacked"])
def test_adapter_slot_matches_merged_model(setup, layout):
    cfg, _, tp = setup
    state = _mk_adapter(cfg, seed=1)
    ids = _ids(cfg, 0, 12)
    ref = _ref(cfg, tp, ids, 6, state)
    assert ref != _ref(cfg, tp, ids, 6)
    eng = _engine(cfg, tp if layout == "list" else _stacked_params(tp))
    aid = eng.register_adapter(bridge.from_jax_numpy(state, device="cpu"))
    assert aid == 1
    got = _drive(eng, [Request(input_ids=ids, max_new_tokens=6, adapter_id=aid)])[0]
    assert got == ref


def test_mixed_batch_base_and_two_adapters(setup):
    """Base, adapter 1 and adapter 2 (of another rank, on fewer
    projections) decode in the same batched steps; each equals its own
    merged model, and adapter 1's answer equals JAX's generate on JAX's
    merge."""
    cfg, jp, tp = setup
    s1 = _mk_adapter(cfg, seed=2)
    s2 = _mk_adapter(cfg, seed=3, r=2, projs=["q_proj", "v_proj", "up_proj"])
    prompts = [_ids(cfg, 10 + i, 10) for i in range(3)]
    refs = [_ref(cfg, tp, p, 5, st) for p, st in zip(prompts, (None, s1, s2))]
    assert refs[1] != _ref(cfg, tp, prompts[1], 5) or refs[2] != _ref(cfg, tp, prompts[2], 5)
    merged = jlora.apply_to_params(jp, _unstacked(s1))
    jref = np.asarray(jgenerate(merged, cfg, jnp.asarray(prompts[1][None]),
                                jnp.ones((1, 10), bool), max_new_tokens=5, eos_id=-1))
    assert jref[0].tolist() == refs[1]
    eng = _engine(cfg, _stacked_params(tp), max_slots=4)
    a1 = eng.register_adapter(bridge.from_jax_numpy(s1, device="cpu"))
    a2 = eng.register_adapter(bridge.from_jax_numpy(s2, device="cpu"))
    assert (a1, a2) == (1, 2) and eng._lora_rank == 4
    assert eng.lora_stacks["k_proj"]["A"].shape[0] == 3
    assert not eng.lora_stacks["k_proj"]["A"][2].any()
    reqs = [Request(input_ids=prompts[0], max_new_tokens=5),
            Request(input_ids=prompts[1], max_new_tokens=5, adapter_id=a1),
            Request(input_ids=prompts[2], max_new_tokens=5, adapter_id=a2)]
    assert _drive(eng, reqs) == refs


def test_adapter_freed_slot_returns_to_fused_base_path(setup):
    """After the adapter request retires the engine drops back to the base
    path (no adapter view in use), and a following base request equals the
    adapter-free engine's answer. The gathered view was built at
    registration and at the adapter's admission (its retirement only drops
    it), never per decode step."""
    cfg, _, tp = setup
    sp = _stacked_params(tp)
    ids = _ids(cfg, 2, 9)
    base_ref = _drive(_engine(cfg, sp), [Request(input_ids=ids, max_new_tokens=5)])[0]
    eng = _engine(cfg, sp)
    aid = eng.register_adapter(bridge.from_jax_numpy(_mk_adapter(cfg, seed=4), device="cpu"))
    assert eng.lora_view_builds == 1
    seen = []
    real = llama.decode_step

    def spy(params, *a, **k):
        seen.append(("lora_b" in params["layers"]["q_proj"], k.get("fused")))
        return real(params, *a, **k)
    llama.decode_step = spy
    try:
        _drive(eng, [Request(input_ids=ids, max_new_tokens=5, adapter_id=aid)])
        assert not eng._use_lora and eng.lora_view_builds == 2
        steps = eng.decode_steps
        assert steps >= 4 and seen == [(True, False)] * steps
        got = _drive(eng, [Request(input_ids=ids, max_new_tokens=5)])[0]
    finally:
        llama.decode_step = real
    assert got == base_ref and eng.lora_view_builds == 2
    assert seen[steps:] == [(False, None)] * (eng.decode_steps - steps)


def test_unknown_adapter_fails_request(setup):
    cfg, _, tp = setup
    eng = _engine(cfg, tp)
    req = Request(input_ids=np.arange(5, 12).astype(np.int32), max_new_tokens=3, adapter_id=5)
    assert _drive(eng, [req], ticks=10) == [[]]
    aid = eng.register_adapter(bridge.from_jax_numpy(_mk_adapter(cfg, seed=5), device="cpu"))
    pid = eng.register_prefix(np.arange(5, 9).astype(np.int32))
    both = Request(input_ids=np.arange(5, 12).astype(np.int32), max_new_tokens=3,
                   adapter_id=aid, prefix_id=pid)
    assert _drive(eng, [both], ticks=10) == [[]]


def test_stack_adapter_state_roundtrip(setup):
    cfg, _, _ = setup
    L = cfg.llm.num_layers
    st = {"rank": 2, "alpha": 4, "adapters": {
        "llm/layers/1/q_proj": {"A": torch.ones((2, 8)), "B": torch.full((8, 2), 2.0)}}}
    ab = tlora.stack_adapter_state(st, L)["adapters"]["llm/layers/q_proj"]
    assert ab["A"].shape == (L, 2, 8) and ab["B"].shape == (L, 8, 2)
    assert float(ab["A"][1].sum()) == 16 and float(ab["A"][0].sum()) == 0


def test_worker_load_adapter_from_peft_dir(setup, tmp_path):
    """save_lora_checkpoint (per-layer paths, PEFT names) ->
    BatchedWorker.load_adapter -> a request naming the adapter by name
    equals the merged model; an unnamed request is the base."""
    from slime_tpu_torch import checkpoint as tckpt
    from slime_tpu_torch.serve.batched_worker import BatchedWorker

    from .toy_tokenizer import ToyTokenizer

    cfg, _, tp = setup
    state = _mk_adapter(cfg, seed=6, r=4)
    state = {**state, "alpha": 8}
    per_layer = bridge.from_jax_numpy(_unstacked(state), device="cpu")
    tckpt.save_lora_checkpoint(str(tmp_path / "ad"), {}, per_layer, cfg)
    tok = ToyTokenizer()
    w = BatchedWorker(controller_addr=None, worker_addr="http://localhost:0", model_name="m",
                      params=_stacked_params(tp), cfg=cfg, tokenizer=tok, max_slots=2,
                      cache_len=96, register=False, device="cpu", prefix_cache_mb=0)
    w.engine.stop()                     # the test ticks the engine itself
    assert w.load_adapter("mine", str(tmp_path / "ad")) == 1 and w.adapters == {"mine": 1}
    assert w._adapter_id({"adapter": "mine"}) == 1 and w._adapter_id({"adapter_id": 0}) == 0
    assert w._adapter_id({}) is None
    ids = _ids(cfg, 7, 8)
    ref = _ref(cfg, tp, ids, 4, state)
    got = _drive(w.engine, [Request(input_ids=ids, max_new_tokens=4,
                                    adapter_id=w._adapter_id({"adapter": "mine"}))])[0]
    assert got == ref
