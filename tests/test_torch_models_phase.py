"""Phase 13 of ``chip_smoke.py`` (the other model families) on the CPU at
small widths: a narrow Mixtral-family SliME (4 experts, top 2, 2 layers),
``MPTConfig.tiny()`` and a Mamba block at d_model 32, with
``torch.cuda``'s synchronisation and memory calls and the profiler stubbed.
Its logic runs end to end (the MoE layer check in fp32 and bf16, the
per-token loop, ``generate`` against full forwards, the engine on an int8
pool against ``generate``, the training backward with the router aux, MPT
bf16 against fp32 and the Mamba block against its sequential scan), and
it launches no kernel (the CPU takes every kernel's plain version, so every
count stays 0; the launch checks run on the card only).

``router_tie_rule``, which holds two bf16 runs' tokens to each other, is
also driven on made-up routing: it takes equal tokens, a split at a logit
near tie with no routing change, and a split whose first routing change is
a router near tie (later layers' changes follow from it), and it raises on
a split with neither, on a first routing change at a wide gate gap, and on
a tape that misses a position."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from slime_tpu_torch.config import LLMConfig, SliMEConfig, VisionConfig
from slime_tpu_torch.models.mpt import MPTConfig

from .test_torch_eval import two_torch_threads  # noqa: F401


def _tiny_mixtral():
    """336-px crops (bench.py's query is a 672x672 image) through a narrow
    tower; a narrow Mixtral-family LLM."""
    return SliMEConfig(
        llm=LLMConfig(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=16, max_position_embeddings=2048,
                      num_experts=4, num_experts_per_tok=2),
        vision=VisionConfig(image_size=336, patch_size=14, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2),
        mm_resampler_dim=4, seperator=7, tokenizer_model_max_length=1024,
        bos_token_id=1, eos_token_id=2)


def test_model_families_phase_runs_on_the_cpu(monkeypatch, capsys):
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(cs, "profiled", lambda fn, path, start=None, tries=3: (fn(), False)[1])
    monkeypatch.setattr(cs, "mixtral_config", _tiny_mixtral)
    monkeypatch.setattr(cs, "mpt_config", MPTConfig.tiny)
    monkeypatch.setattr(cs, "MPT_SEQ", 48)
    monkeypatch.setattr(cs, "MAMBA_SHAPE", (2, 120, 32))
    monkeypatch.setattr(cs, "MOE_NEW", 12)
    counts = cs.model_families_phase(torch.device("cpu"))
    out = capsys.readouterr().out
    assert not any(counts.values())
    for line in ("phase 13 _moe layer 0, 64 tokens sparse against 4 dense chunks of 16, "
                 "float32", "bfloat16: max |diff|", "moe_ffn_sparse against a per-token loop",
                 "phase 13 Mixtral generate: 12 tokens", "against full forwards, float32: 8 tokens",
                 "against full forwards, bfloat16: ",
                 "phase 13 engine, float32 (int8 KV pool", "phase 13 query A, fp32: 12 tokens",
                 "phase 13 engine, bfloat16 (int8 KV pool",
                 "phase 13 query A, bf16 engine against bf16 generate (int8 cache): ",
                 "phase 13 text 300, bf16 engine against bf16 generate (int8 cache): ", "phase 13 Mixtral train "
                 "step (2 layers", "phase 13 MPT forward [1, 48]", "phase 13 Mamba block, "
                 "d_model 32", "phase 13 took"):
        assert line in out, line


def _tape(logits, n_layers=2):
    """A ``RoutingTape`` holding ``logits`` [L, n, E] of one sequence (key 0),
    its top-2 as ``llama.top_k_stable`` picks it."""
    from slime_tpu_torch.models.llama import top_k_stable
    tape = cs.RoutingTape(n_layers, None)
    lg = torch.tensor(logits, dtype=torch.float32)
    tape.chunks[0] = [(li, 0, lg[li], top_k_stable(lg[li], 2)[1]) for li in range(n_layers)]
    return tape


def _routing(n=6, E=4, seed=0):
    """Gate logits [2, n, E] with clear top-2 margins (about 1.0, where a
    bf16 ulp of the row's largest |logit| is 2^-6 to 2^-5)."""
    rng = np.random.default_rng(seed)
    base = np.array([2.5, 1.5, 0.5, -0.5], np.float32)
    return np.stack([np.stack([rng.permutation(base) for _ in range(n)]) for _ in range(2)])


@pytest.mark.parametrize("case", ["equal", "logit_tie", "router_tie", "router_tie_then_wide",
                                  "no_tie", "wide_router_gap", "short_tape"])
def test_router_tie_rule(case):
    a = _routing()
    b = a.copy()
    got, want = [5, 6, 7], [5, 6, 7]
    logits = np.zeros((3, 10), np.float32)
    if case != "equal":
        want = [5, 6, 8]                                # parts at step 2: positions 0 .. 5
        logits[2, 7], logits[2, 8] = 1.0, 1.0 - (0.1 if case != "no_tie" else 1.0)
    if case in ("router_tie", "router_tie_then_wide", "wide_router_gap"):
        # position 3, layer 0: the 2nd and 3rd logits sit 1 ulp (2^-6) apart
        # in run a, swapped in run b; "wide": 0.5 apart, swapped
        gap = 0.5 if case == "wide_router_gap" else 2.0 ** -6
        row = np.array([2.5, 1.0, 1.0 - gap, -0.5], np.float32)
        a[0, 3], b[0, 3] = row, row[[0, 2, 1, 3]]
    if case == "router_tie_then_wide":
        b[1, 4] = b[1, 4][::-1]                          # layer 1 follows layer 0's flip
    tapes = (_tape(a), _tape(b if case != "short_tape" else b[:, :4]))
    run = lambda: cs.router_tie_rule(case, got, want, tapes, (0, 0), 4,  # noqa: E731
                                     lambda j: torch.from_numpy(logits[j]))
    if case in ("no_tie", "wide_router_gap", "short_tape"):
        with pytest.raises(AssertionError):
            run()
        return
    assert run() == {"equal": None, "logit_tie": (2, None), "router_tie": (2, 0),
                     "router_tie_then_wide": (2, 0)}[case]


def test_routing_tapes_line_up():
    """The engine's tape (``engine_rows``: a chunked multimodal admission, a
    chunked text one, decode ticks over 2 slots) and each ``generate``'s
    (``sequence_rows``) name the same (layer, position) for the same token:
    in fp32 compute on bf16 weights the two runs' top-k agree at every
    position a request's tokens saw and their gate logits within 1e-4."""
    import dataclasses

    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.models import slime
    from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request

    dev, f32, new = torch.device("cpu"), torch.float32, 6
    cfg = dataclasses.replace(_tiny_mixtral(), eos_token_id=-1)
    params = cs.mixtral_params(dev, cfg)
    img, ids, attn, anyres = cs.query(dev, cfg)
    crops, mask = anyres(img)
    n_mm = int(slime.prepare_multimodal(params, cfg, ids, attn, crops[None], mask[None],
                                        compute_dtype=f32).lengths[0])
    text = np.random.default_rng(3).integers(5, cfg.llm.vocab_size, (300,))
    prompts = [(ids[0].numpy(), crops, mask, n_mm), (text, None, None, 300)]
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=768, compute_dtype=f32,
                            kv_quant=True, prefix_cache_mb=0, device=dev)
    reqs = [Request(input_ids=p[0], pixel_values=p[1], crop_mask=p[2], max_new_tokens=new)
            for p in prompts]
    with cs.RoutingTape(cfg.llm.num_layers, cs.engine_rows(eng)) as tape:
        for r in reqs:
            eng.submit(r)
        for _ in range(200):
            if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
                break
    assert sum(eng.chunk_rows.values()) >= 4               # both admissions chunked
    for p, r in zip(prompts, reqs):
        t = torch.from_numpy(p[0][None].astype(np.int64))
        with cs.RoutingTape(cfg.llm.num_layers, cs.sequence_rows(0, p[3])) as gtape:
            want = gen.generate(params, cfg, t, torch.ones_like(t, dtype=torch.bool),
                                None if p[1] is None else p[1][None],
                                None if p[2] is None else p[2][None], max_new_tokens=new,
                                compute_dtype=f32, kv_quant=True)[0].tolist()
        assert [x for c in r.stream() for x in c] == want
        lg_e, ti_e = tape.table(id(r), p[3] + new - 1)
        lg_g, ti_g = gtape.table(0, p[3] + new - 1)
        np.testing.assert_array_equal(np.sort(ti_e, -1), np.sort(ti_g, -1))
        np.testing.assert_allclose(lg_e, lg_g, atol=1e-4)
