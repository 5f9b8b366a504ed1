"""The whole slice against the JAX package: prepare_multimodal, greedy
generate and generate_stream on bench.py's query shape (a 672x672 image, a
64-token prompt with the image sentinel at position 2), at reduced width in
fp32; the CLI's 4-bit serving configurations (config A: q4g LLM layers, int8
lm_head, W8A8 vision; config B: per-row q4 layers, int8 lm_head), built by
``checkpoint.quantize_loaded`` byte for byte as JAX's ``load_pretrained``
quantizes, with token-exact greedy generate on the same tree; and a check
that the port runs without importing jax.

JAX's ViT attention runs its Pallas kernel in interpret mode (what it runs on
a TPU), and JAX prefill takes ``use_pallas=False``, the configuration the
port implements. Tolerance 1e-4 relative for the composed embeddings; token
ids, masks and lengths must be equal.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slime_tpu.ops.encoder_attention as jea
from slime_tpu.config import LLMConfig, SliMEConfig, VisionConfig
from slime_tpu.constants import IMAGE_TOKEN_INDEX
from slime_tpu import generate as jgen
from slime_tpu.data.image_ops import make_device_anyres_fn as j_anyres
from slime_tpu.models import llama as jllama
from slime_tpu.models import slime as jslime
from slime_tpu.models import vit as jvit
from slime_tpu.ops.quantization import quantize_params as jquantize_params
from slime_tpu_torch import generate as tgen
from slime_tpu_torch import params as bridge
from slime_tpu_torch.checkpoint import quantize_loaded
from slime_tpu_torch.data.image_ops import make_device_anyres_fn as t_anyres
from slime_tpu_torch.models import llama as tllama
from slime_tpu_torch.models import slime as tslime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    return SliMEConfig(
        llm=LLMConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                      max_position_embeddings=1024),
        vision=VisionConfig(image_size=336, patch_size=14, hidden_size=256,
                            intermediate_size=512, num_layers=3, num_heads=4),
        mm_resampler_dim=4, seperator=7, tokenizer_model_max_length=700,
        bos_token_id=1, eos_token_id=2)


class _IdText:
    """Minimal tokenizer for generate_stream: ids -> space-joined text."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def query():
    """Shared JAX params (stacked LLM layers), inputs and both packages'
    preprocessed crops."""
    cfg = _cfg()
    p = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    r = np.random.default_rng(0)
    p["projector"]["w_gate"] = r.standard_normal((256, 2)).astype(np.float32)
    p["llm"]["layers"] = jax.device_get(jllama.stack_layers(p["llm"]["layers"]))
    ids = r.integers(5, cfg.llm.vocab_size, (1, 64)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    img = r.integers(0, 255, (672, 672, 3), dtype=np.uint8)
    jc, jm = j_anyres((672, 672))(jnp.asarray(img))
    tc, tm = t_anyres((672, 672), device="cpu")(torch.from_numpy(img))
    return dict(cfg=cfg, jp=jax.tree_util.tree_map(jnp.asarray, p),
                tp=bridge.from_jax_numpy(p, device="cpu"), ids=ids, attn=np.ones((1, 64), bool),
                jpx=(jc[None], jm[None]), tpx=(tc[None], tm[None]))


@pytest.fixture
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


def test_prepare_multimodal(query, jax_kernel_attention):
    q = query
    want = jslime.prepare_multimodal(q["jp"], q["cfg"], jnp.asarray(q["ids"]),
                                     jnp.asarray(q["attn"]), *q["jpx"])
    got = tslime.prepare_multimodal(q["tp"], q["cfg"], torch.from_numpy(q["ids"]).long(),
                                    torch.from_numpy(q["attn"]), *q["tpx"])
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.attn_mask.numpy(), np.asarray(want.attn_mask))
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.embeds.numpy(), np.asarray(want.embeds),
                               rtol=1e-4, atol=1e-5)
    # global view + separator + some selected local tokens + 63 text tokens
    assert 576 + 1 + 63 < int(got.lengths[0]) < 576 + 1 + 63 + 4 * 4
    assert tslime.image_token_budget(q["cfg"]) == jslime.image_token_budget(q["cfg"])


def test_generate_greedy_token_exact(query, jax_kernel_attention):
    q = query
    want = jgen.generate(q["jp"], q["cfg"], jnp.asarray(q["ids"]), jnp.asarray(q["attn"]),
                         *q["jpx"], max_new_tokens=10, eos_id=-1, use_pallas=False)
    got = tgen.generate(q["tp"], q["cfg"], torch.from_numpy(q["ids"]).long(),
                        torch.from_numpy(q["attn"]), *q["tpx"],
                        max_new_tokens=10, eos_id=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tgen.trim_at_eos(got, -1) == jgen.trim_at_eos(np.asarray(want), -1)


def test_generate_stream_same_text(query, jax_kernel_attention):
    q = query
    cfg = dataclasses.replace(q["cfg"], eos_token_id=-1)
    want = list(jgen.generate_stream(q["jp"], cfg, _IdText(), jnp.asarray(q["ids"]),
                                     jnp.asarray(q["attn"]), *q["jpx"],
                                     max_new_tokens=7, chunk=3))
    got = list(tgen.generate_stream(q["tp"], cfg, _IdText(),
                                    torch.from_numpy(q["ids"]).long(),
                                    torch.from_numpy(q["attn"]), *q["tpx"],
                                    max_new_tokens=7, chunk=3))
    assert got == want and len(got) == 3


def test_generate_text_only_token_exact(query):
    q = query
    ids = np.random.default_rng(7).integers(5, 256, (2, 12)).astype(np.int32)
    attn = np.ones((2, 12), bool)
    attn[1, 9:] = False
    want = jgen.generate(q["jp"], q["cfg"], jnp.asarray(ids), jnp.asarray(attn),
                         max_new_tokens=6, eos_id=-1, use_pallas=False)
    got = tgen.generate(q["tp"], q["cfg"], torch.from_numpy(ids).long(),
                        torch.from_numpy(attn), max_new_tokens=6, eos_id=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cfg_4bit():
    """q4g needs contractions that are multiples of 256: LLM hidden 256."""
    cfg = _cfg()
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, hidden_size=256, intermediate_size=512, head_dim=64))


def _jax_load_step(p, cfg, scheme, quantize_vision):
    """The quantization step of JAX's ``load_pretrained``
    (checkpoint.py:368-393) with --load-4bit --int4-scheme ``scheme``
    --quantize-lm-head [--quantize-vision], on a list-of-layers tree."""
    p = dict(p, llm=dict(p["llm"]))
    p["llm"]["layers"] = jquantize_params(p["llm"]["layers"], bits=4, min_size=1024,
                                          scheme=scheme)
    p["llm"]["lm_head"] = jquantize_params(p["llm"]["lm_head"], bits=8, min_size=1024)
    if quantize_vision:
        p["vision"] = jvit.quantize_tower(p["vision"], cfg.vision)
    return p


@pytest.fixture(scope="module", params=["A", "B"])
def query_4bit(request, query):
    """Config A (--int4-scheme group --quantize-lm-head --quantize-vision) or
    B (--int4-scheme absmax --quantize-lm-head), quantized by both packages
    from the same fp32 tree; layers stacked after quantizing, as JAX does."""
    cfg = _cfg_4bit()
    scheme, vision = {"A": ("group", True), "B": ("absmax", False)}[request.param]
    p = jax.device_get(jslime.init(jax.random.PRNGKey(1), cfg))
    p["projector"]["w_gate"] = np.random.default_rng(2).standard_normal(
        (256, 2)).astype(np.float32)
    jq = jax.device_get(_jax_load_step(jax.tree_util.tree_map(jnp.asarray, p), cfg,
                                       scheme, vision))
    tq = quantize_loaded(bridge.from_jax_numpy(p, device="cpu"), cfg, load_bits=4,
                         int4_scheme=scheme, quantize_lm_head=True,
                         quantize_vision=vision)
    jq["llm"]["layers"] = jax.device_get(jllama.stack_layers(jq["llm"]["layers"]))
    return dict(query, cfg=cfg, name=request.param, jq=jq, tq=tq,
                jp=jax.tree_util.tree_map(jnp.asarray, jq))


def test_quantize_loaded_equals_jax_load_step(query_4bit):
    """Every leaf of the port's quantized tree (layers stacked after) equals
    JAX's, byte for byte and dtype for dtype."""
    q = query_4bit
    tq = q["tq"]
    got = bridge.to_jax_numpy(dict(tq, llm=dict(
        tq["llm"], layers=tllama.stack_layers(tq["llm"]["layers"]))))
    got, want = (jax.tree_util.tree_leaves_with_path(t) for t in (got, q["jq"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    fmt = "q4g" if q["name"] == "A" else "q4"
    assert fmt in tq["llm"]["layers"][0]["gate_proj"]["weight"]
    assert "q" in tq["llm"]["lm_head"]["weight"]
    assert ("qkv" in tq["vision"]["layers"][0]) == (q["name"] == "A")


def test_generate_4bit_token_exact(query_4bit, jax_kernel_attention):
    """Greedy generate on the same quantized tree: JAX on the CPU (dequantize
    paths, W8A8 reference, non-fused decode) and the port on the CPU (its
    plain versions; config A decodes through the fused structure, B through
    the non-fused path)."""
    q = query_4bit
    tp = bridge.from_jax_numpy(q["jq"], device="cpu")
    want = jgen.generate(q["jp"], q["cfg"], jnp.asarray(q["ids"]), jnp.asarray(q["attn"]),
                         *q["jpx"], max_new_tokens=8, eos_id=-1, use_pallas=False)
    got = tgen.generate(tp, q["cfg"], torch.from_numpy(q["ids"]).long(),
                        torch.from_numpy(q["attn"]), *q["tpx"], max_new_tokens=8, eos_id=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_token_top_p_support():
    """Sampling draws only from the nucleus JAX's rule keeps (the token whose
    exclusive cumulative probability crosses top_p is kept)."""
    logits = np.log(np.array([[0.5, 0.3, 0.15, 0.05], [0.05, 0.05, 0.1, 0.8]],
                             np.float32))
    g = torch.Generator().manual_seed(0)
    seen = {0: set(), 1: set()}
    for _ in range(200):
        tok = tgen.sample_token(torch.from_numpy(logits),
                                temperature=1.0, top_p=0.7, generator=g)
        for b in (0, 1):
            seen[b].add(int(tok[b]))
    assert seen == {0: {0, 1}, 1: {3}}
    greedy = tgen.sample_token(torch.from_numpy(logits))
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(jgen.sample_token(None, jnp.asarray(logits))))


def test_port_runs_without_jax():
    """Import the port, run a tiny slice and two training steps in a fresh
    process without the test suite's JAX setup; jax must never be imported."""
    script = textwrap.dedent("""
        import sys
        import numpy as np, torch
        from slime_tpu_torch import generate, params
        from slime_tpu_torch.config import (IMAGE_TOKEN_INDEX, LLMConfig,
                                            SliMEConfig, VisionConfig)
        from slime_tpu_torch.data.image_ops import make_device_anyres_fn
        from slime_tpu_torch.models import llama, slime
        cfg = SliMEConfig(
            llm=LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                          num_layers=1, num_heads=2, num_kv_heads=1, head_dim=16,
                          max_position_embeddings=256),
            vision=VisionConfig(image_size=56, patch_size=14, hidden_size=32,
                                intermediate_size=64, num_layers=2, num_heads=2),
            mm_resampler_dim=4, seperator=7, tokenizer_model_max_length=128,
            bos_token_id=1, eos_token_id=2)
        p = slime.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        p["llm"]["layers"] = llama.stack_layers(p["llm"]["layers"])
        crops, mask = make_device_anyres_fn((112, 112), tile=56, device="cpu")(
            torch.randint(0, 255, (112, 112, 3), dtype=torch.uint8))
        ids = torch.randint(5, 64, (1, 16)); ids[0, 2] = IMAGE_TOKEN_INDEX
        out = generate.generate(p, cfg, ids, torch.ones((1, 16), dtype=torch.bool),
                                crops[None], mask[None], max_new_tokens=4, eos_id=-1)
        assert out.shape == (1, 4)
        # two steps of training stage 1 through run_stage
        import dataclasses, tempfile
        from slime_tpu_torch.train.optim import TrainConfig
        from slime_tpu_torch.train.trainer import RunConfig, run_stage
        batch = {"input_ids": ids.numpy().astype(np.int32),
                 "labels": np.where(ids.numpy() < 0, -100, ids.numpy()).astype(np.int32),
                 "attention_mask": np.ones((1, 16), bool),
                 "pixel_values": crops[None].numpy(), "crop_mask": mask[None].numpy()}
        _, m = run_stage(p, dataclasses.replace(cfg, use_global_only=True,
                                                mm_learnable_gated=0),
                         TrainConfig(total_steps=2, tune_mm_mlp_adapter=True,
                                     mm_learnable_gated=0),
                         RunConfig(output_dir=tempfile.mkdtemp(), save_steps=0,
                                   log_steps=1), [batch, batch],
                         compute_dtype=torch.float32, remat=True)
        assert np.isfinite(m["loss"])
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
        assert not bad, bad
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items()
           if k not in ("SLIME_PLATFORM", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_import_hides_slime_platform():
    """With SLIME_PLATFORM set (the JAX package's switch to import jax at
    package import), importing the port and every module ``chip_smoke.py``
    uses loads no jax and leaves the variable as it was."""
    script = textwrap.dedent("""
        import os, sys
        import slime_tpu_torch
        from slime_tpu_torch import config, generate, params
        from slime_tpu_torch.data import image_ops
        from slime_tpu_torch.models import layers, llama, projector, sampler, slime, vit
        from slime_tpu_torch.ops import _cuda, encoder_attention, fused_mlp, fused_qkvo
        from slime_tpu_torch.ops import flash_attention, loss
        from slime_tpu_torch.data import dataset
        from slime_tpu_torch.train import optim, step, trainer
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
        assert not bad, bad
        assert os.environ["SLIME_PLATFORM"] == "cpu"
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, SLIME_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py runs where there is no jax: it names neither jax nor the
    JAX package, only ``slime_tpu_torch``."""
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert "slime_tpu_torch" in {n.split(".")[0] for n in names}
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "jaxlib", "slime_tpu"))
    assert not bad, bad


@pytest.mark.parametrize("entry", ["prefill", "decode"])
def test_entry_points_accumulate_in_fp32(monkeypatch, entry):
    """generate's prefill and decode loop run with TF32 and reduced-precision
    reductions off, whatever the caller set, and restore the caller's
    settings afterwards (here with the model replaced by a probe)."""
    mm = torch.backends.cuda.matmul
    flags = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    seen = []

    class Probe(Exception):
        pass

    def probe(*args, **kwargs):
        seen.append([getattr(mm, f) for f in flags] + [torch.backends.cudnn.allow_tf32])
        raise Probe

    saved = [getattr(mm, f) for f in flags] + [torch.backends.cudnn.allow_tf32]
    try:
        for f in flags:
            setattr(mm, f, True)
        torch.backends.cudnn.allow_tf32 = True
        cfg = _cfg()
        ids = torch.ones((1, 4), dtype=torch.long)
        with pytest.raises(Probe):
            if entry == "prefill":
                monkeypatch.setattr(tgen.llama, "forward", probe)
                tgen.prefill({"llm": {"embed_tokens": torch.zeros((256, 64))}}, cfg, ids,
                             torch.ones((1, 4), dtype=torch.bool), None, None,
                             torch.float32)
            else:
                monkeypatch.setattr(tgen.llama, "decode_step", probe)
                tgen._decode_loop({}, {}, ids[:, 0].to(torch.int32), -1, cfg=cfg,
                                  max_new_tokens=2, temperature=0.0, top_p=1.0,
                                  compute_dtype=torch.float32, generator=None)
        assert seen == [[False] * 4]
        assert [getattr(mm, f) for f in flags] + [torch.backends.cudnn.allow_tf32] == [True] * 4
    finally:
        for f, v in zip(flags, saved):
            setattr(mm, f, v)
        torch.backends.cudnn.allow_tf32 = saved[-1]
