"""Loading checkpoints in the port (``checkpoint.load_pretrained``,
``to_torch``, ``load_for_serving``) and the entry points that load them:
the tests of ``tests/test_load_modes.py`` on the CPU with checkpoints
written by the JAX package's ``save_checkpoint`` / ``save_lora_checkpoint``
at ``SliMEConfig.tiny()``.

- Every mode gives the JAX package's loaded tree leaf for leaf (the same
  paths, dtypes and values): a full checkpoint, a base plus the staged
  pretraining's ``mm_projector.bin`` / ``sampler.bin``, a plain LM, and the
  quantized loads (8-bit, 4-bit in each int4 scheme, the int8 lm_head, the
  W8A8 tower), and a LoRA checkpoint merged into its base (also quantized
  after the merge). A LoRA checkpoint without a base, or whose factors map
  onto no weight, raises ValueError. ``save_lora_checkpoint`` writes the JAX
  package's files byte for byte.
- ``python -m slime_tpu_torch.serve.cli --device cpu`` on a saved tiny
  checkpoint with piped input prints an answer, with and without a draft
  model; without a card and without ``--device`` the entry points raise
  (``--adapter-path`` too); ``--tensor-parallel 2`` outside a launch of 2
  processes raises ValueError.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu import checkpoint as jckpt
from slime_tpu.config import SliMEConfig as JCfg
from slime_tpu.models import slime as jslime
from slime_tpu_torch import checkpoint as tckpt
from slime_tpu_torch.config import SliMEConfig
from slime_tpu_torch.models import llama
from slime_tpu_torch.params import named_leaves

from .hf_fixtures import make_hf_tokenizer_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cfg = JCfg.tiny()
    params = jslime.init(jax.random.PRNGKey(0), cfg)
    base = str(tmp_path_factory.mktemp("base"))
    jckpt.save_checkpoint(base, params, cfg)
    make_hf_tokenizer_dir(base)
    return cfg, params, base


def _same_tree(got, want):
    g = dict(named_leaves(got))
    w = {k: np.asarray(v) for k, v in named_leaves(want)}
    assert sorted(g) == sorted(w)
    for k, wv in w.items():
        gv = g[k].numpy()
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, k
        np.testing.assert_array_equal(gv, wv, err_msg=k)


def test_full_checkpoint_matches_jax(saved):
    jcfg, _, base = saved
    _same_tree(tckpt.load_pretrained(base, cfg=SliMEConfig.tiny()),
               jckpt.load_pretrained(base, cfg=jcfg))


def test_adapter_over_base_matches_jax(saved, tmp_path):
    """Base LLM + mm_projector.bin + sampler.bin (reference mode 2): the
    projector and sampler come from the adapter files, the LLM from the
    base."""
    jcfg, params, base = saved
    params2 = jslime.init(jax.random.PRNGKey(9), jcfg)
    adir = str(tmp_path / "adapters")
    jckpt.save_checkpoint(adir, params2, jcfg, adapters_only=True)
    got = tckpt.load_pretrained(adir, model_base=base, cfg=SliMEConfig.tiny())
    _same_tree(got, jckpt.load_pretrained(adir, model_base=base, cfg=jcfg))
    np.testing.assert_allclose(got["projector"]["w_gate"].numpy(),
                               np.asarray(params2["projector"]["w_gate"]), atol=1e-6)
    np.testing.assert_allclose(got["llm"]["embed_tokens"].numpy(),
                               np.asarray(params["llm"]["embed_tokens"]), atol=1e-6)


def test_plain_lm_matches_jax(saved, tmp_path):
    """An LM-only checkpoint (no vision tower in the files): no vision
    subtree, as JAX's."""
    jcfg, params, _ = saved
    lm = {k: v for k, v in jax.device_get(params).items() if k != "vision"}
    d = str(tmp_path / "lm")
    os.makedirs(d)
    jcfg.save(d)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          jckpt.export_state_dict(lm, jcfg).items()}
    torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    got = tckpt.load_pretrained(d, cfg=SliMEConfig.tiny())
    assert "vision" not in got
    _same_tree(got, jckpt.load_pretrained(d, cfg=jcfg))


@pytest.mark.parametrize("kw", [
    dict(load_bits=8), dict(load_bits=8, quantize_lm_head=True),
    dict(load_bits=4), dict(load_bits=4, int4_scheme="absmax"),
    dict(load_bits=4, int4_scheme="group", quantize_lm_head=True),
    dict(quantize_vision=True)])
def test_quantized_load_matches_jax(saved, kw):
    jcfg, _, base = saved
    _same_tree(tckpt.load_pretrained(base, cfg=SliMEConfig.tiny(), **kw),
               jckpt.load_pretrained(base, cfg=jcfg, **kw))


def test_forward_from_loaded_matches(saved):
    """``load_for_serving`` (fp32, CPU, stacked) runs the forward of the
    saved params."""
    jcfg, params, base = saved
    loaded = tckpt.load_for_serving(base, device="cpu", dtype=torch.float32)
    assert isinstance(loaded["llm"]["layers"], dict)
    ids = np.random.default_rng(0).integers(5, jcfg.llm.vocab_size, (1, 8))
    got = llama.forward(loaded["llm"], llama.embed(loaded["llm"], torch.from_numpy(ids)),
                        SliMEConfig.tiny().llm)[0]
    from slime_tpu.models import llama as jllama
    want = jllama.forward(params["llm"], jllama.embed(params["llm"], jnp.asarray(ids)),
                          jcfg.llm)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_to_torch_keeps_quantized_scales_fp32(saved):
    _, _, base = saved
    t = tckpt.to_torch(tckpt.load_pretrained(base, load_bits=8), torch.bfloat16, "cpu")
    w = t["llm"]["layers"][0]["q_proj"]["weight"]
    assert w["q"].dtype == torch.int8 and w["scale"].dtype == torch.float32
    assert t["llm"]["embed_tokens"].dtype == torch.bfloat16


def test_lora_checkpoint_raises(saved, tmp_path):
    """A LoRA checkpoint without ``model_base`` is refused, as is one whose
    factors map onto no loaded weight."""
    _, _, base = saved
    d = tmp_path / "lora"
    d.mkdir()
    SliMEConfig.tiny().save(str(d))
    torch.save({"base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight":
                torch.zeros(4, 32)}, d / "adapter_model.bin")
    with pytest.raises(ValueError, match="model_base"):
        tckpt.load_pretrained(str(d))
    torch.save({"base_model.model.model.layers.0.self_attn.q_proj.lora_A.magnitude":
                torch.zeros(4, 32)}, d / "adapter_model.bin")
    with pytest.raises(ValueError, match="did not map"):
        tckpt.load_pretrained(str(d), model_base=base)


def _lora_dir(saved, tmp_path, seed=3, with_config=True):
    from slime_tpu.train import lora as jlora
    jcfg, params, _ = saved
    state = jax.device_get(jlora.init_lora(jax.random.PRNGKey(1), params, r=4, alpha=8))
    r = np.random.default_rng(seed)
    for ab in state["adapters"].values():
        ab["B"] = (r.standard_normal(ab["B"].shape) * 0.05).astype(np.float32)
    d = str(tmp_path / "jax_lora")
    jckpt.save_lora_checkpoint(d, {"projector": params["projector"],
                                   "sampler": params["sampler"]}, state, jcfg)
    if not with_config:
        os.remove(os.path.join(d, "adapter_config.json"))
    return d, state


@pytest.mark.parametrize("load_bits,with_config", [(None, True), (None, False), (8, True)])
def test_lora_checkpoint_matches_jax(saved, tmp_path, load_bits, with_config):
    """The LoRA load mode: adapter_model.bin (+ adapter_config.json, or the
    rank from the factors and alpha = 2r) and non_lora_trainables.bin over
    model_base, merged at load, leaf for leaf JAX's tree."""
    jcfg, _, base = saved
    d, _ = _lora_dir(saved, tmp_path, with_config=with_config)
    _same_tree(tckpt.load_pretrained(d, model_base=base, load_bits=load_bits),
               jckpt.load_pretrained(d, model_base=base, load_bits=load_bits))
    sd = tckpt.load_state_dict_file(os.path.join(d, "adapter_model.bin"))
    assert tckpt._lora_rank_alpha(d, sd) == jckpt._lora_rank_alpha(d, sd) == (4, 8)


def test_save_lora_checkpoint_files_match_jax(saved, tmp_path):
    from slime_tpu_torch import params as bridge
    jcfg, params, _ = saved
    d, state = _lora_dir(saved, tmp_path)
    out = str(tmp_path / "port_lora")
    tp = bridge.from_jax_numpy(jax.device_get(params), device="cpu")
    tckpt.save_lora_checkpoint(out, {"projector": tp["projector"], "sampler": tp["sampler"]},
                               bridge.from_jax_numpy(state, device="cpu"),
                               SliMEConfig.from_json_dict(jcfg.to_json_dict()))
    names = sorted(os.listdir(d))
    assert names == sorted(os.listdir(out)) == ["adapter_config.json", "adapter_model.bin",
                                                "config.json", "non_lora_trainables.bin"]
    for name in names:
        with open(os.path.join(d, name), "rb") as a, open(os.path.join(out, name), "rb") as b:
            assert a.read() == b.read(), name


# ---------------------------------------------------------------- entry points

def _cli(args, stdin):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "slime_tpu_torch.serve.cli"] + args,
                          input=stdin, capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)


def test_cli_answers_piped_input(saved):
    _, _, base = saved
    r = _cli(["--model-path", base, "--device", "cpu", "--max-new-tokens", "4",
              "--temperature", "0"], "hello world\n")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Assistant:" in r.stdout and len(r.stdout.split("Assistant:")[1].strip()) > 0


def test_cli_speculative_answer(saved, monkeypatch, capsys):
    """With ``--draft-model-path`` and no image, the answer is greedy
    speculative decoding (``speculative_generate_device``), here with the
    checkpoint as its own draft; two turns."""
    import io

    from slime_tpu_torch.serve import cli
    _, _, base = saved
    monkeypatch.setattr("sys.stdin", io.StringIO("hello world\nwhat is\n"))
    cli.main(["--model-path", base, "--device", "cpu", "--max-new-tokens", "4",
              "--draft-model-path", base])
    out = capsys.readouterr().out
    assert out.count("[spec-accept") == 2


def test_entry_points_run_on_the_card_unless_asked(saved, monkeypatch):
    from slime_tpu_torch.serve import batched_worker, cli, model_worker
    _, _, base = saved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (cli.main, batched_worker.main, model_worker.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--model-path", base])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batched_worker.main(["--model-path", base, "--adapter-path", "a=b"])
    for main in (cli.main, batched_worker.main):
        with pytest.raises(ValueError, match="launch of 1 processes"):
            main(["--model-path", base, "--tensor-parallel", "2"])
