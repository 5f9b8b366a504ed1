"""The port's checkpoint tools (``slime_tpu_torch.tools``) against the JAX
package's scripts, on the CPU at ``SliMEConfig.tiny`` widths:

- ``verify_released_weights``: ``scripts/verify_released_weights.py
  --record --skip-quant`` writes the golden from the JAX forward; the port's
  verifier on the same directory returns 0 with ``logit_parity`` (1e-3) and
  all three ``greedy_generation_*`` PASS, so the check is a cross-package
  one; one corrupted weight makes it return 1; with no golden it fails;
  ``--record`` writes a golden whose tokens are JAX's and whose logits are
  within 1e-3 of JAX's; the quantized loads (int8, NF4) run and report with
  JAX's test's loose bars (0.5, 0.0); the probe inputs are the JAX
  script's arrays;
- ``weight_tools``: ``consolidate``, ``make-delta`` and ``apply-delta`` write
  the JAX script's tensors, and apply-delta after make-delta gives the
  target back;
- ``extract_mm_projector`` writes the JAX script's keys and values;
- ``merge_lora_weights`` on a LoRA checkpoint over a base writes a checkpoint
  that ``load_pretrained`` reads leaf for leaf as the JAX script's merge;
- ``convert_sqa_to_llava`` on a 3-problem synthetic ScienceQA directory
  writes the JAX script's files, in both variants.

JAX's ViT attention runs its Pallas kernel in interpret mode. Tolerance:
logits 1e-3 (the verifier's own bar); tokens, keys and files exact.
"""
import functools
import importlib.util
import json
import os
import shutil
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import slime_tpu.ops.encoder_attention as jea
from slime_tpu import checkpoint as jckpt
from slime_tpu.config import SliMEConfig
from slime_tpu.models import slime as jslime
from slime_tpu_torch import checkpoint as tckpt
from slime_tpu_torch.config import SliMEConfig as TConfig
from slime_tpu_torch.params import named_leaves
from slime_tpu_torch.tools import (convert_sqa_to_llava, extract_mm_projector,
                                   merge_lora_weights, verify_released_weights, weight_tools)

from .test_torch_eval import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name + "_script", os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(name, argv):
    with mock.patch("sys.argv", [name + ".py"] + argv):
        return _script(name).main()


@pytest.fixture(autouse=True)
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A tiny checkpoint written by the JAX package, and the JAX script's
    golden recorded on it."""
    cfg = SliMEConfig.tiny()
    params = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    d = str(tmp_path_factory.mktemp("released"))
    jckpt.save_checkpoint(d, params, cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jea, "encoder_attention",
                   functools.partial(jea.encoder_attention, interpret=True))
        assert _script("verify_released_weights").main([d, "--record", "--skip-quant"]) == 0
    return d


def verify(argv):
    return verify_released_weights.main(argv + ["--device", "cpu"])


def test_port_verifies_the_jax_golden(exported, capsys):
    assert verify([exported, "--skip-quant"]) == 0
    out = capsys.readouterr().out
    for name in ("load_full", "logit_parity", "greedy_generation_0", "greedy_generation_1",
                 "greedy_generation_2"):
        assert f"[PASS] {name}" in out, out
    assert json.loads(out.splitlines()[-1])["ok"] is True


def test_corrupted_weight_fails(exported, tmp_path, capsys):
    from safetensors.torch import load_file, save_file

    d = str(tmp_path / "bad")
    shutil.copytree(exported, d)
    fp = os.path.join(d, "model.safetensors")
    sd = load_file(fp)
    g = torch.Generator().manual_seed(0)
    for k in sd:
        if "layers.0.self_attn.q_proj.weight" in k:
            sd[k] = sd[k] + 0.05 * torch.randn(sd[k].shape, generator=g).to(sd[k].dtype)
    save_file(sd, fp)
    assert verify([d, "--skip-quant"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] logit_parity" in out and json.loads(out.splitlines()[-1])["ok"] is False


def test_missing_golden_fails(exported, tmp_path, capsys):
    assert verify([exported, "--skip-quant", "--golden", str(tmp_path / "none.npz")]) == 1
    assert "[FAIL] golden_present" in capsys.readouterr().out


def test_port_record_is_the_jax_golden(exported, tmp_path):
    g = str(tmp_path / "port_golden.npz")
    assert verify([exported, "--record", "--skip-quant", "--golden", g]) == 0
    mine, jax_g = np.load(g), np.load(os.path.join(exported, "slime_tpu_golden.npz"))
    assert sorted(mine.files) == sorted(jax_g.files)
    np.testing.assert_allclose(mine["last_logits"], jax_g["last_logits"], atol=1e-3, rtol=0)
    for i in range(3):
        k = f"gen_tokens_{i}"
        assert mine[k].dtype == jax_g[k].dtype and (mine[k] == jax_g[k]).all()


def test_quant_modes_report(exported, capsys):
    """int8/NF4 loads run and report top-1 agreement, with JAX's test's bars."""
    assert verify([exported, "--top1-int8", "0.5", "--top1-int4", "0.0"]) == 0
    out = capsys.readouterr().out
    assert "[PASS] load_int8" in out and "[PASS] load_int4" in out


@pytest.mark.parametrize("preset", ["tiny", "slime_8b"])
def test_probe_inputs_are_the_jax_scripts(preset):
    jmod = _script("verify_released_weights")
    cfg = getattr(SliMEConfig, preset)()
    if preset == "slime_8b":          # the 8B pixels are 2 x 8 x 3 x 336^2; keep the ids
        cfg = SliMEConfig(llm=cfg.llm, vision=SliMEConfig.tiny().vision)
    for a, b in zip(verify_released_weights.probe_inputs(cfg), jmod.probe_inputs(cfg)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(verify_released_weights.gen_prompts(cfg), jmod.gen_prompts(cfg)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _tensors(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _same_tensors(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def target(exported, tmp_path_factory):
    """A finetuned copy of the exported checkpoint: every leaf moved."""
    from safetensors.torch import load_file, save_file

    d = str(tmp_path_factory.mktemp("target"))
    shutil.copytree(exported, d, dirs_exist_ok=True)
    fp = os.path.join(d, "model.safetensors")
    sd = load_file(fp)
    g = torch.Generator().manual_seed(1)
    save_file({k: v + 0.01 * torch.randn(v.shape, generator=g).to(v.dtype)
               for k, v in sd.items()}, fp)
    return d


def test_delta_round_trip_matches_jax(exported, target, tmp_path):
    for who, run in (("j", lambda a: run_script("weight_tools", a)),
                     ("t", weight_tools.main)):
        run(["make-delta", "--base", exported, "--target", target,
             "--delta", str(tmp_path / who / "delta")])
        run(["apply-delta", "--base", exported, "--delta", str(tmp_path / who / "delta"),
             "--target", str(tmp_path / who / "back")])
        run(["consolidate", "--src", target, "--dst", str(tmp_path / who / "one")])
    for name in ("delta", "back", "one"):
        _same_tensors(_tensors(tmp_path / "t" / name / "pytorch_model.bin"),
                      _tensors(tmp_path / "j" / name / "pytorch_model.bin"))
        assert ((tmp_path / "t" / name / "config.json").read_bytes()
                == (tmp_path / "j" / name / "config.json").read_bytes())
    back = tckpt.load_sharded_state_dict(str(tmp_path / "t" / "back"))
    want = tckpt.load_sharded_state_dict(target)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_allclose(back[k], want[k], rtol=0, atol=1e-6)


def test_extract_mm_projector_matches_jax(exported, tmp_path):
    run_script("extract_mm_projector", ["--model-path", exported, "--output",
                                        str(tmp_path / "j")])
    extract_mm_projector.main(["--model-path", exported, "--output", str(tmp_path / "t")])
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) == ["mm_projector.bin", "sampler.bin"]
    for name in names:
        _same_tensors(_tensors(tmp_path / "t" / name), _tensors(tmp_path / "j" / name))


def test_merge_lora_weights_matches_jax(exported, tmp_path):
    from slime_tpu.train import lora as jlora

    cfg = SliMEConfig.tiny()
    params = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    state = jax.device_get(jlora.init_lora(jax.random.PRNGKey(1), params, r=4, alpha=8))
    r = np.random.default_rng(3)
    for ab in state["adapters"].values():
        ab["B"] = (r.standard_normal(ab["B"].shape) * 0.05).astype(np.float32)
    lora = str(tmp_path / "lora")
    jckpt.save_lora_checkpoint(lora, {"projector": params["projector"],
                                      "sampler": params["sampler"]}, state, cfg)
    argv = ["--model-path", lora, "--model-base", exported, "--save-model-path"]
    run_script("merge_lora_weights", argv + [str(tmp_path / "j")])
    merge_lora_weights.main(argv + [str(tmp_path / "t")])
    got = dict(named_leaves(tckpt.load_pretrained(str(tmp_path / "t"))))
    want = dict(named_leaves(tckpt.load_pretrained(str(tmp_path / "j"))))
    direct = dict(named_leaves(tckpt.load_pretrained(lora, model_base=exported)))
    assert sorted(got) == sorted(want) == sorted(direct)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], direct[k]), k
    base = dict(named_leaves(tckpt.load_pretrained(exported)))
    assert not torch.equal(got["llm/layers/0/q_proj/weight"],
                           base["llm/layers/0/q_proj/weight"])
    assert TConfig.load(str(tmp_path / "t")) == TConfig.load(str(tmp_path / "j"))


SQA_PROBLEMS = {
    "p1": {"question": "Which is heavier?", "hint": "Think about mass.",
           "caption": "a rock and a feather", "choices": ["rock", "feather"], "answer": 0,
           "lecture": "Mass measures matter.\nHeavier means more mass.",
           "solution": "A rock has more mass.\nSo it is heavier.", "image": "image.png"},
    "p2": {"question": "What color is the sky?", "hint": "", "caption": "",
           "choices": ["blue", "green", "red"], "answer": 0, "lecture": "",
           "solution": "The sky scatters blue light.", "image": None},
    "p3": {"question": "Which is a mammal?", "hint": "Look at the animals.", "caption": "",
           "choices": ["shark", "whale", "trout", "eel"], "answer": 1,
           "lecture": "Mammals feed milk.", "solution": "A whale is a mammal.",
           "image": "image.png"},
}


@pytest.mark.parametrize("flags", [[], ["--prompt-format", "QCM-A"],
                                   ["--jsonl", "--prompt-format", "QCM-LEPA"]])
def test_convert_sqa_to_llava_matches_jax(tmp_path, flags):
    base = tmp_path / "sqa"
    base.mkdir()
    (base / "problems.json").write_text(json.dumps(SQA_PROBLEMS))
    (base / "pid_splits.json").write_text(json.dumps({"train": ["p1", "p2", "p3"],
                                                      "val": ["p3"]}))
    for who, run in (("j", lambda a: run_script("convert_sqa_to_llava", a)),
                     ("t", convert_sqa_to_llava.main)):
        run(["--base-dir", str(base), "--output", str(tmp_path / who)] + flags)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    assert len((tmp_path / "t").read_text()) > 100


def test_bf16_safetensors_load_as_fp32(tmp_path):
    """A bf16 safetensors file loads as fp32 arrays of the same values,
    whether numpy can hold bf16 (ml_dtypes loaded, as here) or not."""
    from safetensors.torch import save_file

    import ml_dtypes  # noqa: F401  (numpy's bf16, as a jax install brings it)

    g = torch.Generator().manual_seed(0)
    sd = {"a": torch.randn((3, 5), generator=g).to(torch.bfloat16),
          "b": torch.randn((4,), generator=g)}
    save_file(sd, str(tmp_path / "m.safetensors"))
    got = tckpt.load_state_dict_file(str(tmp_path / "m.safetensors"))
    assert got["a"].dtype == got["b"].dtype == np.float32
    for k in sd:
        assert torch.equal(torch.from_numpy(got[k]), sd[k].float())
