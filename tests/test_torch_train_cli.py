"""The port's training command line (``slime_tpu_torch.train.cli``) against
``scripts/train_slime.py``.

- The flags: every option of the JAX CLI's parser, with the same names,
  defaults, types, choices, ``nargs`` and requiredness; the port adds
  ``--device`` only.
- In process, on the CPU at tiny width (a ``config.json``-only model
  directory, so random weights from ``--seed``, as the JAX CLI makes them;
  hidden 256 so ``--bits 4`` quantizes the LLM's projections to NF4): SFT
  with images, ``--lora-enable --bits 4 --remat --group-by-modality-length``
  (QLoRA: the NF4 base unchanged, the adapters and the projector moved on
  the first, multimodal, batch), ``--seq-packing`` on text-only
  records (and its refusal of image records), ``--gradient-accumulation-steps
  2``, and resume from the saved state, which continues exactly as the
  uninterrupted trainer fed the same batches. The files each run writes are
  the JAX CLI's (names of a run of ``scripts/train_slime.py`` itself with
  the same flags, on its own checkpoint).
- ``--task DPO`` (full-parameter with ``--optim adamw8bit`` and with
  ``--ref-model-path``, LoRA, QLoRA) end to end on preference pairs, one
  multimodal, as ``tests/test_cli_entrypoints.py::test_train_slime_cli_dpo``
  runs the JAX CLI: the DPO metrics logged, the files saved, the 8-bit
  moments in the optimizer, LoRA-DPO's first loss at log 2.
- JAX's refusals: ``--bits 4`` without LoRA, ``--seq-packing`` with DPO,
  ``--ref-model-path`` with ``--lora-enable``; a mesh larger than the
  launch raises ValueError.

Tolerance: none; resumed parameters equal the uninterrupted ones exactly.
"""
import argparse
import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from slime_tpu_torch.config import LLMConfig, SliMEConfig, VisionConfig
from slime_tpu_torch.ops.quantization import is_quantized
from slime_tpu_torch.params import named_leaves
from slime_tpu_torch.train import cli
from slime_tpu_torch.train.optim import MultiSteps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "train_slime_script", os.path.join(REPO, "scripts", "train_slime.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parser_of(parse_args, monkeypatch):
    got = {}

    def grab(self, *a, **k):
        got["parser"] = self
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        parse_args()
    monkeypatch.undo()
    return got["parser"]


def _options(parser):
    return {a.option_strings[0]: (a.default, a.type, a.choices, a.nargs, a.required,
                                  type(a).__name__)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_flags_match_the_jax_cli(monkeypatch):
    want = _options(_parser_of(_jax_cli().parse_args, monkeypatch))
    got = _options(_parser_of(lambda: cli.parse_args([]), monkeypatch))
    assert set(got) - set(want) == {"--device"}
    for flag, spec in want.items():
        assert got[flag] == spec, flag
    a = cli.parse_args(["--model-path", "m", "--data-path", "a", "b", "--output-dir", "o"])
    assert a.data_path == ["a", "b"] and a.bf16 and a.bits == 16 and a.lora_r == 128


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A config-only model directory at hidden 256 (random init) and the
    offline toy tokenizer (``tests/toy_tokenizer.py``)."""
    from .toy_tokenizer import ToyTokenizer
    d = tmp_path_factory.mktemp("model")
    cfg = SliMEConfig(
        llm=LLMConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=64, max_position_embeddings=512),
        vision=VisionConfig(image_size=56, patch_size=14, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2),
        mm_resampler_dim=4, seperator=7, tokenizer_model_max_length=512, bos_token_id=1,
        eos_token_id=2, max_local_crops=7)
    cfg.save(str(d))
    return str(d), ToyTokenizer()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    Image.new("RGB", (500, 400), (200, 40, 10)).save(d / "x.png")
    mm = [{"id": str(i), "image": "x.png", "conversations": [
        {"from": "human", "value": "<image>\nwhat is in the picture ?"},
        {"from": "gpt", "value": "a cat " + "red " * i + "."}]} for i in range(4)]
    txt = [{"id": str(i), "conversations": [
        {"from": "human", "value": f"question {i} what color ?"},
        {"from": "gpt", "value": "blue " * (i % 5 + 1) + "."}]} for i in range(12)]
    (d / "mm.json").write_text(json.dumps(mm + txt[:4]))
    (d / "txt.json").write_text(json.dumps(txt))
    return d


def _argv(model, data_json, out, *extra, img=""):
    return ["--model-path", model, "--data-path", data_json, "--image-folder", img,
            "--output-dir", out, "--version", "v1", "--per-device-batch-size", "2",
            "--model-max-length", "128", "--logging-steps", "1", "--learning-rate", "1e-3",
            "--device", "cpu", *extra]


def _nf4_hash(tree):
    return sum(int(leaf.to(torch.int64).sum()) * (i + 1)
               for i, (path, leaf) in enumerate(named_leaves(tree)) if "nf4" in path)


def test_sft_and_qlora_runs(model_dir, data, tmp_path):
    model, tok = model_dir
    out = str(tmp_path / "sft")
    tr = cli.main(_argv(model, str(data / "mm.json"), out, "--max-steps", "2",
                        "--save-steps", "1", img=str(data)), tokenizer=tok)
    assert tr.lora is None and tr.state["step"] == 2
    assert isinstance(tr.params["llm"]["layers"], dict)            # stacked
    assert sorted(os.listdir(out)) == ["checkpoint-1", "checkpoint-2", "config.json",
                                       "metrics.jsonl", "model.safetensors", "state-1",
                                       "state-2"]
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 and r["target_tokens"] > 2
               for r in recs)

    out = str(tmp_path / "qlora")
    tr = cli.main(_argv(model, str(data / "mm.json"), out, "--max-steps", "2",
                        "--save-steps", "0", "--lora-enable", "--bits", "4", "--lora-r", "8",
                        "--lora-alpha", "16", "--remat", "--warmup-ratio", "0",
                        "--group-by-modality-length", img=str(data)), tokenizer=tok)
    layers = tr.base["llm"]["layers"]
    assert isinstance(layers, list) and "nf4" in layers[0]["gate_proj"]["weight"]
    assert all(is_quantized(layers[0][p]["weight"]) for p in ("q_proj", "down_proj"))
    fresh = cli.build_params(cli.parse_args(_argv(model, "d", out, "--lora-enable", "--bits",
                                                  "4")),
                             SliMEConfig.load(model), torch.device("cpu"))
    assert _nf4_hash(tr.base["llm"]) == _nf4_hash(fresh["llm"]) != 0
    adapters = tr.state["params"]["adapters"]
    assert set(adapters) == {f"llm/layers/{i}/{p}" for i in range(2) for p in (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")}
    assert any(ab["B"].abs().max() > 0 for ab in adapters.values())
    before = dict(named_leaves(fresh["projector"]))
    assert any(not torch.equal(leaf, before[path]) for path, leaf in
               named_leaves(tr.state["params"]["extras"]["projector"]))
    assert sorted(os.listdir(out)) == ["adapter_config.json", "adapter_model.bin",
                                       "config.json", "metrics.jsonl",
                                       "non_lora_trainables.bin"]
    assert json.load(open(os.path.join(out, "adapter_config.json")))["r"] == 8


def test_packed_and_accumulated_runs(model_dir, data, tmp_path):
    model, tok = model_dir
    out = str(tmp_path / "packed")
    seen = []
    from slime_tpu_torch.models import llama
    real = llama.forward

    def spy(*a, **k):
        seen.append(k.get("segment_ids") is not None)
        return real(*a, **k)
    llama.forward = spy
    try:
        tr = cli.main(_argv(model, str(data / "txt.json"), out, "--seq-packing", "--max-steps",
                            "2", "--save-steps", "0", "--lora-enable", "--lora-r", "4"),
                      tokenizer=tok)
    finally:
        llama.forward = real
    assert tr.state["step"] == 2 and seen == [True, True]
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert all(0 < r["packing_efficiency"] <= 1 for r in recs)
    with pytest.raises(SystemExit, match="text-only"):
        cli.main(_argv(model, str(data / "mm.json"), str(tmp_path / "no"), "--seq-packing",
                       "--max-steps", "1", img=str(data)), tokenizer=tok)

    out = str(tmp_path / "accum")
    tr = cli.main(_argv(model, str(data / "mm.json"), out, "--max-steps", "4", "--save-steps",
                        "0", "--gradient-accumulation-steps", "2", "--lora-enable",
                        "--lora-r", "4", img=str(data)), tokenizer=tok)
    assert isinstance(tr.tx, MultiSteps) and tr.tx.gradient_step == 2
    assert tr.tx.inner.groups[0]["count"] == 2 and tr.state["step"] == 4


def test_resume_continues_exactly(model_dir, data, tmp_path):
    """Run 3 micro-steps of accumulation 2 and save state-3 (mid window);
    the same command with --max-steps 5 resumes from it and, fed the
    loader's batches from their start (JAX's resume skips none), ends
    exactly where the first trainer ends when it is fed the same two
    batches."""
    model, tok = model_dir
    out = str(tmp_path / "run")
    flags = ["--save-steps", "3", "--gradient-accumulation-steps", "2", "--lora-enable",
             "--lora-r", "4", "--num-train-epochs", "3"]
    first = cli.main(_argv(model, str(data / "mm.json"), out, "--max-steps", "3", *flags,
                           img=str(data)), tokenizer=tok)
    assert first.state["step"] == 3 and first.tx.mini_step == 1
    resumed = cli.main(_argv(model, str(data / "mm.json"), out, "--max-steps", "5", *flags,
                             img=str(data)), tokenizer=tok)
    assert resumed.state["step"] == 5
    args = cli.parse_args(_argv(model, str(data / "mm.json"), out, *flags, img=str(data)))
    ds = cli.build_dataset(args, SliMEConfig.load(model), tok)
    first.rc = dataclasses.replace(first.rc, max_steps=5, save_steps=0)
    first.train(cli.batches(args, ds, tok.pad_token_id))
    for (path, a), (_, b) in zip(named_leaves(first.state["params"]),
                                 named_leaves(resumed.state["params"])):
        assert torch.equal(a, b), path
    assert torch.equal(first.generator.get_state(), resumed.generator.get_state())


def _pref_data(data):
    recs = [{"id": "0", "image": "x.png",
             "conversations": [{"from": "human", "value": "<image>\nwhat is this ?"}],
             "chosen": "a cat .", "rejected": "a dog ."},
            {"id": "1", "conversations": [{"from": "human", "value": "2 + 2 ?"}],
             "output_1": {"value": "4 ."}, "output_2": {"value": "5 ."},
             "preference": 1}] * 2
    path = data / "pref.json"
    path.write_text(json.dumps(recs))
    return str(path)


def _logged(out):
    return [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]


def test_dpo_and_adamw8bit_runs(model_dir, data, tmp_path):
    """--task DPO through the CLI, as test_train_slime_cli_dpo runs the JAX
    one (token-weighted pairs, one multimodal; batch 2, 2 steps): full
    parameters with 8-bit moments; again against the first run's
    checkpoint as --ref-model-path; LoRA and QLoRA, whose first loss is
    log 2 (the adapters start at B = 0, the base is the reference)."""
    from slime_tpu_torch.train.opt8 import AdamW8bit
    model, tok = model_dir
    pref = _pref_data(data)
    dpo = ["--task", "DPO", "--dpo-beta", "0.1", "--dpo-token-weighted", "--max-steps", "2",
           "--save-steps", "0", "--learning-rate", "1e-4"]
    full = str(tmp_path / "full")
    tr = cli.main(_argv(model, pref, full, *dpo, "--optim", "adamw8bit", img=str(data)),
                  tokenizer=tok)
    assert tr.dpo is not None and tr.state["step"] == 2
    assert all(isinstance(g["opt"], AdamW8bit) for g in tr.tx.groups)
    assert all(st["m_q"].dtype == torch.int8 for g in tr.tx.groups for st in g["opt"].state)
    recs = _logged(full)
    assert [r["step"] for r in recs] == [1, 2]
    assert all("reward_margin" in r and "target_weight_mass" in r
               and "target_tokens" not in r and np.isfinite(r["loss"]) for r in recs)
    assert sorted(os.listdir(full)) == ["config.json", "metrics.jsonl", "model.safetensors"]

    ref = cli.main(_argv(model, pref, str(tmp_path / "ref"), *dpo, "--ref-model-path", full,
                         "--dpo-loss-type", "ipo", "--sft-weight", "0.1", img=str(data)),
                   tokenizer=tok)
    assert np.isfinite(_logged(str(tmp_path / "ref"))[0]["loss"])
    assert isinstance(ref.params["llm"]["layers"], dict)           # stacked, as the policy

    for tag, extra in (("lora", ["--lora-r", "4"]), ("qlora", ["--bits", "4", "--lora-r", "4"])):
        out = str(tmp_path / tag)
        tr = cli.main(_argv(model, pref, out, *dpo, "--lora-enable", "--dpo-loss-type",
                            "kto_pair", *extra, img=str(data)), tokenizer=tok)
        assert tr.lora is not None and tr.state["step"] == 2
        recs = _logged(out)
        # kto_pair at policy == reference: 1 - sigmoid(0) per term
        assert recs[0]["loss"] == pytest.approx(0.5, abs=1e-5)
        assert "adapter_model.bin" in os.listdir(out)


def test_refusals(model_dir, data, tmp_path):
    """JAX's refusals (scripts/train_slime.py:145-148, :253-260, :270) and
    a mesh of more ranks than the launch has processes."""
    model, tok = model_dir
    base = _argv(model, str(data / "txt.json"), str(tmp_path / "r"))
    for extra in (["--mesh-fsdp", "2"], ["--mesh-model", "2"]):
        with pytest.raises(ValueError, match="the world has 1"):
            cli.main(base + extra, tokenizer=tok)
    with pytest.raises(SystemExit, match="lora-enable"):
        cli.main(base + ["--bits", "4"], tokenizer=tok)
    with pytest.raises(SystemExit, match="seq-packing"):
        cli.main(base + ["--task", "DPO", "--seq-packing"], tokenizer=tok)
    with pytest.raises(SystemExit, match="ref-model-path"):
        cli.main(base + ["--task", "DPO", "--lora-enable", "--ref-model-path", model],
                 tokenizer=tok)


def test_run_writes_the_jax_cli_files(tmp_path):
    """scripts/train_slime.py (in a subprocess on one CPU device, as
    ``tests/test_cli_entrypoints.py`` runs it) and the port's CLI with the
    same flags on the same tiny checkpoint (tests/hf_fixtures.py): the same
    files."""
    import subprocess
    from .hf_fixtures import make_tiny_checkpoint_dir
    ckpt = make_tiny_checkpoint_dir(str(tmp_path / "ckpt"))
    (tmp_path / "d.json").write_text(json.dumps([{"id": str(i), "conversations": [
        {"from": "human", "value": f"what is {i} ?"}, {"from": "gpt", "value": "a cat ."}]}
        for i in range(4)]))
    outs = {}
    for name in ("jax", "port"):
        out = str(tmp_path / name)
        argv = ["--model-path", ckpt, "--data-path", str(tmp_path / "d.json"),
                "--output-dir", out, "--per-device-batch-size", "2", "--max-steps", "2",
                "--model-max-length", "64", "--save-steps", "2", "--logging-steps", "1",
                "--lora-enable", "--lora-r", "4", "--lora-alpha", "8"]
        if name == "jax":
            env = dict(os.environ, JAX_PLATFORMS="cpu", SLIME_PLATFORM="cpu", XLA_FLAGS="",
                       PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
            r = subprocess.run([sys.executable, "scripts/train_slime.py"] + argv, cwd=REPO,
                               env=env, capture_output=True, text=True, timeout=600)
            assert r.returncode == 0, r.stderr[-2000:]
        else:
            cli.main(argv + ["--device", "cpu"])
        outs[name] = {p: sorted(os.listdir(os.path.join(out, p))) if os.path.isdir(
            os.path.join(out, p)) else None for p in os.listdir(out)}
    # the state directories hold each package's own format
    assert {k: v for k, v in outs["port"].items() if not k.startswith("state-")} == \
        {k: v for k, v in outs["jax"].items() if not k.startswith("state-")}
    assert sorted(k for k in outs["port"] if k.startswith("state-")) == \
        sorted(k for k in outs["jax"] if k.startswith("state-")) == ["state-2"]
