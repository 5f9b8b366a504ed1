"""The port's evaluation command lines (``slime_tpu_torch.eval.cli``,
``eval.mmhal_cli``) against ``scripts/eval_benchmark.py`` and
``scripts/eval_mmhal.py``:

- every option of the JAX scripts' parsers exists in the port's with the
  same name, default, type, choices, ``nargs`` and requiredness; the eval CLI
  adds ``--device`` only, the MMHal CLI nothing;
- JAX's refusals (sampling, beam and single-prediction flags with the
  chartqa, mmhal and amber drivers) exit the same way with the same message;
- without ``--device`` and without a card the eval CLI raises;
- in process, on a tiny checkpoint (``tests/hf_fixtures.
  make_tiny_checkpoint_dir``): two chunks, then ``--merge --scorer textvqa``,
  give JAX's merged answers (ids, prompts, text) and TextVQA score. The JAX
  CLI loads and computes in bf16; both sides run at fp32 here (JAX's
  ``to_jax`` and ``harness.run_eval`` wrapped, the port's
  ``load_for_serving`` and ``run_eval`` likewise), both reading the test's
  tokenizer. The port's default bf16 run on the CPU writes every answer too;
- ``mmhal_cli summarize`` prints JAX's summary.

JAX's ViT attention runs its Pallas kernel in interpret mode. Tolerance:
none.
"""
import argparse
import functools
import importlib.util
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

import slime_tpu.checkpoint as jckpt
from slime_tpu.eval import harness as jh
from slime_tpu_torch import checkpoint as tckpt
from slime_tpu_torch.eval import cli
from slime_tpu_torch.eval import harness as th
from slime_tpu_torch.eval import mmhal_cli

from .test_torch_eval import (IdTokenizer, jax_kernel_attention, rows_of,  # noqa: F401
                              two_torch_threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name + "_script", os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parser_of(main, monkeypatch):
    got = {}

    def grab(self, *a, **k):
        got["parser"] = self
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        main()
    monkeypatch.undo()
    return got["parser"]


def _options(parser):
    return {a.option_strings[0] if a.option_strings else a.dest:
            (a.default, a.type, a.choices, a.nargs, a.required, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("jax_name,port_main,added", [
    ("eval_benchmark", lambda: cli.parse_args([]), {"--device"}),
    ("eval_mmhal", lambda: mmhal_cli.parse_args([]), set()),
])
def test_flags_match_the_jax_cli(jax_name, port_main, added, monkeypatch):
    want = _options(_parser_of(_script(jax_name).main, monkeypatch))
    got = _options(_parser_of(port_main, monkeypatch))
    assert set(got) - set(want) == added and set(want) <= set(got)
    for flag, spec in want.items():
        assert got[flag] == spec, flag


BASE = ["--model-path", "m", "--question-file", "q", "--image-folder", "i",
        "--answers-file", "a"]


@pytest.mark.parametrize("flags", [
    ["--benchmark", "chartqa", "--temperature", "0.7"],
    ["--benchmark", "mmhal", "--num-beams", "2"],
    ["--benchmark", "amber", "--single-pred-prompt"],
    ["--benchmark", "chartqa", "--temperature", "1", "--num-beams", "3",
     "--single-pred-prompt"],
])
def test_refusals_match_the_jax_cli(flags, capsys):
    with mock.patch("sys.argv", ["eval_benchmark.py"] + BASE + flags), \
            pytest.raises(SystemExit) as jexit:
        _script("eval_benchmark").main()
    want = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as texit:
        cli.main(BASE + flags)
    got = capsys.readouterr().err.splitlines()[-1]
    assert texit.value.code == jexit.value.code == 2
    assert got.split(": error: ")[1] == want.split(": error: ")[1]
    assert "not supported by the" in got


def test_greedy_flags_pass_the_refusals():
    for b in ("chartqa", "mmhal", "amber"):
        a = cli.parse_args(BASE + ["--benchmark", b, "--temperature", "0"])
        assert a.benchmark == b and a.temperature == 0.0 and a.device is None


def test_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(BASE)


QUESTIONS = [{"question_id": i, "image": f"im{i % 2}.jpg", "text": t}
             for i, t in enumerate(["what color ?", "is it red ?", "what is in the picture ?",
                                    "describe this image"])]
ANNOTATION = {"data": [{"question_id": i, "answers": [a] * 10}
                       for i, a in enumerate(["red", "yes", "cat", "dog"])]}


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    from .hf_fixtures import make_tiny_checkpoint_dir

    root = tmp_path_factory.mktemp("evalcli")
    ckpt = make_tiny_checkpoint_dir(str(root / "ckpt"))
    (root / "imgs").mkdir()
    Image.new("RGB", (500, 400), (200, 10, 10)).save(root / "imgs" / "im0.jpg")
    Image.new("RGB", (300, 420), (10, 120, 30)).save(root / "imgs" / "im1.jpg")
    (root / "q.jsonl").write_text("".join(json.dumps(q) + "\n" for q in QUESTIONS))
    (root / "ann.json").write_text(json.dumps(ANNOTATION))
    return root, ckpt


def tokenizer():
    tok = IdTokenizer()
    for q in QUESTIONS:
        tok(jh.build_prompt(q["text"], "v1"))
    return tok


def argv_of(root, ckpt, out):
    return ["--model-path", ckpt, "--question-file", str(root / "q.jsonl"),
            "--image-folder", str(root / "imgs"), "--answers-file",
            str(root / out / "ans_{chunk}.jsonl"), "--conv-mode", "v1", "--num-chunks", "2",
            "--batch-size", "2", "--max-new-tokens", "5", "--seq-len", "64"]


def merge_argv(argv, root):
    return argv + ["--merge", "--scorer", "textvqa", "--annotation-file",
                   str(root / "ann.json")]


def test_two_chunks_merge_and_score_match_jax(eval_dir, monkeypatch, capsys):
    import transformers

    import slime_tpu.ops.encoder_attention as jea

    root, ckpt = eval_dir
    tok = tokenizer()
    # the JAX CLI at fp32, reading the test's tokenizer
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda *a, **k: tok)
    to_jax = jckpt.to_jax
    monkeypatch.setattr(jckpt, "to_jax", lambda params, dtype=None: to_jax(params))
    monkeypatch.setattr(jh, "run_eval", functools.partial(jh.run_eval,
                                                          compute_dtype=np.float32))
    jargv = argv_of(root, ckpt, "jax")
    script = _script("eval_benchmark")
    for k in ("0", "1", None):
        extra = ["--chunk-idx", k] if k else []
        argv = jargv + extra if k else merge_argv(jargv, root)
        with mock.patch("sys.argv", ["eval_benchmark.py"] + argv):
            script.main()
    want_out = capsys.readouterr().out.splitlines()

    load = tckpt.load_for_serving
    monkeypatch.setattr(tckpt, "load_for_serving", lambda *a, **k: load(
        *a, **{**k, "dtype": torch.float32}))
    monkeypatch.setattr(th, "run_eval", functools.partial(th.run_eval,
                                                          compute_dtype=torch.float32))
    targv = argv_of(root, ckpt, "port")
    for k in ("0", "1"):
        cli.main(targv + ["--chunk-idx", k, "--device", "cpu"], tokenizer=tok)
    cli.main(merge_argv(targv, root))
    got_out = capsys.readouterr().out.splitlines()

    keys = ("question_id", "prompt", "text", "model_id", "metadata")
    got = [{k: r[k] for k in keys} for r in rows_of(root / "port" / "ans_merged.jsonl")]
    want = [{k: r[k] for k in keys} for r in rows_of(root / "jax" / "ans_merged.jsonl")]
    assert got == want and [r["question_id"] for r in got] == [0, 1, 2, 3]
    assert got_out[-1] == want_out[-1]                       # the TextVQA score
    assert "'n': 4" in got_out[-1] and got_out[-2] == want_out[-2].replace("jax", "port")


def test_default_bf16_run_writes_every_answer(eval_dir, tmp_path):
    """The CLI's own path (bf16 checkpoint and compute) on the CPU, one chunk."""
    root, ckpt = eval_dir
    argv = argv_of(root, ckpt, "bf16") + ["--chunk-idx", "1", "--device", "cpu"]
    cli.main(argv, tokenizer=tokenizer())
    rows = rows_of(root / "bf16" / "ans_1.jsonl")
    assert [r["question_id"] for r in rows] == [2, 3]
    assert all(isinstance(r["text"], str) and r["model_id"] == "slime-tpu" for r in rows)


def test_mmhal_summarize_matches_jax(tmp_path, capsys):
    reviews = [{"rating": r, "review": "x"} for r in [6, 5, 1, None, 3, 2, 4, 0, 6]]
    f = tmp_path / "reviews.json"
    f.write_text(json.dumps(reviews))
    with mock.patch("sys.argv", ["eval_mmhal.py", "summarize", "--evaluation", str(f)]):
        _script("eval_mmhal").main()
    want = capsys.readouterr().out
    mmhal_cli.main(["summarize", "--evaluation", str(f)])
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["n"] == 9
