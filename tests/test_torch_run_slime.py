"""``slime_tpu_torch.eval.run_slime`` against ``slime_tpu/eval/run_slime.py``
on a tiny checkpoint directory (``tests/hf_fixtures.make_tiny_checkpoint_dir``)
on the CPU: ``eval_model`` prints the JAX script's answer, greedy. The JAX
script hard-codes bf16 for the checkpoint and the compute; both sides run at
fp32 here (JAX's ``to_jax`` and ``generate`` wrapped to fp32, the port's
``load_for_serving`` and ``generate`` likewise), and both read the test's tokenizer (JAX's through
``AutoTokenizer.from_pretrained``). Without ``--device`` and without a card
the port raises. JAX's ViT attention runs its Pallas kernel in interpret
mode. Tolerance: none; the text is compared exactly.
"""
import functools

import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import slime_tpu.ops.encoder_attention as jea
from slime_tpu.eval import harness as jh

from .test_torch_eval import NEW, IdTokenizer, two_torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


def test_run_slime_prints_jax_text(tmp_path, monkeypatch, capsys):
    """``eval_model`` on a checkpoint directory: the port's printed answer is
    the JAX script's (both at fp32, greedy)."""
    import transformers

    import slime_tpu.checkpoint as jckpt
    import slime_tpu.generate as jgen
    from slime_tpu.eval import run_slime as jrun
    from slime_tpu_torch import checkpoint as tckpt
    from slime_tpu_torch import generate as tgen
    from slime_tpu_torch.eval import run_slime as trun

    from .hf_fixtures import make_tiny_checkpoint_dir

    d = make_tiny_checkpoint_dir(str(tmp_path / "ckpt"))
    Image.new("RGB", (500, 400), (200, 10, 10)).save(tmp_path / "x.jpg")
    argv = ["--model-path", d, "--image-file", str(tmp_path / "x.jpg"), "--query",
            "what color is it ?", "--conv-mode", "v1", "--temperature", "0",
            "--max-new-tokens", str(NEW)]
    tok = IdTokenizer()
    tok(jh.build_prompt("what color is it ?", "v1"))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda *a, **k: tok)
    to_jax, generate = jckpt.to_jax, jgen.generate
    monkeypatch.setattr(jckpt, "to_jax", lambda params, dtype=None: to_jax(params))
    monkeypatch.setattr(jgen, "generate", lambda *a, **k: generate(
        *a, **{**k, "compute_dtype": jnp.float32}))
    want = jrun.eval_model(_jax_args(argv))
    capsys.readouterr()
    load, tgenerate = tckpt.load_for_serving, tgen.generate
    monkeypatch.setattr(tckpt, "load_for_serving", lambda *a, **k: load(
        *a, **{**k, "dtype": torch.float32}))
    monkeypatch.setattr(tgen, "generate", lambda *a, **k: tgenerate(
        *a, **{**k, "compute_dtype": torch.float32}))
    got = trun.eval_model(trun.parse_args(argv + ["--device", "cpu"]), tokenizer=tok)
    assert capsys.readouterr().out == got + "\n"
    assert got == want and got


def _jax_args(argv):
    """The JAX script's arguments: its parser, read from its ``main``."""
    import argparse
    from unittest import mock

    from slime_tpu.eval import run_slime as jrun

    got = {}
    with mock.patch.object(jrun, "eval_model", lambda a: got.setdefault("a", a)), \
            mock.patch("sys.argv", ["run_slime"] + argv):
        jrun.main()
    assert isinstance(got["a"], argparse.Namespace)
    return got["a"]


def test_run_slime_raises_without_a_card(tmp_path):
    """No ``--device`` and no CUDA: the port runs on the card or not at all."""
    from slime_tpu_torch.eval import run_slime as trun

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--model-path", str(tmp_path), "--image-file", "x", "--query", "q"])
