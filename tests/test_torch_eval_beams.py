"""``eval.harness.run_eval(num_beams=2)`` against the JAX package's, at
``SliMEConfig.tiny`` widths on the CPU in fp32: the harness's right-padded
batch of three questions (one past the 64-token bucket, the batch of 4
padded with a copy of its last row) through the port's ``beam_search``
gives JAX's records (``answer_id`` aside). JAX's ViT attention runs its Pallas kernel in interpret mode.
Tolerance: none; the text is compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.eval import harness as jh
from slime_tpu.models import llama as jllama
from slime_tpu_torch.eval import harness as th

from .test_torch_eval import (NEW, QUESTIONS, images, jax_kernel_attention, kept,  # noqa: F401
                              model, prewarmed, rows_of, two_torch_threads)

BEAM_QUESTIONS = QUESTIONS[:3]


def test_run_eval_beams_match_jax(model, images, tmp_path):  # noqa: F811
    cfg, p, tp = model
    # JAX's beam search scans over stacked layers of device arrays
    p = jax.tree_util.tree_map(jnp.asarray, {**p, "llm": {
        **p["llm"], "layers": jllama.stack_layers(p["llm"]["layers"])}})
    tok = prewarmed(questions=BEAM_QUESTIONS)
    kw = dict(image_folder=images, conv_mode="v1", batch_size=4, max_new_tokens=NEW,
              num_beams=2, seq_len=256, progress=False)
    want = rows_of(jh.run_eval(p, cfg, tok, BEAM_QUESTIONS, answers_file=str(
        tmp_path / "j.jsonl"), compute_dtype=np.float32, **kw))
    got = rows_of(th.run_eval(tp, cfg, tok, BEAM_QUESTIONS, answers_file=str(
        tmp_path / "t.jsonl"), compute_dtype=torch.float32, **kw))
    assert kept(got) == kept(want)
    assert [r["question_id"] for r in got] == [0, 1, "q2"]
