"""The port's evaluation harness (``slime_tpu_torch.eval.harness``) and
``eval.run_slime`` against the JAX package's, at ``SliMEConfig.tiny`` widths
on the CPU in fp32, on the same parameters (the ``params`` bridge) and
questions:

- ``run_eval`` at batch 4: the answers file's ``question_id``, ``prompt``,
  ``text``, ``model_id`` and ``metadata`` equal JAX's ``run_eval`` on five
  questions over synthetic images of five sizes, two of them past the
  64-token bucket, the last batch padded with copies of its last row;
  ``answer_id`` is a fresh 22-character hex id, as JAX's;
- the port's batch-1 text equals its batch-4 text (JAX's
  ``test_harness_batched_matches_bs1`` pin), and a prompt over ``seq_len``
  is cut with a warning, at batch 1 and 3 alike;
- ``run_text_qa`` at temperature 0 equals JAX's; sampled, it repeats itself
  under one seed (its draws come from a ``torch.Generator``, JAX's from
  ``jax.random.PRNGKey``, so sampled text is not compared across packages);
- the jax-free helpers (``split_list``, ``get_chunk``, ``load_questions``,
  ``build_prompt``, ``merge_chunks``) equal JAX's.

The drivers take ``compute_dtype``; both sides run at fp32. JAX's ViT attention runs its Pallas kernel in interpret mode. Tolerance:
none; text is compared exactly.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import slime_tpu.ops.encoder_attention as jea
from slime_tpu.config import SliMEConfig
from slime_tpu.eval import harness as jh
from slime_tpu.models import slime as jslime
from slime_tpu_torch import params as bridge
from slime_tpu_torch.eval import harness as th
from slime_tpu_torch.models import llama as tllama

from .toy_tokenizer import ToyTokenizer

LONG_Q = " ".join(f"word{j}" for j in range(70))     # crosses the 64-token bucket
QUESTIONS = [
    {"question_id": 0, "image": "im0.jpg", "text": "what color ?"},
    {"question_id": 1, "image": "im1.jpg", "text": LONG_Q},
    {"question_id": "q2", "image": "im2.jpg", "text": "short ?"},
    {"question_id": 3, "image": "im3.jpg", "text": LONG_Q + " extra"},
    {"id": 4, "image": "im4.jpg", "text": "is it red ?"},
]
TEXT_QA = [{"question_id": i, "text": t, "category": "c"}
           for i, t in enumerate(["why is the sky blue ?", "name a color", "count to three"])]
NEW = 6


class IdTokenizer(ToyTokenizer):
    """The toy tokenizer, decoding ids outside its words as ``t<id>`` so that
    every generated token shows in the text."""

    def decode(self, ids, skip_special_tokens=True):
        ids = [int(i) for i in ids if not (skip_special_tokens and int(i) in (0, 1, 2, 3))]
        return " ".join(self.inv.get(i, f"t{i}") for i in ids)


def prewarmed(conv_mode="v1", questions=QUESTIONS, key="text"):
    """A tokenizer whose vocabulary already holds every prompt's words, so
    the harness's preprocessing threads assign no ids."""
    tok = IdTokenizer()
    for q in questions:
        tok(jh.build_prompt(q[key], conv_mode))
    return tok


@pytest.fixture(autouse=True)
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = SliMEConfig.tiny()
    p = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    tp = bridge.from_jax_numpy(p, device="cpu")
    tp["llm"]["layers"] = tllama.stack_layers(tp["llm"]["layers"])
    return cfg, p, tp


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    for i in range(5):
        Image.new("RGB", (300 + 60 * i, 240), (40 * i, 10, 200)).save(d / f"im{i}.jpg")
    return str(d)


def rows_of(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def kept(rows, keys=("question_id", "prompt", "text", "model_id", "metadata")):
    return [{k: r[k] for k in keys if k in r} for r in rows]


@pytest.fixture(scope="module")
def jax_answers(model, images, tmp_path_factory):
    """JAX's ``run_eval`` at batch 4, fp32, once for the file."""
    cfg, p, _ = model
    d = tmp_path_factory.mktemp("jax_eval")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jea, "encoder_attention",
                   functools.partial(jea.encoder_attention, interpret=True))
        f = jh.run_eval(p, cfg, prewarmed(), QUESTIONS, image_folder=images,
                        answers_file=str(d / "ans.jsonl"), conv_mode="v1", batch_size=4,
                        max_new_tokens=NEW, seq_len=256, compute_dtype=np.float32,
                        progress=False)
    return rows_of(f)


def port_run(model, images, tmp_path, bs, **kw):
    cfg, _, tp = model
    kw = {"seq_len": 256, **kw}
    f = th.run_eval(tp, cfg, prewarmed(), QUESTIONS, image_folder=images,
                    answers_file=str(tmp_path / f"ans_bs{bs}.jsonl"), conv_mode="v1",
                    batch_size=bs, max_new_tokens=NEW, compute_dtype=torch.float32,
                    progress=False, **kw)
    return rows_of(f)


def test_run_eval_matches_jax(model, images, jax_answers, tmp_path):
    got = port_run(model, images, tmp_path, 4)
    assert kept(got) == kept(jax_answers)
    assert [r["question_id"] for r in got] == [0, 1, "q2", 3, 4]
    assert len({r["text"] for r in got}) > 1            # the answers tell rows apart
    for r in got:
        assert len(r["answer_id"]) == 22 and int(r["answer_id"], 16) >= 0
        assert set(r) == set(jax_answers[0])


def test_run_eval_batch_one_equals_batch_four(model, images, jax_answers, tmp_path):
    assert kept(port_run(model, images, tmp_path, 1)) == kept(jax_answers)


def test_run_eval_truncates_with_warning(model, images, tmp_path):
    """A prompt over ``seq_len`` is cut with a warning, and its text does not
    depend on the batch it lands in."""
    with pytest.warns(UserWarning, match="truncated"):
        three = port_run(model, images, tmp_path, 3, seq_len=64)
    with pytest.warns(UserWarning, match="truncated"):
        one = port_run(model, images, tmp_path, 1, seq_len=64)
    assert kept(three) == kept(one)


@pytest.fixture(scope="module")
def jax_text_qa(model, tmp_path_factory):
    cfg, p, _ = model
    f = jh.run_text_qa(p, cfg, prewarmed("v1", TEXT_QA), TEXT_QA,
                       answers_file=str(tmp_path_factory.mktemp("jqa") / "qa.jsonl"),
                       conv_mode="v1", batch_size=2, max_new_tokens=NEW, temperature=0.0,
                       seq_len=64, compute_dtype=np.float32)
    return rows_of(f)


def text_qa(model, tmp_path, name, **kw):
    cfg, _, tp = model
    f = th.run_text_qa(tp, cfg, prewarmed("v1", TEXT_QA), TEXT_QA,
                       answers_file=str(tmp_path / name), conv_mode="v1", batch_size=2,
                       max_new_tokens=NEW, seq_len=64, compute_dtype=torch.float32, **kw)
    return rows_of(f)


def test_run_text_qa_greedy_matches_jax(model, jax_text_qa, tmp_path):
    got = text_qa(model, tmp_path, "qa.jsonl", temperature=0.0)
    keys = ("question_id", "text", "model_id", "metadata")
    assert kept(got, keys) == kept(jax_text_qa, keys)
    assert set(got[0]) == set(jax_text_qa[0]) and "prompt" not in got[0]


def test_run_text_qa_sampled_repeats_under_one_seed(model, tmp_path):
    a = text_qa(model, tmp_path, "a.jsonl", temperature=0.7, seed=3)
    b = text_qa(model, tmp_path, "b.jsonl", temperature=0.7, seed=3)
    assert kept(a) == kept(b)
    assert [r["question_id"] for r in a] == [0, 1, 2]


@pytest.mark.parametrize("n,k", [(10, 3), (5, 2), (4, 4), (7, 1)])
def test_chunking_matches_jax(n, k):
    lst = list(range(n))
    assert th.split_list(lst, k) == jh.split_list(lst, k)
    for i in range(len(jh.split_list(lst, k))):
        assert th.get_chunk(lst, k, i) == jh.get_chunk(lst, k, i)


@pytest.mark.parametrize("conv_mode", ["v1", "llama3", "vicuna_v1", "plain"])
@pytest.mark.parametrize("single", [False, True])
def test_build_prompt_matches_jax(conv_mode, single):
    for q in ("what is it?", "<image>\nwhere?"):
        for se in (False, True):
            assert (th.build_prompt(q, conv_mode, mm_use_im_start_end=se,
                                    single_pred_prompt=single)
                    == jh.build_prompt(q, conv_mode, mm_use_im_start_end=se,
                                       single_pred_prompt=single))


def test_load_questions_and_merge_match_jax(tmp_path):
    (tmp_path / "q.jsonl").write_text("".join(json.dumps(q) + "\n" for q in QUESTIONS) + "\n")
    (tmp_path / "q.json").write_text(json.dumps(QUESTIONS))
    for name in ("q.jsonl", "q.json"):
        assert th.load_questions(str(tmp_path / name)) == jh.load_questions(
            str(tmp_path / name)) == QUESTIONS
    files = []
    for i in range(3):
        f = tmp_path / f"c{i}.jsonl"
        f.write_text(json.dumps({"question_id": i, "text": f"a{i}"}) + "\n")
        files.append(str(f))
    th.merge_chunks(files, str(tmp_path / "t.jsonl"))
    jh.merge_chunks(files, str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
