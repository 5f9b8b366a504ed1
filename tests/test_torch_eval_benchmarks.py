"""The port's benchmark drivers and video path (``slime_tpu_torch.eval.
benchmarks``, ``eval.video``) against the JAX package's, on the CPU:

- ``run_mmbench`` with ``all_rounds`` on a 2-row base64 TSV (4 options, so
  4 rotated rounds each; one row with a hint) at ``SliMEConfig.tiny`` widths
  in fp32 writes JAX's records (text compared exactly);
- ``run_chartqa``, ``run_mmhal`` and ``run_amber`` write JAX's files byte for
  byte around the same stand-in generation (``harness.run_eval`` replaced in
  each package, as ``tests/test_benchmarks.py`` does), and ChartQA's score;
- the converters and ``mmbench_to_submission`` (xlsx and json) write JAX's
  bytes; the prompts and ``get_options`` are JAX's;
- ``process_video_frames`` is byte-equal to JAX's for 3, 8 and 20 frames
  (fewer than the 8 slots leave the rest masked off, more are sampled
  uniformly); ``run_video_mme`` writes JAX's records for 2 videos of 3 and 10
  frames (greedy, fp32), ``score_video_mme`` JAX's scores, and each video
  reads its own frames directory.

JAX's ViT attention runs its Pallas kernel in interpret mode. Tolerance:
none.
"""
import base64
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from slime_tpu.eval import benchmarks as jbm
from slime_tpu.eval import harness as jh
from slime_tpu.eval import video as jvideo
from slime_tpu_torch import generate as tgen_mod
from slime_tpu_torch.eval import benchmarks as tbm
from slime_tpu_torch.eval import harness as th
from slime_tpu_torch.eval import video as tvideo

from .test_torch_eval import (IdTokenizer, jax_kernel_attention, model,  # noqa: F401
                              rows_of, two_torch_threads)

OPTIONS = (("red", "green", "blue", "black"), ("one", "two", "three", "four"))


def png_b64(seed, size):
    r = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(r.integers(0, 255, size[::-1] + (3,), dtype=np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def mmbench_tsv(tmp_path_factory):
    rows = [{"index": "10", "question": "what color is it ?", "hint": "a photo .",
             "image": png_b64(0, (90, 70)), "category": "c", "l2-category": "x",
             "source": "s", "comment": "", "answer": "A",
             **dict(zip("ABCD", OPTIONS[0]))},
            {"index": "11", "question": "how many ?", "hint": "nan",
             "image": png_b64(1, (60, 120)), "category": "c", "l2-category": "x",
             "source": "s", "comment": "", "answer": "C",
             **dict(zip("ABCD", OPTIONS[1]))}]
    cols = list(rows[0])
    p = tmp_path_factory.mktemp("mmb") / "mmbench.tsv"
    p.write_text("\t".join(cols) + "\n"
                 + "".join("\t".join(r[c] for c in cols) + "\n" for r in rows))
    return str(p)


def mmbench_tokenizer():
    tok = IdTokenizer()
    for row, opts in zip(("what color is it ?", "how many ?"), OPTIONS):
        cur = list(opts)
        for _ in opts:
            tok(jbm.mmbench_prompt(row, cur, hint="a photo .", conv_mode="v1"))
            cur = cur[1:] + cur[:1]
    return tok


def test_run_mmbench_all_rounds_matches_jax(model, mmbench_tsv, tmp_path):
    cfg, p, tp = model
    tok = mmbench_tokenizer()
    kw = dict(conv_mode="v1", all_rounds=True, max_new_tokens=4)
    want = rows_of(jbm.run_mmbench(p, cfg, tok, mmbench_tsv, answers_file=str(
        tmp_path / "j.jsonl"), compute_dtype=np.float32, **kw))
    got = rows_of(tbm.run_mmbench(tp, cfg, tok, mmbench_tsv, answers_file=str(
        tmp_path / "t.jsonl"), compute_dtype=torch.float32, **kw))
    assert got == want
    assert [(r["question_id"], r["round_id"]) for r in got] == [
        (i, r) for i in ("10", "11") for r in range(4)]
    assert got[1]["options"] == ["green", "blue", "black", "red"]
    sub_t, sub_j = tmp_path / "t.xlsx", tmp_path / "j.xlsx"
    tbm.mmbench_to_submission(str(tmp_path / "t.jsonl"), mmbench_tsv, str(sub_t))
    jbm.mmbench_to_submission(str(tmp_path / "j.jsonl"), mmbench_tsv, str(sub_j))
    assert sub_t.read_bytes() == sub_j.read_bytes()


def fake_run_eval(question_key, image_key="image"):
    """A stand-in for ``harness.run_eval``: 'ans:<question>' for each question."""
    def fake(params, cfg, tokenizer, qs, *, answers_file, **kw):
        assert kw.get("question_key", "text") == question_key
        assert kw.get("image_key", "image") == image_key
        with open(answers_file, "w") as f:
            for i, q in enumerate(qs):
                f.write(json.dumps({"question_id": q.get("id", i),
                                    "text": f"ans:{q[question_key]}",
                                    "model_id": "slime-tpu"}) + "\n")
        return answers_file
    return fake


DRIVERS = {
    "chartqa": ("question", "image", "run_chartqa", "chartqa.json",
                [{"image": "a.png", "question": "total?", "answer": "10"},
                 {"image": "b.png", "question": "12", "answer": ["12", "y"]}]),
    "mmhal": ("question", "image_path", "run_mmhal", "mmhal.json",
              [{"question": "how many cats?", "image_path": "/x/a.png",
                "image_content": ["Cat"], "gt_answer": "two"}]),
    "amber": ("query", "image", "run_amber", "amber.jsonl",
              [{"id": 7, "image": "a.png", "query": "describe this"}]),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_files_match_jax(name, tmp_path, monkeypatch):
    key, image_key, fn, fname, qs = DRIVERS[name]
    monkeypatch.setattr(jh, "run_eval", fake_run_eval(key, image_key))
    monkeypatch.setattr(th, "run_eval", fake_run_eval(key, image_key))
    out = {}
    for tag, mod in (("j", jbm), ("t", tbm)):
        (tmp_path / tag).mkdir()
        out[tag] = getattr(mod, fn)(None, None, None, qs, image_folder="",
                                    answers_file=str(tmp_path / tag / fname),
                                    conv_mode="v1")
        assert sorted(p.name for p in (tmp_path / tag).iterdir()) == [fname]
    assert (tmp_path / "t" / fname).read_bytes() == (tmp_path / "j" / fname).read_bytes()
    if name == "chartqa":
        assert out["t"] == out["j"] and out["t"]["n"] == 2


ANSWERS = [{"question_id": 1, "text": "Blue "}, {"question_id": 2, "text": "cat"},
           {"question_id": 3, "text": " The answer is C."}]


@pytest.mark.parametrize("conv", ["convert_gqa", "convert_vqav2", "convert_mmvet",
                                  "convert_seed", "convert_vizwiz"])
def test_converters_match_jax(conv, tmp_path):
    ans = tmp_path / "a.jsonl"
    ans.write_text("".join(json.dumps(a) + "\n" for a in ANSWERS))
    extra = []
    if conv == "convert_vizwiz":
        (tmp_path / "ann.json").write_text(json.dumps(
            [{"question_id": 1, "image": "x.jpg"}, {"image": "y.jpg"}]))
        extra = [str(tmp_path / "ann.json")]
    getattr(tbm, conv)(str(ans), *extra, str(tmp_path / "t.json"))
    getattr(jbm, conv)(str(ans), *extra, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_prompts_and_options_match_jax(mmbench_tsv, tmp_path):
    rows = tbm.load_mmbench_tsv(mmbench_tsv)
    assert rows == jbm.load_mmbench_tsv(mmbench_tsv)
    for row in rows + [{"A": "x", "B": "y", "C": "", "D": "z"}, {"A": "nan"}]:
        assert tbm.get_options(row) == jbm.get_options(row)
    for hint in ("a hint", None, "nan"):
        for lang in ("en", "cn"):
            assert (tbm.mmbench_prompt("q?", ["a", "b"], hint=hint, conv_mode="llama3",
                                       lang=lang)
                    == jbm.mmbench_prompt("q?", ["a", "b"], hint=hint, conv_mode="llama3",
                                          lang=lang))
    prob = {"question": "which is lighter?", "choices": ["rock", "feather", "x", "y", "z"],
            "hint": "two things", "image": "i.png"}
    for single in (True, False):
        assert (tbm.scienceqa_prompt(prob, conv_mode="v1", single_pred=single)
                == jbm.scienceqa_prompt(prob, conv_mode="v1", single_pred=single))
    ans = tmp_path / "a.jsonl"
    ans.write_text(json.dumps({"question_id": "10", "round_id": 0, "text": "B"}) + "\n")
    tbm.mmbench_to_submission(str(ans), mmbench_tsv, str(tmp_path / "t.json"))
    jbm.mmbench_to_submission(str(ans), mmbench_tsv, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def frames(n, seed=0, size=(64, 48)):
    r = np.random.default_rng(seed)
    return [Image.fromarray(r.integers(0, 255, size[::-1] + (3,), dtype=np.uint8))
            for _ in range(n)]


@pytest.mark.parametrize("n", [3, 8, 20])
def test_process_video_frames_matches_jax(n):
    fr = frames(n, seed=n)
    for tile, mc in ((56, 8), (336, 8)):
        tp, tm = tvideo.process_video_frames(fr, tile=tile, max_crops=mc)
        jp, jm = jvideo.process_video_frames(fr, tile=tile, max_crops=mc)
        assert tp.dtype == jp.dtype and tp.tobytes() == jp.tobytes()
        assert tm.tobytes() == jm.tobytes() and int(tm.sum()) == min(n, mc)
        assert not tm[min(n, mc):].any() and not tp[min(n, mc):].any()


VIDEO_QS = [
    {"video_id": "A", "videoID": "vidA", "question_id": "q1", "duration": "short",
     "question": "what is shown ?", "options": ["A. a cat", "B. a dog", "C. x", "D. y"],
     "answer": "A", "subtitles": "hello there"},
    {"video_id": "A", "videoID": "vidA", "question_id": "q2", "duration": "short",
     "question": "which color ?", "options": ["A. red", "B. blue"], "answer": "B"},
    {"video_id": "B", "videoID": "vidB", "question_id": "q3", "duration": "long",
     "question": "how many ?", "options": ["A. 1", "B. 2"], "answer": "B"},
]


@pytest.fixture(scope="module")
def frames_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    for name, n, seed in (("vidA", 3, 1), ("vidB", 10, 2)):
        (root / name).mkdir()
        for i, f in enumerate(frames(n, seed)):
            f.save(root / name / f"{i:03d}.png")
    return str(root)


def video_tokenizer(subs):
    tok = IdTokenizer()
    for q in VIDEO_QS:
        tok(jvideo.build_video_mme_prompt(q["question"], q["options"], conv_mode="v1",
                                          subtitles=q.get("subtitles") if subs else None))
    return tok


@pytest.mark.parametrize("subs", [False, True])
def test_run_video_mme_matches_jax(model, frames_root, tmp_path, subs):
    cfg, p, tp = model
    tok = video_tokenizer(subs)
    kw = dict(frames_root=frames_root, conv_mode="v1", max_new_tokens=4, subs=subs)
    jf = jvideo.run_video_mme(p, cfg, tok, VIDEO_QS, answers_file=str(tmp_path / "j.jsonl"),
                              compute_dtype=np.float32, **kw)
    tf = tvideo.run_video_mme(tp, cfg, tok, VIDEO_QS, answers_file=str(tmp_path / "t.jsonl"),
                              compute_dtype=torch.float32, **kw)
    got = rows_of(tf)
    assert got == rows_of(jf)
    assert [r["video_id"] for r in got] == ["A", "B"]
    assert [len(r["questions"]) for r in got] == [2, 1]
    assert tvideo.score_video_mme(tf) == jvideo.score_video_mme(jf)


def test_score_video_mme_matches_jax(tmp_path):
    f = tmp_path / "v.jsonl"
    recs = [{"video_id": "v1", "duration": "short", "questions": [
                {"response": "The answer is A", "answer": "A"},
                {"response": "B", "answer": "C"}]},
            {"video_id": "v2", "duration": None, "questions": [
                {"response": "D", "answer": "D"}, {"response": "no idea", "answer": "A"}]}]
    f.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert tvideo.score_video_mme(str(f)) == jvideo.score_video_mme(str(f))
    assert tvideo.score_video_mme(str(f))["short"] == 50.0


def test_each_video_reads_its_own_frames(model, frames_root, tmp_path, monkeypatch):
    """Regression of the JAX package's: each video's pixels come from its own
    frames directory (``videoID``), never the last question's."""
    cfg, _, tp = model
    seen = []

    def fake_generate(params, cfg, ids, attn, pix=None, mask=None, **kw):
        seen.append((pix.numpy().copy(), mask.numpy().copy()))
        return torch.full((1, 1), cfg.eos_token_id, dtype=torch.int32)

    monkeypatch.setattr(tgen_mod, "generate", fake_generate)
    tvideo.run_video_mme(tp, cfg, video_tokenizer(False), VIDEO_QS, frames_root=frames_root,
                         answers_file=str(tmp_path / "a.jsonl"), conv_mode="v1")
    assert len(seen) == 3
    for (pix, mask), name in zip(seen, ("vidA", "vidA", "vidB")):
        want, wmask = jvideo.process_video_frames(
            jvideo.load_frames(f"{frames_root}/{name}"), tile=cfg.vision.image_size,
            max_crops=1 + cfg.max_local_crops)
        assert pix[0].tobytes() == want.tobytes() and (mask[0] == wmask).all()
    assert not np.array_equal(seen[0][0], seen[2][0])
    assert [int(m.sum()) for _, m in seen] == [3, 3, 8]
