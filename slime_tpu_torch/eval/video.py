"""Training-free video path: frames as crops.

Port of ``slime_tpu/eval/video.py``, which rebuilds the reference's video fork
(llava/eval/video/, Slime_video.md): each frame is resized to the 336x336 view
(process_anyres_image_video, video/mm_utils.py:212-227); the frame stack then
flows through the standard SliME pipeline where frame 0 plays the global view
and the remaining frames are the "local crops" — compressed 576->144 by the
resampler and top-p-selected against the question
(video/llava_arch.py:226-248). 8 frames fit the 1+7 crop budget exactly;
fewer frames leave the trailing slots masked off.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import conversation as conv_lib
from ..config import SliMEConfig
from ..constants import DEFAULT_IMAGE_TOKEN, MAX_CROPS
from ..data.image_ops import _pil_to_chw, clip_normalize
from ..data.tokenization import tokenizer_image_token

VIDEO_MME_PROMPT = ("Select the best answer to the following multiple-choice "
                    "question based on the video. Respond with only the letter "
                    "(A, B, C, or D) of the correct option.\n")


def process_video_frames(frames: Sequence, *, tile: int = 336,
                         max_crops: int = MAX_CROPS
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """PIL frames -> ([max_crops, 3, t, t] float32, crop_mask). Frames beyond the
    budget are dropped uniformly; fewer frames leave padded slots masked off.
    Each frame is resized by PIL's bicubic filter, as the JAX package's."""
    from PIL import Image

    if len(frames) > max_crops:
        idx = np.linspace(0, len(frames) - 1, max_crops).round().astype(int)
        frames = [frames[i] for i in idx]
    out = np.zeros((max_crops, 3, tile, tile), np.float32)
    mask = np.zeros((max_crops,), bool)
    for i, f in enumerate(frames):
        out[i] = clip_normalize(_pil_to_chw(f.convert("RGB").resize((tile, tile),
                                                                    Image.BICUBIC)))
        mask[i] = True
    return out, mask


def load_frames(frames_dir: str) -> List:
    from PIL import Image
    files = sorted(f for f in os.listdir(frames_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    return [Image.open(os.path.join(frames_dir, f)) for f in files]


def build_video_mme_prompt(question: str, options: Sequence[str], *,
                           subtitles: Optional[str] = None,
                           conv_mode: str = "llama3") -> str:
    """Video-MME MCQ prompt (video/model_vqa_video_mme.py:75-90)."""
    qs = ""
    if subtitles:
        qs += f"This video's subtitles are listed below:\n {subtitles}\n"
    qs += VIDEO_MME_PROMPT + question
    choice = " The choices are listed below: \n" + "".join(o + "\n" for o in options)
    qs = DEFAULT_IMAGE_TOKEN + "\n" + qs + choice + "The best answer is:"
    conv = conv_lib.conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def run_video_mme(params, cfg: SliMEConfig, tokenizer, questions: List[Dict], *,
                  frames_root: str, answers_file: str, conv_mode: str = "llama3",
                  max_new_tokens: int = 16, subs: bool = False,
                  compute_dtype=None) -> str:
    """Video-MME driver: one answer record per video, grouping its questions
    (video/model_vqa_video_mme.py:140-170 output format); greedy, one
    question at a time."""
    from ..generate import generate
    from .harness import decode_row, padded_batch, params_device

    if compute_dtype is None:
        compute_dtype = torch.bfloat16
    dev = params_device(params)

    by_video: Dict[str, Dict] = {}
    for q in questions:
        vid = q["video_id"]
        by_video.setdefault(vid, {
            "video_id": vid, "duration": q.get("duration"),
            "domain": q.get("domain"), "sub_category": q.get("sub_category"),
            "questions": []})["questions"].append(q)

    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    with open(answers_file, "w") as out:
        for vid, item in by_video.items():
            # frames dir comes from THIS video's records ("videoID" names the
            # extracted-frames folder; falls back to the grouping id)
            frames_dir = item["questions"][0].get("videoID", vid)
            frames = load_frames(os.path.join(frames_root, frames_dir))
            pix, mask = process_video_frames(frames, tile=cfg.vision.image_size,
                                             max_crops=1 + cfg.max_local_crops)
            pixels = torch.from_numpy(pix[None]).to(dev)
            crop_mask = torch.from_numpy(mask[None]).to(dev)
            answered = []
            for q in item["questions"]:
                prompt = build_video_mme_prompt(
                    q["question"], q.get("options", []),
                    subtitles=q.get("subtitles") if subs else None,
                    conv_mode=conv_mode)
                ids = tokenizer_image_token(prompt, tokenizer, return_tensors="np")
                # the JAX package's bucket: a multiple of 64 positions
                input_ids, attn = padded_batch([ids], 1, ((len(ids) + 63) // 64) * 64, dev)
                toks = generate(params, cfg, input_ids, attn, pixels, crop_mask,
                                max_new_tokens=max_new_tokens, temperature=0.0,
                                compute_dtype=compute_dtype)
                answered.append({
                    "question_id": q.get("question_id"),
                    "question": q["question"],
                    "options": q.get("options", []),
                    "answer": q.get("answer"),
                    "response": decode_row(tokenizer, toks, 0, cfg.eos_token_id),
                })
            rec = dict(item)
            rec["questions"] = answered
            out.write(json.dumps(rec) + "\n")
    return answers_file


def score_video_mme(answers_file: str) -> Dict:
    """Accuracy by duration bucket + overall (Slime_video.md table format)."""
    from .scorers import parse_multichoice
    buckets: Dict[str, List[int]] = {}
    for line in open(answers_file):
        rec = json.loads(line)
        dur = rec.get("duration") or "all"
        for q in rec["questions"]:
            pred = parse_multichoice(q["response"], options="ABCD")
            ok = int(pred is not None and pred == (q.get("answer") or "").strip())
            buckets.setdefault(dur, []).append(ok)
            buckets.setdefault("overall", []).append(ok)
    return {k: 100.0 * sum(v) / max(len(v), 1) for k, v in buckets.items()}
