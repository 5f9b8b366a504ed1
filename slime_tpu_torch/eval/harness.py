"""Evaluation generation driver: chunked question files -> answers jsonl.

Port of ``slime_tpu/eval/harness.py``, which rebuilds the reference's
per-benchmark drivers (llava/eval/model_vqa_loader.py and variants, SURVEY.md
§2.29): dataset chunking for embarrassingly-parallel eval
(``--num-chunks/--chunk-idx``, model_vqa_loader.py:19-27), conversation-template
prompting, anyres preprocessing, greedy generation (or beam search), and the
unchanged answers-jsonl format so the reference's converters and scorers
consume the outputs directly.

Questions are batched (the reference runs bs=1): prompts are padded into
batches of ``batch_size`` rows, their length rounded up to a multiple of 64
(capped at ``seq_len``), and a short last batch padded with copies of its last
row, as in the JAX package, so a run's text does not depend on the batch it
lands in. The model runs on the device its parameters are on, in
``compute_dtype`` (bf16 unless given, as the JAX drivers).
"""
from __future__ import annotations

import json
import math
import os
import uuid
from typing import Dict, Iterable, List

import numpy as np
import torch

from .. import conversation as conv_lib
from ..config import SliMEConfig
from ..constants import DEFAULT_IMAGE_TOKEN
from ..data.image_ops import process_anyres_image_host
from ..data.tokenization import tokenizer_image_token


def split_list(lst: List, n: int) -> List[List]:
    """Split into n roughly-equal chunks (ceil-sized, reference semantics)."""
    size = math.ceil(len(lst) / n)
    return [lst[i:i + size] for i in range(0, len(lst), size)]


def get_chunk(lst: List, n: int, k: int) -> List:
    return split_list(lst, n)[k]


def load_questions(path: str) -> List[Dict]:
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(l) for l in f if l.strip()]
    with open(path) as f:
        return json.load(f)


def build_prompt(question: str, conv_mode: str, *, mm_use_im_start_end: bool = False,
                 single_pred_prompt: bool = False) -> str:
    qs = question
    if DEFAULT_IMAGE_TOKEN not in qs:
        qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
    if mm_use_im_start_end:
        qs = qs.replace(DEFAULT_IMAGE_TOKEN,
                        "<im_start>" + DEFAULT_IMAGE_TOKEN + "<im_end>")
    if single_pred_prompt:
        qs += "\nAnswer the question using a single word or phrase."
    conv = conv_lib.conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def params_device(params) -> torch.device:
    """The device the model's parameters are on (its token embedding's)."""
    return params["llm"]["embed_tokens"].device


def padded_batch(ids_list: List[np.ndarray], rows: int, S: int, device):
    """Right-padded (input_ids [rows, S] int64, attention_mask [rows, S] bool)
    on ``device``; each prompt is cut to S."""
    input_ids = np.zeros((rows, S), np.int64)
    attn = np.zeros((rows, S), bool)
    for b, ids in enumerate(ids_list):
        n = min(len(ids), S)
        input_ids[b, :n] = ids[:n]
        attn[b, :n] = True
    return torch.from_numpy(input_ids).to(device), torch.from_numpy(attn).to(device)


def decode_row(tokenizer, toks, b: int, eos_id: int) -> str:
    """Row b of the generated tokens, cut at EOS, as stripped text."""
    from ..generate import trim_at_eos

    ids = trim_at_eos(toks[b:b + 1], eos_id)[0]
    return tokenizer.decode(ids, skip_special_tokens=True).strip()


def run_eval(params, cfg: SliMEConfig, tokenizer, questions: List[Dict], *,
             image_folder: str, answers_file: str, conv_mode: str,
             model_id: str = "slime-tpu", batch_size: int = 4,
             max_new_tokens: int = 128, temperature: float = 0.0,
             num_beams: int = 1,
             seq_len: int = 0, question_key: str = "text",
             image_key: str = "image",
             single_pred_prompt: bool = False,
             compute_dtype=None, progress: bool = True) -> str:
    """Generate answers for a question chunk; returns the answers file path.

    seq_len caps the TEXT prompt length (0 = the model's
    tokenizer_model_max_length). Prompts are bucketed to 64-token multiples up
    to that cap; anything over the cap is truncated WITH a warning (the
    reference truncates only after image splicing, llava_arch.py:408-412).
    ``num_beams`` > 1 runs ``beam_search``."""
    import warnings
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from ..generate import beam_search, generate

    if compute_dtype is None:
        compute_dtype = torch.bfloat16
    if not seq_len:
        seq_len = cfg.tokenizer_model_max_length
    dev = params_device(params)

    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    MC = 1 + cfg.max_local_crops
    t_sz = cfg.vision.image_size

    def prep_one(q):
        prompt = build_prompt(q[question_key], conv_mode,
                              single_pred_prompt=single_pred_prompt)
        ids = tokenizer_image_token(prompt, tokenizer, return_tensors="np")
        if len(ids) > seq_len:
            warnings.warn(
                f"prompt for question {q.get('question_id', q.get('id', '?'))} "
                f"truncated {len(ids)} -> {seq_len} tokens (raise seq_len or "
                f"tokenizer_model_max_length)")
            ids = ids[:seq_len]
        img = Image.open(os.path.join(image_folder, q[image_key])).convert("RGB")
        crops, m, _ = process_anyres_image_host(img, tile=t_sz, max_crops=MC)
        return ids, crops, m

    # PIL releases the GIL: the pool overlaps preprocessing with the device
    with ThreadPoolExecutor(8) as pool, open(answers_file, "w") as out:
        for s in range(0, len(questions), batch_size):
            chunk = questions[s:s + batch_size]
            B = len(chunk)
            prepped = list(pool.map(prep_one, chunk))
            ids_list = [p[0] for p in prepped]
            pix = [p[1] for p in prepped]
            cmask = [p[2] for p in prepped]

            # the JAX package's buckets: the length rounds up to a multiple
            # of 64, a short batch is padded with copies of its last row
            S = max(len(i) for i in ids_list)
            S = min(((S + 63) // 64) * 64, seq_len)
            if B < batch_size:
                ids_list += [ids_list[-1]] * (batch_size - B)
                pix += [pix[-1]] * (batch_size - B)
                cmask += [cmask[-1]] * (batch_size - B)
            input_ids, attn = padded_batch(ids_list, batch_size, S, dev)
            pixel_values = torch.from_numpy(np.stack(pix)).to(dev)
            crop_mask = torch.from_numpy(np.stack(cmask)).to(dev)

            if num_beams > 1:
                toks = beam_search(params, cfg, input_ids, attn, pixel_values, crop_mask,
                                   num_beams=num_beams, max_new_tokens=max_new_tokens,
                                   compute_dtype=compute_dtype)
            else:
                toks = generate(params, cfg, input_ids, attn, pixel_values, crop_mask,
                                max_new_tokens=max_new_tokens, temperature=temperature,
                                compute_dtype=compute_dtype)
            for b, q in enumerate(chunk):
                out.write(json.dumps({
                    "question_id": q.get("question_id", q.get("id", s + b)),
                    "prompt": q[question_key],
                    "text": decode_row(tokenizer, toks, b, cfg.eos_token_id),
                    "answer_id": uuid.uuid4().hex[:22],
                    "model_id": model_id,
                    "metadata": {},
                }) + "\n")
            if progress:
                print(f"[eval] {min(s + B, len(questions))}/{len(questions)}",
                      flush=True)
    return answers_file


def run_text_qa(params, cfg: SliMEConfig, tokenizer, questions: List[Dict], *,
                answers_file: str, conv_mode: str = "vicuna_v1",
                model_id: str = "slime-tpu", batch_size: int = 4,
                max_new_tokens: int = 1024, temperature: float = 0.7,
                seq_len: int = 0, compute_dtype=None, seed: int = 0) -> str:
    """Text-only QA driver (reference llava/eval/model_qa.py:14-54): no images,
    default conversation template, sampled decoding. Questions are jsonl rows
    with question_id/text/category; answers keep the reference jsonl format.

    The draws come from one ``torch.Generator`` seeded with ``seed`` on the
    parameters' device, so a sampled run repeats itself under one seed (its
    text is not the JAX package's, whose draws come from
    ``jax.random.PRNGKey(seed)``); greedy runs (temperature 0) give JAX's."""
    from ..generate import generate

    if compute_dtype is None:
        compute_dtype = torch.bfloat16
    if not seq_len:
        seq_len = cfg.tokenizer_model_max_length
    dev = params_device(params)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)

    def prep(q):
        conv = conv_lib.conv_templates[conv_mode].copy()
        conv.append_message(conv.roles[0], q["text"])
        conv.append_message(conv.roles[1], None)
        ids = tokenizer(conv.get_prompt(), add_special_tokens=True).input_ids
        return np.asarray(ids[:seq_len], np.int64)

    rng = torch.Generator(device=dev).manual_seed(seed)
    with open(answers_file, "w") as out:
        for s in range(0, len(questions), batch_size):
            chunk = questions[s:s + batch_size]
            ids_list = [prep(q) for q in chunk]
            B = len(chunk)
            if B < batch_size:
                ids_list += [ids_list[-1]] * (batch_size - B)
            S = min(((max(len(i) for i in ids_list) + 63) // 64) * 64, seq_len)
            input_ids, attn = padded_batch(ids_list, batch_size, S, dev)
            toks = generate(params, cfg, input_ids, attn,
                            max_new_tokens=max_new_tokens, temperature=temperature,
                            generator=rng, compute_dtype=compute_dtype)
            for b, q in enumerate(chunk):
                out.write(json.dumps({
                    "question_id": q.get("question_id", s + b),
                    "text": decode_row(tokenizer, toks, b, cfg.eos_token_id),
                    "answer_id": uuid.uuid4().hex[:22],
                    "model_id": model_id,
                    "metadata": {},
                }) + "\n")
    return answers_file


def merge_chunks(chunk_files: Iterable[str], merged_file: str) -> str:
    """Concatenate per-chunk answer files (the reference's `cat` step,
    scripts/llama/eval/textvqa.sh:31-40)."""
    with open(merged_file, "w") as out:
        for cf in chunk_files:
            with open(cf) as f:
                out.write(f.read())
    return merged_file
