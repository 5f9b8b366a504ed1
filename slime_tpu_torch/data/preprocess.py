"""Conversation -> (input_ids, labels) with instruction masking.

The port's own copy of ``slime_tpu/data/preprocess.py`` (jax-free, numpy
only): ``preprocess_multimodal`` ('<image>' placement) and ``preprocess``
with its ``plain``, ``v1``, ``llama3`` and ``mpt`` templates, the
reference's masking (llava/train/train.py:373-747) including the
non-legacy tokenizer corrections and the mismatch guard that masks a whole
sample. ``tests/test_torch_independence.py`` holds it to the original's
code.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np

from .. import conversation as conv_lib
from ..constants import DEFAULT_IMAGE_TOKEN, IGNORE_INDEX
from .tokenization import tokenizer_image_token


def _tok_len(text: str, tokenizer, has_image: bool) -> int:
    if has_image:
        return len(tokenizer_image_token(text, tokenizer))
    return len(tokenizer(text).input_ids)


def _tokenizer_not_legacy(tokenizer) -> bool:
    # transformers >= 0.14 fast tokenizers drop the leading SPIECE on continuation
    return not getattr(tokenizer, "legacy", False)


def preprocess_multimodal(sources: Sequence[List[Dict]], *,
                          mm_use_im_start_end: bool = False) -> Sequence[List[Dict]]:
    """Normalize '<image>' placement: move to the front of the turn, one per turn."""
    for source in sources:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                v = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                sentence["value"] = (DEFAULT_IMAGE_TOKEN + "\n" + v).strip()
            if mm_use_im_start_end:
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_IMAGE_TOKEN, "<im_start>" + DEFAULT_IMAGE_TOKEN + "<im_end>")
    return sources


def _render(conv_template, source: List[Dict]) -> str:
    conv = conv_template.copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    if roles.get(source[0]["from"]) != conv.roles[0]:
        source = source[1:]
    for j, sentence in enumerate(source):
        role = roles[sentence["from"]]
        assert role == conv.roles[j % 2], "conversation roles must alternate"
        conv.append_message(role, sentence["value"])
    return conv.get_prompt()


def _ids(prompt: str, tokenizer, has_image: bool) -> np.ndarray:
    if has_image:
        return tokenizer_image_token(prompt, tokenizer, return_tensors="np")
    return np.asarray(tokenizer(prompt).input_ids, dtype=np.int32)


def preprocess_plain(sources, tokenizer) -> Dict[str, List[np.ndarray]]:
    """Pretrain format: '<image>' + caption + sep; only the caption is supervised."""
    input_ids, labels = [], []
    sep = conv_lib.conv_templates["plain"].sep
    for source in sources:
        assert len(source) == 2 and DEFAULT_IMAGE_TOKEN in source[0]["value"]
        prompt = DEFAULT_IMAGE_TOKEN + source[1]["value"] + sep
        ids = tokenizer_image_token(prompt, tokenizer, return_tensors="np")
        lab = ids.copy()
        n_instr = len(tokenizer_image_token(DEFAULT_IMAGE_TOKEN, tokenizer))
        lab[:n_instr] = IGNORE_INDEX
        input_ids.append(ids)
        labels.append(lab)
    return {"input_ids": input_ids, "labels": labels}


def preprocess_v1(sources, tokenizer, has_image: bool = False,
                  conv_template=None) -> Dict[str, List[np.ndarray]]:
    """Vicuna v1 (TWO separator style): mask system + 'USER: ...' spans."""
    conv = conv_template or conv_lib.conv_templates["v1"]
    input_ids, labels = [], []
    sep = conv.sep + conv.roles[1] + ": "
    minus = 1 if _tokenizer_not_legacy(tokenizer) else 0
    for source in sources:
        prompt = _render(conv, source)
        ids = _ids(prompt, tokenizer, has_image)
        lab = ids.copy()
        total_len = int(np.sum(ids != tokenizer.pad_token_id))
        cur = 1
        lab[:cur] = IGNORE_INDEX
        ok = True
        for i, rou in enumerate(prompt.split(conv.sep2)):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            instr = parts[0] + sep
            round_len = _tok_len(rou, tokenizer, has_image)
            instr_len = _tok_len(instr, tokenizer, has_image) - 2
            if i != 0:
                round_len -= minus
                instr_len -= minus
            lab[cur:cur + instr_len] = IGNORE_INDEX
            cur += round_len
        lab[cur:] = IGNORE_INDEX
        if cur < tokenizer.model_max_length and cur != total_len:
            lab[:] = IGNORE_INDEX  # tokenization-mismatch guard
        input_ids.append(ids)
        labels.append(lab)
    return {"input_ids": input_ids, "labels": labels}


def preprocess_llama3(sources, tokenizer, has_image: bool = False,
                      conv_template=None) -> Dict[str, List[np.ndarray]]:
    """Llama-3 header style; the rendered prompt strips the inter-round sep2."""
    conv = conv_template or conv_lib.conv_templates["llama3"]
    sep = f"<|start_header_id|>{conv.roles[1]}<|end_header_id|>\n\n"
    minus = 1 if _tokenizer_not_legacy(tokenizer) else 0
    input_ids, labels = [], []
    for source in sources:
        prompt = _render(conv, source)
        ids = _ids(prompt.replace(conv.sep2, ""), tokenizer, has_image)
        lab = ids.copy()
        total_len = lab.shape[0]
        cur = 0
        for i, rou in enumerate(prompt.split(conv.sep2)):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            instr = parts[0] + sep
            round_len = _tok_len(rou, tokenizer, has_image)
            instr_len = _tok_len(instr, tokenizer, has_image)
            if i != 0:
                round_len -= minus
                instr_len -= minus
            lab[cur:cur + instr_len] = IGNORE_INDEX
            cur += round_len
        lab[cur:] = IGNORE_INDEX
        if cur < tokenizer.model_max_length and cur != total_len:
            lab[:] = IGNORE_INDEX
        input_ids.append(ids)
        labels.append(lab)
    return {"input_ids": input_ids, "labels": labels}


def preprocess_mpt(sources, tokenizer, has_image: bool = False,
                   conv_template=None) -> Dict[str, List[np.ndarray]]:
    """ChatML/MPT style: rounds regrouped as [system+user+gpt], then [user+gpt]..."""
    conv = conv_template or conv_lib.conv_templates["mpt"]
    sep = conv.sep + conv.roles[1]
    plus = 1 if (getattr(tokenizer, "legacy", False)) else 0
    input_ids, labels = [], []
    for source in sources:
        prompt = _render(conv, source)
        ids = _ids(prompt, tokenizer, has_image)
        lab = ids.copy()
        total_len = int(np.sum(ids != tokenizer.pad_token_id))
        rounds = prompt.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for ci in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[ci:ci + 2]))
        cur = 0
        for rou in re_rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            instr = parts[0] + sep
            round_len = _tok_len(rou, tokenizer, has_image) + plus
            instr_len = _tok_len(instr, tokenizer, has_image) - 1 + plus
            lab[cur:cur + instr_len] = IGNORE_INDEX
            cur += round_len
        lab[cur:] = IGNORE_INDEX
        if cur < tokenizer.model_max_length and cur != total_len:
            lab[:] = IGNORE_INDEX
        input_ids.append(ids)
        labels.append(lab)
    return {"input_ids": input_ids, "labels": labels}


def preprocess(sources, tokenizer, has_image: bool = False,
               version: str = "v1") -> Dict[str, List[np.ndarray]]:
    """Dispatch on template version (train.py:702-721)."""
    if version in ("plain", "v0_plain"):
        return preprocess_plain(sources, tokenizer)
    if version == "llama3":
        return preprocess_llama3(sources, tokenizer, has_image=has_image)
    if version.startswith("v1") or version in ("vicuna_v1", "llava_v1"):
        return preprocess_v1(sources, tokenizer, has_image=has_image)
    if version in ("mpt", "chatml_direct", "mistral_direct"):
        return preprocess_mpt(sources, tokenizer, has_image=has_image)
    raise ValueError(f"Unsupported conversation version: {version}")
