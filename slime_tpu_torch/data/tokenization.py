"""Prompt tokenization with the image sentinel, and stop strings.

The port's copy of ``slime_tpu/data/tokenization.py:16-90``: the semantics
of the reference's ``tokenizer_image_token`` (llava/mm_utils.py:262-281) and
``KeywordsStoppingCriteria`` (llava/mm_utils.py:292-324).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..constants import DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX


def tokenizer_image_token(prompt: str, tokenizer, image_token_index: int = IMAGE_TOKEN_INDEX,
                          return_tensors: Optional[str] = None):
    """Tokenize the chunks between '<image>' markers and splice the sentinel
    id between them. When every chunk starts with BOS, only the first keeps
    it (the reference's offset logic)."""
    chunks = [tokenizer(c).input_ids for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    for i, c in enumerate(chunks):
        input_ids.extend(c[offset:])
        if i < len(chunks) - 1:
            input_ids.extend(sep[offset:])
    if return_tensors == "np":
        return np.asarray(input_ids, dtype=np.int32)
    if return_tensors == "pt":
        import torch
        return torch.tensor(input_ids, dtype=torch.long)
    if return_tensors is not None:
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids


def get_model_name_from_path(model_path: str) -> str:
    """A checkpoint directory -> the model name the worker registers
    (``checkpoint-N`` directories keep their parent's name)."""
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


class StopStringMatcher:
    """Host-side stop-string detection between decode chunks: the generated
    ids are checked against each keyword's ids, and the decoded tail against
    the keyword strings."""

    def __init__(self, keywords: Sequence[str], tokenizer):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.keyword_ids: List[List[int]] = []
        for kw in self.keywords:
            ids = tokenizer(kw).input_ids
            if len(ids) > 1 and ids[0] == tokenizer.bos_token_id:
                ids = ids[1:]
            self.keyword_ids.append(ids)
        self.max_keyword_len = max((len(i) for i in self.keyword_ids), default=0)

    def __call__(self, generated_ids: Sequence[int]) -> bool:
        gen = list(generated_ids)
        for ids in self.keyword_ids:
            if len(gen) >= len(ids) and gen[-len(ids):] == ids:
                return True
        tail = self.tokenizer.decode(gen[-max(self.max_keyword_len, 1):],
                                     skip_special_tokens=True)
        return any(kw in tail for kw in self.keywords)

    def trim(self, text: str) -> str:
        for kw in self.keywords:
            if text.endswith(kw):
                text = text[: -len(kw)]
        return text.strip()
