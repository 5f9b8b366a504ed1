"""Preference-pair dataset + collator for DPO (train/dpo.py).

The reference's DPO launch script points at an RLHF-V-style preference
dataset (`--data_path data/llava_7b_v1_preference.json`,
reference scripts/llama-lora/eval/log_p_inference.sh) with no loader behind
it (train.py never reads `task`). This module defines the loader for that
role. Accepted record shapes (all LLaVA-adjacent preference formats):

- {"conversations": [prompt turns...], "chosen": str|{"value"},
   "rejected": str|{"value"}, "image"?: path}
- LLaVA-RLHF: {"conversations"|"question", "output_1": {"value"},
   "output_2": {"value"}, "preference": 1|2, "image"?}

If ``conversations`` ends with a gpt turn it is treated as the original
answer and dropped — the prompt is everything before it. Each side of the
pair renders through the SAME conversation template + label-masking
machinery as SFT (data/preprocess.py), so instruction spans are IGNOREd
identically on both rows.

Token weighting (reference dpo_token_weighted / dpo_token_weight,
train.py:152-159 — the RLHF-V recipe): the chosen and rejected answers'
target-token lists are diffed with difflib.SequenceMatcher; tokens inside
matching blocks weigh 1.0, differing tokens weigh ``token_weight``. The
weights ride the batch as per-target-token lists ([2B, T]) and are
redistributed onto the fused rows in-graph (train/dpo._fused_weights).
"""
from __future__ import annotations

import difflib
import json
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..constants import IGNORE_INDEX, MAX_CROPS
from . import preprocess as pp
from .dataset import image_crops_for_record


def _answer_text(v) -> str:
    if isinstance(v, dict):
        return v.get("value", "")
    return str(v)


def normalize_record(r: Dict) -> Tuple[List[Dict], str, str]:
    """-> (prompt turns, chosen text, rejected text)."""
    if "chosen" in r and "rejected" in r:
        chosen, rejected = _answer_text(r["chosen"]), _answer_text(r["rejected"])
    elif "output_1" in r and "output_2" in r:
        o1, o2 = _answer_text(r["output_1"]), _answer_text(r["output_2"])
        if "preference" not in r:
            raise ValueError(
                "output_1/output_2 record needs an explicit 'preference' key")
        pref = int(r["preference"])
        if pref not in (1, 2):
            # LLaVA-RLHF uses 1/2; anything else (0, ties, malformed) has no
            # defined orientation — refuse rather than train on it
            raise ValueError(f"preference must be 1 or 2, got {pref!r}")
        chosen, rejected = (o1, o2) if pref == 1 else (o2, o1)
    else:
        raise ValueError(
            "preference record needs chosen/rejected or output_1/output_2: "
            f"keys={sorted(r.keys())}")
    if "conversations" in r:
        prompt = [dict(t) for t in r["conversations"]]
        if prompt and prompt[-1].get("from") == "gpt":
            prompt = prompt[:-1]
    elif "question" in r:
        prompt = [{"from": "human", "value": r["question"]}]
    else:
        raise ValueError("preference record needs conversations or question")
    return prompt, chosen, rejected


class PreferenceDataset:
    """Lazy preference-pair dataset over LLaVA-format JSON files."""

    def __init__(self, data_paths: Sequence[str], tokenizer, *,
                 image_folder: str = "", image_aspect_ratio: str = "anyres",
                 conv_version: str = "v1", max_crops: int = MAX_CROPS,
                 is_multimodal: bool = True, tile: int = 336,
                 use_native_preprocess: bool = True,
                 pixel_dtype: str = "float32", token_weighted: bool = False,
                 token_weight: float = 1.1):
        if isinstance(data_paths, str):
            data_paths = [data_paths]
        self.tokenizer = tokenizer
        self.image_folder = image_folder
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_version = conv_version
        self.max_crops = max_crops
        self.is_multimodal = is_multimodal
        self.tile = tile
        self.use_native_preprocess = use_native_preprocess and tile == 336
        if image_aspect_ratio not in ("anyres", "any_res"):
            pixel_dtype = "float32"
        self.pixel_dtype = pixel_dtype
        self.token_weighted = token_weighted
        self.token_weight = float(token_weight)
        self.records: List[Dict] = []
        for p in data_paths:
            with open(p) as f:
                self.records.extend(json.load(f))

    def __len__(self) -> int:
        return len(self.records)

    def _side(self, prompt: List[Dict], answer: str, has_image: bool):
        convs = prompt + [{"from": "gpt", "value": answer}]
        sources = pp.preprocess_multimodal(
            [json.loads(json.dumps(convs))]) if has_image else \
            [json.loads(json.dumps(convs))]
        d = pp.preprocess(sources, self.tokenizer, has_image=has_image,
                          version=self.conv_version)
        return d["input_ids"][0], d["labels"][0]

    def __getitem__(self, i: int) -> Dict:
        r = self.records[i]
        has_image = "image" in r and self.is_multimodal
        prompt, chosen, rejected = normalize_record(r)
        ids_c, lab_c = self._side(prompt, chosen, has_image)
        ids_r, lab_r = self._side(prompt, rejected, has_image)
        item: Dict = {"input_ids_chosen": ids_c, "labels_chosen": lab_c,
                      "input_ids_rejected": ids_r, "labels_rejected": lab_r}
        if self.token_weighted:
            wc, wr = target_token_weights(
                [int(t) for t in lab_c[lab_c != IGNORE_INDEX]],
                [int(t) for t in lab_r[lab_r != IGNORE_INDEX]],
                self.token_weight)
            item["target_weights_chosen"] = wc
            item["target_weights_rejected"] = wr
        pv, mask = image_crops_for_record(
            r if has_image else None, image_folder=self.image_folder,
            image_aspect_ratio=self.image_aspect_ratio, tile=self.tile,
            max_crops=self.max_crops, use_native=self.use_native_preprocess,
            pixel_dtype=self.pixel_dtype)
        item["pixel_values"] = pv
        item["crop_mask"] = mask
        return item


def target_token_weights(chosen_targets: List[int],
                         rejected_targets: List[int],
                         token_weight: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-target-token weights: 1.0 where the two answers' token streams
    match (difflib matching blocks), ``token_weight`` where they differ."""
    wc = np.full((max(len(chosen_targets), 1),), token_weight, np.float32)
    wr = np.full((max(len(rejected_targets), 1),), token_weight, np.float32)
    sm = difflib.SequenceMatcher(a=chosen_targets, b=rejected_targets,
                                 autojunk=False)
    for i, j, n in sm.get_matching_blocks():
        wc[i:i + n] = 1.0
        wr[j:j + n] = 1.0
    return wc[:len(chosen_targets) or 1], wr[:len(rejected_targets) or 1]


def collate_dpo(items: Sequence[Dict], *, pad_token_id: int,
                seq_len: int) -> Dict[str, np.ndarray]:
    """Stacked pair batch: rows [0, B) are chosen, rows [B, 2B) rejected.

    pixel_values/crop_mask stay per-PAIR [B, ...] — the step tiles them to
    both rows (train/dpo.pair_logps), halving the host->device pixel bytes."""
    B = len(items)
    ids = np.full((2 * B, seq_len), pad_token_id, np.int32)
    labels = np.full((2 * B, seq_len), IGNORE_INDEX, np.int32)
    mask = np.zeros((2 * B, seq_len), bool)
    for b, it in enumerate(items):
        for row, side in ((b, "chosen"), (B + b, "rejected")):
            src_ids = it[f"input_ids_{side}"]
            src_lab = it[f"labels_{side}"]
            n = min(len(src_ids), seq_len)
            ids[row, :n] = src_ids[:n]
            labels[row, :n] = src_lab[:n]
            mask[row, :n] = True
            # truncation that removes ALL of one side's target tokens feeds a
            # logp over zero mass into the DPO loss — a silently distorted
            # gradient for the whole pair; surface it
            if (np.asarray(src_lab[:n]) != IGNORE_INDEX).sum() == 0 and \
                    (np.asarray(src_lab) != IGNORE_INDEX).sum() > 0:
                import warnings
                warnings.warn(
                    f"collate_dpo: seq_len={seq_len} truncated away every "
                    f"target token of the {side} row of pair {b}; the pair "
                    f"contributes a distorted gradient — raise seq_len or "
                    f"filter long records", stacklevel=2)
    batch = {
        "input_ids": ids,
        "labels": labels,
        "attention_mask": mask,
        "pixel_values": np.stack([it["pixel_values"] for it in items]),
        "crop_mask": np.stack([it["crop_mask"] for it in items]),
    }
    if "target_weights_chosen" in items[0]:
        t_max = max(max(len(it["target_weights_chosen"]),
                        len(it["target_weights_rejected"])) for it in items)
        w = np.ones((2 * B, max(t_max, 1)), np.float32)
        for b, it in enumerate(items):
            for row, side in ((b, "chosen"), (B + b, "rejected")):
                tw = it[f"target_weights_{side}"]
                w[row, :len(tw)] = tw
        batch["target_weights"] = w
    return batch


def dpo_loader(dataset: PreferenceDataset, *, batch_size: int, seq_len: int,
               pad_token_id: int, shuffle: bool = True, seed: int = 0,
               drop_last: bool = True, num_workers: int = 0):
    """Epoch iterator yielding collated pair batches (mirror of
    dataset.data_loader)."""
    order = list(range(len(dataset)))
    if shuffle:
        random.Random(seed).shuffle(order)

    def get(i):
        return dataset[i]

    if num_workers > 0:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(num_workers) as ex:
            for s in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                           batch_size):
                chunk = order[s:s + batch_size]
                if drop_last and len(chunk) < batch_size:
                    break
                items = list(ex.map(get, chunk))
                yield collate_dpo(items, pad_token_id=pad_token_id,
                                  seq_len=seq_len)
    else:
        for s in range(0, len(order), batch_size):
            chunk = order[s:s + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            yield collate_dpo([get(i) for i in chunk],
                              pad_token_id=pad_token_id, seq_len=seq_len)
