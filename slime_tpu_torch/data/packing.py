"""Sequence packing for text-only SFT: fixed [B, S] batches filled with many
short examples instead of padding.

The port's own copy of ``slime_tpu/data/packing.py`` (jax-free, numpy
only): ``pack_rows`` (first-fit decreasing), ``collate_packed`` (per-example
``segment_ids`` 1..n and restarting ``positions``), ``packed_loader`` and
``packing_efficiency``. Attention stays inside a segment
(``llama.forward(segment_ids=...)``) and the loss drops cross-segment
targets, so the packed batch's summed NLL equals the padded batches'.
Text-only: image features splice into the embeddings at fusion time.
``tests/test_torch_independence.py`` holds it to the original's code.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np

from ..constants import IGNORE_INDEX


def pack_rows(items: Sequence[Dict], *, seq_len: int) -> List[List[Dict]]:
    """First-fit-decreasing bin packing: items (dicts with 'input_ids',
    'labels') -> list of rows, each a list of items whose total length fits
    seq_len. Items longer than seq_len are truncated to fit one row."""
    order = sorted(range(len(items)),
                   key=lambda i: len(items[i]["input_ids"]), reverse=True)
    rows: List[List[Dict]] = []
    space: List[int] = []
    for i in order:
        it = items[i]
        n = min(len(it["input_ids"]), seq_len)
        for r, free in enumerate(space):
            if n <= free:
                rows[r].append(it)
                space[r] -= n
                break
        else:
            rows.append([it])
            space.append(seq_len - n)
    return rows


def collate_packed(rows: Sequence[Sequence[Dict]], *, seq_len: int,
                   pad_token_id: int) -> Dict[str, np.ndarray]:
    """Rows of examples -> one packed batch:

    input_ids/labels [B, S]; segment_ids [B, S] (1..n per example, 0 pad);
    positions [B, S] (restart at 0 per segment — RoPE must not see one long
    document); attention_mask [B, S] (real tokens)."""
    B = len(rows)
    ids = np.full((B, seq_len), pad_token_id, np.int32)
    labels = np.full((B, seq_len), IGNORE_INDEX, np.int32)
    seg = np.zeros((B, seq_len), np.int32)
    pos = np.zeros((B, seq_len), np.int32)
    mask = np.zeros((B, seq_len), bool)
    for b, row in enumerate(rows):
        off = 0
        for s_idx, it in enumerate(row, start=1):
            n = min(len(it["input_ids"]), seq_len - off)
            if n <= 0:
                break
            ids[b, off:off + n] = np.asarray(it["input_ids"])[:n]
            labels[b, off:off + n] = np.asarray(it["labels"])[:n]
            seg[b, off:off + n] = s_idx
            pos[b, off:off + n] = np.arange(n)
            mask[b, off:off + n] = True
            off += n
    return {"input_ids": ids, "labels": labels, "segment_ids": seg,
            "positions": pos, "attention_mask": mask}


def packed_loader(items: Iterable[Dict], *, batch_size: int, seq_len: int,
                  pad_token_id: int, buffer_rows: int = 4) -> Iterator[Dict]:
    """Stream tokenized text-only items into packed [batch_size, seq_len]
    batches. Buffers ``buffer_rows`` x batch_size rows' worth of items so
    first-fit-decreasing has material to bin well, then emits full batches;
    the tail is flushed (possibly underfull rows, never dropped)."""
    buf: List[Dict] = []
    approx = 0

    def flush_full():
        nonlocal buf, approx
        rows = pack_rows(buf, seq_len=seq_len)
        while len(rows) >= batch_size:
            take, rows = rows[:batch_size], rows[batch_size:]
            yield collate_packed(take, seq_len=seq_len,
                                 pad_token_id=pad_token_id)
        buf = [it for row in rows for it in row]
        approx = sum(min(len(it["input_ids"]), seq_len) for it in buf)

    for it in items:
        buf.append(it)
        approx += min(len(it["input_ids"]), seq_len)
        if approx >= buffer_rows * batch_size * seq_len:
            yield from flush_full()
    yield from flush_full()
    if buf:
        rows = pack_rows(buf, seq_len=seq_len)
        for s in range(0, len(rows), batch_size):
            yield collate_packed(rows[s:s + batch_size], seq_len=seq_len,
                                 pad_token_id=pad_token_id)


def packing_efficiency(batch: Dict[str, np.ndarray]) -> float:
    """Real-token fraction of the packed batch (1.0 = zero padding)."""
    return float(batch["attention_mask"].mean())
