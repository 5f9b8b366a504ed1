"""The fixed-shape collator and the background input pipeline.

The port's copies of ``collate`` (``slime_tpu/data/dataset.py:141-159``) and
``Prefetcher`` (:239-297). ``collate`` pads token rows to a fixed ``seq_len``
and stacks crops at the fixed crop budget with their mask, so every batch has
one shape. ``Prefetcher`` runs an iterator (host preprocessing, and the
host-to-device copy as ``map_fn``) in a producer thread.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Sequence

import numpy as np

from ..constants import IGNORE_INDEX


def collate(items: Sequence[Dict], *, pad_token_id: int, seq_len: int) -> Dict[str, np.ndarray]:
    """Fixed-shape batch: ids/labels right-padded (truncated) to ``seq_len``,
    crops stacked at the fixed crop budget."""
    B = len(items)
    ids = np.full((B, seq_len), pad_token_id, np.int32)
    labels = np.full((B, seq_len), IGNORE_INDEX, np.int32)
    mask = np.zeros((B, seq_len), bool)
    for b, it in enumerate(items):
        n = min(len(it["input_ids"]), seq_len)
        ids[b, :n] = it["input_ids"][:n]
        labels[b, :n] = it["labels"][:n]
        mask[b, :n] = True
    return {"input_ids": ids, "labels": labels, "attention_mask": mask,
            "pixel_values": np.stack([it["pixel_values"] for it in items]),
            "crop_mask": np.stack([it["crop_mask"] for it in items])}


class Prefetcher:
    """Bounded-queue background input pipeline with stall accounting.

    Runs ``iterator`` in a daemon thread and keeps up to ``depth`` items
    ready, each passed through ``map_fn`` in that thread. ``stall_s`` is the
    time the consumer spent blocked on an empty queue (the trainer logs it
    over the loop's wall time). A producer exception re-raises on the
    consumer's side."""

    _END = object()

    def __init__(self, iterator, depth: int = 2, map_fn=None):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self.stall_s = 0.0
        self.batches = 0

        def producer():
            try:
                for item in iterator:
                    self._q.put(map_fn(item) if map_fn is not None else item)
                self._q.put(Prefetcher._END)
            except BaseException as e:  # noqa: BLE001 (re-raised by the consumer)
                self._q.put(e)

        self._t = threading.Thread(target=producer, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._q.empty():
            t0 = time.perf_counter()
            item = self._q.get()
            self.stall_s += time.perf_counter() - t0
        else:
            item = self._q.get()
        if item is Prefetcher._END:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        self.batches += 1
        return item
