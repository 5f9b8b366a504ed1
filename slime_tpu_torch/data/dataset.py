"""The supervised dataset, its sampler and loader, the fixed-shape collator
and the background input pipeline.

The port's copy of ``slime_tpu/data/dataset.py`` (numpy and PIL only):

- ``SupervisedDataset`` (:29-114): LLaVA-format JSON conversation lists, one
  or several files (sqrt-size mixing), each item preprocessed lazily
  (``data.preprocess``) with its anyres crops from the port's host path
  (``data.image_ops``, the C++ library where it is built);
- ``image_crops_for_record`` (:117-138), ``LengthGroupedSampler``
  (:162-198: megabatches grouped by modality and sorted by length),
  ``data_loader`` (:201-236) and ``prefetch`` (:298);
- ``collate`` (:141-159) pads token rows to a fixed ``seq_len`` and stacks
  crops at the fixed crop budget with their mask, so every batch has one
  shape. ``Prefetcher`` (:239-297) runs an iterator (host preprocessing, and
  the host-to-device copy as ``map_fn``) in a producer thread.
"""
from __future__ import annotations

import json
import os
import queue
import random
import threading
import time
from typing import Dict, List, Sequence

import numpy as np

from ..constants import IGNORE_INDEX, MAX_CROPS
from . import preprocess as pp
from .image_ops import process_anyres_image_host, process_pad_image_host


class SupervisedDataset:
    """Lazy conversation dataset over one or more LLaVA-format JSON files.

    ``pixel_dtype="uint8"`` ships raw [0, 255] anyres crops (the device
    normalizes them); other aspect-ratio modes keep float32."""

    def __init__(self, data_paths: Sequence[str], tokenizer, *,
                 image_folder: str = "", image_aspect_ratio: str = "anyres",
                 conv_version: str = "v1", max_crops: int = MAX_CROPS,
                 is_multimodal: bool = True, seed: int = 3407,
                 tile: int = 336, use_native_preprocess: bool = True,
                 pixel_dtype: str = "float32"):
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
        if pixel_dtype not in ("float32", "uint8"):
            raise ValueError(f"pixel_dtype {pixel_dtype!r}")
        if image_aspect_ratio not in ("anyres", "any_res"):
            pixel_dtype = "float32"
        self.pixel_dtype = pixel_dtype

        datasets = []
        for p in data_paths:
            with open(p) as f:
                datasets.append(json.load(f))
        if len(datasets) > 1:
            # sqrt-size mixing (train.py:793-796)
            sizes = np.asarray([len(d) for d in datasets], dtype=np.float64)
            probs = np.sqrt(sizes) / np.sqrt(sizes).sum()
            rng = random.Random(seed)
            self.records = []
            for _ in range(int(sizes.sum())):
                src = rng.choices(range(len(datasets)), weights=probs)[0]
                self.records.append(rng.choice(datasets[src]))
        else:
            self.records = datasets[0]

    def __len__(self) -> int:
        return len(self.records)

    @property
    def lengths(self) -> List[int]:
        return [sum(len(c["value"].split()) for c in r["conversations"])
                + (128 if "image" in r else 0) for r in self.records]

    @property
    def modality_lengths(self) -> List[int]:
        """Positive for multimodal samples, negative for text-only (train.py:809-817)."""
        out = []
        for r in self.records:
            n = sum(len(c["value"].split()) for c in r["conversations"])
            out.append(n if "image" in r else -n)
        return out

    def __getitem__(self, i: int) -> Dict:
        r = self.records[i]
        has_image = "image" in r and self.is_multimodal
        sources = [json.loads(json.dumps(r["conversations"]))]
        if has_image:
            sources = pp.preprocess_multimodal(sources)
        d = pp.preprocess(sources, self.tokenizer, has_image=has_image,
                          version=self.conv_version)
        pv, mask = image_crops_for_record(
            r if has_image else None, image_folder=self.image_folder,
            image_aspect_ratio=self.image_aspect_ratio, tile=self.tile,
            max_crops=self.max_crops, use_native=self.use_native_preprocess,
            pixel_dtype=self.pixel_dtype)
        return {"input_ids": d["input_ids"][0], "labels": d["labels"][0],
                "pixel_values": pv, "crop_mask": mask}


def image_crops_for_record(record, *, image_folder: str, image_aspect_ratio: str,
                           tile: int, max_crops: int, use_native: bool, pixel_dtype: str):
    """(pixel_values [max_crops, 3, t, t], crop_mask [max_crops]) of one
    record; ``record=None`` (text-only) gives zero slots so batch shapes stay
    uniform."""
    if record is None:
        return (np.zeros((max_crops, 3, tile, tile), getattr(np, pixel_dtype)),
                np.zeros((max_crops,), bool))
    from PIL import Image
    img = Image.open(os.path.join(image_folder, record["image"])).convert("RGB")
    if image_aspect_ratio in ("anyres", "any_res"):
        crops, mask, _ = process_anyres_image_host(
            img, tile=tile, max_crops=max_crops, use_native=use_native,
            normalize=pixel_dtype == "float32")
        return crops, mask
    one = process_pad_image_host(img, tile=tile)
    crops = np.zeros((max_crops,) + one.shape, np.float32)
    crops[0] = one
    mask = np.zeros((max_crops,), bool)
    mask[0] = True
    return crops, mask


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
    consumer's side. ``close()`` ends the producer at its next item, so a
    consumer that stops early (a trainer at ``max_steps``) leaves no thread
    holding ``map_fn``, its device batches and what they reference."""

    _END = object()

    def __init__(self, iterator, depth: int = 2, map_fn=None):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._closed = threading.Event()
        self.stall_s = 0.0
        self.batches = 0

        def producer():
            try:
                for item in iterator:
                    if not self._put(map_fn(item) if map_fn is not None else item):
                        return
                self._put(Prefetcher._END)
            except BaseException as e:  # noqa: BLE001 (re-raised by the consumer)
                self._put(e)

        self._t = threading.Thread(target=producer, daemon=True)
        self._t.start()

    def _put(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def close(self) -> None:
        """Stop the producer (at its next item) and drop what it queued."""
        self._closed.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

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


class LengthGroupedSampler:
    """Megabatch length grouping with the modality split (LLaVATrainer's
    get_modality_length_grouped_indices): shuffle, bucket multimodal and
    text-only samples apart, sort each megabatch by length."""

    def __init__(self, lengths: Sequence[int], batch_size: int, *,
                 world_size: int = 1, seed: int = 0, group_by_modality: bool = True):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.world_size = world_size
        self.seed = seed
        self.group_by_modality = group_by_modality

    def _sorted_megabatches(self, pool, mega):
        out = []
        for s in range(0, len(pool), mega):
            out.extend(sorted(pool[s:s + mega], key=lambda i: abs(self.lengths[i]),
                              reverse=True))
        return out

    def indices(self, epoch: int = 0) -> List[int]:
        rng = random.Random(self.seed + epoch)
        mega = self.batch_size * self.world_size * 50
        if (self.group_by_modality and any(n < 0 for n in self.lengths)
                and any(n > 0 for n in self.lengths)):
            mm = [i for i, n in enumerate(self.lengths) if n > 0]
            txt = [i for i, n in enumerate(self.lengths) if n <= 0]
            rng.shuffle(mm)
            rng.shuffle(txt)
            return self._sorted_megabatches(mm, mega) + self._sorted_megabatches(txt, mega)
        idx = list(range(len(self.lengths)))
        rng.shuffle(idx)
        return self._sorted_megabatches(idx, mega)


def data_loader(dataset: SupervisedDataset, *, batch_size: int, seq_len: int,
                pad_token_id: int, shuffle: bool = True, seed: int = 0,
                group_by_modality_length: bool = False, drop_last: bool = True,
                num_workers: int = 0):
    """One epoch of collated numpy batches. ``num_workers`` > 0 preprocesses
    each batch's items on a thread pool (PIL and the C++ library release the
    GIL)."""
    if group_by_modality_length:
        order = LengthGroupedSampler(dataset.modality_lengths, batch_size,
                                     seed=seed).indices()
    else:
        order = list(range(len(dataset)))
        if shuffle:
            random.Random(seed).shuffle(order)
    pool = None
    if num_workers > 0:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(num_workers)
    try:
        for s in range(0, len(order), batch_size):
            chunk = order[s:s + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            items = (list(pool.map(dataset.__getitem__, chunk)) if pool is not None
                     else [dataset[i] for i in chunk])
            yield collate(items, pad_token_id=pad_token_id, seq_len=seq_len)
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def prefetch(iterator, depth: int = 2):
    """Generator view of ``Prefetcher`` (for callers that need no stall
    statistics); closing the generator closes the prefetcher."""
    pf = Prefetcher(iterator, depth=depth)
    try:
        yield from pf
    finally:
        pf.close()
