"""Automatic prefix KV cache: the RadixAttention role (host bookkeeping).

The port's own copy of ``slime_tpu/serve/prefix_cache.py`` (that module
imports nothing of JAX; the port imports nothing of the JAX package, so it
keeps this copy, and ``tests/test_torch_independence.py`` holds the two to
the same behaviour).

Prompts are cut into fixed ``block``-token blocks, chain-hashed (each digest
covers the whole prefix up to that block); after an admission prefill each
new block's KV slice is copied out and kept on the device under its digest,
and a later prompt sharing a prefix seeds its admission cache with the
matched blocks and prefills only the suffix. Reuse is exact by construction:
a stored block is the very KV a fresh prefill of those positions writes
(RoPE is absolute-position; prefixes start at position 0). Eviction is LRU
over a byte budget, cascading to descendants.

Multimodal prompts cache through identity streams: the cache hashes a
per-position ``uint64`` identity (the token id for text positions,
``image_slot_identities`` of a content hash of the preprocessed pixels for
image-feature slots, high bit set), so a digest match implies the same KV.
The engine (``serve/batch_engine.py``) owns the device copies.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_IMG_BIT = np.uint64(1 << 63)
_MIX = np.uint64(0x9E3779B97F4A7C15)  # odd => bijective slot mixing


def image_content_digest(pixel_values: np.ndarray,
                         crop_mask: np.ndarray) -> bytes:
    """Content address of one preprocessed image: pixels + crop layout.

    Covers dtype/shape so a uint8-transport crop stack never aliases a
    normalized float one.
    """
    h = hashlib.blake2b(digest_size=16)
    pv = np.ascontiguousarray(pixel_values)
    cm = np.ascontiguousarray(crop_mask)
    h.update(str((pv.dtype.str, pv.shape, cm.dtype.str, cm.shape)).encode())
    h.update(pv.tobytes())
    h.update(cm.tobytes())
    return h.digest()


def image_slot_identities(digest: bytes, n_slots: int) -> np.ndarray:
    """[n_slots] uint64 identities for an image's pre-compaction feature
    slots. Slot j's content is a pure function of (digest, params, cfg), so
    (digest, j) addresses it; the high bit keeps the values disjoint from
    token ids."""
    base = np.frombuffer(hashlib.blake2b(digest, digest_size=8).digest(),
                         "<u8")[0]
    j = np.arange(n_slots, dtype=np.uint64)
    return (base ^ (j * _MIX)) | _IMG_BIT


class PrefixCache:
    """Chain-hashed block store with LRU byte-budget eviction.

    Values are opaque to this class (the engine stores device KV arrays plus
    their byte size); the cache tracks digests, recency, and the parent/child
    chain needed for cascading eviction.
    """

    def __init__(self, block: int = 64, budget_bytes: int = 512 << 20):
        assert block >= 1
        self.block = block
        self.budget_bytes = int(budget_bytes)
        self.entries: Dict[bytes, dict] = {}   # digest -> entry
        self._children: Dict[bytes, set] = {}  # digest -> child digests
        self._clock = 0
        self.used_bytes = 0
        # stats
        self.hits = 0
        self.misses = 0
        self.matched_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0

    # -- hashing ---------------------------------------------------------
    def _digests(self, ids: np.ndarray, n_blocks: int) -> List[bytes]:
        """Chain digests for the first ``n_blocks`` full blocks of ``ids``.

        ``ids`` is an identity stream: plain (non-negative) token ids, or the
        fused-layout stream a multimodal admission builds with
        ``image_slot_identities``. Both widen to uint64 value-preservingly,
        so a text-only prompt and the pre-image text span of a multimodal one
        produce the same digests and share cache entries."""
        out, parent = [], b""
        ids = np.ascontiguousarray(np.asarray(ids).astype(np.uint64))
        for b in range(n_blocks):
            blk = ids[b * self.block:(b + 1) * self.block]
            d = hashlib.blake2b(parent + blk.tobytes(), digest_size=16).digest()
            out.append(d)
            parent = d
        return out

    # -- lookup ----------------------------------------------------------
    def match(self, ids: np.ndarray) -> Tuple[int, List[dict]]:
        """Longest cached full-block prefix of ``ids`` -> (P, entries).

        P is a multiple of ``block`` and is capped at len(ids)-1 so at least
        one token remains for the suffix prefill (the admission needs its
        next-token logits). Touches matched entries for LRU.
        """
        n = (len(ids) - 1) // self.block
        if n <= 0 or not self.entries:
            self.misses += 1
            return 0, []
        got: List[dict] = []
        for d in self._digests(ids, n):
            e = self.entries.get(d)
            if e is None:
                break
            got.append(e)
        if not got:
            self.misses += 1
            return 0, []
        self._clock += 1
        for e in got:
            e["tick"] = self._clock
        self.hits += 1
        self.matched_tokens += len(got) * self.block
        return len(got) * self.block, got

    def match_len(self, ids: np.ndarray) -> int:
        """Longest match WITHOUT touching LRU clocks or stats (planning)."""
        n = (len(ids) - 1) // self.block
        parent_hit = 0
        for d in self._digests(ids, n):
            if d not in self.entries:
                break
            parent_hit += 1
        return parent_hit * self.block

    # -- insertion -------------------------------------------------------
    def missing_blocks(self, ids: np.ndarray, length: int) -> List[Tuple[int, bytes, Optional[bytes]]]:
        """Blocks of ids[:length] not yet cached -> [(block_idx, digest,
        parent_digest)]. Only FULL blocks are cacheable; callers extract the
        KV slices and hand them to :meth:`put`."""
        n = length // self.block
        out = []
        digs = self._digests(ids, n)
        for b, d in enumerate(digs):
            if d not in self.entries:
                out.append((b, d, digs[b - 1] if b > 0 else None))
        return out

    def put(self, digest: bytes, parent: Optional[bytes], value: dict,
            nbytes: int) -> None:
        """Store one block (engine-opaque ``value``) under ``digest``."""
        if digest in self.entries:
            return
        if parent is not None and parent not in self.entries:
            return  # parent evicted mid-insert; an orphan is unmatchable
        self._clock += 1
        self.entries[digest] = {"value": value, "bytes": int(nbytes),
                                "parent": parent, "digest": digest,
                                "tick": self._clock}
        if parent is not None:
            self._children.setdefault(parent, set()).add(digest)
        self.used_bytes += int(nbytes)
        self.inserted_blocks += 1
        self._evict_to_budget()

    # -- eviction --------------------------------------------------------
    def _evict_subtree(self, digest: bytes) -> None:
        for child in list(self._children.get(digest, ())):
            self._evict_subtree(child)
        e = self.entries.pop(digest, None)
        if e is None:
            return
        self._children.pop(digest, None)
        if e["parent"] is not None and e["parent"] in self._children:
            self._children[e["parent"]].discard(digest)
        self.used_bytes -= e["bytes"]
        self.evicted_blocks += 1

    def _evict_to_budget(self) -> None:
        while self.used_bytes > self.budget_bytes and self.entries:
            # LRU among leaves only (evicting an inner node would orphan its
            # still-warm descendants)
            leaves = [e for d, e in self.entries.items()
                      if not self._children.get(d)]
            victim = min(leaves, key=lambda e: e["tick"])
            self._evict_subtree(victim["digest"])

    def stats(self) -> dict:
        return {"blocks": len(self.entries), "bytes": self.used_bytes,
                "hits": self.hits, "misses": self.misses,
                "matched_tokens": self.matched_tokens,
                "inserted_blocks": self.inserted_blocks,
                "evicted_blocks": self.evicted_blocks}
