"""Ring attention: exact (causal) attention over sequence-sharded q/k/v.

Port of ``slime_tpu/ops/ring_attention.py`` (:31-115), the collective ring
that ``llama.forward(ring=...)`` runs. Each rank keeps its query block, the
kv blocks travel around the ring, and each one is merged into fp32
online-softmax statistics (m, l, acc). The compute is plain torch on every
device, as the JAX package leaves it to XLA; ``ops/ring_attention_rdma.py``
(K9) is the kernel that computes the same function.

Arithmetic kept from JAX: q and k in fp32; masked scores are ``NEG_INF``
and a block's max is ``max(m, NEG_INF)``; p is rounded to v's dtype before
P.V, which sums in fp32; ``l == 0`` reads as 1 at the end. GQA stays native:
only the KVH-head kv blocks rotate.

``ring`` takes one of two forms (``ring_layout``):

- an int n: n virtual ranks in this process, on q's device. q [B, H, S, D]
  and k, v [B, KVH, S, D] are the global tensors, cut into n shards of S/n;
  rank r attends shard (r - s) mod n at step s, so the rotation is the shard
  index. This is the counterpart of JAX's ``Mesh`` over virtual devices;
- a ``torch.distributed`` ProcessGroup of n processes: q, k, v are this
  rank's shard [B, H|KVH, S/n, D] (query positions from rank * S/n on), and
  the kv block moves to rank + 1 with ``batch_isend_irecv``, the next block
  posted before this block's compute. The result is this rank's shard.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

NEG_INF = -1e30


def ring_layout(ring, q, k) -> Tuple[int, List[int], Optional[object]]:
    """(n, the ranks this process holds, the process group or None) of
    ``ring``: an int of virtual ranks, or a ``torch.distributed``
    ProcessGroup. Checks that q and k fit it."""
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"ring attention: KVH={k.shape[1]} does not divide H={q.shape[1]}")
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"ring attention: q holds {q.shape[2]} positions, k {k.shape[2]}")
    if isinstance(ring, int) and not isinstance(ring, bool):
        if ring < 1 or q.shape[2] % ring:
            raise ValueError(f"ring attention: {ring} virtual ranks do not divide "
                             f"S = {q.shape[2]}")
        return ring, list(range(ring)), None
    if isinstance(ring, dist.ProcessGroup):
        return dist.get_world_size(ring), [dist.get_rank(ring)], ring
    raise TypeError(f"ring must be an int of virtual ranks or a ProcessGroup, got {ring!r}")


def ring_peers(group, n: int) -> Tuple[int, int]:
    """Global ranks of this rank's right (rank + 1) and left neighbours."""
    rank = dist.get_rank(group)
    return (dist.get_global_rank(group, (rank + 1) % n),
            dist.get_global_rank(group, (rank - 1) % n))


def _block_attend(q, k, v, scale, *, q_start, k_start, causal):
    """Partial attention of q [B, KVH, G, Sq, D] fp32 against one kv block
    (k fp32, v in its dtype, [B, KVH, Sk, D]) -> (m, l [B, KVH, G, Sq, 1],
    acc [B, KVH, G, Sq, D]), the unnormalised softmax statistics."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k) * scale
    if causal:
        qi = q_start + torch.arange(q.shape[3], device=q.device)[:, None]
        kj = k_start + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(qi >= kj, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)   # all-masked rows stay finite
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return m, l, acc


def _merge(m1, l1, a1, m2, l2, a2):
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, l1 * c1 + l2 * c2, a1 * c1 + a2 * c2


def _rotated_blocks(k, v, group, n) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """The kv blocks a process-group rank attends at steps 0 .. n-1: its own,
    then each received from its left neighbour. The exchange for step s + 1
    is posted before step s's block is handed out for compute."""
    right, left = ring_peers(group, n)
    cur = torch.stack([k, v]).contiguous()
    for step in range(n):
        reqs, nxt = [], None
        if step < n - 1:
            nxt = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, cur, right, group),
                                           dist.P2POp(dist.irecv, nxt, left, group)])
        yield cur[0], cur[1]
        for req in reqs:
            req.wait()
        cur = nxt


def _local(q_blk, blocks, *, rank, n, KVH, scale, causal):
    """One rank's ring (JAX's ``local_fn``): q_blk [B, H, Sq, D] against the
    kv blocks of steps 0 .. n-1 (``blocks``) -> [B, H, Sq, D] in q's dtype."""
    B, H, Sq, D = q_blk.shape
    qf = q_blk.reshape(B, KVH, H // KVH, Sq, D).to(torch.float32)
    m = torch.full((B, KVH, H // KVH, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=q_blk.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=q_blk.device)
    for step, (k_cur, v_cur) in enumerate(blocks):
        src = (rank - step) % n               # the rank whose block this is
        bm, bl, bacc = _block_attend(qf, k_cur.to(torch.float32), v_cur, scale,
                                     q_start=rank * Sq, k_start=src * k_cur.shape[2],
                                     causal=causal)
        m, l, acc = _merge(m, l, acc, bm, bl, bacc)
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q_blk.dtype).reshape(B, H, Sq, D)


def ring_attention(q, k, v, *, ring, causal: bool = True, scale: Optional[float] = None):
    """q [B, H, S, D], k/v [B, KVH, S, D] (KVH divides H; KVH == H for MHA),
    sequence-sharded over ``ring`` (n virtual ranks, or a ProcessGroup with
    this rank's shards) -> attention output with q's layout and dtype.
    Exact: it matches full attention."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n, ranks, group = ring_layout(ring, q, k)
    KVH = k.shape[1]
    kw = dict(n=n, KVH=KVH, scale=scale, causal=causal)
    if group is not None:
        return _local(q, _rotated_blocks(k, v, group, n), rank=ranks[0], **kw)
    qs, ks, vs = (t.chunk(n, dim=2) for t in (q, k, v))
    outs = [_local(qs[r], ((ks[(r - s) % n], vs[(r - s) % n]) for s in range(n)),
                   rank=r, **kw)
            for r in ranks]
    return torch.cat(outs, dim=2)
