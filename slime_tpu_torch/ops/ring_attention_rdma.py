"""K9: ring attention with a double-buffered kv rotation and per-slot credits.

Port of ``slime_tpu/ops/ring_attention_rdma.py``: ``ring_attention_rdma``
(:148), whose ``pallas_call`` (:168) runs ``_ring_kernel`` (:79) over
``_attend_block`` (:43). It computes what ``ops.ring_attention`` computes
(exact attention over sequence-sharded q/k/v, GQA-native) and is its drop-in:
same signature, same two forms of ``ring`` (n virtual ranks, or a
``torch.distributed`` ProcessGroup; see ``ring_attention.ring_layout``).

The TPU kernel moves kv between chips from inside the kernel
(``make_async_remote_copy``). A CUDA kernel has no such remote copy, so on
the card that transport sits outside the kernel and the kernel
``slime_ring_attend`` (``csrc/ring_attention.cu``) attends one kv slot and
merges it into the fp32 state, once per ring step. The protocol
(``_ring``), shared by the kernel and its plain version: kv lives in a double
buffer with slots ``cur = s % 2`` and ``tgt = 1 - cur``; for each step
s < n - 1

- the transfer of slot ``cur`` into the right neighbour's slot ``tgt`` starts
  on a side stream; from s >= 1 it first waits on the event recorded after
  step s - 1's attend, which read ``tgt`` (the TPU kernel's credit token,
  :100-134, becomes that event);
- the attend of slot ``cur`` runs on the compute stream;
- step s + 1 waits on the transfer's event.

With virtual ranks one device copy moves all n blocks at once (rank r's
``tgt`` takes rank r - 1's ``cur``); with a process group NCCL (on the card)
or gloo (on the CPU, in the tests) point-to-point does the move, through the
same code. On the CPU there are no streams: the transfer runs behind the
compute and is waited on before the next step.

The plain version ``ring_attention_rdma_ref`` keeps the TPU kernel's
arithmetic (``_attend_block``): q, k, v and p all fp32, m = max(max(s),
NEG_INF), the merge c0 = exp(m0 - m), c1 = exp(bm - m), and at the end acc /
l with ``l == 0 -> 1`` cast to q's dtype (:142-145). It is what CPU tensors
run and the card's oracle for the kernel.

The kernel takes every input JAX's does (the TPU kernel casts q, k and v to
fp32 inside, :55-57, and takes any D and any S/n): bf16 at D = 128 and 256
runs the ``wgmma`` design K5's forward shares (p carried as two bf16 halves
through P.V); fp32 at any D, and bf16 at every other D, runs an FFMA kernel
with the TPU kernel's fp32 arithmetic. Any S/n: a row tile stops at its
rank's shard and keys past it are masked. Inputs of another floating dtype,
or of mixed dtypes, are cast to fp32 (the values JAX's kernel computes on)
and the output is cast back to q's dtype, as JAX's is. B * KVH is folded
into the grid's first dimension, so it has no limit of its own. A q that TMA
cannot read (``_cuda.tma_ready``) is copied into a fresh contiguous tensor
first, and the kernel runs on the copy. Only inputs that do not fit
q [B, H, S, D] / k, v [B, KVH, S, D] raise.

Launch counts: ``ring_attention_rdma.launches``, one per kernel launch: n per
call with n virtual ranks, n per rank with a process group;
``.f32_launches`` those of the fp32 FFMA kernel, ``.ffma_launches`` those of
the bf16 FFMA kernel (D other than 128 and 256).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.distributed as dist

from . import _cuda
from .flash_attention import _bhs, _bshd_like
from .ring_attention import NEG_INF, ring_layout, ring_peers

WGMMA_HEAD_DIMS = (128, 256)     # bf16 head dims of the wgmma kernel; others take FFMA


def _attend_ref(q, slot, step, ranks, n, state, *, scale, causal):
    """The TPU kernel's ``_attend_block`` for each local rank: merge kv
    ``slot`` [R, 2, B, KVH, Sk, D] (rank j's block came from rank
    (ranks[j] - step) mod n) into ``state`` = (m, l [R, B, H, Sq],
    acc [B, H, R * Sq, D]) in place, all in fp32."""
    m, l, acc = state
    B, H, _, D = q.shape
    KVH, Sk = slot.shape[3], slot.shape[4]
    Sq = m.shape[-1]
    G = H // KVH
    for j, rank in enumerate(ranks):
        rows = slice(j * Sq, (j + 1) * Sq)
        qf = q[:, :, rows].reshape(B, KVH, G * Sq, D).to(torch.float32)
        kf = slot[j, 0].to(torch.float32)
        vf = slot[j, 1].to(torch.float32)
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        if causal:
            src = (rank - step) % n
            qi = rank * Sq + torch.arange(G * Sq, device=q.device)[:, None] % Sq
            kj = src * Sk + torch.arange(Sk, device=q.device)[None, :]
            s = torch.where(qi >= kj, s, NEG_INF)
        bm = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
        p = torch.exp(s - bm)
        bl = p.sum(dim=-1, keepdim=True)
        bacc = torch.matmul(p, vf)
        m0 = m[j].reshape(B, KVH, G * Sq, 1)
        l0 = l[j].reshape(B, KVH, G * Sq, 1)
        a0 = acc[:, :, rows].reshape(B, KVH, G * Sq, D)
        mm = torch.maximum(m0, bm)
        c0 = torch.exp(m0 - mm)
        c1 = torch.exp(bm - mm)
        m[j] = mm.reshape(B, H, Sq)
        l[j] = (l0 * c0 + bl * c1).reshape(B, H, Sq)
        acc[:, :, rows] = (a0 * c0 + bacc * c1).reshape(B, H, Sq, D)


def _attend_kernel(q, slot, src, ranks, state, out, *, scale, causal, step, last):
    """One launch of ``slime_ring_attend``: every local rank's block of
    ``slot`` (rank ranks[j]'s came from rank src[j], an int32 device
    vector) merged into ``state`` = (m, l [2, R, B, H, Sq], acc); step s
    reads m, l slot (s - 1) % 2 and writes slot s % 2. On the ``last`` step
    it writes ``acc / l`` to ``out`` in q's dtype instead."""
    m, l, acc = state
    B, H, _, D = q.shape
    rd, wr = (step - 1) % 2, step % 2
    f32 = int(q.dtype == torch.float32)
    _cuda.check(_cuda.library().slime_ring_attend(
        q.data_ptr(), slot.data_ptr(), src.data_ptr(), m[rd].data_ptr(), l[rd].data_ptr(),
        m[wr].data_ptr(), l[wr].data_ptr(), acc.data_ptr(), out.data_ptr(),
        _cuda.longs(_bhs(q) + _bhs(out)), len(ranks), B, H, slot.shape[3], m.shape[-1], D,
        f32, ranks[0], int(causal), int(step == 0), int(last), scale, _cuda.stream()),
        "ring_attend")
    ring_attention_rdma.launches += 1
    ring_attention_rdma.f32_launches += f32
    ring_attention_rdma.ffma_launches += int(not f32 and D not in WGMMA_HEAD_DIMS)


def _start_transfer(src, dst, group, n, left, side, credit):
    """Start moving slot ``src`` [R, ...] into the right neighbour's ``dst``
    (virtual ranks: rank r's ``dst`` takes rank ``left[r]``'s ``src``):
    (requests to wait on the CPU, event to wait on the card)."""
    ctx = torch.cuda.stream(side) if side is not None else contextlib.nullcontext()
    with ctx:
        if credit is not None:
            side.wait_event(credit)     # the last attend that read dst is done
        reqs = []
        if group is None:
            torch.index_select(src, 0, left, out=dst)
        else:
            to_rank, from_rank = ring_peers(group, n)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, to_rank, group),
                                           dist.P2POp(dist.irecv, dst, from_rank, group)])
        if side is None:
            return reqs, None
        for req in reqs:
            req.wait()                  # NCCL: the side stream waits, not the host
        return [], side.record_event()


def _ring(q, k, v, ring, causal, scale, kernel):
    """The double-buffered ring with ``kernel`` (the CUDA kernel) or the
    plain ``_attend_ref`` as each step's attend."""
    n, ranks, group = ring_layout(ring, q, k)
    B, H, S_here, D = q.shape
    KVH, R = k.shape[1], len(ranks)
    Sq = S_here // R
    dev = q.device
    buf = torch.empty((2, R, 2, B, KVH, Sq, D), dtype=k.dtype, device=dev)
    buf[0, :, 0] = k.reshape(B, KVH, R, Sq, D).permute(2, 0, 1, 3, 4)
    buf[0, :, 1] = v.reshape(B, KVH, R, Sq, D).permute(2, 0, 1, 3, 4)
    if kernel:       # step 0 writes every state element before any is read
        state = (torch.empty((2, R, B, H, Sq), dtype=torch.float32, device=dev),
                 torch.empty((2, R, B, H, Sq), dtype=torch.float32, device=dev),
                 torch.empty((B, H, S_here, D), dtype=torch.float32, device=dev))
    else:
        state = (torch.full((R, B, H, Sq), NEG_INF, dtype=torch.float32, device=dev),
                 torch.zeros((R, B, H, Sq), dtype=torch.float32, device=dev),
                 torch.zeros((B, H, S_here, D), dtype=torch.float32, device=dev))
    out = _bshd_like(q) if kernel else None
    # at step s rank ranks[j] holds rank srcs[s, j]'s block (the kernel's
    # input); a virtual rank receives from its left neighbour
    local = torch.arange(R, device=dev)
    srcs = (((ranks[0] + local)[None] - torch.arange(n, device=dev)[:, None]) % n).to(
        torch.int32)
    left = (local - 1) % R
    side = None
    if q.is_cuda:
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))     # buf[0] and left are written
    read_done = None
    for step in range(n):
        cur, tgt = step % 2, 1 - step % 2
        moving = None
        if step < n - 1:
            moving = _start_transfer(buf[cur], buf[tgt], group, n, left, side, read_done)
        if kernel:
            _attend_kernel(q, buf[cur], srcs[step], ranks, state, out, scale=scale,
                           causal=causal, step=step, last=step == n - 1)
        else:
            _attend_ref(q, buf[cur], step, ranks, n, state, scale=scale, causal=causal)
        if side is not None:
            read_done = torch.cuda.current_stream(dev).record_event()
        if moving is not None:
            reqs, event = moving
            for req in reqs:
                req.wait()
            if event is not None:
                torch.cuda.current_stream(dev).wait_event(event)
    if kernel:
        return out
    m, l, acc = state
    l = l.permute(1, 2, 0, 3).reshape(B, H, S_here, 1)
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def ring_attention_rdma_ref(q, k, v, *, ring, causal: bool = True,
                            scale: Optional[float] = None):
    """Plain version of K9: the protocol of ``_ring`` with the TPU kernel's
    fp32 ``_attend_block`` as each step's attend (any device)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _ring(q, k, v, ring, causal, scale, kernel=False)


def _check_kernel_inputs(q, k, v, ring):
    """Raise unless q [B, H, S, D] and k, v [B, KVH, S, D] (KVH dividing H)
    lie on the current card; the shard shapes follow from ``ring``."""
    _cuda.require_cuda(q, k, v)
    ring_layout(ring, q, k)
    B, H, _, D = q.shape
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != B
            or k.shape[2] != q.shape[2] or k.shape[3] != D or H % k.shape[1]):
        raise ValueError(f"ring_attention_rdma: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit [B,H,S,D] / [B,KVH,S,D]")


def kernel_operands(q, k, v):
    """q, k, v as the kernel reads them: one dtype, bf16 or fp32 (any other
    floating dtype, or a mix, cast to fp32: the TPU kernel computes in fp32),
    q with unit stride over D (the FFMA kernel's plain loads take any
    alignment) and, for the wgmma kernel, 16-byte aligned data and strides
    (``_cuda.tma_operand``: else a fresh contiguous copy).
    A pure function of the tensors, so CPU tests can check it."""
    dtype = (torch.bfloat16 if q.dtype == k.dtype == v.dtype == torch.bfloat16
             else torch.float32)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    if dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS:
        q = _cuda.tma_operand(q)
    elif q.stride(-1) != 1:
        q = q.contiguous()
    return q, k, v


def ring_attention_rdma(q, k, v, *, ring, causal: bool = True, scale: Optional[float] = None):
    """Drop-in for ``ring_attention.ring_attention``: q [B, H, S, D], k/v
    [B, KVH, S, D] sequence-sharded over ``ring``. CUDA tensors run the K9
    kernel (bf16 at D = 128 or 256: ``wgmma``; fp32, or bf16 at another D:
    FFMA; another dtype is computed in fp32 and cast back, as JAX does);
    CPU tensors run the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ring_attention_rdma_ref(q, k, v, ring=ring, causal=causal, scale=scale)
    _check_kernel_inputs(q, k, v, ring)
    kq, kk, kv = kernel_operands(q, k, v)
    return _ring(kq, kk, kv, ring, causal, scale, kernel=True).to(q.dtype)


ring_attention_rdma.launches = 0
ring_attention_rdma.f32_launches = ring_attention_rdma.ffma_launches = 0
