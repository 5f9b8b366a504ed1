"""Expert-parallel MoE dispatch: GShard-style capacity routing over a mesh axis.

Port of ``slime_tpu/ops/moe_ep.py``. The experts are split over the ranks of
one mesh axis: each rank stores and computes E/n of them and the tokens
travel to their experts and back in two ``all_to_all_single``s (NCCL on the
cards, gloo on the CPU). As in JAX it is wired into no model: the model's MoE
layers take the dropless ``ops.moe_dispatch`` path (experts split over
``model`` by their neurons).

A per-rank capacity C = max(8, ceil(Tl * K / E * capacity_factor)), with Tl
this rank's token count, gives static buffers. Each (token, slot) pick takes
the next free position of its expert in (token, slot) order (a cumsum,
``_dispatch_indices``); a pick past C is dropped, its combine weight 0. With
a generous factor nothing is dropped and the result is the dense oracle's.

Per rank, n ranks, El = E/n local experts:
tokens [Tl, H] -> dispatch [E, C, H] (this rank's tokens in every expert's
slots) -> all_to_all -> [El, n*C, H] (this rank's experts, every rank's
tokens) -> SwiGLU FFN -> all_to_all back -> [E, C, H] -> combine.

The expert products are einsums with fp32 results, as JAX's
``preferred_element_type=float32``; silu (``models.layers.silu``) of the fp32
h1 times h3, cast to the tokens' dtype, into the second product, whose fp32
result is cast back. The all-to-alls carry their gradient (the backward is
the reverse exchange).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..models.layers import silu


def _dispatch_indices(topi, E: int, C: int):
    """Position of each (token, slot) pick inside its expert's capacity
    buffer: topi [T, K] -> (pos [T, K] int64, >= C when dropped; keep [T, K]
    bool), priority in (token, slot) order."""
    T, K = topi.shape
    flat = topi.reshape(-1).long()                                   # [T*K]
    onehot = torch.nn.functional.one_hot(flat, E)                    # [T*K, E]
    pos_flat = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos_flat, 1, flat[:, None])[:, 0].reshape(T, K)
    return pos, pos < C


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()           # empty_like of a strided gradient keeps its strides
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 in equal blocks; the backward sends
    each block's gradient back to the rank it came from (the same exchange)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def moe_ffn_ep(x, w1, w2, w3, topi, topw, *, mesh, axis: str = "model",
               capacity_factor: float = 2.0):
    """Expert-parallel top-k MoE SwiGLU FFN on this rank's blocks.

    x [Tl, H] this rank's tokens; w1 / w3 [El, I, H] and w2 [El, H, I] this
    rank's experts (rank j holds experts j*El .. (j+1)*El - 1 of E = n*El);
    topi / topw [Tl, K] its tokens' global expert ids and combine weights.
    Returns [Tl, H] in x's dtype. Every rank of ``mesh``'s ``axis`` group
    calls it. Over-capacity picks are dropped (weight 0)."""
    group = mesh.group(axis)
    n = mesh.shape[axis] if group is not None else 1
    El = w1.shape[0]
    E = El * n
    Tl, H = x.shape
    K = topi.shape[1]
    C = max(8, int(math.ceil(Tl * K / E * capacity_factor)))

    pos, keep = _dispatch_indices(topi, E, C)
    e_idx = topi.reshape(-1).long()
    p_idx = torch.where(keep.reshape(-1), pos.reshape(-1), C)         # C: dropped
    # scatter this rank's tokens into every expert's capacity buffer (an
    # extra slot C takes the dropped picks and is cut off)
    buf = torch.zeros((E, C + 1, H), dtype=x.dtype, device=x.device)
    buf = buf.index_put((e_idx, p_idx), x.repeat_interleave(K, dim=0))[:, :C]

    # rank j's block i (its tokens for rank i's experts) goes to rank i:
    # [n, El, C, H] -> [n (source), El, C, H] -> [El, n * C, H]
    recv = buf.reshape(n, El, C, H)
    if group is not None:
        recv = _AllToAll.apply(recv, group)
    recv = recv.transpose(0, 1).reshape(El, n * C, H)

    h1 = torch.einsum("ech,eih->eci", recv.to(torch.float32), w1.to(torch.float32))
    h3 = torch.einsum("ech,eih->eci", recv.to(torch.float32), w3.to(torch.float32))
    a = (silu(h1) * h3).to(x.dtype)
    y = torch.einsum("eci,ehi->ech", a.to(torch.float32),
                     w2.to(torch.float32)).to(x.dtype)

    # back: [El, n, C, H] -> [n (destination), El, C, H] -> exchange ->
    # [n (expert group), El, C, H] = [E, C, H] in global expert order
    back = y.reshape(El, n, C, H).transpose(0, 1).contiguous()
    if group is not None:
        back = _AllToAll.apply(back, group)
    back = back.reshape(E, C, H)
    back = torch.cat([back, torch.zeros((E, 1, H), dtype=back.dtype, device=back.device)], 1)

    got = back[e_idx, p_idx]                                          # [Tl*K, H]
    w = torch.where(keep.reshape(-1), topw.reshape(-1), torch.zeros_like(topw.reshape(-1)))
    return (got * w[:, None].to(got.dtype)).reshape(Tl, K, H).sum(dim=1)
