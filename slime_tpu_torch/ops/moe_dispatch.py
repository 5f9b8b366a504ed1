"""Dropless sparse MoE dispatch: sort the token -> expert assignments by
expert, run each expert's SwiGLU FFN on its contiguous run of rows, combine.

Port of ``slime_tpu/ops/moe_dispatch.py`` (``moe_ffn_sparse``). JAX computes
the grouped products with ``jax.lax.ragged_dot`` over static shapes; here
each expert's run is one product of its rows (cuBLAS on the card), so the
group sizes come to the host: one sync per call. Experts that receive no
row are skipped and contribute exactly zero. FLOPs: K * T rows of FFN,
against E * T for the dense masked path of ``models/llama.py:_moe``.

Rounding points, as JAX's: the products are in ``dt``, the promoted type of
``x`` and the weights (``ragged_dot`` promotes: fp32 weights under bf16
``x`` give fp32), with fp32 accumulation; h1 and h3 in ``dt``; silu on fp32
h1, cast to ``x.dtype``, times h3; y in ``dt``; the combine weights cast to
``dt``; each token's K weighted rows added in ``dt`` in sorted
(expert-ascending) order, the order of JAX's ``zeros.at[tok_of].add``. The
sum is formed by un-permuting the rows to [T, K, H] in that order, not by a
scatter-add, so it is the same on every run (``index_add_`` on the card
adds in atomic order).
"""
from __future__ import annotations

import torch

from ..models.layers import silu


def moe_ffn_sparse(x, w1, w2, w3, topi, topw):
    """Exact top-k MoE SwiGLU FFN over grouped rows.

    x [T, H] tokens; w1, w3 [E, I, H] expert gate / up projections, w2 [E, H,
    I] down; topi [T, K] expert ids, topw [T, K] combine weights -> [T, H]
    in the promoted type of ``x`` and the weights."""
    T, H = x.shape
    E = w1.shape[0]
    K = topi.shape[1]
    flat_e = topi.reshape(T * K).long()
    # stable: equal experts keep token order, as jnp.argsort(stable=True)
    order = torch.argsort(flat_e, stable=True)
    tok_of = order // K
    xs = x[tok_of]                                                  # [TK, H]
    sizes = torch.bincount(flat_e, minlength=E).tolist()            # the host sync
    dt = torch.promote_types(x.dtype, w1.dtype)
    ys, start = [], 0
    for e, n in enumerate(sizes):
        if n == 0:
            continue
        rows = xs[start:start + n].to(dt)
        h1 = torch.matmul(rows, w1[e].to(dt).T)
        h3 = torch.matmul(rows, w3[e].to(dt).T)
        a = silu(h1.to(torch.float32)).to(x.dtype) * h3
        ys.append(torch.matmul(a, w2[e].to(dt).T))
        start += n
    y = torch.cat(ys)                                               # [TK, H], sorted
    c = y * topw.reshape(T * K)[order].to(y.dtype)[:, None]
    # each token's K rows in sorted order: its flat slots' sorted positions,
    # ascending
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * K, device=order.device)
    pos = torch.sort(pos.reshape(T, K), dim=1).values
    c = c[pos]                                                      # [T, K, H]
    out = c[:, 0]
    for j in range(1, K):
        out = out + c[:, j]
    return out
