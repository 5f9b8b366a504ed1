"""Blockwise 8-bit AdamW: both Adam moments stored as int8 codes with one fp32
scale per 256-element block (~2.06 bytes a parameter against fp32 Adam's 8).

Port of ``slime_tpu/train/opt8.py`` (``_quantize``, ``_dequantize``, the
``scale_by_adam8bit`` leaf update, ``adamw8bit``'s chain, ``state_bytes``;
:33-132), with the same arithmetic in the same order so that the codes and
scales are byte for byte JAX's:

- ``m`` is stored as absmax-linear codes; ``v`` in the square-root domain
  (codes of sqrt(v), squared on dequantize). Scale = max|x| / 127 per block,
  1 where that is 0; codes round half to even and clip to +-127; the last
  block is zero-padded.
- The bias corrections are fp32 (``1 - b ** count`` with count cast to fp32)
  and every division is a true fp32 division by a tensor: on the card,
  dividing by a host scalar multiplies by its reciprocal, which moves codes
  at rounding boundaries.
- The update is ``(m / bc1) / (sqrt(v / bc2) + eps)``, cast to the
  gradient's dtype.

Each code depends only on its own block, so ``update_leaf`` runs the leaf
update over slices of whole blocks (``SLICE_BLOCKS``, 2^26 elements): a
[32, 14336, 4096] leaf never has a whole-leaf fp32 temporary, and the codes,
scales and updates are those of the whole-leaf ``leaf_update``.

``AdamW8bit`` is the optimizer over a list of parameter groups that
``train.optim.GroupedAdamW`` builds per label group (``optim="adamw8bit"``):
per leaf, optax's ``chain(scale_by_adam8bit, add_decayed_weights(mask),
scale_by_learning_rate)`` applied slice by slice to the parameter.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

BLOCK = 256
SLICE_BLOCKS = 2 ** 18          # 2^26 elements of a leaf at a time


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on ``like``'s device (a true division by it)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _quantize(x: torch.Tensor, *, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 tensor -> (int8 codes [nb, block], fp32 scales [nb, 1])."""
    n = x.numel()
    flat = x.reshape(-1).to(torch.float32)
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blk = flat.reshape(-1, block)
    scale = blk.abs().amax(dim=1, keepdim=True) / _const(127.0, blk)
    scale = torch.where(scale > 0, scale, _const(1.0, scale))
    q = torch.clamp(torch.round(blk / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(shape)


def bias_corrections(count: int, b1: float, b2: float, device) -> Tuple[torch.Tensor,
                                                                        torch.Tensor]:
    """(1 - b1 ** count, 1 - b2 ** count) in fp32, computed on the host as
    JAX computes them and placed on ``device`` as 0-d tensors."""
    c = torch.tensor(float(count), dtype=torch.float32)
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** c
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** c
    return bc1.to(device), bc2.to(device)


def leaf_update(g, mq, ms, vq, vs, *, bc1, bc2, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, block: int = BLOCK):
    """One leaf of ``scale_by_adam8bit``'s update (opt8.py:85-93), whole:
    -> (update in g's dtype, new m codes, m scales, v codes, v scales)."""
    g32 = g.to(torch.float32)
    m = b1 * _dequantize(mq, ms, g.shape) + (1.0 - b1) * g32
    v_sqrt = _dequantize(vq, vs, g.shape)
    v = b2 * (v_sqrt * v_sqrt) + (1.0 - b2) * (g32 * g32)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    mq2, ms2 = _quantize(m, block=block)
    vq2, vs2 = _quantize(torch.sqrt(v), block=block)
    return upd.to(g.dtype), mq2, ms2, vq2, vs2


def init_leaf(p: torch.Tensor, block: int = BLOCK) -> Dict[str, torch.Tensor]:
    """Zero moments for one leaf: codes [nb, block] int8, scales [nb, 1] fp32."""
    nb = -(-p.numel() // block)
    q = lambda: torch.zeros((nb, block), dtype=torch.int8, device=p.device)  # noqa: E731
    s = lambda: torch.zeros((nb, 1), dtype=torch.float32, device=p.device)   # noqa: E731
    return {"m_q": q(), "m_s": s(), "v_q": q(), "v_s": s()}


def update_leaf(g: torch.Tensor, st: Dict[str, torch.Tensor], *, bc1, bc2,
                b1: float, b2: float, eps: float, block: int = BLOCK,
                slice_blocks: int = SLICE_BLOCKS) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """``leaf_update`` over slices of whole blocks of the flattened leaf: the
    state ``st`` is written in place slice by slice, and each slice's update
    is yielded as (lo, hi, update of elements [lo, hi) in g's dtype)."""
    flat = g.reshape(-1)
    n = flat.numel()
    nb = st["m_q"].shape[0]
    for b0 in range(0, nb, slice_blocks):
        b1_ = min(b0 + slice_blocks, nb)
        lo, hi = b0 * block, min(b1_ * block, n)
        gs = flat[lo:hi]
        if hi - lo < (b1_ - b0) * block:
            gs = torch.nn.functional.pad(gs, (0, (b1_ - b0) * block - (hi - lo)))
        upd, mq, ms, vq, vs = leaf_update(
            gs, st["m_q"][b0:b1_], st["m_s"][b0:b1_], st["v_q"][b0:b1_],
            st["v_s"][b0:b1_], bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps, block=block)
        st["m_q"][b0:b1_] = mq
        st["m_s"][b0:b1_] = ms
        st["v_q"][b0:b1_] = vq
        st["v_s"][b0:b1_] = vs
        yield lo, hi, upd[:hi - lo]


class AdamW8bit:
    """optax's ``adamw8bit`` (opt8.py:114-124) over parameter groups
    ``[{"params": [...], "weight_decay": wd}, ...]`` with one shared count:
    each leaf's 8-bit Adam update, plus ``wd * p`` where the group decays,
    times ``-lr`` in the gradient's dtype, added to the parameter, one slice
    of blocks at a time. ``lr`` is set on the groups before each ``step``."""

    def __init__(self, param_groups: List[Dict], *, betas=(0.9, 0.999), eps: float = 1e-8):
        self.param_groups = [{"lr": 0.0, **g, "params": list(g["params"])}
                             for g in param_groups]
        self.b1, self.b2 = betas
        self.eps = eps
        self.count = 0
        self.state = [init_leaf(p) for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        leaves = [(g, p) for g in self.param_groups for p in g["params"]]
        if not leaves:
            return
        bc = {}
        for (group, p), st in zip(leaves, self.state):
            if p.device not in bc:
                bc[p.device] = bias_corrections(self.count, self.b1, self.b2, p.device)
            bc1, bc2 = bc[p.device]
            grad = p.grad if p.grad is not None else torch.zeros_like(p)
            wd = group.get("weight_decay", 0.0)
            step_size = torch.tensor(-group["lr"], dtype=grad.dtype, device=p.device)
            flat_p = p.view(-1)
            for lo, hi, u in update_leaf(grad, st, bc1=bc1, bc2=bc2, b1=self.b1,
                                         b2=self.b2, eps=self.eps):
                ps = flat_p[lo:hi]
                if wd:
                    u = u + wd * ps
                ps.copy_(ps + step_size * u)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for g in self.param_groups:
            for p in g["params"]:
                p.grad = None

    def state_dict(self) -> Dict:
        """The count and every leaf's codes and scales (the groups' lr is set
        before each step)."""
        return {"count": self.count, "state": [dict(st) for st in self.state]}

    def load_state_dict(self, sd: Dict) -> None:
        self.count = sd["count"]
        for st, saved in zip(self.state, sd["state"]):
            for k in st:
                st[k].copy_(saved[k])


def state_bytes(params) -> Dict:
    """Analytic state size of a parameter tree: fp32 Adam's against 8-bit
    Adam's (opt8.py:127-132)."""
    from ..params import named_leaves

    sizes = [t.numel() for _, t in named_leaves(params)]
    n = sum(sizes)
    nb = sum(-(-s // BLOCK) for s in sizes)
    return {"params": n, "fp32_adam_bytes": 8 * n, "int8_adam_bytes": 2 * n + 8 * nb,
            "ratio": (8 * n) / (2 * n + 8 * nb)}
