"""Vision projector: linear / mlpNx_gelu / gated (2-expert MoE).

Port of ``slime_tpu/models/projector.py``. The ``gated`` type is SliME's
2-expert MoE: an MLP projection expert and a Resampler attention-adapter
expert mixed by a softmax gate over per-token features; with k == 2 == number
of experts the top-k gate is a dense softmax mixture (``projector.py:110-146``).
In training the gate logits get Gaussian noise (``gate_weights``, :82-99),
drawn from an explicit ``torch.Generator`` or passed in as ``noise``. The
``qformer`` and ``qformer_text`` types are not ported yet.
"""
from __future__ import annotations

import re
from typing import Dict

import torch
import torch.nn.functional as F

from ..config import SliMEConfig
from . import layers as L
from . import resampler


def gelu(x):
    """Exact erf GELU (torch nn.GELU default, jax.nn.gelu(approximate=False))."""
    return F.gelu(x, approximate="none")


def _mlp_init(in_dim, out_dim, depth, **kw) -> Dict:
    layers = [L.linear_init(in_dim, out_dim, **kw)]
    for _ in range(1, depth):
        layers.append(L.linear_init(out_dim, out_dim, **kw))
    return {"layers": layers}


def _mlp_apply(p, x):
    x = L.linear(p["layers"][0], x)
    for lp in p["layers"][1:]:
        x = L.linear(lp, gelu(x))
    return x


def init(cfg: SliMEConfig, *, generator, device=None,
         dtype=torch.float32) -> Dict:
    """Random parameters with the JAX ``projector.init`` key set and shapes,
    on ``device`` (the current CUDA device when None)."""
    device = L.resolve_device(device)
    kw = dict(generator=generator, device=device, dtype=dtype)
    ptype = cfg.mm_projector_type
    if ptype == "linear":
        return {"proj": L.linear_init(cfg.mm_hidden_size, cfg.hidden_size, **kw)}
    m = re.match(r"^mlp(\d+)x_gelu$", ptype)
    if m:
        return {"mlp": _mlp_init(cfg.mm_hidden_size, cfg.hidden_size,
                                 int(m.group(1)), **kw)}
    if ptype == "gated":
        zeros = lambda: torch.zeros((cfg.mm_hidden_size, 2),   # noqa: E731
                                    device=device, dtype=dtype)
        return {
            "projection": _mlp_init(cfg.mm_hidden_size, cfg.hidden_size, 2, **kw),
            "attn": resampler.init(grid_size=24, embed_dim=cfg.mm_hidden_size,
                                   kv_dim=cfg.mm_hidden_size,
                                   llm_hidden_size=cfg.hidden_size, **kw),
            "w_gate": zeros(),
            "w_noise": zeros(),
        }
    raise NotImplementedError(f"projector type {ptype!r} is not ported yet")


def gate_weights(params, x, *, training: bool = False, generator=None,
                 noise=None, noise_epsilon: float = 1e-2):
    """Per-token expert mixture weights [..., 2]: softmax(x @ w_gate),
    renormalized with the reference's +1e-6. In training (with a
    ``generator``, or ``noise`` of the logits' shape) the logits first get
    N(0, 1) noise times softplus(logits) + 1e-2 (the reference derives the
    stddev from w_gate, not w_noise)."""
    logits = torch.matmul(x.to(torch.float32), params["w_gate"].to(torch.float32))
    if training and (noise is not None or generator is not None):
        if noise is None:
            noise = torch.randn(logits.shape, generator=generator,
                                device=logits.device)
        stddev = F.softplus(logits) + noise_epsilon
        logits = logits + noise.to(torch.float32) * stddev
    g = torch.softmax(logits, dim=-1)
    g = g / (g.sum(dim=-1, keepdim=True) + 1e-6)
    return g.to(x.dtype)


def apply(params, x, *, cfg: SliMEConfig, training: bool = False,
          generator=None, noise=None) -> torch.Tensor:
    """x [N, L, mm_hidden] -> [N, L_out, llm_hidden]. For the gated type a
    sequence of other than 576 tokens takes the MLP expert alone;
    ``training``, ``generator`` and ``noise`` reach ``gate_weights``."""
    t = cfg.mm_projector_type
    if t == "linear":
        return L.linear(params["proj"], x)
    if t.startswith("mlp"):
        return _mlp_apply(params["mlp"], x)
    if t != "gated":
        raise NotImplementedError(f"projector type {t!r} is not ported yet")
    if x.shape[1] != 576 or cfg.mm_learnable_gated == 0:
        return _mlp_apply(params["projection"], x)
    att = resampler.apply(params["attn"], x, num_heads=cfg.mm_num_heads)
    expert1 = _mlp_apply(params["projection"], att)
    if cfg.mm_learnable_gated == 1:
        return expert1
    expert0 = _mlp_apply(params["projection"], x)
    g = gate_weights(params, x, training=training, generator=generator,
                     noise=noise)
    return expert0 * g[..., 0:1] + expert1 * g[..., 1:2]
