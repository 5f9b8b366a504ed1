"""Decoder-only LLM (Llama-3 family) in PyTorch: prefill and KV-cache decode.

Port of ``slime_tpu/models/llama.py`` for dense (non-MoE) models:

- ``forward`` is the full-sequence forward of prefill and training over list
  or stacked ``[L, ...]`` layers (``llama.py:233-323``), with ``positions``,
  ``return_kv``, ``logit_positions``, ``return_hidden``, ``segment_ids``
  (sequence packing) and ``remat`` (each layer a ``torch.utils.checkpoint``
  region, JAX's ``jax.checkpoint`` around each block). Its attention is
  ``ops.flash_attention`` (JAX ``_attn_prefill`` :176-179): the K5 kernels
  under JAX's rule or ``use_kernel=True``, the plain version otherwise; with
  ``ring`` (context parallelism, :166-174) it is the collective
  ``ops.ring_attention`` over n virtual ranks or a process group.
- ``decode_step`` takes JAX's ``fused`` choice (``llama.py:769-888``). The
  fused path (``_decode_step_fused``, :670-766) runs per layer
  ``fused_qkv_decode`` -> RoPE -> the KV write -> masked attention over the
  cache in plain torch (plain XLA in JAX) -> ``fused_o_residual`` ->
  ``fused_mlp_decode``; on the card those three are the CUDA kernels of
  ``ops/`` (dense, int8 and q4g). The non-fused path (``layer_decode``) runs
  the same layer through ``layers.linear``: per-row q4 (K6), NF4, mixed
  formats and biases.

Logits are fp32. The int8 ``lm_head`` dequantizes the whole matrix to fp32 on
every call, as the JAX code does; on the card that is a 2.1 GB temporary at
the 128k vocabulary (see PERF.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..config import LLMConfig
from ..ops.flash_attention import flash_attention
from ..ops.fused_mlp import auto_block_ok, fused_mlp_decode, silu
from ..ops.fused_qkvo import fused_o_residual, fused_qkv_decode
from ..ops.quantization import dequantize_weight
from ..ops.ring_attention import ring_attention
from . import layers as L

_MOE_TODO = "MoE layers are not ported yet (ROADMAP Queue 1 step 11)"


def init_layer(cfg: LLMConfig, *, generator, device=None, dtype=torch.float32) -> Dict:
    """One decoder layer's random parameters (``init``'s per-layer dict)."""
    if cfg.num_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    H, HD = cfg.hidden_size, cfg.head_dim
    device = L.resolve_device(device)
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "input_layernorm": L.rms_norm_init(H, device=device, dtype=dtype),
        "q_proj": L.linear_init(H, cfg.num_heads * HD, bias=cfg.attention_bias, **kw),
        "k_proj": L.linear_init(H, cfg.num_kv_heads * HD, bias=cfg.attention_bias, **kw),
        "v_proj": L.linear_init(H, cfg.num_kv_heads * HD, bias=cfg.attention_bias, **kw),
        "o_proj": L.linear_init(cfg.num_heads * HD, H, bias=False, **kw),
        "post_attention_layernorm": L.rms_norm_init(H, device=device, dtype=dtype),
        "gate_proj": L.linear_init(H, cfg.intermediate_size, bias=False, **kw),
        "up_proj": L.linear_init(H, cfg.intermediate_size, bias=False, **kw),
        "down_proj": L.linear_init(cfg.intermediate_size, H, bias=False, **kw),
    }


def init(cfg: LLMConfig, *, generator, device=None, dtype=torch.float32) -> Dict:
    """Random parameters with the JAX ``llama.init`` key set and shapes
    (list-of-layers layout), on ``device`` (the current CUDA device when
    None)."""
    if cfg.num_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    H = cfg.hidden_size
    device = L.resolve_device(device)

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)

    params: Dict = {"embed_tokens": normal(cfg.vocab_size, H),
                    "norm": L.rms_norm_init(H, device=device, dtype=dtype),
                    "layers": [init_layer(cfg, generator=generator, device=device, dtype=dtype)
                               for _ in range(cfg.num_layers)]}
    params["lm_head"] = {"weight": normal(cfg.vocab_size, H)}
    return params


def stack_layers(layers):
    """List of layer dicts -> one dict with a leading [num_layers] dim."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lp[k] for lp in layers]) for k in first}
    return torch.stack(layers)


def _layer(layers, i):
    """Layer i of a list or of a stacked dict (views, no copy)."""
    if isinstance(layers, list):
        return layers[i]

    def pick(node):
        return {k: pick(v) for k, v in node.items()} if isinstance(node, dict) else node[i]
    return pick(layers)


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------

_ROPE_CACHE: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def rope_table(cfg: LLMConfig, max_len: int, device=None):
    """(cos, sin) [max_len, head_dim] fp32, HF half-rotation layout, built in
    fp32 as ``llama.py:78-85``; cached per (theta, head_dim, length, device).
    ``device`` defaults to the current CUDA device (``layers.resolve_device``)."""
    device = L.resolve_device(device)
    key = (cfg.rope_theta, cfg.head_dim, max_len, str(device))
    if key not in _ROPE_CACHE:
        hd = cfg.head_dim
        exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
        inv_freq = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                                device=device), exps)
        t = torch.arange(max_len, dtype=torch.float32, device=device)
        freqs = torch.outer(t, inv_freq)
        emb = torch.cat([freqs, freqs], dim=-1)
        _ROPE_CACHE[key] = (torch.cos(emb), torch.sin(emb))
    return _ROPE_CACHE[key]


def apply_rope(x, cos, sin):
    """x [B, S, H, hd]; cos/sin [B, S, hd] or [S, hd]."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(torch.float32)
    sin = sin[:, :, None, :].to(torch.float32)
    xf = x.to(torch.float32)
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


# ----------------------------------------------------------------------------
# Prefill
# ----------------------------------------------------------------------------

def _mlp(lp, x):
    g = L.linear(lp["gate_proj"], x)
    u = L.linear(lp["up_proj"], x)
    return L.linear(lp["down_proj"], silu(g) * u)


def _layer_prefill(lp, x, cos, sin, cfg: LLMConfig, use_kernel=None,
                   segment_ids=None, ring=None):
    B, S, _ = x.shape
    hd = cfg.head_dim
    h = L.rms_norm(lp["input_layernorm"], x, eps=cfg.rms_norm_eps)
    q = L.linear(lp["q_proj"], h).reshape(B, S, cfg.num_heads, hd)
    k = L.linear(lp["k_proj"], h).reshape(B, S, cfg.num_kv_heads, hd)
    v = L.linear(lp["v_proj"], h).reshape(B, S, cfg.num_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if ring is not None:
        # context parallelism: exact ring attention, GQA-native (only the
        # KVH-head kv blocks rotate)
        out = ring_attention(qh, kh, vh, ring=ring, causal=True)
    else:
        out = flash_attention(qh, kh, vh, causal=True, use_kernel=use_kernel,
                              segment_ids=segment_ids)
    out = out.transpose(1, 2).reshape(B, S, cfg.num_heads * hd)
    x = x + L.linear(lp["o_proj"], out)
    h = L.rms_norm(lp["post_attention_layernorm"], x, eps=cfg.rms_norm_eps)
    return x + _mlp(lp, h), (k, v)


def embed(params, input_ids):
    return params["embed_tokens"][input_ids.long()]


def _lm_head(params, x):
    """Final vocab projection -> fp32 logits. The weight (dequantized when
    int8) is cast to x.dtype and the products accumulate in fp32, as the JAX
    einsum with preferred_element_type=fp32."""
    w = params["lm_head"]["weight"]
    if isinstance(w, dict):
        w = dequantize_weight(w)
    return torch.matmul(x.to(torch.float32),
                        w.to(x.dtype).to(torch.float32).T)


def forward(params, embeds, cfg: LLMConfig, *, positions=None,
            use_kernel: Optional[bool] = None, return_kv: bool = False,
            compute_dtype=torch.float32, remat: bool = False,
            logit_positions=None, return_hidden: bool = False,
            segment_ids=None, ring=None):
    """Full-sequence forward (training / prefill). embeds [B, S, H];
    positions [B, S] or None (arange); segment_ids [B, S] (packed sequences:
    attention stays inside a segment; pass per-segment positions too).
    Returns (logits fp32 [B, S, V], or [B, 1, V] at ``logit_positions`` [B],
    or the final normed hidden states with ``return_hidden``; list of
    per-layer (k, v) or None). ``use_kernel`` is JAX's ``use_pallas``;
    ``remat`` recomputes each layer in the backward (under autograd).

    ``ring`` (JAX's ``ring=(mesh, axis)``): the attention is the collective
    ``ops.ring_attention`` with the sequence sharded over n virtual ranks (an
    int; ``embeds`` is the whole sequence) or over a ``torch.distributed``
    ProcessGroup (``embeds`` is this rank's shard of S/n positions, and
    ``positions=None`` means its global positions from rank * S/n on;
    ``logit_positions`` index the shard). ``remat`` keeps the ring (JAX's
    non-scan remat path drops it, which changes no number: the ring is exact).
    ``ring`` with ``segment_ids`` raises: JAX's ring branch ignores them,
    which is wrong attention for packed sequences (ROADMAP Queue 3)."""
    if cfg.num_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    if ring is not None and segment_ids is not None:
        raise ValueError("forward: ring attention does not take segment_ids (packed "
                         "sequences); JAX's ring branch ignores them (ROADMAP Queue 3)")
    B, S, _ = embeds.shape
    x = embeds.to(compute_dtype)
    cos, sin = rope_table(cfg, cfg.max_position_embeddings, x.device)
    if positions is None:
        start = dist.get_rank(ring) * S if isinstance(ring, dist.ProcessGroup) else 0
        cos_s, sin_s = cos[start:start + S], sin[start:start + S]
    else:
        cos_s, sin_s = cos[positions.long()], sin[positions.long()]
    remat = remat and torch.is_grad_enabled()
    kvs = []
    for i in range(cfg.num_layers):
        args = (_layer(params["layers"], i), x, cos_s, sin_s, cfg, use_kernel,
                segment_ids, ring)
        if remat:
            x, kv = checkpoint(_layer_prefill, *args, use_reentrant=False)
        else:
            x, kv = _layer_prefill(*args)
        if return_kv:
            kvs.append(kv)
    x = L.rms_norm(params["norm"], x, eps=cfg.rms_norm_eps)
    if logit_positions is not None:
        x = torch.gather(x, 1, logit_positions[:, None, None].expand(B, 1, x.shape[-1]))
    out = x if return_hidden else _lm_head(params, x)
    return out, (kvs if return_kv else None)


# ----------------------------------------------------------------------------
# KV-cache decode
# ----------------------------------------------------------------------------

def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int,
                  dtype=torch.float32, device=None, quantized: bool = False):
    """[L, B, max_len, KVH, hd] k/v caches and per-row lengths, on ``device``
    (the current CUDA device when None)."""
    if quantized:
        raise NotImplementedError("the int8 KV cache is not ported yet "
                                  "(ROADMAP: int8 KV cache)")
    device = L.resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill_into_cache(cache, kvs, lengths):
    """Write prefill KV (list of (k [B,S,KVH,hd], v)) into the cache at offset
    0, in place, and set the lengths. Returns the same cache dict."""
    S = kvs[0][0].shape[1]
    for li, (k, v) in enumerate(kvs):
        cache["k"][li, :, :S] = k.to(cache["k"].dtype)
        cache["v"][li, :, :S] = v.to(cache["v"].dtype)
    cache["length"] = lengths.to(torch.int32)
    return cache


def _fused_fmt(p):
    """Weight format if a fused decode kernel can serve this projection
    (``llama.py:626-637``): dense, per-row int8 or q4g, without bias or LoRA."""
    if "lora" in p or "lora_b" in p or "bias" in p:
        return None
    w = p["weight"]
    if isinstance(w, dict):
        if "q4g" in w:
            return "q4g"
        if "q" in w and w["scale"].shape[-1] == 1:
            return "int8"
        return None               # NF4, per-row or grouped q4, grouped int8
    return "dense"


def _uniform_fused_fmt(layers, names) -> bool:
    if not isinstance(layers, dict) or names[0] not in layers:
        return False
    fmts = {_fused_fmt(layers[k]) for k in names}
    return len(fmts) == 1 and None not in fmts


def _fused_mlp_ok(layers) -> bool:
    """Stacked layers whose three MLP projections share one fused format."""
    return _uniform_fused_fmt(layers, ("gate_proj", "up_proj", "down_proj"))


def _fused_auto_ok(layers) -> bool:
    """The automatic choice of the fused decode: fused-able, and the
    intermediate dim tiles at the TPU kernel's preferred chunk."""
    return _fused_mlp_ok(layers) and auto_block_ok(layers)


def _fused_attn_ok(layers) -> bool:
    """q/k/v/o share one fused format (else the fused decode runs them
    through ``layers.linear``)."""
    return _uniform_fused_fmt(layers, ("q_proj", "k_proj", "v_proj", "o_proj"))


def _attend(q, cache, li, pos, visible, W, cfg: LLMConfig, compute_dtype):
    """One query row per sequence over layer li's cache window: q [B, NH,
    hd] -> [B, NH * hd] in compute_dtype. Scores and the softmax in fp32
    over compute_dtype values; p rounds to compute_dtype before P.V."""
    B, hd = q.shape[0], cfg.head_dim
    qg = q.reshape(B, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, hd)
    kk = cache["k"][li, :, :W].to(compute_dtype).to(torch.float32)
    vv = cache["v"][li, :, :W].to(compute_dtype).to(torch.float32)
    s = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32), kk) / math.sqrt(hd)
    s = torch.where(visible, s, -1e30)
    p = torch.softmax(s, dim=-1).to(compute_dtype).to(torch.float32)
    o = torch.einsum("bkgt,btkd->bkgd", p, vv).to(compute_dtype)
    return o.reshape(B, cfg.num_heads * hd)


def decode_step(params, cache, token_ids, cfg: LLMConfig,
                compute_dtype=torch.float32, window: Optional[int] = None,
                fused: Optional[bool] = None):
    """One decode step: token_ids [B] -> (logits fp32 [B, V], cache).

    ``fused`` is JAX's (``llama.py:769-798``): True runs each layer through
    the fused decode kernels (``_decode_step_fused``: stacked layers whose
    MLP has one fused format); False the per-layer ``layers.linear`` path
    (list or stacked layers; per-row q4 takes K6 there on the card, NF4 and
    mixed formats their dequantize path); None is ``_fused_auto_ok``, on any
    device (the CPU runs the kernels' plain versions). The cache is updated
    in place (the new k/v at [li, b, length[b]], then length + 1) and
    returned. ``window``: attend only over the first ``window`` cache
    positions."""
    if cfg.num_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    layers = params["layers"]
    if fused is None:
        fused = _fused_auto_ok(layers)
    if fused and not _fused_mlp_ok(layers):
        raise ValueError("fused decode needs stacked layers with one fused MLP "
                         "format (dense, per-row int8 or q4g)")
    B = token_ids.shape[0]
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    pos = cache["length"].long()                                    # [B]
    x = params["embed_tokens"][token_ids].to(compute_dtype)         # [B, H]
    cos, sin = rope_table(cfg, cfg.max_position_embeddings, x.device)
    cos_s, sin_s = cos[pos][:, None], sin[pos][:, None]             # [B, 1, hd]
    max_len = cache["k"].shape[2]
    W = max_len if window is None else min(window, max_len)
    bidx = torch.arange(B, device=x.device)
    visible = torch.arange(W, device=x.device)[None, None, None, :] <= pos[:, None, None, None]
    attn_fused = fused and _fused_attn_ok(layers)

    for li in range(cfg.num_layers):
        lp = None if attn_fused else _layer(layers, li)
        if attn_fused:
            qf, kf, vf = fused_qkv_decode(x, layers, li, eps=cfg.rms_norm_eps)
        else:
            h = L.rms_norm(lp["input_layernorm"], x, eps=cfg.rms_norm_eps)
            qf, kf, vf = (L.linear(lp[n], h) for n in ("q_proj", "k_proj", "v_proj"))
        q = apply_rope(qf.reshape(B, 1, nh, hd), cos_s, sin_s)
        k = apply_rope(kf.reshape(B, 1, nkv, hd), cos_s, sin_s)
        # in-place KV write at each row's position
        cache["k"][li, bidx, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][li, bidx, pos] = vf.reshape(B, nkv, hd).to(cache["v"].dtype)
        o = _attend(q[:, 0], cache, li, pos, visible, W, cfg, compute_dtype)
        if attn_fused:
            x = fused_o_residual(o.contiguous(), x, layers, li)
        else:
            x = x + L.linear(lp["o_proj"], o)
        if fused:
            x = fused_mlp_decode(x, layers, li, eps=cfg.rms_norm_eps)
        else:
            h = L.rms_norm(lp["post_attention_layernorm"], x, eps=cfg.rms_norm_eps)
            x = x + _mlp(lp, h)

    x = L.rms_norm(params["norm"], x, eps=cfg.rms_norm_eps)
    logits = _lm_head(params, x)
    cache["length"] = cache["length"] + 1
    return logits, cache
