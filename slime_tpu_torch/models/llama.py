"""Decoder-only LLM (Llama / Mistral / Mixtral) in PyTorch: prefill and
KV-cache decode.

Port of ``slime_tpu/models/llama.py``:

- ``forward`` is the full-sequence forward of prefill and training over list
  or stacked ``[L, ...]`` layers (``llama.py:233-323``), with ``positions``,
  ``return_kv``, ``logit_positions``, ``return_hidden``, ``segment_ids``
  (sequence packing) and ``remat`` (each layer a ``torch.utils.checkpoint``
  region, JAX's ``jax.checkpoint`` around each block). Its attention is
  ``ops.flash_attention`` (JAX ``_attn_prefill`` :176-179): the K5 kernels
  under JAX's rule or ``use_kernel=True``, the plain version otherwise; with
  ``ring`` (context parallelism, :166-174) it is the collective
  ``ops.ring_attention`` over n virtual ranks or a process group.
- ``decode_step`` (``llama.py:769-888``) and ``prefill_chunk`` (:505-623,
  C positions per row, each row at its own cache length) share one body,
  ``_cache_forward``, and take JAX's ``fused`` choice. The fused path
  (``_decode_step_fused`` :670-766, ``_prefill_chunk_fused`` :398-503) runs
  per layer ``fused_qkv_decode`` -> RoPE -> the KV write -> masked
  attention over the cache in plain torch (plain XLA in JAX) ->
  ``fused_o_residual`` -> ``fused_mlp_decode`` on the [B * C, H] rows; on
  the card those three are the CUDA kernels of ``ops/`` (dense, int8 and
  q4g). The non-fused path runs the same layer through ``layers.linear``:
  per-row q4 (K6), NF4, mixed formats and biases.
- The KV cache is float or int8 (``init_kv_cache(quantized=True)``,
  :341-395): int8 k/v with per-(position, head) absmax scales that
  multiply the scores and the probabilities; no dequantized copy.
- Mixtral's MoE layers (``cfg.num_experts > 0``: ``gate`` [E, H],
  ``experts`` w1 / w3 [E, I, H] and w2 [E, H, I]) replace the dense MLP in
  every entry point (``_moe``, :126-153): top-k routing over the gate's fp32
  logits, the sparse dispatch (``ops.moe_dispatch``) at B * S >= 32 and the
  dense masked path below, and the router load-balancing loss
  (``_router_aux``), returned by ``forward(return_aux=True)`` as the mean
  over layers. The fused decode is dense-MLP only, as JAX's.

Under an active mesh (``parallel.mesh``; ``generate(mesh=...)``, the
engine, the trainer) every layer runs on this rank's view of its
parameters (``parallel.tensor_parallel.llm_layer``): attention on
``H / tp`` heads and ``KVH / tp`` kv heads, the MLP and the experts on
``I / tp`` neurons, each pair ended by one all-reduce over ``model``; the
embedding and ``lm_head`` are vocab-parallel; the KV cache holds the local
kv heads (``init_kv_cache``). The fused decode is off there, as in JAX.

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
from ..ops.fused_mlp import auto_block_ok, fused_mlp_decode
from ..ops.fused_qkvo import fused_o_residual, fused_qkv_decode
from ..ops.moe_dispatch import moe_ffn_sparse
from ..ops.quantization import dequantize_weight
from ..ops.ring_attention import ring_attention
from ..parallel import tensor_parallel as tp
from ..parallel.mesh import active as active_mesh, kv_heads_local
from . import layers as L

# _moe's switch (llama.py:137): the sparse dispatch from this many tokens on
MOE_SPARSE_TOKENS = 32


def _normal(shape, generator, device, dtype):
    return (torch.randn(shape, generator=generator, device=device) * 0.02).to(dtype)


def init_layer(cfg: LLMConfig, *, generator, device=None, dtype=torch.float32) -> Dict:
    """One decoder layer's random parameters (``init``'s per-layer dict): a
    SwiGLU MLP, or with ``cfg.num_experts`` the MoE block's ``gate`` and
    ``experts`` (N(0, 0.02), ``llama.py:54-62``)."""
    H, HD, I, E = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.num_experts
    device = L.resolve_device(device)
    kw = dict(generator=generator, device=device, dtype=dtype)
    lp = {
        "input_layernorm": L.rms_norm_init(H, device=device, dtype=dtype),
        "q_proj": L.linear_init(H, cfg.num_heads * HD, bias=cfg.attention_bias, **kw),
        "k_proj": L.linear_init(H, cfg.num_kv_heads * HD, bias=cfg.attention_bias, **kw),
        "v_proj": L.linear_init(H, cfg.num_kv_heads * HD, bias=cfg.attention_bias, **kw),
        "o_proj": L.linear_init(cfg.num_heads * HD, H, bias=False, **kw),
        "post_attention_layernorm": L.rms_norm_init(H, device=device, dtype=dtype),
    }
    if E > 0:
        lp["gate"] = L.linear_init(H, E, bias=False, **kw)
        lp["experts"] = {"w1": _normal((E, I, H), generator, device, dtype),
                         "w2": _normal((E, H, I), generator, device, dtype),
                         "w3": _normal((E, I, H), generator, device, dtype)}
    else:
        lp["gate_proj"] = L.linear_init(H, I, bias=False, **kw)
        lp["up_proj"] = L.linear_init(H, I, bias=False, **kw)
        lp["down_proj"] = L.linear_init(I, H, bias=False, **kw)
    return lp


def init(cfg: LLMConfig, *, generator, device=None, dtype=torch.float32) -> Dict:
    """Random parameters with the JAX ``llama.init`` key set and shapes
    (list-of-layers layout), on ``device`` (the current CUDA device when
    None)."""
    H = cfg.hidden_size
    device = L.resolve_device(device)
    params: Dict = {"embed_tokens": _normal((cfg.vocab_size, H), generator, device, dtype),
                    "norm": L.rms_norm_init(H, device=device, dtype=dtype),
                    "layers": [init_layer(cfg, generator=generator, device=device, dtype=dtype)
                               for _ in range(cfg.num_layers)]}
    params["lm_head"] = {"weight": _normal((cfg.vocab_size, H), generator, device, dtype)}
    return params


def stack_layers(layers):
    """List of layer dicts -> one dict with a leading [num_layers] dim."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lp[k] for lp in layers]) for k in first}
    return torch.stack(layers)


def unstack_layers(layers, num_layers: int):
    """Inverse of ``stack_layers`` (``llama.py:211-216``): a stacked dict ->
    the list of its ``num_layers`` layers (views, no copy); a list as it
    is."""
    if not isinstance(layers, dict):
        return layers
    return [_layer(layers, i) for i in range(num_layers)]


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

def _mlp(lp, x, plan=None):
    """SwiGLU; under a mesh ``plan`` says how its pair is split."""
    xi = tp.enter(x, plan is not None and plan.mlp)
    g = L.linear(lp["gate_proj"], xi)
    u = L.linear(lp["up_proj"], xi)
    return tp.project_out(L.linear, lp["down_proj"], L.silu(g) * u,
                          plan.mlp_out if plan is not None else "none")


def top_k_stable(x, k: int):
    """(values, indices) of the k largest entries along the last dim, ties
    to the lower index first, as ``jax.lax.top_k`` (``torch.topk`` promises
    no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_aux(logits, topi, num_experts: int):
    """Switch/Mixtral load-balancing loss (HF ``load_balancing_loss_func``,
    ``llama.py:112-123``): E * sum over (slot k, expert e) of the share of
    tokens whose k-th choice is e times e's mean router probability. A
    balanced routing gives about top_k. Under a mesh whose batch axes hold
    more than one rank the two means are over the global batch."""
    T = logits.shape[0] * logits.shape[1]
    probs = torch.softmax(logits.reshape(T, -1), dim=-1)                 # [T, E]
    onehot = torch.nn.functional.one_hot(topi.reshape(T, -1).long(),
                                         num_experts).to(torch.float32)  # [T, K, E]
    mesh = active_mesh()
    if mesh is not None and mesh.axis_size("dp") > 1:
        n = tp.reduce_dp(torch.tensor(float(T), device=logits.device))
        tokens_per_expert = tp.reduce_dp(onehot.sum(dim=0)) / n
        router_prob = tp.reduce_dp(probs.sum(dim=0)) / n
    else:
        tokens_per_expert = onehot.mean(dim=0)                           # [K, E]
        router_prob = probs.mean(dim=0)                                  # [E]
    return (tokens_per_expert * router_prob[None, :]).sum() * num_experts


def _moe(lp, x, cfg: LLMConfig, plan=None):
    """Mixtral's block-sparse MoE on x [B, S, H] -> (out [B, S, H], its
    routing: the gate's fp32 logits [B, S, E] and the top-k ids [B, S, K],
    from which ``_layer_prefill`` forms the aux loss).
    Top-k softmax routing over the gate's fp32 logits; the experts run
    sparsely (``ops.moe_dispatch``: sorted, grouped, k/E of the dense work)
    at B * S >= 32, else densely (every expert on every token, the others
    weighted 0), with JAX's rounding points on each path (``llama.py:126-153``).
    The products run in the promoted type of x and the weights, as JAX's
    promotes; the dense path rounds each to x.dtype. Under a mesh whose
    ``plan`` splits the experts' neurons, each rank runs its I / tp of
    every expert and one all-reduce adds them."""
    B, S, H = x.shape
    ex = lp["experts"]
    logits = L.linear(lp["gate"], x).to(torch.float32)                  # [B, S, E]
    topw, topi = top_k_stable(logits, cfg.num_experts_per_tok)
    topw = torch.softmax(topw, dim=-1)
    split = plan is not None and plan.mlp
    # both enter the split experts: each rank's combine weights see only its
    # neurons' part of the outputs, so their gradients add over the ranks
    xe, topw = tp.enter(x, split), tp.enter(topw, split)
    if B * S >= MOE_SPARSE_TOKENS:
        out = moe_ffn_sparse(xe.reshape(B * S, H), ex["w1"], ex["w2"], ex["w3"],
                             topi.reshape(B * S, -1), topw.to(x.dtype).reshape(B * S, -1))
        out = out.reshape(B, S, H)
    else:
        w_full = torch.zeros_like(logits).scatter(-1, topi, topw)       # [B, S, E]
        dt = torch.promote_types(x.dtype, ex["w1"].dtype)
        xd = xe.to(dt)
        h1 = torch.einsum("bsh,eih->bsei", xd, ex["w1"].to(dt)).to(x.dtype)
        h3 = torch.einsum("bsh,eih->bsei", xd, ex["w3"].to(dt)).to(x.dtype)
        a = L.silu(h1) * h3
        y = torch.einsum("bsei,ehi->bseh", a.to(dt), ex["w2"].to(dt)).to(x.dtype)
        out = torch.einsum("bseh,bse->bsh", y, w_full.to(x.dtype))
    if split:
        out = tp.reduce_model(out)
    return out, (logits, topi)


def _layer_prefill(lp, x, cos, sin, cfg: LLMConfig, use_kernel=None,
                   segment_ids=None, ring=None):
    B, S, _ = x.shape
    lp, cfg, plan = tp.llm_layer(lp, cfg)
    hd = cfg.head_dim
    h = L.rms_norm(lp["input_layernorm"], x, eps=cfg.rms_norm_eps)
    hq = tp.enter(h, plan is not None and plan.attn)
    q = L.linear(lp["q_proj"], hq).reshape(B, S, cfg.num_heads, hd)
    k = L.linear(lp["k_proj"], hq).reshape(B, S, cfg.num_kv_heads, hd)
    v = L.linear(lp["v_proj"], hq).reshape(B, S, cfg.num_kv_heads, hd)
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
    x = x + tp.project_out(L.linear, lp["o_proj"], out,
                           plan.attn_out if plan is not None else "none")
    h = L.rms_norm(lp["post_attention_layernorm"], x, eps=cfg.rms_norm_eps)
    if cfg.num_experts > 0:
        h, (logits, topi) = _moe(lp, h, cfg, plan)
        aux = _router_aux(logits, topi, cfg.num_experts)
    else:
        h, aux = _mlp(lp, h, plan), None     # a dense layer adds nothing to the aux
    return x + h, (k, v), aux


def embed(params, input_ids):
    """Token embeddings (vocab-parallel under a mesh: ``tp.embed``)."""
    if active_mesh() is not None:
        return tp.embed(params["embed_tokens"], input_ids)
    return params["embed_tokens"][input_ids.long()]


def _lm_head(params, x):
    """Final vocab projection -> fp32 logits. The weight (dequantized when
    int8) is cast to x.dtype and the products accumulate in fp32, as the JAX
    einsum with preferred_element_type=fp32. Under a mesh each rank
    computes its vocab slice and the all-gather joins them (every rank
    then holds the same logits)."""
    head, offset = tp.head_view(params["lm_head"])
    if offset is not None:
        x = tp.enter(x)
    w = head["weight"]
    if isinstance(w, dict):
        w = dequantize_weight(w)
    logits = torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32).T)
    return logits if offset is None else tp.gather_model(logits, -1)


def forward(params, embeds, cfg: LLMConfig, *, positions=None,
            use_kernel: Optional[bool] = None, return_kv: bool = False,
            compute_dtype=torch.float32, remat: bool = False,
            logit_positions=None, return_hidden: bool = False,
            segment_ids=None, ring=None, return_aux: bool = False):
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
    which is wrong attention for packed sequences (ROADMAP Queue 3).

    ``return_aux``: a third element, the router load-balancing loss averaged
    over the layers (0 for dense layers); it comes out of each ``remat``
    region with the hidden state, so its gradient reaches the gates."""
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
    kvs, auxes = [], []
    for i in range(cfg.num_layers):
        args = (_layer(params["layers"], i), x, cos_s, sin_s, cfg, use_kernel,
                segment_ids, ring)
        if remat:
            x, kv, aux = checkpoint(_layer_prefill, *args, use_reentrant=False)
        else:
            x, kv, aux = _layer_prefill(*args)
        if aux is not None:
            auxes.append(aux)
        if return_kv:
            kvs.append(kv)
    x = L.rms_norm(params["norm"], x, eps=cfg.rms_norm_eps)
    if logit_positions is not None:
        x = torch.gather(x, 1, logit_positions[:, None, None].expand(B, 1, x.shape[-1]))
    out = x if return_hidden else _lm_head(params, x)
    if return_aux:
        aux = (sum(auxes) if auxes else
               torch.zeros((), dtype=torch.float32, device=x.device)) / cfg.num_layers
        return out, (kvs if return_kv else None), aux
    return out, (kvs if return_kv else None)


# ----------------------------------------------------------------------------
# KV-cache decode and chunked prefill
# ----------------------------------------------------------------------------

def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int,
                  dtype=torch.float32, device=None, quantized: bool = False):
    """[L, B, max_len, KVH, hd] k/v caches and per-row lengths, on ``device``
    (the current CUDA device when None).

    ``quantized`` (``llama.py:341-361``): k/v are int8 with per-(position,
    kv-head) absmax scales ``k_scale`` / ``v_scale`` [L, B, max_len, KVH]
    fp32, initialised to 1. Attention never dequantizes the cache: the int8
    values feed the products and the scales multiply the scores (k) and the
    probabilities (v), which per-(t, head) scaling commutes through.

    Under an active mesh the cache holds this rank's kv heads
    (``parallel.mesh.kv_heads_local``)."""
    device = L.resolve_device(device)
    shape = (cfg.num_layers, batch, max_len,
             kv_heads_local(cfg.num_kv_heads, active_mesh()), cfg.head_dim)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones(shape[:-1], dtype=torch.float32, device=device),
                "v_scale": torch.ones(shape[:-1], dtype=torch.float32, device=device),
                "length": length}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": length}


def cache_quantized(cache) -> bool:
    return "k_scale" in cache


def quantize_kv(x):
    """x [..., KVH, hd] float -> (int8 [..., KVH, hd], scale [..., KVH] fp32):
    per-head absmax over the head dim, scale 1 where the absmax is 0."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _write_kv(cache, li, rows, positions, k, v):
    """Write k/v [B, C, KVH, hd] at [li, rows, positions] ([B, 1] and [B, C]
    indices), quantized on the way in for an int8 cache. Callers keep every
    position below the cache length."""
    if cache_quantized(cache):
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        cache["k"][li, rows, positions] = kq
        cache["v"][li, rows, positions] = vq
        cache["k_scale"][li, rows, positions] = ks
        cache["v_scale"][li, rows, positions] = vs
    else:
        cache["k"][li, rows, positions] = k.to(cache["k"].dtype)
        cache["v"][li, rows, positions] = v.to(cache["v"].dtype)


def prefill_into_cache(cache, kvs, lengths):
    """Write prefill KV (list of (k [B,S,KVH,hd], v)) into the cache at offset
    0, in place (quantized for an int8 cache), and set the lengths. Returns
    the same cache dict."""
    B, S = kvs[0][0].shape[:2]
    dev = cache["k"].device
    rows = torch.arange(B, device=dev)[:, None]
    positions = torch.arange(S, device=dev)[None]
    for li, (k, v) in enumerate(kvs):
        _write_kv(cache, li, rows, positions, k, v)
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


def _attend(q, cache, li, visible, W, cfg: LLMConfig, compute_dtype):
    """C query rows per sequence over layer li's cache window: q [B, C, NH,
    hd], visible [B, 1, 1, C, W] -> [B, C, NH * hd] in compute_dtype. Scores
    and the softmax in fp32 over compute_dtype values; p rounds to
    compute_dtype before P.V. An int8 cache feeds its int values to the
    products; its k scales multiply the scores and its v scales the
    probabilities (``llama.py:843-856``)."""
    B, C, _, hd = q.shape
    qg = q.reshape(B, C, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, hd)
    kk = cache["k"][li, :, :W].to(compute_dtype).to(torch.float32)
    vv = cache["v"][li, :, :W].to(compute_dtype).to(torch.float32)
    s = torch.einsum("bckgd,btkd->bkgct", qg.to(torch.float32), kk) / math.sqrt(hd)
    quant = cache_quantized(cache)
    if quant:
        s = s * cache["k_scale"][li, :, :W].transpose(1, 2)[:, :, None, None, :]
    s = torch.where(visible, s, -1e30)
    p = torch.softmax(s, dim=-1)
    if quant:
        p = p * cache["v_scale"][li, :, :W].transpose(1, 2)[:, :, None, None, :]
    p = p.to(compute_dtype).to(torch.float32)
    o = torch.einsum("bkgct,btkd->bckgd", p, vv).to(compute_dtype)
    return o.reshape(B, C, cfg.num_heads * hd)


def _cache_forward(params, cache, x, cfg: LLMConfig, compute_dtype, window, fused):
    """The layers over C new positions per row: x [B, C, H] embeddings, each
    row starting at its own ``cache["length"]`` -> (final normed hidden
    states [B, C, H], cache). The new k/v are written in place at [li, b,
    length[b] + c] and the lengths advance by C. ``fused`` runs the
    projections through K1-K3 on the [B * C, H] rows
    (``_decode_step_fused`` / ``_prefill_chunk_fused``); otherwise each layer
    runs through ``layers.linear``, and MoE layers through ``_moe`` on the
    [B, C, H] rows (dense masked at B * C < 32, else sparse). Attention
    reads the first ``window`` cache positions (all when None)."""
    layers = params["layers"]
    if fused and cfg.num_experts > 0:
        raise ValueError("the fused decode is dense-MLP only; MoE layers take fused=False")
    if fused and active_mesh() is not None:
        raise ValueError("the fused decode runs on one card; under a mesh take fused=False")
    if fused and not _fused_mlp_ok(layers):
        raise ValueError("the fused path needs stacked layers with one fused MLP "
                         "format (dense, per-row int8 or q4g)")
    B, C, H = x.shape
    hd, eps = cfg.head_dim, cfg.rms_norm_eps
    dev = x.device
    positions = cache["length"].long()[:, None] + torch.arange(C, device=dev)[None]
    cos, sin = rope_table(cfg, cfg.max_position_embeddings, dev)
    cos_s, sin_s = cos[positions], sin[positions]                  # [B, C, hd]
    max_len = cache["k"].shape[2]
    W = max_len if window is None else min(window, max_len)
    visible = (torch.arange(W, device=dev)[None, None] <= positions[:, :, None]
               )[:, None, None]                                   # [B, 1, 1, C, W]
    rows = torch.arange(B, device=dev)[:, None]
    attn_fused = fused and _fused_attn_ok(layers)
    x = x.to(compute_dtype).reshape(B * C, H)

    for li in range(cfg.num_layers):
        lp, lcfg, plan = (None, cfg, None) if attn_fused else tp.llm_layer(_layer(layers, li),
                                                                          cfg)
        nh, nkv = lcfg.num_heads, lcfg.num_kv_heads
        if attn_fused:
            qf, kf, vf = fused_qkv_decode(x, layers, li, eps=eps)
        else:
            h = tp.enter(L.rms_norm(lp["input_layernorm"], x, eps=eps),
                         plan is not None and plan.attn)
            qf, kf, vf = (L.linear(lp[n], h) for n in ("q_proj", "k_proj", "v_proj"))
        q = apply_rope(qf.reshape(B, C, nh, hd), cos_s, sin_s)
        k = apply_rope(kf.reshape(B, C, nkv, hd), cos_s, sin_s)
        _write_kv(cache, li, rows, positions, k, vf.reshape(B, C, nkv, hd))
        o = _attend(q, cache, li, visible, W, lcfg, compute_dtype).reshape(B * C, nh * hd)
        if attn_fused:
            x = fused_o_residual(o.contiguous(), x, layers, li)
        else:
            x = x + tp.project_out(L.linear, lp["o_proj"], o,
                                   plan.attn_out if plan is not None else "none")
        if fused:
            x = fused_mlp_decode(x, layers, li, eps=eps)
        else:
            h = L.rms_norm(lp["post_attention_layernorm"], x, eps=eps)
            if cfg.num_experts > 0:
                x = x + _moe(lp, h.reshape(B, C, H), lcfg, plan)[0].reshape(B * C, H)
            else:
                x = x + _mlp(lp, h, plan)

    x = L.rms_norm(params["norm"], x, eps=eps)
    cache["length"] = cache["length"] + C
    return x.reshape(B, C, H), cache


def decode_step(params, cache, token_ids, cfg: LLMConfig,
                compute_dtype=torch.float32, window: Optional[int] = None,
                fused: Optional[bool] = None):
    """One decode step: token_ids [B] -> (logits fp32 [B, V], cache).

    ``fused`` is JAX's (``llama.py:769-798``): True runs each layer through
    the fused decode kernels (``_decode_step_fused``: stacked layers whose
    MLP has one fused format); False the per-layer ``layers.linear`` path
    (list or stacked layers; per-row q4 takes K6 there on the card, NF4 and
    mixed formats their dequantize path); None is ``_fused_auto_ok``, on any
    device (the CPU runs the kernels' plain versions). The cache (float or
    int8) is updated in place (the new k/v at [li, b, length[b]], then
    length + 1) and returned. ``window``: attend only over the first
    ``window`` cache positions; callers keep every row's length below it.
    MoE layers run non-fused (None picks it; True raises)."""
    if fused is None:
        fused = active_mesh() is None and _fused_auto_ok(params["layers"])
    x = embed(params, token_ids)[:, None]
    x, cache = _cache_forward(params, cache, x, cfg, compute_dtype, window, fused)
    return _lm_head(params, x[:, 0]), cache


def chunk_takes_fused(shape, device, layers) -> bool:
    """``prefill_chunk``'s automatic choice for embeds of ``shape`` [B, C, H]
    on ``device``: JAX's rule (``llama.py:522-525``) with "single-device TPU"
    read as "a CUDA device"."""
    return (torch.device(device).type == "cuda" and shape[0] * shape[1] <= 64
            and active_mesh() is None and _fused_auto_ok(layers))


def prefill_chunk(params, cache, embeds, cfg: LLMConfig,
                  compute_dtype=torch.float32, window: Optional[int] = None,
                  fused: Optional[bool] = None):
    """Incremental prefill (``llama.py:505-623``): append a C-position chunk
    embeds [B, C, H] to the cache, each row at its own ``cache["length"]``,
    and return (logits fp32 [B, C, V], cache), the cache (float or int8)
    updated in place. Callers keep length + C within the cache.

    ``fused`` runs the chunk's [B * C, H] rows through K1-K3
    (``_prefill_chunk_fused``, :398-503), whose own routing picks the weight
    ring or the row-per-warp kernels. None is JAX's auto rule with its
    single-device TPU read as "the embeds are on a CUDA device": no experts,
    B * C <= 64 and ``_fused_auto_ok``; larger chunks and CPU tensors take
    the per-layer ``layers.linear`` path."""
    if fused is None:
        fused = chunk_takes_fused(embeds.shape, embeds.device, params["layers"])
    x, cache = _cache_forward(params, cache, embeds, cfg, compute_dtype, window, fused)
    return _lm_head(params, x), cache
