"""Autoregressive generation: multimodal prefill + KV-cache decode loop.

Port of ``slime_tpu/generate.py`` (``generate`` :127-198, ``generate_stream``
:201-286, ``beam_search`` :304-392, the decode loop :97-124, ``sample_token``
:30-47 and the serving engine's per-row ``sample_token_dynamic`` :50-96).
Pixels of 6 dimensions [B, N, MC, 3, t, t] are a multi-image prompt
(``slime.prepare_multimodal_multi``), 5 dimensions one image a sample. Prefill attention goes through
``ops.flash_attention`` under JAX's rule: the K5 kernels for causal CUDA
tensors at S >= 2048 (multimodal prompts are padded to 2048 positions; bf16
or the default fp32), the plain ``reference_attention`` otherwise; decode
goes through ``llama.decode_step`` and its kernels, which take the default
fp32 compute dtype and any batch too.

The decode loop is a Python loop with the JAX loop's semantics: rows that are
done emit ``eos_id``, untouched slots stay 0, and the loop stops once every
row is done, which costs one device-to-host sync per step.

Prefill and the decode loop run under ``layers.fp32_accumulation``: every
matmul accumulates in fp32, as in the JAX package, whatever the caller's
TF32 / reduced-precision settings are.

``mesh=`` (``generate``, ``generate_stream``; ``generate.py:133-197``,
:206-264) is tensor-parallel inference on every rank of a
``parallel.mesh.Mesh``: the parameters are sharded by the rule table unless
they already are (stacked layers as their list, ``mesh.layer_list``), the KV
cache holds this rank's kv heads, the fused decode is off, and prefill and
the decode loop run under the mesh. The logits are all-gathered, so every
rank samples the same tokens from a generator seeded alike, and leaves the
loop at the same step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import SliMEConfig
from .data.tokenization import StopStringMatcher
from .models import llama, slime
from .models.layers import fp32_accumulation
from .models.llama import top_k_stable
from .parallel.mesh import layer_list, on_mesh, shard_params, use_mesh


def sample_token(logits, *, temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, generator: Optional[torch.Generator] = None):
    """logits [B, V] fp32 -> token [B] int32 (``generate.py:30-47``).
    temperature <= 0 is greedy (first maximal index, as jnp.argmax);
    otherwise top_k > 0 keeps the k highest logits (HF semantics, before
    top_p), top_p keeps the token whose exclusive cumulative probability
    crosses top_p, then a categorical draw from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = (cum - probs < top_p).sum(dim=-1) - 1
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def categorical(logits, generator: Optional[torch.Generator] = None):
    """One draw per row from softmax(logits) [B, V] (-inf entries never
    drawn) by the Gumbel-max rule, as jax.random.categorical: no host sync
    and no check of the row sums."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def dynamic_filter(logits, temperature, top_p, top_k=None, min_p=None):
    """The logits ``sample_token_dynamic`` draws from: temperature-scaled,
    with the tokens each row's filters drop set to -inf."""
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    filt = scaled
    neg_inf = float("-inf")
    if top_k is not None:
        V = logits.shape[-1]
        kth_idx = torch.clamp(top_k.long(), 1, V) - 1
        kth = torch.gather(sorted_logits, -1, kth_idx[:, None])
        filt = torch.where((top_k[:, None] > 0) & (scaled < kth), neg_inf, filt)
        # HF chains top_p after top_k: the nucleus is computed over the
        # top-k-filtered distribution (sorted positions >= k drop out)
        keepk = ((top_k[:, None] <= 0) | (torch.arange(V, device=logits.device)[None]
                                          < torch.clamp(top_k, min=0)[:, None]))
        sorted_logits = torch.where(keepk, sorted_logits, neg_inf)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_idx = (cum - probs < top_p[:, None]).sum(dim=-1) - 1
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
    filt = torch.where((top_p[:, None] < 1.0) & (scaled < cutoff), neg_inf, filt)
    if min_p is not None:
        # HF MinPLogitsWarper: drop tokens with prob < min_p * max_prob,
        # evaluated after the top_k / top_p masks
        row_probs = torch.softmax(filt, dim=-1)
        pmax = row_probs.amax(dim=-1, keepdim=True)
        filt = torch.where((min_p[:, None] > 0.0) & (row_probs < min_p[:, None] * pmax),
                           neg_inf, filt)
    return filt


def sample_token_dynamic(logits, temperature, top_p, top_k=None, min_p=None, *,
                         generator: Optional[torch.Generator] = None):
    """Per-row variant of :func:`sample_token` for the serving engine
    (``generate.py:50-96``): logits [B, V] fp32 and [B] tensors of knobs.
    Rows with temperature <= 0 are greedy; top_p >= 1, top_k <= 0 and
    min_p <= 0 are "off" per row; ``top_k`` / ``min_p`` None leave that
    filter out. Filters in HF's order (temperature, top_k, top_p, min_p);
    the nucleus keeps the token whose exclusive cumulative probability
    crosses top_p."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = categorical(dynamic_filter(logits, temperature, top_p, top_k, min_p),
                          generator)
    return torch.where(temperature > 0, sampled, greedy)


@fp32_accumulation()
def _decode_loop(params_llm, cache, first_token, eos_id: int, *, cfg: SliMEConfig,
                 max_new_tokens: int, temperature: float, top_p: float,
                 compute_dtype, generator):
    """tokens [B, max_new_tokens] int32 with first_token at index 0; the cache
    is advanced in place."""
    B = first_token.shape[0]
    tokens = torch.zeros((B, max_new_tokens), dtype=torch.int32,
                         device=first_token.device)
    tokens[:, 0] = first_token
    done = first_token == eos_id
    for i in range(1, max_new_tokens):
        if bool(done.all()):
            break
        logits, cache = llama.decode_step(params_llm, cache, tokens[:, i - 1],
                                          cfg.llm, compute_dtype=compute_dtype)
        nxt = sample_token(logits, temperature=temperature, top_p=top_p,
                           generator=generator)
        nxt = torch.where(done, eos_id, nxt)
        tokens[:, i] = nxt
        done = done | (nxt == eos_id)
    return tokens, cache


@fp32_accumulation()
def prefill(params, cfg: SliMEConfig, input_ids, attention_mask, pixel_values,
            crop_mask, compute_dtype):
    """Multimodal (one image or several a sample) or text-only prefill ->
    (logits at each row's last valid position [B, V] fp32, per-layer (k, v),
    valid lengths [B], padded length L)."""
    if pixel_values is not None:
        prep = (slime.prepare_multimodal_multi if pixel_values.dim() == 6
                else slime.prepare_multimodal)
        fused = prep(params, cfg, input_ids, attention_mask, pixel_values, crop_mask,
                     compute_dtype=compute_dtype)
        embeds, positions, lengths = fused.embeds, fused.positions, fused.lengths
    else:
        embeds = llama.embed(params["llm"], torch.where(input_ids < 0, 0, input_ids)
                             ).to(compute_dtype)
        lengths = attention_mask.to(torch.int32).sum(dim=1).to(torch.int32)
        positions = None
    idx = torch.clamp(lengths.long() - 1, min=0)
    logits, kvs = llama.forward(params["llm"], embeds, cfg.llm, positions=positions,
                                return_kv=True, compute_dtype=compute_dtype,
                                logit_positions=idx)
    return logits[:, 0], kvs, lengths, embeds.shape[1]


def generate(params, cfg: SliMEConfig, input_ids, attention_mask,
             pixel_values=None, crop_mask=None, *, max_new_tokens: int = 128,
             temperature: float = 0.0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None, compute_dtype=torch.float32,
             cache_len: Optional[int] = None, kv_quant: bool = False, mesh=None):
    """Multimodal generate -> token ids [B, max_new_tokens] int32 (on the
    inputs' device); cut each row at EOS with ``trim_at_eos``.
    ``params["llm"]["layers"]`` must be stacked (``llama.stack_layers``) for
    the fused decode; under ``mesh`` (tensor-parallel, see the module
    docstring) they may be a list too.
    ``kv_quant``: the int8 KV cache (``llama.init_kv_cache``)."""
    if eos_id is None:
        eos_id = cfg.eos_token_id
    if mesh is not None:
        if not on_mesh(params, mesh):
            params = shard_params(mesh, layer_list(params))
        with use_mesh(mesh):
            return generate(params, cfg, input_ids, attention_mask, pixel_values,
                            crop_mask, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_p=top_p, generator=generator,
                            eos_id=eos_id, compute_dtype=compute_dtype,
                            cache_len=cache_len, kv_quant=kv_quant)
    B = input_ids.shape[0]
    last, kvs, lengths, L = prefill(params, cfg, input_ids, attention_mask,
                                    pixel_values, crop_mask, compute_dtype)
    cache = llama.init_kv_cache(cfg.llm, B, cache_len or L + max_new_tokens,
                                dtype=compute_dtype, device=last.device,
                                quantized=kv_quant)
    cache = llama.prefill_into_cache(cache, kvs, lengths)
    del kvs
    first = sample_token(last, temperature=temperature, top_p=top_p,
                         generator=generator)
    tokens, _ = _decode_loop(params["llm"], cache, first, eos_id, cfg=cfg,
                             max_new_tokens=max_new_tokens,
                             temperature=temperature, top_p=top_p,
                             compute_dtype=compute_dtype, generator=generator)
    return tokens


def generate_stream(params, cfg: SliMEConfig, tokenizer, input_ids,
                    attention_mask, pixel_values=None, crop_mask=None, *,
                    max_new_tokens: int = 256, temperature: float = 0.0,
                    top_p: float = 1.0, generator: Optional[torch.Generator] = None,
                    stop_strings=(), chunk: int = 16,
                    compute_dtype=torch.float32, kv_quant: bool = False, mesh=None):
    """Streaming generation (B == 1): decode ``chunk`` tokens at a time and
    yield the text so far after each chunk. Stops on EOS or a stop string.
    ``kv_quant``: the int8 KV cache. ``mesh``: tensor-parallel, as
    ``generate``; the mesh is entered around each device step only, so the
    caller's code between the yields runs outside it."""
    eos_id = cfg.eos_token_id
    matcher = StopStringMatcher(stop_strings, tokenizer) if stop_strings else None
    if mesh is not None and not on_mesh(params, mesh):
        params = shard_params(mesh, layer_list(params))
    with use_mesh(mesh):
        last, kvs, lengths, L = prefill(params, cfg, input_ids, attention_mask,
                                        pixel_values, crop_mask, compute_dtype)
        cache = llama.init_kv_cache(cfg.llm, input_ids.shape[0], L + max_new_tokens + 1,
                                    dtype=compute_dtype, device=last.device,
                                    quantized=kv_quant)
        cache = llama.prefill_into_cache(cache, kvs, lengths)
    del kvs
    cur = sample_token(last, temperature=temperature, top_p=top_p,
                       generator=generator)

    # each chunk emits its first token at index 0 and feeds it to the model;
    # the chunk's last token is sampled but not yet consumed, so it seeds the
    # next chunk (and is skipped on re-emission)
    generated = []
    done = False
    first_chunk = True
    while len(generated) < max_new_tokens and not done:
        n = min(chunk, max_new_tokens - len(generated)) + (0 if first_chunk else 1)
        with use_mesh(mesh):
            toks, cache = _decode_loop(params["llm"], cache, cur, eos_id, cfg=cfg,
                                       max_new_tokens=n, temperature=temperature,
                                       top_p=top_p, compute_dtype=compute_dtype,
                                       generator=generator)
        row = toks[0].tolist()
        if not first_chunk:
            row = row[1:]
        first_chunk = False
        for t in row:
            if t == eos_id:
                done = True
                break
            generated.append(int(t))
            if len(generated) >= max_new_tokens:
                break
        if not generated:
            break
        cur = torch.tensor([generated[-1]], dtype=torch.int32, device=last.device)
        text = tokenizer.decode(generated, skip_special_tokens=True)
        if matcher is not None and matcher(generated):
            text = matcher.trim(text)
            done = True
        yield text
        if done:
            break


@fp32_accumulation()
def beam_search(params, cfg: SliMEConfig, input_ids, attention_mask, pixel_values=None,
                crop_mask=None, *, num_beams: int = 3, max_new_tokens: int = 32,
                eos_id: Optional[int] = None, length_penalty: float = 1.0,
                compute_dtype=torch.float32):
    """Deterministic beam search (HF ``num_beams``; ``generate.py:304-392``)
    -> token ids [B, max_new_tokens] int32 of each row's best beam.

    The beams are a batch dimension of B*K rows (beam-major per row). The
    seed is the top K first tokens; each of the ``max_new_tokens - 1`` steps
    runs ``llama.decode_step`` on the B*K rows (its kernels under JAX's
    auto rule), takes the top K of the joint log-probs over K*V, and
    reorders the cache rows, the finished flags and the tokens by source
    beam. A finished beam continues only by EOS at log-prob 0. The best beam
    has the highest score / gen_len ** length_penalty, gen_len counting
    through the first EOS of a finished beam, else ``max_new_tokens``."""
    if eos_id is None:
        eos_id = cfg.eos_token_id
    B, K = input_ids.shape[0], num_beams
    NEG = -1e30
    last, kvs, lengths, L = prefill(params, cfg, input_ids, attention_mask,
                                    pixel_values, crop_mask, compute_dtype)
    cache = llama.init_kv_cache(cfg.llm, B, L + max_new_tokens, dtype=compute_dtype,
                                device=last.device)
    cache = llama.prefill_into_cache(cache, kvs, lengths)
    del kvs
    # each row's cache repeated for its K beams: [b0k0, b0k1, ..., b1k0, ...]
    cache = {k: v.repeat_interleave(K, dim=1 if k in ("k", "v") else 0)
             for k, v in cache.items()}
    lp0 = torch.log_softmax(last.to(torch.float32), dim=-1)              # [B, V]
    V = lp0.shape[-1]
    scores, t0 = top_k_stable(lp0, K)                                     # [B, K]
    dev = lp0.device
    out = torch.zeros((B * K, max_new_tokens), dtype=torch.int32, device=dev)
    out[:, 0] = t0.reshape(-1)
    done = t0 == eos_id
    toks = t0.reshape(-1).to(torch.int32)
    frozen = torch.full((V,), NEG, dtype=torch.float32, device=dev)
    frozen[eos_id] = 0.0                # a negative id wraps, as JAX's .at[] does
    rows = torch.arange(B, device=dev)[:, None] * K
    for t in range(1, max_new_tokens):
        logits, cache = llama.decode_step(params["llm"], cache, toks, cfg.llm,
                                          compute_dtype=compute_dtype)
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(B, K, V)
        lp = torch.where(done[..., None], frozen, lp)
        joint = scores[..., None] + lp
        scores, best = top_k_stable(joint.reshape(B, K * V), K)
        src_beam = best // V
        tok = (best % V).to(torch.int32)
        gather = (rows + src_beam).reshape(-1)
        cache = {k: (v[:, gather] if k in ("k", "v") else v[gather])
                 for k, v in cache.items()}
        done = torch.gather(done, 1, src_beam) | (tok == eos_id)
        out = out[gather]
        out[:, t] = tok.reshape(-1)
        toks = tok.reshape(-1)
    out = out.reshape(B, K, max_new_tokens)
    gen_len = (out == eos_id).to(torch.int8).argmax(dim=-1) + 1
    gen_len = torch.where(done, gen_len, max_new_tokens).to(torch.float32)
    final = scores / gen_len ** length_penalty
    pick = final.argmax(dim=1)
    return out[torch.arange(B, device=dev), pick]


def trim_at_eos(tokens, eos_id: int):
    """[B, T] tensor or array -> list of python lists cut before the first EOS."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    out = []
    for row in np.asarray(tokens):
        ids = []
        for t in row.tolist():
            if t == eos_id:
                break
            ids.append(int(t))
        out.append(ids)
    return out
