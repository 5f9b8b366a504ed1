"""Autoregressive generation: multimodal prefill + KV-cache decode loop.

Port of ``slime_tpu/generate.py`` (``generate`` :127-198, ``generate_stream``
:201-286, the decode loop :97-124). Prefill attention goes through
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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import SliMEConfig
from .data.tokenization import StopStringMatcher
from .models import llama, slime
from .models.layers import fp32_accumulation


def sample_token(logits, *, temperature: float = 0.0, top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None):
    """logits [B, V] fp32 -> token [B] int32. temperature <= 0 is greedy
    (first maximal index, as jnp.argmax); otherwise top_p (the token whose
    exclusive cumulative probability crosses top_p is kept), then a
    categorical draw from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = (cum - probs < top_p).sum(dim=-1) - 1
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


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
    """Multimodal (or text-only) prefill -> (logits at each row's last valid
    position [B, V] fp32, per-layer (k, v), valid lengths [B], padded length L)."""
    if pixel_values is not None:
        if pixel_values.dim() == 6:
            raise NotImplementedError("multi-image prompts are not ported yet "
                                      "(ROADMAP: multi-image/unpad/identity)")
        fused = slime.prepare_multimodal(params, cfg, input_ids, attention_mask,
                                         pixel_values, crop_mask,
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
             cache_len: Optional[int] = None):
    """Multimodal generate -> token ids [B, max_new_tokens] int32 (on the
    inputs' device); cut each row at EOS with ``trim_at_eos``.
    ``params["llm"]["layers"]`` must be stacked (``llama.stack_layers``)."""
    if eos_id is None:
        eos_id = cfg.eos_token_id
    B = input_ids.shape[0]
    last, kvs, lengths, L = prefill(params, cfg, input_ids, attention_mask,
                                    pixel_values, crop_mask, compute_dtype)
    cache = llama.init_kv_cache(cfg.llm, B, cache_len or L + max_new_tokens,
                                dtype=compute_dtype, device=last.device)
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
                    compute_dtype=torch.float32):
    """Streaming generation (B == 1): decode ``chunk`` tokens at a time and
    yield the text so far after each chunk. Stops on EOS or a stop string."""
    eos_id = cfg.eos_token_id
    matcher = StopStringMatcher(stop_strings, tokenizer) if stop_strings else None
    last, kvs, lengths, L = prefill(params, cfg, input_ids, attention_mask,
                                    pixel_values, crop_mask, compute_dtype)
    cache = llama.init_kv_cache(cfg.llm, input_ids.shape[0], L + max_new_tokens + 1,
                                dtype=compute_dtype, device=last.device)
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
