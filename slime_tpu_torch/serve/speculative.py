"""Speculative decoding: draft-model lookahead verified by the target model
(port of ``slime_tpu/serve/speculative.py``).

Greedy speculative decoding is exact: the emitted sequence equals the
target model's own greedy decode; the draft only changes how many target
forward passes it takes. The draft proposes K tokens (K ``decode_step``
calls); the target verifies them in one ``llama.prefill_chunk`` of K + 1
positions. Acceptance is the longest matching prefix; rollback resets the
caches' ``length``, which every attention masks by, so the rejected tail is
overwritten by the next chunk.

``speculative_generate`` reads each round's result on the host.
``speculative_generate_device`` keeps the whole loop's state on the device
(tokens, lengths, counts) and reads one flag every ``ROUNDS_PER_SYNC``
rounds; its emitted tokens and acceptance rate are the host loop's.

``warp_probs`` and ``rejection_round`` are the distribution-exact
accept/resample rule (Leviathan et al. 2023) the serving engine applies to
sampled slots; draws come from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SliMEConfig
from ..generate import categorical
from ..models import llama
from ..models.layers import fp32_accumulation

# the device loop reads its end flag once this many rounds (a round after
# the end emits and counts nothing)
ROUNDS_PER_SYNC = 8


def _prefill(llm_params, input_ids, cfg_llm, cache_len: int, compute_dtype):
    """Prompt prefill -> (the first greedy token [1] int32, the primed cache
    of ``cache_len`` positions). Logits only at the last position."""
    S = input_ids.shape[1]
    embeds = llama.embed(llm_params, input_ids).to(compute_dtype)
    logits, kvs = llama.forward(llm_params, embeds, cfg_llm, return_kv=True,
                                compute_dtype=compute_dtype,
                                logit_positions=torch.full((1,), S - 1,
                                                           device=input_ids.device))
    cache = llama.init_kv_cache(cfg_llm, 1, cache_len, dtype=compute_dtype,
                                device=input_ids.device)
    cache = llama.prefill_into_cache(cache, kvs, torch.full((1,), S, dtype=torch.int32,
                                                            device=input_ids.device))
    return torch.argmax(logits[0, 0]).to(torch.int32)[None], cache


def _draft_k(dp, d_cache, tok, dl, K: int, compute_dtype):
    """K greedy draft tokens [K] from token ``tok`` [1]; the draft cache
    advances K positions."""
    out = []
    for _ in range(K):
        logits, d_cache = llama.decode_step(dp, d_cache, tok, dl, compute_dtype=compute_dtype)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out), d_cache


def _verify(tp, t_cache, cur, proposals, tl, compute_dtype):
    """One target chunk over [cur, *proposals] (K + 1 positions) -> the
    target's greedy token after each [K + 1]; position K is the bonus token
    of a fully accepted draft."""
    toks = torch.cat([cur, proposals])[None]
    embeds = llama.embed(tp, toks).to(compute_dtype)
    logits, t_cache = llama.prefill_chunk(tp, t_cache, embeds, tl, compute_dtype=compute_dtype)
    return torch.argmax(logits[0], dim=-1).to(torch.int32), t_cache


def _set_len(cache, n):
    cache["length"] = torch.full((1,), int(n), dtype=torch.int32, device=cache["k"].device)
    return cache


@torch.no_grad()
@fp32_accumulation()
def speculative_generate(params_target, cfg_target: SliMEConfig, params_draft,
                         cfg_draft: SliMEConfig, input_ids, *, K: int = 4,
                         max_new_tokens: int = 64, eos_id: Optional[int] = None,
                         compute_dtype=torch.float32):
    """Greedy speculative decode of one text prompt (input_ids [1, S]; both
    models share the vocabulary) -> (numpy tokens [1, <= max_new_tokens],
    cut after EOS, and the acceptance rate: kept draft tokens over
    proposed ones)."""
    if eos_id is None:
        eos_id = cfg_target.eos_token_id
    tl, dl = cfg_target.llm, cfg_draft.llm
    tp, dp = params_target["llm"], params_draft["llm"]
    B, S = input_ids.shape
    if B != 1:
        raise ValueError("speculative decoding takes one prompt (B = 1)")
    cache_len = S + max_new_tokens + K + 2       # verify chunks span K + 1 positions

    cur, t_cache = _prefill(tp, input_ids, tl, cache_len, compute_dtype)
    _, d_cache = _prefill(dp, input_ids, dl, cache_len, compute_dtype)
    out = [int(cur)]
    n_accept = n_prop = 0
    t_len = d_len = S
    while len(out) < max_new_tokens and out[-1] != eos_id:
        d_cache, t_cache = _set_len(d_cache, d_len), _set_len(t_cache, t_len)
        proposals, d_cache = _draft_k(dp, d_cache, cur, dl, K, compute_dtype)
        targets, t_cache = _verify(tp, t_cache, cur, proposals, tl, compute_dtype)
        props, targs = proposals.cpu().numpy(), targets.cpu().numpy()
        n_prop += K
        match = props == targs[:K]
        acc = int(np.argmin(match)) if not match.all() else K
        n_accept += acc
        # accepted draft tokens are the target's own greedy tokens; every
        # round adds one target token: the correction, or the bonus
        emitted = targs[:acc + 1][:max_new_tokens - len(out)]
        if eos_id in emitted:
            emitted = emitted[:int(np.argmax(emitted == eos_id)) + 1]
        out.extend(int(t) for t in emitted)
        if len(emitted) == K + 1:
            # full acceptance: the draft cache lacks the last proposal's KV
            _, d_cache = llama.decode_step(dp, d_cache, proposals[K - 1:], dl,
                                           compute_dtype=compute_dtype)
        t_len += len(emitted)
        d_len += len(emitted)
        cur = torch.tensor([out[-1]], dtype=torch.int32, device=input_ids.device)
    return np.asarray(out, np.int32)[None], n_accept / max(n_prop, 1)


def _spec_loop_device(tp, dp, t_cache, d_cache, first_tok, *, tl, dl, K: int,
                      max_new: int, eos_id: int, compute_dtype):
    """(out [max_new + K + 1], n_out, n_accept, n_prop) as device tensors.
    Entering a round, each cache holds KV for every emitted token but the
    last (``cur``), which the round writes at the current length. Rounds
    after ``done`` change nothing (they emit 0 tokens and count nothing);
    the host reads ``done`` every ``ROUNDS_PER_SYNC`` rounds."""
    dev = first_tok.device
    i32 = dict(dtype=torch.int32, device=dev)
    out = torch.zeros((max_new + K + 1,), **i32)
    out[0] = first_tok[0]
    n_out = torch.ones((), **i32)
    n_acc = torch.zeros((), **i32)
    n_prop = torch.zeros((), **i32)
    done = first_tok[0] == eos_id
    cur = first_tok
    idx = torch.arange(K + 1, device=dev)
    for r in range(max_new):
        if r % ROUNDS_PER_SYNC == 0 and bool(done):
            break
        proposals, d_cache = _draft_k(dp, d_cache, cur, dl, K, compute_dtype)
        targets, t_cache = _verify(tp, t_cache, cur, proposals, tl, compute_dtype)
        match = proposals == targets[:K]
        acc = torch.where(match.all(), K, (~match).to(torch.int32).argmax()).to(torch.int32)
        e = torch.minimum(acc + 1, max_new - n_out)                  # budget cut
        eos_hit = (targets == eos_id) & (idx < e)
        e = torch.where(eos_hit.any(), eos_hit.to(torch.int32).argmax() + 1, e)
        e = torch.where(done, 0, e).to(torch.int32)
        # the round's e tokens land at n_out; the rest of the window keeps
        # what it held
        live = idx < e
        out.scatter_(0, n_out + idx, torch.where(live, targets, out[n_out + idx]))
        n_out = n_out + e
        cur = torch.where(e > 0, targets[torch.clamp(e - 1, min=0)], cur[0]).reshape(1)
        n_acc = n_acc + torch.where(done, 0, acc)
        n_prop = n_prop + torch.where(done, 0, K)
        done = done | eos_hit.any() | (n_out >= max_new)
        # complete the draft cache for the fully accepted case (harmless
        # otherwise: the position lies past the rolled-back length)
        _, d_cache = llama.decode_step(dp, d_cache, proposals[K - 1:], dl,
                                       compute_dtype=compute_dtype)
        # rollback: both caches point at the verified prefix
        t_cache["length"] = (t_cache["length"] - (K + 1) + e).to(torch.int32)
        d_cache["length"] = t_cache["length"].clone()
    return out, n_out, n_acc, n_prop


@torch.no_grad()
@fp32_accumulation()
def speculative_generate_device(params_target, cfg_target: SliMEConfig, params_draft,
                                cfg_draft: SliMEConfig, input_ids, *, K: int = 4,
                                max_new_tokens: int = 64, eos_id: Optional[int] = None,
                                compute_dtype=torch.float32):
    """``speculative_generate`` with the loop's state on the device: no
    per-round host read; the host checks for the end every
    ``ROUNDS_PER_SYNC`` rounds and pulls the tokens once. Same output."""
    if eos_id is None:
        eos_id = cfg_target.eos_token_id
    tl, dl = cfg_target.llm, cfg_draft.llm
    B, S = input_ids.shape
    if B != 1:
        raise ValueError("speculative decoding takes one prompt (B = 1)")
    cache_len = S + max_new_tokens + K + 2
    first, t_cache = _prefill(params_target["llm"], input_ids, tl, cache_len, compute_dtype)
    _, d_cache = _prefill(params_draft["llm"], input_ids, dl, cache_len, compute_dtype)
    out, n_out, n_acc, n_prop = _spec_loop_device(
        params_target["llm"], params_draft["llm"], t_cache, d_cache, first, tl=tl, dl=dl,
        K=K, max_new=max_new_tokens, eos_id=eos_id, compute_dtype=compute_dtype)
    packed = torch.cat([n_out[None], n_acc[None], n_prop[None], out]).cpu().numpy()
    n = int(packed[0])
    return packed[3:3 + n][None], int(packed[1]) / max(int(packed[2]), 1)


# ---------------------------------------------------------------------------
# rejection-sampled speculation (Leviathan et al. / Chen et al.)
# ---------------------------------------------------------------------------

def warp_probs(logits, temperature, top_p):
    """Per-row warped sampling distribution: logits [B, ..., V] -> probs,
    temperature-scaled and nucleus-truncated with the sampler's
    exclusive-cumulative rule; rows with temperature <= 0 are the one-hot
    argmax (the greedy limit), so one formula serves mixed batches.
    temperature, top_p: [B]."""
    V = logits.shape[-1]
    t = torch.clamp(temperature, min=1e-6)
    tp = top_p
    while t.dim() < logits.dim():
        t, tp = t[..., None], tp[..., None]
    scaled = logits / t
    sorted_l = torch.sort(scaled, dim=-1, descending=True).values
    sp = torch.softmax(sorted_l, dim=-1)
    cum = torch.cumsum(sp, dim=-1)
    cutoff_idx = (cum - sp < tp).sum(dim=-1, keepdim=True) - 1
    cutoff = torch.gather(sorted_l, -1, cutoff_idx)
    filt = torch.where((tp < 1.0) & (scaled < cutoff), float("-inf"), scaled)
    probs = torch.softmax(filt, dim=-1)
    greedy = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1), V).to(probs.dtype)
    tcond = temperature
    while tcond.dim() < probs.dim():
        tcond = tcond[..., None]
    return torch.where(tcond > 0, probs, greedy)


def rejection_round(generator, props, q_rows, p_rows):
    """One speculative round's accept/resample, distribution-exact.

    props [B, K] draft proposals drawn from q_rows [B, K, V] (warped draft
    probs); p_rows [B, K+1, V] warped target probs at the same positions.
    Proposal i is accepted with probability min(1, p_i(x_i) / q_i(x_i)); at
    the first rejection the token is drawn from norm(max(p_i - q_i, 0)); if
    all K are accepted a bonus token is drawn from p_K. -> (tokens [B, K+1]
    int32, acc [B] int32): the emitted sequence is tokens[b, :acc[b] + 1].
    One-hot (greedy) rows reduce to the longest-matching-prefix rule."""
    B, K, V = q_rows.shape
    pl = props.long()
    q_x = torch.gather(q_rows, -1, pl[..., None])[..., 0]                   # [B, K]
    p_x = torch.gather(p_rows[:, :K], -1, pl[..., None])[..., 0]
    u = torch.rand((B, K), generator=generator, device=q_rows.device)
    accept = u * q_x < p_x                    # u < p / q without dividing by zero
    acc = torch.where(accept.all(dim=1), K, (~accept).to(torch.int32).argmax(dim=1))
    at = acc.long()[:, None, None].expand(B, 1, V)
    p_at = torch.gather(p_rows, 1, at)[:, 0]                               # [B, V]
    q_pad = torch.cat([q_rows, torch.zeros((B, 1, V), dtype=q_rows.dtype,
                                           device=q_rows.device)], dim=1)
    q_at = torch.gather(q_pad, 1, at)[:, 0]
    resid = torch.clamp(p_at - torch.where(acc[:, None] < K, q_at, 0.0), min=0.0)
    Z = resid.sum(dim=-1, keepdim=True)
    # a degenerate residual (p == q, or one-hot rows) falls back to p
    resid = torch.where(Z > 0, resid / torch.where(Z > 0, Z, 1.0), p_at)
    fix = categorical(torch.log(resid + 1e-30), generator)
    pos = torch.arange(K + 1, device=props.device)[None]
    tokens = torch.cat([props, torch.zeros((B, 1), dtype=props.dtype, device=props.device)],
                       dim=1)
    tokens = torch.where(pos == acc[:, None], fix[:, None].to(props.dtype), tokens)
    return tokens.to(torch.int32), acc.to(torch.int32)
