"""SliME multimodal fusion: ViT -> gated projector / local compression ->
text-guided selection -> static-shape token splice -> LLM embeddings.

Port of ``slime_tpu/models/slime.py`` for one image per sample with the
sampler path and the flat merge (``encode_images`` :82-207, ``_splice_one``
:210-249, ``prepare_multimodal`` :252-299), and the training entry points
``forward`` (:404-427) and ``loss_fn`` (:430-504), multimodal and packed
text-only. The splice is batched over samples where the JAX package vmaps.
Multi-image prompts, the 'unpad' and 'spatial' merges and the identity
resampler are not ported yet.

Training noise (the gate's and the selection's) comes from an explicit
``torch.Generator`` or from a ``noise`` dict the caller passes: ``"gate"``
[B, 576, 2] for the global view's gate logits and ``"select"`` [B, M] for
the selection scores. The vision tower runs under ``torch.no_grad()`` while
none of its parameters requires a gradient (it is frozen in stages 1-3).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..config import (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, IGNORE_INDEX,
                      IMAGE_TOKEN_INDEX, SliMEConfig)
from ..ops.loss import DEFAULT_LOSS_CHUNK, chunked_cross_entropy
from ..params import named_leaves
from . import layers, llama, projector, sampler, vit


class FusedBatch(NamedTuple):
    embeds: torch.Tensor      # [B, L, H]
    attn_mask: torch.Tensor   # [B, L] bool
    positions: torch.Tensor   # [B, L] int32
    labels: torch.Tensor      # [B, L] int32 (IGNORE_INDEX on image/pad slots)
    lengths: torch.Tensor     # [B] int32


def _check_supported(cfg: SliMEConfig):
    if not cfg.has_sampler or cfg.mm_patch_merge_type != "flat":
        raise NotImplementedError("only the sampler path with the flat merge is "
                                  "ported (ROADMAP: multi-image/unpad/identity)")


def _any_requires_grad(tree) -> bool:
    return any(t.requires_grad for _, t in named_leaves(tree))


def init(cfg: SliMEConfig, *, generator, device=None, dtype=torch.float32) -> Dict:
    """Random parameters with the JAX ``slime.init`` key set and shapes, on
    ``device`` (the current CUDA device when None; ``"cpu"`` to build there)."""
    _check_supported(cfg)
    device = layers.resolve_device(device)
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {"vision": vit.init(cfg.vision, **kw),
            "projector": projector.init(cfg, **kw),
            "llm": llama.init(cfg.llm, **kw),
            "sampler": sampler.init(cfg, **kw)}


def image_token_budget(cfg: SliMEConfig) -> int:
    n_global = cfg.vision.num_patches
    if not cfg.has_sampler:
        return (1 + cfg.max_local_crops) * n_global
    return n_global + 1 + cfg.max_local_crops * cfg.mm_resampler_dim


def _text_embeds_for_selector(params, input_ids, attention_mask):
    """Text embeddings and mask with the image sentinel masked out."""
    is_img = input_ids == IMAGE_TOKEN_INDEX
    emb = llama.embed(params["llm"], torch.where(is_img, 0, input_ids))
    return emb, attention_mask.to(torch.bool) & ~is_img


def encode_images(params, cfg: SliMEConfig, pixel_values, crop_mask,
                  input_ids, attention_mask, *, training: bool = False,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Dict] = None, compute_dtype=torch.float32,
                  remat: bool = False):
    """-> (img_embeds [B, T_img, H], img_valid [B, T_img]).

    pixel_values [B, MC, 3, t, t] (float, or uint8 normalized here);
    crop_mask [B, MC] (slot 0 = global view). ``training`` turns on the
    gate and selection noise (from ``noise`` or ``generator``).
    ``use_global_only`` / ``use_local_only`` keep only the global view or
    only the selected local tokens valid (the separator with neither).
    ``remat`` reaches the vision tower (``vit.apply``), as slime.py:116."""
    _check_supported(cfg)
    B, MC = pixel_values.shape[:2]
    P = cfg.vision.num_patches
    dim = cfg.mm_resampler_dim
    dev = pixel_values.device

    if pixel_values.dtype == torch.uint8:
        mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=dev).reshape(3, 1, 1)
        std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=dev).reshape(3, 1, 1)
        pixel_values = (pixel_values.to(torch.float32) / 255.0 - mean) / std

    noise = noise or {}
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and _any_requires_grad(params["vision"])):
        feats = vit.apply(params["vision"],
                          pixel_values.reshape(B * MC, *pixel_values.shape[2:])
                          .to(compute_dtype), cfg.vision, remat=remat)
    feats = feats.reshape(B, MC, P, -1)

    # global view: the full gated projector; local crops: compression, then
    # the projector (its MLP expert, since they are not 576 tokens long)
    global_f = projector.apply(params["projector"], feats[:, 0], cfg=cfg,
                               training=training, generator=generator,
                               noise=noise.get("gate"))
    local = feats[:, 1:].reshape(B * (MC - 1), P, -1)
    local_c = sampler.compress(params["sampler"], local, cfg=cfg)
    local_p = projector.apply(params["projector"], local_c, cfg=cfg)
    local_p = local_p.reshape(B, (MC - 1) * dim, -1)
    token_valid = crop_mask[:, 1:].to(torch.bool).repeat_interleave(dim, dim=1)

    text_emb, text_mask = _text_embeds_for_selector(params, input_ids, attention_mask)
    keep, _ = sampler.select(params["sampler"], local_p, text_emb, text_mask,
                             token_valid, cfg=cfg, training=training,
                             generator=generator, noise=noise.get("select"))

    sep = llama.embed(params["llm"], torch.full((B, 1), cfg.seperator,
                                                dtype=torch.long, device=dev))
    img_embeds = torch.cat([global_f.to(compute_dtype), sep.to(compute_dtype),
                            local_p.to(compute_dtype)], dim=1)
    ones = torch.ones((B, P), dtype=torch.bool, device=dev)
    sep_valid = torch.full((B, 1), not (cfg.use_global_only or cfg.use_local_only),
                           dtype=torch.bool, device=dev)
    if cfg.use_global_only:
        img_valid = torch.cat([ones, sep_valid, torch.zeros_like(keep)], dim=1)
    elif cfg.use_local_only:
        img_valid = torch.cat([~ones, sep_valid, keep], dim=1)
    else:
        img_valid = torch.cat([ones, sep_valid, keep], dim=1)
    return img_embeds, img_valid


def splice(text_emb, text_valid, text_labels, img_emb, img_valid, img_pos, *,
           max_len: int):
    """Batched ``_splice_one``: insert each sample's image block at img_pos
    [B] (S when it has none), then move the valid slots to a right-padded
    prefix of length max_len. Dropped slots (and overflow) land in an extra
    row max_len of the buffer, which is cut off."""
    B, S, H = text_emb.shape
    T = img_emb.shape[1]
    E = S + T
    dev = text_emb.device
    e = torch.arange(E, device=dev)[None]                       # [1, E]
    img_pos = img_pos[:, None]
    in_img = (e >= img_pos) & (e < img_pos + T)
    after = e >= img_pos + T
    src = torch.where(in_img, S + (e - img_pos), torch.where(after, e - T, e))
    src = src.clamp(0, E - 1)                                   # [B, E]

    full_emb = torch.cat([text_emb, img_emb], dim=1)
    full_valid = torch.cat([text_valid, img_valid], dim=1)
    full_labels = torch.cat([text_labels, torch.full((B, T), IGNORE_INDEX,
                                                     dtype=text_labels.dtype,
                                                     device=dev)], dim=1)
    emb_ext = torch.gather(full_emb, 1, src[..., None].expand(B, E, H))
    valid_ext = torch.gather(full_valid, 1, src)
    lab_ext = torch.gather(full_labels, 1, src)

    tgt = torch.cumsum(valid_ext.to(torch.int64), dim=1) - 1
    tgt = torch.where(valid_ext, tgt, max_len).clamp(max=max_len)
    rows = torch.arange(B, device=dev)[:, None].expand(B, E)
    out_emb = torch.zeros((B, max_len + 1, H), dtype=emb_ext.dtype, device=dev)
    out_emb[rows, tgt] = emb_ext
    out_lab = torch.full((B, max_len + 1), IGNORE_INDEX, dtype=lab_ext.dtype,
                         device=dev)
    out_lab[rows, tgt] = lab_ext
    out_emb, out_lab = out_emb[:, :max_len], out_lab[:, :max_len]
    length = valid_ext.sum(dim=1).clamp(max=max_len)
    mask = torch.arange(max_len, device=dev)[None] < length[:, None]
    out_lab = torch.where(mask, out_lab, IGNORE_INDEX)
    positions = torch.arange(max_len, dtype=torch.int32, device=dev).expand(B, max_len)
    return out_emb, mask, positions, out_lab, length.to(torch.int32)


def prepare_multimodal(params, cfg: SliMEConfig, input_ids, attention_mask,
                       pixel_values, crop_mask, labels=None, *,
                       training: bool = False,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[Dict] = None, max_len=None,
                       compute_dtype=torch.float32, remat: bool = False) -> FusedBatch:
    """Encode images and splice them into the token stream. Only the first
    IMAGE_TOKEN_INDEX sentinel per sample expands; later ones are dropped."""
    B, S = input_ids.shape
    if max_len is None:
        max_len = cfg.tokenizer_model_max_length
    img_embeds, img_valid = encode_images(params, cfg, pixel_values, crop_mask,
                                          input_ids, attention_mask,
                                          training=training, generator=generator,
                                          noise=noise, compute_dtype=compute_dtype,
                                          remat=remat)
    is_img = input_ids == IMAGE_TOKEN_INDEX
    text_emb = llama.embed(params["llm"], torch.where(is_img, 0, input_ids)
                           ).to(compute_dtype)
    text_valid = attention_mask.to(torch.bool) & ~is_img
    if labels is None:
        labels = torch.full_like(input_ids, IGNORE_INDEX)
    text_labels = torch.where(is_img, IGNORE_INDEX, labels)

    has_img = is_img.any(dim=1)
    first_img = is_img.to(torch.int8).argmax(dim=1)
    img_pos = torch.where(has_img, first_img, S)
    img_valid = img_valid & has_img[:, None]
    return FusedBatch(*splice(text_emb, text_valid, text_labels, img_embeds,
                              img_valid, img_pos, max_len=max_len))


def forward(params, cfg: SliMEConfig, input_ids, attention_mask, pixel_values,
            crop_mask, labels=None, *, training: bool = False,
            generator: Optional[torch.Generator] = None,
            noise: Optional[Dict] = None, use_kernel: Optional[bool] = None,
            compute_dtype=torch.float32, remat: bool = False,
            return_hidden: bool = False):
    """End to end -> (logits [B, L, V] fp32, or the final hidden states with
    ``return_hidden``; the FusedBatch). ``remat`` checkpoints each LLM layer
    and each vision block (slime.py:404-427)."""
    fused = prepare_multimodal(params, cfg, input_ids, attention_mask,
                               pixel_values, crop_mask, labels,
                               training=training, generator=generator,
                               noise=noise, compute_dtype=compute_dtype, remat=remat)
    out, _ = llama.forward(params["llm"], fused.embeds, cfg.llm,
                           positions=fused.positions, use_kernel=use_kernel,
                           compute_dtype=compute_dtype, remat=remat,
                           return_hidden=return_hidden)
    return out, fused


def loss_fn(params, cfg: SliMEConfig, batch, *, training: bool = True,
            generator: Optional[torch.Generator] = None,
            noise: Optional[Dict] = None, use_kernel: Optional[bool] = None,
            compute_dtype=torch.float32, remat: bool = False,
            loss_chunk="auto"):
    """Next-token cross entropy with IGNORE_INDEX masking (HF shift), the
    vocab projection chunked over the sequence -> (loss, metrics).

    ``loss_chunk="auto"`` chunks only at real vocab widths (V >= 16384);
    an int forces a chunk size, None one dense projection. A batch with
    ``segment_ids`` is a packed text-only batch: attention stays inside each
    segment, positions restart per segment (``batch["positions"]``), and a
    token is a target only when it continues its predecessor's segment."""
    if loss_chunk == "auto":
        loss_chunk = DEFAULT_LOSS_CHUNK if cfg.llm.vocab_size >= 16384 else None
    head = params["llm"]["lm_head"]
    if batch.get("segment_ids") is not None:
        seg = batch["segment_ids"]
        embeds = llama.embed(params["llm"], batch["input_ids"]).to(compute_dtype)
        hidden, _ = llama.forward(params["llm"], embeds, cfg.llm,
                                  positions=batch["positions"], segment_ids=seg,
                                  use_kernel=use_kernel, compute_dtype=compute_dtype,
                                  remat=remat, return_hidden=True)
        continues = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)
        prev_ok = torch.cat([torch.zeros_like(continues[:, :1]), continues], dim=1)
        labels = torch.where(prev_ok, batch["labels"], IGNORE_INDEX)
        total, count = chunked_cross_entropy(hidden, head, labels, chunk=loss_chunk)
        count = torch.clamp(count, min=1)
        return total / count, {"n_target_tokens": count,
                               "packing_efficiency": (seg > 0).to(torch.float32).mean()}
    hidden, fused = forward(params, cfg, batch["input_ids"], batch["attention_mask"],
                            batch["pixel_values"], batch["crop_mask"],
                            batch.get("labels"), training=training,
                            generator=generator, noise=noise, use_kernel=use_kernel,
                            compute_dtype=compute_dtype, remat=remat,
                            return_hidden=True)
    total, count = chunked_cross_entropy(hidden, head, fused.labels, chunk=loss_chunk)
    count = torch.clamp(count, min=1)
    return total / count, {"n_target_tokens": count}
