"""Checkpoints: the quantized load's quantization step, and the export side.

- ``quantize_loaded`` is the quantization step of the JAX package's
  ``load_pretrained`` (``slime_tpu/checkpoint.py:368-393``): the CLI's
  ``--load-4bit/--load-8bit --int4-scheme``, ``--quantize-lm-head`` and
  ``--quantize-vision`` applied to fp parameters. Loading checkpoint files
  is not ported yet (ROADMAP, Queue 1 step 7).
- ``export_*`` and ``save_checkpoint`` are the port's copies of
  ``checkpoint.py:416-583``: our parameter trees -> the reference's flat
  state dicts and files (``config.json`` + ``model.safetensors`` or
  ``pytorch_model.bin``, or the staged pretraining's ``mm_projector.bin`` /
  ``sampler.bin``), byte for byte what the JAX package writes for the same
  values. Each tensor is saved as its own compact CPU copy, so a view into a
  stacked ``[L, ...]`` weight never drags its whole storage into the file.
"""
from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

from .config import LLMConfig, SliMEConfig
from .models import llama, vit
from .ops.quantization import quantize_params

Tensors = Dict[str, torch.Tensor]


def quantize_loaded(params: Dict, cfg: SliMEConfig, *, load_bits=None,
                    int4_scheme: str = "default", quantize_lm_head: bool = False,
                    quantize_vision: bool = False) -> Dict:
    """fp parameters -> the quantized serving tree, in place of the subtrees
    it converts (list-of-layers LLM, before ``llama.stack_layers``):

    - ``load_bits`` 4 or 8: the LLM layers through ``quantize_params``
      (``min_size=1024``; int4 ``scheme`` ``default`` NF4, ``absmax`` per-row
      q4, ``group`` q4g, with per-row q4 where ``in % 256 != 0``);
    - ``quantize_lm_head``: per-row int8 ``lm_head``;
    - ``quantize_vision``: the W8A8 vision tower (``vit.quantize_tower``).
    Embeddings, norms, the projector and the sampler stay as they are."""
    if load_bits in (4, 8):
        params["llm"]["layers"] = quantize_params(params["llm"]["layers"], bits=load_bits,
                                                  min_size=1024, scheme=int4_scheme)
    if quantize_lm_head:
        params["llm"]["lm_head"] = quantize_params(params["llm"]["lm_head"], bits=8,
                                                   min_size=1024)
    if quantize_vision and "vision" in params:
        params["vision"] = vit.quantize_tower(params["vision"], cfg.vision)
    return params


def _t(v) -> torch.Tensor:
    """A compact, detached CPU tensor of a leaf (tensor or numpy array)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").clone(memory_format=torch.contiguous_format)
    return torch.from_numpy(np.ascontiguousarray(v))


def export_resampler(p: Dict, prefix: str) -> Tensors:
    out: Tensors = {f"{prefix}pos_embed": _t(p["pos_embed"]),
                    f"{prefix}query": _t(p["query"])}
    for name in ("attn", "self_attn"):
        if name in p:
            out[f"{prefix}{name}.in_proj_weight"] = _t(p[name]["in_proj_weight"])
            out[f"{prefix}{name}.in_proj_bias"] = _t(p[name]["in_proj_bias"])
            out[f"{prefix}{name}.out_proj.weight"] = _t(p[name]["out_proj"]["weight"])
            out[f"{prefix}{name}.out_proj.bias"] = _t(p[name]["out_proj"]["bias"])
    for ln in ("ln_q", "ln_kv", "ln_post"):
        out[f"{prefix}{ln}.weight"] = _t(p[ln]["weight"])
        out[f"{prefix}{ln}.bias"] = _t(p[ln]["bias"])
    if "kv_proj" in p:
        out[f"{prefix}kv_proj.weight"] = _t(p["kv_proj"]["weight"])
    if "proj" in p:
        out[f"{prefix}proj.weight"] = _t(p["proj"]["weight"])
        out[f"{prefix}proj.bias"] = _t(p["proj"]["bias"])
    return out


def export_projector(p: Dict, cfg: SliMEConfig, prefix: str = "model.mm_projector.") -> Tensors:
    t = cfg.mm_projector_type
    out: Tensors = {}
    if t == "linear":
        return {f"{prefix}weight": _t(p["proj"]["weight"]),
                f"{prefix}bias": _t(p["proj"]["bias"])}
    if re.match(r"^mlp(\d+)x_gelu$", t):
        for i, lp in enumerate(p["mlp"]["layers"]):
            out[f"{prefix}{2 * i}.weight"] = _t(lp["weight"])
            out[f"{prefix}{2 * i}.bias"] = _t(lp["bias"])
        return out
    if t == "qformer":
        return export_resampler(p["resampler"], prefix)
    if t != "gated":
        raise ValueError(f"unknown projector type {t!r}")
    for i, lp in enumerate(p["projection"]["layers"]):
        out[f"{prefix}projection.{2 * i}.weight"] = _t(lp["weight"])
        out[f"{prefix}projection.{2 * i}.bias"] = _t(lp["bias"])
    out.update(export_resampler(p["attn"], f"{prefix}attn."))
    out[f"{prefix}w_gate"] = _t(p["w_gate"])
    out[f"{prefix}w_noise"] = _t(p["w_noise"])
    # constant buffers the reference's GatedBlock persists
    # (multimodal_projector/builder.py:69-70); its strict load expects them
    out[f"{prefix}mean"] = torch.zeros((1,), dtype=torch.float32)
    out[f"{prefix}std"] = torch.ones((1,), dtype=torch.float32)
    return out


def export_sampler(p: Dict, cfg: SliMEConfig, prefix: str = "model.sampler.") -> Tensors:
    out = export_resampler(p["post_qformer"], f"{prefix}post_qformer.")
    if "selector" in p:
        sel, sp = p["selector"], f"{prefix}selector."
        out[f"{sp}query"] = _t(sel["query"])
        for name in ("self_attn", "cross_attn"):
            out[f"{sp}{name}.in_proj_weight"] = _t(sel[name]["in_proj_weight"])
            out[f"{sp}{name}.in_proj_bias"] = _t(sel[name]["in_proj_bias"])
            out[f"{sp}{name}.out_proj.weight"] = _t(sel[name]["out_proj"]["weight"])
            out[f"{sp}{name}.out_proj.bias"] = _t(sel[name]["out_proj"]["bias"])
        for ln in ("ln_q", "ln_kv", "ln_post"):
            out[f"{sp}{ln}.weight"] = _t(sel[ln]["weight"])
            out[f"{sp}{ln}.bias"] = _t(sel[ln]["bias"])
        out[f"{sp}prob_proj.0.weight"] = _t(sel["prob_proj"]["fc1"]["weight"])
        out[f"{sp}prob_proj.0.bias"] = _t(sel["prob_proj"]["fc1"]["bias"])
        out[f"{sp}prob_proj.2.weight"] = _t(sel["prob_proj"]["fc2"]["weight"])
        out[f"{sp}prob_proj.2.bias"] = _t(sel["prob_proj"]["fc2"]["bias"])
    return out


def export_llama(p: Dict, cfg: LLMConfig, prefix: str = "model.") -> Tensors:
    out: Tensors = {f"{prefix}embed_tokens.weight": _t(p["embed_tokens"]),
                    f"{prefix}norm.weight": _t(p["norm"]["weight"])}
    layers = p["layers"]
    if isinstance(layers, dict):   # stacked [L, ...] storage
        layers = [llama._layer(layers, i) for i in range(cfg.num_layers)]
    for i, lp in enumerate(layers):
        b = f"{prefix}layers.{i}"
        out[f"{b}.input_layernorm.weight"] = _t(lp["input_layernorm"]["weight"])
        out[f"{b}.post_attention_layernorm.weight"] = _t(lp["post_attention_layernorm"]["weight"])
        for nm in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{b}.self_attn.{nm}.weight"] = _t(lp[nm]["weight"])
            if "bias" in lp[nm]:
                out[f"{b}.self_attn.{nm}.bias"] = _t(lp[nm]["bias"])
        if cfg.num_experts > 0:
            out[f"{b}.block_sparse_moe.gate.weight"] = _t(lp["gate"]["weight"])
            for e in range(cfg.num_experts):
                for wn in ("w1", "w2", "w3"):
                    out[f"{b}.block_sparse_moe.experts.{e}.{wn}.weight"] = \
                        _t(lp["experts"][wn][e])
        else:
            for nm in ("gate_proj", "up_proj", "down_proj"):
                out[f"{b}.mlp.{nm}.weight"] = _t(lp[nm]["weight"])
    out["lm_head.weight"] = _t(p["lm_head"]["weight"])
    return out


def export_state_dict(params: Dict, cfg: SliMEConfig) -> Tensors:
    """Full model -> the reference's flat state dict (llava key names)."""
    sd = export_llama(params["llm"], cfg.llm)
    sd.update(export_projector(params["projector"], cfg))
    if "sampler" in params and cfg.has_sampler:
        sd.update(export_sampler(params["sampler"], cfg))
    if "vision" in params:
        v = params["vision"]
        vp = "model.vision_tower.vision_tower.vision_model."
        E, ps = cfg.vision.hidden_size, cfg.vision.patch_size
        sd[f"{vp}embeddings.class_embedding"] = _t(v["class_embedding"])
        sd[f"{vp}embeddings.patch_embedding.weight"] = \
            _t(v["patch_embedding"]).reshape(E, 3, ps, ps)
        sd[f"{vp}embeddings.position_embedding.weight"] = _t(v["position_embedding"])
        sd[f"{vp}pre_layrnorm.weight"] = _t(v["pre_layernorm"]["weight"])
        sd[f"{vp}pre_layrnorm.bias"] = _t(v["pre_layernorm"]["bias"])
        if "post_layernorm" in v:
            sd[f"{vp}post_layernorm.weight"] = _t(v["post_layernorm"]["weight"])
            sd[f"{vp}post_layernorm.bias"] = _t(v["post_layernorm"]["bias"])
        for i, lp in enumerate(v["layers"]):
            b = f"{vp}encoder.layers.{i}"
            for nm in ("layer_norm1", "layer_norm2"):
                sd[f"{b}.{nm}.weight"] = _t(lp[nm]["weight"])
                sd[f"{b}.{nm}.bias"] = _t(lp[nm]["bias"])
            for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{b}.self_attn.{nm}.weight"] = _t(lp[nm]["weight"])
                sd[f"{b}.self_attn.{nm}.bias"] = _t(lp[nm]["bias"])
            for nm in ("fc1", "fc2"):
                sd[f"{b}.mlp.{nm}.weight"] = _t(lp[nm]["weight"])
                sd[f"{b}.mlp.{nm}.bias"] = _t(lp[nm]["bias"])
    return sd


def save_checkpoint(path: str, params: Dict, cfg: SliMEConfig, *,
                    adapters_only: bool = False) -> None:
    """Write a checkpoint directory: config.json + weights. ``adapters_only``
    writes the staged pretraining's ``mm_projector.bin`` + ``sampler.bin``
    (llava_trainer.py:248-276) so the reference loads them unchanged."""
    os.makedirs(path, exist_ok=True)
    cfg.save(path)
    if adapters_only:
        torch.save(export_projector(params["projector"], cfg),
                   os.path.join(path, "mm_projector.bin"))
        if "sampler" in params and cfg.has_sampler:
            torch.save(export_sampler(params["sampler"], cfg),
                       os.path.join(path, "sampler.bin"))
        return
    sd = export_state_dict(params, cfg)
    try:
        from safetensors.torch import save_file
    except ImportError:
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    else:
        save_file(sd, os.path.join(path, "model.safetensors"))
