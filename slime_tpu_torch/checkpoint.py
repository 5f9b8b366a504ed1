"""Checkpoints: loading, the quantized load's quantization step, and export.

- ``load_pretrained`` is the JAX package's loader (``slime_tpu/checkpoint.py:
  21-394``, numpy only): HF/torch state dicts (safetensors or .bin, sharded
  or not) onto our parameter trees in three of the reference's four load
  modes (llava/model/builder.py:26-173): a full checkpoint, a base model
  plus the staged pretraining's ``mm_projector.bin`` / ``sampler.bin``, a
  LoRA checkpoint merged at load into ``model_base`` (:85-101, :308-365), and
  a plain LM. It returns
  CPU tensors with list layers; ``to_torch`` casts and moves them and
  ``load_for_serving`` also stacks the layers, as the serving entry points
  need them.
- ``quantize_loaded`` is its quantization step (``checkpoint.py:368-393``):
  the CLI's ``--load-4bit/--load-8bit --int4-scheme``,
  ``--quantize-lm-head`` and ``--quantize-vision`` applied to fp parameters.
- ``export_*`` and ``save_checkpoint`` are the port's copies of
  ``checkpoint.py:416-583``: our parameter trees -> the reference's flat
  state dicts and files (``config.json`` + ``model.safetensors`` or
  ``pytorch_model.bin``, or the staged pretraining's ``mm_projector.bin`` /
  ``sampler.bin``), byte for byte what the JAX package writes for the same
  values. Each tensor is saved as its own compact CPU copy, so a view into a
  stacked ``[L, ...]`` weight never drags its whole storage into the file.
  ``save_lora_checkpoint`` (:586) writes the reference's LoRA split
  (``adapter_config.json``, ``adapter_model.bin`` with PEFT key names,
  ``non_lora_trainables.bin``), byte for byte the JAX package's files.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .config import LLMConfig, SliMEConfig, VisionConfig
from .models import llama, vit
from .models.layers import resolve_device
from .ops.quantization import is_quantized, quantize_params
from .parallel.mesh import shard_params

Tensors = Dict[str, torch.Tensor]


def _np(x) -> np.ndarray:
    """torch tensor / array-like -> float32 numpy (bf16-safe)."""
    if hasattr(x, "detach"):
        x = x.detach()
        if str(x.dtype) in ("torch.bfloat16", "torch.float16"):
            x = x.float()
        x = x.cpu().numpy()
    return np.asarray(x)


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """Load a .safetensors or torch .bin file into numpy arrays (bf16 tensors
    as fp32)."""
    if path.endswith(".safetensors"):
        from safetensors import safe_open
        out = {}
        with safe_open(path, framework="np") as f:
            for k in f.keys():
                try:
                    out[k] = f.get_tensor(k)
                    if out[k].dtype.name == "bfloat16":
                        # numpy holds bf16 only where ml_dtypes is loaded;
                        # torch takes no such array: fp32, as the path below
                        out[k] = out[k].astype(np.float32)
                except Exception:
                    # bf16 tensors can't map to numpy directly; go through torch
                    from safetensors.torch import load_file
                    return {k: _np(v) for k, v in load_file(path).items()}
        return out
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np(v) for k, v in sd.items()}


def load_sharded_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """Load all weight shards in an HF model directory."""
    index_files = [f for f in os.listdir(model_dir)
                   if f.endswith(".index.json")]
    files: Iterable[str]
    if index_files:
        with open(os.path.join(model_dir, index_files[0])) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(model_dir)
                       if f.endswith((".safetensors", ".bin"))
                       and not f.startswith("training_args"))
    sd: Dict[str, np.ndarray] = {}
    for fn in files:
        sd.update(load_state_dict_file(os.path.join(model_dir, fn)))
    return sd


def _strip(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _normalize_peft_prefixes(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip PEFT wrapper prefixes the reference strips at load
    (builder.py:69-75): 'base_model.' first, then one redundant leading 'model.'
    when keys start 'model.model.' (named_parameters of a PEFT-wrapped model)."""
    sd = {(k[len("base_model."):] if k.startswith("base_model.") else k): v
          for k, v in sd.items()}
    if any(k.startswith("model.model.") for k in sd):
        sd = {(k[len("model."):] if k.startswith("model.") else k): v
              for k, v in sd.items()}
    return sd


# ----------------------------------------------------------------------------------
# Per-module converters: torch key set -> our pytree layout.
# ----------------------------------------------------------------------------------

def _lora_rank_alpha(model_path: str, lora_sd: Dict[str, np.ndarray]):
    """(r, alpha) from adapter_config.json, else the rank from the factors'
    shapes and alpha = 2r (the reference's r = 128, alpha = 256)."""
    cfg_fp = os.path.join(model_path, "adapter_config.json")
    ac = {}
    if os.path.exists(cfg_fp):
        with open(cfg_fp) as f:
            ac = json.load(f)
        if "r" in ac:
            return int(ac["r"]), int(ac.get("lora_alpha", 2 * ac["r"]))
    r = next((v.shape[0] for k, v in lora_sd.items() if ".lora_A." in k), None)
    if r is None:
        raise ValueError(
            f"cannot infer LoRA rank for {model_path}: adapter_config.json has "
            "no 'r' and no '.lora_A.' factors were found in the adapter state "
            "dict (unsupported adapter naming?)")
    return int(r), int(ac.get("lora_alpha", 2 * r))


def _merge_lora(params: Dict, model_path: str, lora_sd: Dict[str, np.ndarray]) -> None:
    """W <- W + (alpha / r) B A in place on the numpy tree (PEFT's
    merge_and_unload); refuses adapters that map onto no loaded weight."""
    from .train import lora as lora_lib
    r, alpha = _lora_rank_alpha(model_path, lora_sd)
    state = lora_lib.import_peft(lora_sd, r=r, alpha=alpha)
    scale = alpha / r
    merged = 0
    for path, ab in state["adapters"].items():
        node = params
        for part in path.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        w = np.asarray(node["weight"], np.float32)
        delta = scale * (np.asarray(ab["B"], np.float32) @ np.asarray(ab["A"], np.float32))
        node["weight"] = (w + delta).astype(np.asarray(node["weight"]).dtype)
        merged += 1
    if not merged:
        raise ValueError(f"LoRA adapter keys in {model_path} did not map onto any "
                         "loaded weights: key-name mismatch, refusing to return an "
                         "unmerged model")


def _lin(sd, key, bias=True):
    pre = f"{key}." if key else ""
    p = {"weight": sd[f"{pre}weight"]}
    if bias and f"{pre}bias" in sd:
        p["bias"] = sd[f"{pre}bias"]
    return p


def _ln(sd, key):
    return {"weight": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _mha(sd, key):
    return {"in_proj_weight": sd[f"{key}.in_proj_weight"],
            "in_proj_bias": sd[f"{key}.in_proj_bias"],
            "out_proj": _lin(sd, f"{key}.out_proj")}


def convert_resampler(sd: Dict[str, np.ndarray], prefix: str = "") -> Dict:
    """Resampler state dict (sampler.py:91-173) -> resampler.init() layout."""
    sd = _strip(sd, prefix) if prefix else sd
    p = {
        "pos_embed": sd["pos_embed"].astype(np.float32),
        "query": sd["query"],
        "attn": _mha(sd, "attn"),
        "ln_q": _ln(sd, "ln_q"),
        "ln_kv": _ln(sd, "ln_kv"),
        "ln_post": _ln(sd, "ln_post"),
    }
    if "kv_proj.weight" in sd:
        p["kv_proj"] = _lin(sd, "kv_proj", bias=False)
    if "proj.weight" in sd:
        p["proj"] = _lin(sd, "proj")
    if "self_attn.in_proj_weight" in sd:
        p["self_attn"] = _mha(sd, "self_attn")
    return p


def convert_projector(sd: Dict[str, np.ndarray], cfg: SliMEConfig,
                      prefix: str = "") -> Dict:
    """mm_projector state dict -> projector.init() layout.

    Gated keys (builder.py:38-74): projection.{0,2}.{weight,bias}, attn.*, w_gate, w_noise.
    """
    sd = _strip(sd, prefix) if prefix else sd
    t = cfg.mm_projector_type
    if t == "linear":
        return {"proj": _lin(sd, "0") if "0.weight" in sd else _lin(sd, "")}
    m = re.match(r"^mlp(\d+)x_gelu$", t)
    if m:
        depth = int(m.group(1))
        return {"mlp": {"layers": [_lin(sd, str(2 * i)) for i in range(depth)]}}
    if t == "qformer":
        return {"resampler": convert_resampler(sd)}
    assert t == "gated", t
    return {
        "projection": {"layers": [_lin(sd, "projection.0"), _lin(sd, "projection.2")]},
        "attn": convert_resampler(sd, "attn."),
        "w_gate": sd["w_gate"].astype(np.float32),
        "w_noise": sd["w_noise"].astype(np.float32),
    }


def convert_sampler(sd: Dict[str, np.ndarray], cfg: SliMEConfig,
                    prefix: str = "") -> Dict:
    """TextGuidedSampler state dict (builder.py:222-281) -> sampler.init() layout."""
    sd = _strip(sd, prefix) if prefix else sd
    p: Dict = {"post_qformer": convert_resampler(sd, "post_qformer.")}
    if cfg.mm_resampler_type == "qformer":
        sel = _strip(sd, "selector.")
        p["selector"] = {
            "query": sel["query"],
            "self_attn": _mha(sel, "self_attn"),
            "cross_attn": _mha(sel, "cross_attn"),
            "ln_q": _ln(sel, "ln_q"),
            "ln_kv": _ln(sel, "ln_kv"),
            "ln_post": _ln(sel, "ln_post"),
            "prob_proj": {"fc1": _lin(sel, "prob_proj.0"),
                          "fc2": _lin(sel, "prob_proj.2")},
        }
    return p


def convert_clip_vision(sd: Dict[str, np.ndarray], cfg: VisionConfig,
                        prefix: str = "vision_model.") -> Dict:
    """HF CLIPVisionModel state dict -> vit.init() layout.

    The patch-embed conv [E,3,ph,pw] flattens to the matmul weight [E, 3*ph*pw] in
    the order matching vit.embed_patches' (c, ph, pw) patch flattening.
    """
    sd = _strip(sd, prefix) if prefix else sd
    E = cfg.hidden_size
    conv = sd["embeddings.patch_embedding.weight"]  # [E, 3, ph, pw]
    params = {
        "class_embedding": sd["embeddings.class_embedding"].reshape(E),
        "patch_embedding": conv.reshape(E, -1),
        "position_embedding": sd["embeddings.position_embedding.weight"],
        "pre_layernorm": _ln(sd, "pre_layrnorm"),  # HF's historical typo
        "layers": [],
    }
    if "post_layernorm.weight" in sd:  # absent from pre-round-2 saves
        params["post_layernorm"] = _ln(sd, "post_layernorm")
    for i in range(cfg.num_layers):
        b = f"encoder.layers.{i}"
        params["layers"].append({
            "layer_norm1": _ln(sd, f"{b}.layer_norm1"),
            "q_proj": _lin(sd, f"{b}.self_attn.q_proj"),
            "k_proj": _lin(sd, f"{b}.self_attn.k_proj"),
            "v_proj": _lin(sd, f"{b}.self_attn.v_proj"),
            "out_proj": _lin(sd, f"{b}.self_attn.out_proj"),
            "layer_norm2": _ln(sd, f"{b}.layer_norm2"),
            "fc1": _lin(sd, f"{b}.mlp.fc1"),
            "fc2": _lin(sd, f"{b}.mlp.fc2"),
        })
    return params


def convert_llama(sd: Dict[str, np.ndarray], cfg: LLMConfig,
                  prefix: str = "model.") -> Dict:
    """HF LlamaForCausalLM state dict -> llama.init() layout."""
    body = _strip(sd, prefix) if prefix else sd
    params = {
        "embed_tokens": body["embed_tokens.weight"],
        "norm": {"weight": body["norm.weight"]},
        "layers": [],
    }
    for i in range(cfg.num_layers):
        b = f"layers.{i}"
        lp = {
            "input_layernorm": {"weight": body[f"{b}.input_layernorm.weight"]},
            "q_proj": _lin(body, f"{b}.self_attn.q_proj"),
            "k_proj": _lin(body, f"{b}.self_attn.k_proj"),
            "v_proj": _lin(body, f"{b}.self_attn.v_proj"),
            "o_proj": _lin(body, f"{b}.self_attn.o_proj"),
            "post_attention_layernorm": {"weight": body[f"{b}.post_attention_layernorm.weight"]},
        }
        if cfg.num_experts > 0:
            lp["gate"] = _lin(body, f"{b}.block_sparse_moe.gate", bias=False)
            lp["experts"] = {
                "w1": np.stack([body[f"{b}.block_sparse_moe.experts.{e}.w1.weight"]
                                for e in range(cfg.num_experts)]),
                "w2": np.stack([body[f"{b}.block_sparse_moe.experts.{e}.w2.weight"]
                                for e in range(cfg.num_experts)]),
                "w3": np.stack([body[f"{b}.block_sparse_moe.experts.{e}.w3.weight"]
                                for e in range(cfg.num_experts)]),
            }
        else:
            lp["gate_proj"] = _lin(body, f"{b}.mlp.gate_proj")
            lp["up_proj"] = _lin(body, f"{b}.mlp.up_proj")
            lp["down_proj"] = _lin(body, f"{b}.mlp.down_proj")
        params["layers"].append(lp)
    if "lm_head.weight" in sd:
        params["lm_head"] = {"weight": sd["lm_head.weight"]}
    else:  # tied embeddings
        params["lm_head"] = {"weight": params["embed_tokens"]}
    return params


def load_pretrained(model_path: str, *, model_base: Optional[str] = None,
                    cfg: Optional[SliMEConfig] = None, vision_path: Optional[str] = None,
                    load_bits: Optional[int] = None, quantize_lm_head: bool = False,
                    quantize_vision: bool = False, int4_scheme: str = "default") -> Dict:
    """A SliME checkpoint directory -> the parameter tree {vision, projector,
    sampler, llm} as CPU tensors (list layers), the JAX package's
    ``load_pretrained`` leaf for leaf: a full checkpoint, ``model_base``
    overlaid by this directory's files (``mm_projector.bin`` /
    ``sampler.bin`` adapters), a LoRA checkpoint (``adapter_model.*`` or
    inline ``lora_*`` keys) merged into ``model_base`` (without one it
    raises ValueError), or a plain LM. ``load_bits`` 4/8, ``int4_scheme``,
    ``quantize_lm_head`` and ``quantize_vision`` go through
    ``quantize_loaded``, after the merge."""
    if cfg is None:
        cfg = SliMEConfig.load(model_path)
    sd = load_sharded_state_dict(model_path)
    # adapter files next to a base model, each gated on its own key prefixes
    for extra, prefixes in (
            ("mm_projector.bin", ("model.mm_projector.",)),
            ("sampler.bin", ("model.sampler.",)),
            ("non_lora_trainables.bin", ("model.mm_projector.", "model.sampler."))):
        fp = os.path.join(model_path, extra)
        if not os.path.exists(fp):
            continue
        if all(any(k.startswith(p) for k in sd) for p in prefixes):
            continue  # index-less dirs read the .bin files with the shards
        sd.update(_normalize_peft_prefixes(load_state_dict_file(fp)))
    # the LoRA load mode (builder.py:52-91): low-rank factors in
    # adapter_model.{safetensors,bin} (or inline lora_* keys), merged below
    adapter_fp = next((os.path.join(model_path, f)
                       for f in ("adapter_model.safetensors", "adapter_model.bin")
                       if os.path.exists(os.path.join(model_path, f))), None)
    lora_sd = (load_state_dict_file(adapter_fp) if adapter_fp
               else {k: v for k, v in sd.items() if ".lora_A." in k or ".lora_B." in k})
    if lora_sd and model_base is None:
        raise ValueError(
            f"{model_path} is a LoRA checkpoint (low-rank adapter factors found): "
            "pass model_base so the adapters can be merged into the base weights "
            "(reference builder.py:52-91)")
    if model_base is not None:
        base = load_sharded_state_dict(model_base)
        base.update(sd)
        sd = base

    params: Dict = {}
    params["llm"] = convert_llama(
        {k: v for k, v in sd.items()
         if not k.startswith(("model.vision_tower", "model.mm_projector", "model.sampler"))},
        cfg.llm)
    params["projector"] = convert_projector(_strip(sd, "model.mm_projector."), cfg)
    if cfg.has_sampler:
        params["sampler"] = convert_sampler(_strip(sd, "model.sampler."), cfg)
    vt = _strip(sd, "model.vision_tower.vision_tower.")
    if vt:
        params["vision"] = convert_clip_vision(vt, cfg.vision)
    elif vision_path:
        params["vision"] = convert_clip_vision(load_sharded_state_dict(vision_path), cfg.vision)
    if lora_sd:
        _merge_lora(params, model_path, lora_sd)
    return quantize_loaded(_as_tensors(params), cfg, load_bits=load_bits,
                           int4_scheme=int4_scheme, quantize_lm_head=quantize_lm_head,
                           quantize_vision=quantize_vision)


def _as_tensors(tree):
    """numpy tree -> CPU tensors sharing nothing with the loaded arrays
    (a tied lm_head becomes its own copy of the embedding)."""
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def to_torch(params, dtype=None, device=None):
    """A loaded tree (tensors or numpy arrays) -> tensors on ``device`` (the
    current CUDA device when None), floating leaves cast to ``dtype``
    except the fp32 scales of quantized weights (JAX's ``to_jax``)."""
    device = resolve_device(device)

    def conv(x, keep_fp32=False):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        if dtype is not None and not keep_fp32 and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    def walk(node):
        if is_quantized(node):
            return {k: conv(v, keep_fp32=(k == "scale")) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return conv(node)
    return walk(params)


def load_for_serving(model_path: str, *, device=None, dtype=torch.bfloat16,
                     cfg: Optional[SliMEConfig] = None, mesh=None, **load_kw) -> Dict:
    """What the serving entry points load: ``load_pretrained``, then
    ``to_torch`` (``dtype`` on ``device``) and the LLM layers stacked for
    ``generate`` and the fused decode. Under a ``mesh`` (tensor-parallel
    serving, where the fused decode is off) the tree is cast on the CPU and
    each rank moves only its shard to its card (``parallel.mesh.
    shard_params``), the LLM layers a list that the rule table splits."""
    params = load_pretrained(model_path, cfg=cfg, **load_kw)
    if mesh is not None:
        return shard_params(mesh, to_torch(params, dtype, "cpu"))
    params = to_torch(params, dtype, device)
    params["llm"]["layers"] = llama.stack_layers(params["llm"]["layers"])
    return params


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


def save_lora_checkpoint(path: str, params: Dict, lora_state: Dict,
                         cfg: SliMEConfig) -> None:
    """Write the reference's LoRA checkpoint directory (train.py:1185-1196):
    config.json, adapter_config.json, adapter_model.bin (PEFT key names) and
    non_lora_trainables.bin (the projector and sampler trained outside
    PEFT). ``load_pretrained(path, model_base=...)`` merges it back."""
    from .train.lora import export_peft

    os.makedirs(path, exist_ok=True)
    cfg.save(path)
    targets = sorted({p.rsplit("/", 1)[-1] for p in lora_state["adapters"]})
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": int(lora_state["rank"]),
                   "lora_alpha": int(lora_state["alpha"]),
                   "lora_dropout": 0.0, "bias": "none",
                   "target_modules": targets,
                   "task_type": "CAUSAL_LM"}, f, indent=2)
    torch.save(export_peft(lora_state), os.path.join(path, "adapter_model.bin"))
    non_lora: Tensors = {}
    if "projector" in params:
        non_lora.update(export_projector(params["projector"], cfg))
    if "sampler" in params and cfg.has_sampler:
        non_lora.update(export_sampler(params["sampler"], cfg))
    if non_lora:
        torch.save(non_lora, os.path.join(path, "non_lora_trainables.bin"))
