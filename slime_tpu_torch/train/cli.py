"""The training command line: the port's ``scripts/train_slime.py``.

The same flags, names and defaults (``scripts/train_slime.py:26-116``, the
reference's ModelArguments / DataArguments / TrainingArguments) and the same
flow (:118-314): the config with the run's overrides; weights from a
checkpoint directory, or random ones from ``--seed`` when it holds only a
``config.json``; the LLM quantized for QLoRA (``--bits 8/4`` with
``--lora-enable``: int8, or NF4); the staged adapters' warm starts; the
dataset (``data.dataset.SupervisedDataset``, or ``data.dpo.PreferenceDataset``
under ``--task DPO``), its loader, the pair loader or the packed loader
(``--seq-packing``, text-only SFT); the ``Trainer`` (LoRA mode with
``--lora-enable``; DPO with ``--task DPO``, against ``--ref-model-path`` or
the starting weights, or LoRA-DPO against the frozen base; 8-bit Adam
moments with ``--optim adamw8bit``; gradient accumulation; resume from the
latest ``state-<step>`` in ``--output-dir``); and the final save, which
writes the JAX CLI's files. ``--device`` (the port's own flag) picks where it
runs: the current CUDA device unless it says otherwise.

    python -m slime_tpu_torch.train.cli --model-path DIR --data-path data.json \\
        --image-folder IMAGES --output-dir OUT --version llama3 \\
        --lora-enable --bits 4 --remat

    python -m slime_tpu_torch.train.cli ... --task DPO --dpo-beta 0.1 \\
        --dpo-loss-type sigmoid --lora-enable --bits 4

JAX's refusals are kept: ``--bits 8/4`` without ``--lora-enable``,
``--seq-packing`` with ``--task DPO``, ``--ref-model-path`` with
``--lora-enable``.

Several cards, one process each, under torchrun's environment:

    torchrun --nproc-per-node N -m slime_tpu_torch.train.cli ... --mesh-fsdp N

``--mesh-data`` x ``--mesh-fsdp`` x ``--mesh-model`` must equal the world
size (``--mesh-fsdp`` unset takes what is left, as JAX's); the loader yields
the global batch, ``--per-device-batch-size`` x data x fsdp
(``scripts/train_slime.py:227-234``), and each rank feeds its rows of it.
``--device cpu`` runs the ranks over gloo.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import random
from typing import Optional, Sequence

import torch



def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # model args (reference ModelArguments)
    ap.add_argument("--model-path", required=True,
                    help="checkpoint dir (config.json + weights) or config-only dir")
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--version", default="v1",
                    help="conversation template: plain|v1|llama3|mpt")
    ap.add_argument("--tune-mm-mlp-adapter", action="store_true")
    ap.add_argument("--freeze-mm-mlp-adapter", action="store_true")
    ap.add_argument("--freeze-backbone", action="store_true")
    ap.add_argument("--mm-learnable-gated", type=int, default=-1)
    ap.add_argument("--use-global-only", action="store_true")
    ap.add_argument("--use-local-only", action="store_true")
    ap.add_argument("--pretrain-mm-mlp-adapter", default=None)
    ap.add_argument("--pretrain-mm-re-sampler", default=None)
    # data args
    ap.add_argument("--data-path", nargs="+", required=True)
    ap.add_argument("--image-folder", default="")
    ap.add_argument("--image-aspect-ratio", default="anyres")
    ap.add_argument("--pixel-dtype", default="uint8", choices=["uint8", "float32"],
                    help="pixel transport: uint8 ships raw crops and CLIP-normalizes "
                         "on the device; float32 ships normalized crops")
    ap.add_argument("--group-by-modality-length", action="store_true")
    ap.add_argument("--seq-packing", action="store_true",
                    help="pack text-only examples into full sequences (block-diagonal "
                         "attention, exact loss; data/packing.py); refuses multimodal "
                         "datasets")
    # training args
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--per-device-batch-size", type=int, default=8)
    ap.add_argument("--gradient-accumulation-steps", type=int, default=1)
    ap.add_argument("--num-train-epochs", type=int, default=1)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--learning-rate", type=float, default=2e-5)
    ap.add_argument("--mm-projector-lr", type=float, default=None)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--warmup-ratio", type=float, default=0.03)
    ap.add_argument("--lr-scheduler-type", default="cosine")
    ap.add_argument("--optim", default="adamw", choices=["adamw", "adamw8bit"],
                    help="adamw8bit stores Adam moments as blockwise int8 "
                         "(~2.06 B/param vs 8: train/opt8.py)")
    ap.add_argument("--model-max-length", type=int, default=2048)
    ap.add_argument("--save-steps", type=int, default=1000)
    ap.add_argument("--async-save", action="store_true",
                    help="train-state saves written in the background")
    ap.add_argument("--logging-steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=3407)
    # DPO (the reference's --task DPO fields, train.py:133-166: train/dpo.py
    # and data/dpo.py)
    ap.add_argument("--task", default="SFT", choices=["SFT", "DPO"],
                    help="SFT, or DPO over preference pairs (records with "
                         "chosen/rejected or output_1/output_2 + preference)")
    ap.add_argument("--dpo-beta", type=float, default=0.1)
    ap.add_argument("--dpo-loss-type", default="sigmoid",
                    choices=["sigmoid", "ipo", "kto_pair"])
    ap.add_argument("--dpo-use-average", action="store_true",
                    help="average per-token log-probs instead of sums")
    ap.add_argument("--dpo-token-weighted", action="store_true",
                    help="up-weight tokens where chosen/rejected differ")
    ap.add_argument("--dpo-token-weight", type=float, default=1.1)
    ap.add_argument("--sft-weight", type=float, default=0.0,
                    help="mix in plain NLL on the chosen rows")
    ap.add_argument("--dpo-weight", type=float, default=1.0)
    ap.add_argument("--ref-model-path", default=None,
                    help="reference-policy checkpoint for full-parameter DPO "
                         "(default: the starting weights); refused with "
                         "--lora-enable, whose reference is the frozen base")
    # LoRA / QLoRA (reference r = 128, alpha = 256; --bits 8/4 quantizes the
    # frozen LLM base, the bitsandbytes k-bit path, train.py:956-972)
    ap.add_argument("--lora-enable", action="store_true")
    ap.add_argument("--lora-r", type=int, default=128)
    ap.add_argument("--lora-alpha", type=int, default=256)
    ap.add_argument("--bits", type=int, default=16, choices=[16, 8, 4],
                    help="quantize the (frozen) LLM base for QLoRA; requires "
                         "--lora-enable")
    # mesh: (data, fsdp, model) over the launch's processes
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-fsdp", type=int, default=None)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--use-pallas-attention", action="store_true",
                    help="route LLM attention through the flash kernel (K5 on the card)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute decoder blocks in the backward (gradient "
                         "checkpointing)")
    ap.add_argument("--device", default=None,
                    help="where the run trains (default: the current CUDA device)")
    return ap.parse_args(argv)


def _refuse_unported(args) -> None:
    if args.bits != 16 and not args.lora_enable:
        raise SystemExit("--bits 8/4 trains a quantized base: only valid with "
                         "--lora-enable (QLoRA)")


def _refuse_dpo(args) -> None:
    """JAX's DPO refusals (scripts/train_slime.py:253-260, :270)."""
    if args.task != "DPO":
        return
    if args.ref_model_path and args.lora_enable:
        raise SystemExit("--ref-model-path is incompatible with --lora-enable: LoRA-DPO "
                         "uses the frozen base as the reference policy (drop "
                         "--ref-model-path, or run full-parameter DPO)")
    if args.seq_packing:
        raise SystemExit("--seq-packing does not compose with --task DPO (pair rows "
                         "must stay aligned)")


def build_params(args, cfg, device):
    """The starting parameters on ``device``: a checkpoint (LoRA ones merged
    into ``--model-base``; quantized at load with ``--bits``), or random
    ones from ``--seed`` with the LLM layers quantized; list layers under
    ``--lora-enable`` (adapter paths read llm/layers/<i>/<proj>), else
    stacked; then the staged adapters' warm starts."""
    from .. import checkpoint as ckpt
    from ..models import llama, slime
    from ..ops.quantization import quantize_params

    has_weights = any(f.endswith((".safetensors", ".bin")) for f in os.listdir(args.model_path))
    if has_weights:
        params = ckpt.to_torch(ckpt.load_pretrained(
            args.model_path, model_base=args.model_base, cfg=cfg,
            load_bits=args.bits if args.bits != 16 else None), device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = slime.init(cfg, generator=gen, device=device)
        if args.bits != 16:
            params["llm"]["layers"] = quantize_params(params["llm"]["layers"], args.bits)
    if (not args.lora_enable and cfg.llm.num_experts == 0
            and isinstance(params["llm"].get("layers"), list)):
        params["llm"]["layers"] = llama.stack_layers(params["llm"]["layers"])
    for pre, key, conv in (
            (args.pretrain_mm_mlp_adapter, "projector",
             lambda sd: ckpt.convert_projector(ckpt._strip(sd, "model.mm_projector."), cfg)),
            (args.pretrain_mm_re_sampler, "sampler",
             lambda sd: ckpt.convert_sampler(ckpt._strip(sd, "model.sampler."), cfg))):
        if pre:
            params[key] = ckpt.to_torch(conv(ckpt.load_state_dict_file(pre)), device=device)
    return params


def build_ref_params(args, cfg, device):
    """Full-parameter DPO's reference policy from ``--ref-model-path`` (its
    LLM layers stacked as the policy's), or None: the starting weights."""
    if not args.ref_model_path:
        return None
    from .. import checkpoint as ckpt
    from ..models import llama
    ref = ckpt.to_torch(ckpt.load_pretrained(args.ref_model_path, cfg=cfg), device=device)
    if cfg.llm.num_experts == 0 and isinstance(ref["llm"].get("layers"), list):
        ref["llm"]["layers"] = llama.stack_layers(ref["llm"]["layers"])
    return ref


def build_dataset(args, cfg, tokenizer):
    if args.task == "DPO":
        from ..data.dpo import PreferenceDataset
        return PreferenceDataset(args.data_path, tokenizer, image_folder=args.image_folder,
                                 image_aspect_ratio=args.image_aspect_ratio,
                                 conv_version=args.version,
                                 max_crops=1 + cfg.max_local_crops,
                                 tile=cfg.vision.image_size, pixel_dtype=args.pixel_dtype,
                                 token_weighted=args.dpo_token_weighted,
                                 token_weight=args.dpo_token_weight)
    from ..data.dataset import SupervisedDataset
    return SupervisedDataset(args.data_path, tokenizer, image_folder=args.image_folder,
                             image_aspect_ratio=args.image_aspect_ratio,
                             conv_version=args.version, max_crops=1 + cfg.max_local_crops,
                             tile=cfg.vision.image_size, pixel_dtype=args.pixel_dtype)


def make_run_mesh(args, device_arg):
    """The run's mesh, or None for one process and a mesh of one: the
    launch's process group (gloo with ``--device cpu``, else NCCL) split as
    ``--mesh-*`` say."""
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and args.mesh_data * (args.mesh_fsdp or 1) * args.mesh_model <= 1:
        return None
    cpu = device_arg is not None and torch.device(device_arg).type == "cpu"
    distributed.initialize(backend="gloo" if cpu else "nccl")
    return make_mesh(args.mesh_data, args.mesh_fsdp, args.mesh_model,
                     device="cpu" if cpu else None)


def batches(args, ds, pad_token_id: int, batch_size: Optional[int] = None):
    """The run's numpy batches of ``batch_size`` rows (default
    ``--per-device-batch-size``), epoch after epoch: stacked preference pairs
    (``--task DPO``), packed text-only rows (``--seq-packing``) or
    ``data_loader``'s collated ones."""
    bs = batch_size or args.per_device_batch_size
    from ..data.dataset import data_loader
    from ..data.dpo import dpo_loader
    from ..data.packing import packed_loader
    for epoch in range(args.num_train_epochs):
        if args.task == "DPO":
            yield from dpo_loader(ds, batch_size=bs,
                                  seq_len=args.model_max_length, pad_token_id=pad_token_id,
                                  seed=args.seed + epoch, num_workers=8)
            continue
        if args.seq_packing:
            order = list(range(len(ds)))
            random.Random(args.seed + epoch).shuffle(order)
            yield from packed_loader((ds[i] for i in order),
                                     batch_size=bs,
                                     seq_len=args.model_max_length, pad_token_id=pad_token_id)
            continue
        yield from data_loader(ds, batch_size=bs,
                               seq_len=args.model_max_length, pad_token_id=pad_token_id,
                               seed=args.seed + epoch,
                               group_by_modality_length=args.group_by_modality_length,
                               num_workers=8)


def main(argv: Optional[Sequence[str]] = None, tokenizer=None):
    """Run the CLI -> the ``Trainer`` after its final save. ``tokenizer``
    replaces ``AutoTokenizer.from_pretrained`` (imported only when it is
    None)."""
    from ..config import SliMEConfig
    from ..data.dataset import prefetch
    from ..models.layers import resolve_device
    from . import lora as lora_lib
    from .optim import TrainConfig
    from .trainer import RunConfig, Trainer

    args = parse_args(argv)
    _refuse_unported(args)
    _refuse_dpo(args)
    mesh = make_run_mesh(args, args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    batch_mult = 1 if mesh is None else mesh.axis_size("dp")
    cfg = SliMEConfig.load(args.model_path)
    cfg = dataclasses.replace(cfg, use_global_only=args.use_global_only,
                              use_local_only=args.use_local_only,
                              mm_learnable_gated=args.mm_learnable_gated,
                              image_aspect_ratio=args.image_aspect_ratio,
                              tokenizer_model_max_length=args.model_max_length)
    params = build_params(args, cfg, device)
    if tokenizer is None:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.model_base or args.model_path)
    tokenizer.model_max_length = args.model_max_length
    ds = build_dataset(args, cfg, tokenizer)

    n_batches = max(len(ds) // args.per_device_batch_size, 1) * args.num_train_epochs
    total_steps = args.max_steps or n_batches
    tc = TrainConfig(
        learning_rate=args.learning_rate, mm_projector_lr=args.mm_projector_lr,
        weight_decay=args.weight_decay, warmup_ratio=args.warmup_ratio,
        total_steps=total_steps, lr_schedule=args.lr_scheduler_type,
        tune_mm_mlp_adapter=args.tune_mm_mlp_adapter,
        freeze_mm_mlp_adapter=args.freeze_mm_mlp_adapter,
        freeze_backbone=args.freeze_backbone, mm_learnable_gated=args.mm_learnable_gated,
        gradient_accumulation_steps=args.gradient_accumulation_steps, optim=args.optim)
    rc = RunConfig(output_dir=args.output_dir, save_steps=args.save_steps,
                   log_steps=args.logging_steps, max_steps=total_steps, seed=args.seed,
                   adapters_only_save=args.tune_mm_mlp_adapter, async_save=args.async_save)
    lora_state = None
    if args.lora_enable:
        lora_state = lora_lib.init_lora(
            params, generator=torch.Generator(device=device).manual_seed(args.seed + 1),
            r=args.lora_r, alpha=args.lora_alpha)
    dpo_cfg = None
    if args.task == "DPO":
        from .dpo import DPOConfig
        dpo_cfg = DPOConfig(beta=args.dpo_beta, loss_type=args.dpo_loss_type,
                            use_average=args.dpo_use_average,
                            token_weighted=args.dpo_token_weighted,
                            token_weight=args.dpo_token_weight, sft_weight=args.sft_weight,
                            dpo_weight=args.dpo_weight)
    trainer = Trainer(params, cfg, tc, rc,
                      compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                      use_kernel=args.use_pallas_attention or None, remat=args.remat,
                      lora=lora_state, dpo=dpo_cfg,
                      ref_params=build_ref_params(args, cfg, device) if dpo_cfg else None,
                      mesh=mesh)
    if args.seq_packing and any(n > 0 for n in ds.modality_lengths):
        raise SystemExit("--seq-packing is text-only (image features splice into the "
                         "embedding sequence; token-aligned segments can't describe them)")
    trainer.train(prefetch(batches(args, ds, tokenizer.pad_token_id or 0,
                                   args.per_device_batch_size * batch_mult), depth=2))
    trainer.save(args.output_dir)
    if trainer.main:
        print(f"done -> {args.output_dir}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
