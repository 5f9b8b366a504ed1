"""Interactive CLI chat (port of ``slime_tpu/serve/cli.py``): load a
checkpoint, infer the conversation mode from the model name, stream the
answers to stdout. With ``--draft-model-path`` and no image, each answer is
greedy speculative decoding (``speculative_generate_device``).

    python -m slime_tpu_torch.serve.cli --model-path DIR [--image-file X.jpg]

It runs on the current CUDA device unless ``--device`` says otherwise
(``--device cpu``). ``--tensor-parallel N`` shards the model over N cards,
one process each (``torchrun --nproc-per-node N -m slime_tpu_torch.serve.cli
... --tensor-parallel N``): rank 0 reads the prompts and prints, every rank
generates (``generate_stream(mesh=...)``).
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    import torch

    from .. import checkpoint as ckpt
    from ..config import SliMEConfig
    from ..constants import DEFAULT_IMAGE_TOKEN
    from ..conversation import conv_mode_from_model_name, conv_templates
    from ..data.image_ops import process_anyres_image_host
    from ..data.tokenization import get_model_name_from_path, tokenizer_image_token
    from ..generate import generate_stream, trim_at_eos
    from ..models.layers import resolve_device
    from ..parallel import distributed
    from ..parallel.mesh import tp_mesh, use_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--load-8bit", action="store_true")
    ap.add_argument("--quantize-lm-head", action="store_true",
                    help="also int8-quantize the vocab projection")
    ap.add_argument("--load-4bit", action="store_true")
    ap.add_argument("--quantize-vision", action="store_true",
                    help="W8A8 vision tower (the K8 kernel on the card)")
    ap.add_argument("--int4-scheme", default="default", choices=["default", "absmax", "group"],
                    help="int4 data type: default = NF4 group-64, absmax = per-row "
                         "int4, group = group-128 int4 (q4g)")
    ap.add_argument("--draft-model-path", default=None,
                    help="small same-tokenizer model for greedy speculative decoding "
                         "(exact; text-only prompts)")
    ap.add_argument("--image-file", default=None)
    ap.add_argument("--conv-mode", default=None)
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--kv-cache-int8", action="store_true",
                    help="int8 KV cache with per-(position, head) scales")
    ap.add_argument("--tensor-parallel", type=int, default=1,
                    help="shard the model over N cards, one process each (torchrun "
                         "--nproc-per-node N); 1 = one card")
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the current CUDA device)")
    ap.add_argument("--debug", action="store_true")
    args = ap.parse_args(argv)

    from transformers import AutoTokenizer
    mesh = tp_mesh(args.tensor_parallel, args.device)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
    bf = torch.bfloat16
    cfg = SliMEConfig.load(args.model_path)
    params = ckpt.load_for_serving(
        args.model_path, device=dev, cfg=cfg, model_base=args.model_base,
        load_bits=8 if args.load_8bit else (4 if args.load_4bit else None),
        quantize_lm_head=args.quantize_lm_head, int4_scheme=args.int4_scheme,
        quantize_vision=args.quantize_vision, mesh=mesh)
    tokenizer = AutoTokenizer.from_pretrained(args.model_base or args.model_path)
    draft = None
    if args.draft_model_path:
        dcfg = SliMEConfig.load(args.draft_model_path)
        draft = (ckpt.load_for_serving(args.draft_model_path, device=dev, cfg=dcfg,
                                       mesh=mesh), dcfg)

    conv_mode = args.conv_mode or conv_mode_from_model_name(
        get_model_name_from_path(args.model_path))
    conv = conv_templates[conv_mode].copy()

    pix = cmask = None
    image_pending = args.image_file is not None
    if image_pending:
        from PIL import Image
        img = Image.open(args.image_file).convert("RGB")
        crops, mask, _ = process_anyres_image_host(
            img, tile=cfg.vision.image_size, max_crops=1 + cfg.max_local_crops)
        pix = torch.from_numpy(crops[None]).to(dev)
        cmask = torch.from_numpy(mask[None]).to(dev)

    while True:
        inp = ""
        if lead:
            try:
                inp = input(f"{conv.roles[0]}: ")
            except EOFError:
                inp = ""
        inp = distributed.broadcast_object(inp)
        if not inp:
            break
        if image_pending:
            inp = DEFAULT_IMAGE_TOKEN + "\n" + inp
            image_pending = False
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()

        ids = tokenizer_image_token(prompt, tokenizer, return_tensors="np")
        input_ids = torch.from_numpy(ids[None].astype(np.int64)).to(dev)
        attn = torch.ones_like(input_ids, dtype=torch.bool)

        show = print if lead else (lambda *a, **k: None)
        show(f"{conv.roles[1]}: ", end="", flush=True)
        out_text = ""
        stop = conv.sep2 if conv.sep2 else conv.sep
        if draft is not None and pix is None:
            from .speculative import speculative_generate_device
            with use_mesh(mesh):
                toks, rate = speculative_generate_device(
                    params, cfg, draft[0], draft[1], input_ids,
                    max_new_tokens=args.max_new_tokens, compute_dtype=bf)
            out_text = tokenizer.decode(trim_at_eos(toks, cfg.eos_token_id)[0],
                                        skip_special_tokens=True)
            if stop and out_text.endswith(stop):
                out_text = out_text[:-len(stop)].rstrip()
            show(out_text + f"   [spec-accept {rate:.0%}]")
        else:
            with torch.no_grad():
                for text in generate_stream(params, cfg, tokenizer, input_ids, attn, pix, cmask,
                                            max_new_tokens=args.max_new_tokens,
                                            temperature=args.temperature,
                                            stop_strings=[stop] if stop else [],
                                            compute_dtype=bf, kv_quant=args.kv_cache_int8,
                                            mesh=mesh):
                    show(text[len(out_text):], end="", flush=True)
                    out_text = text
            show()
        conv.messages[-1][1] = out_text
        if args.debug and lead:
            print({"prompt": prompt, "outputs": out_text})


if __name__ == "__main__":
    main()
