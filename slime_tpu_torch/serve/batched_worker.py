"""HTTP worker backed by the continuous-batching engine (port of
``slime_tpu/serve/batched_worker.py``).

It speaks the controller/worker protocol of ``model_worker`` (registration,
heartbeats, ``/worker_generate_stream`` as b"\\0"-delimited JSON), but its
requests share one batched decode loop (``serve.batch_engine``): concurrency
comes from the engine's slots. The same port serves the OpenAI routes
(``serve/openai_api.py``) and ``/worker_register_prefix``.

Start it on the card (the default device) from a checkpoint directory:

    python -m slime_tpu_torch.serve.batched_worker --model-path DIR \\
        --controller-address http://localhost:21001 --load-8bit --kv-cache-int8

``--device cpu`` runs it on the CPU. ``--adapter-path NAME=DIR`` (repeatable)
serves LoRA checkpoints beside the base model (``load_adapter``); a request
picks one with ``"adapter": NAME`` or ``"adapter_id": N``.

``--tensor-parallel N`` shards the model over N cards, one process each,
started by a launcher that sets torchrun's environment:

    torchrun --nproc-per-node N -m slime_tpu_torch.serve.batched_worker \
        --model-path DIR --tensor-parallel N ...

Rank 0 serves HTTP (the controller sees one worker) and owns the engine's
requests; the other ranks run the engine's ``follow()`` loop only.
"""
from __future__ import annotations

import argparse
import base64
import io
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..config import SliMEConfig
from ..constants import WORKER_HEART_BEAT_INTERVAL
from ..data.image_ops import process_anyres_image_host
from ..data.tokenization import StopStringMatcher, tokenizer_image_token
from .batch_engine import BatchDecodeEngine, Request
from .protocol import ErrorCode, SERVER_ERROR_MSG, JsonHTTPServer


class BatchedWorker:
    def __init__(self, *, controller_addr: Optional[str], worker_addr: str,
                 model_name: str, params, cfg: SliMEConfig, tokenizer,
                 max_slots: int = 8, cache_len: int = 2048,
                 compute_dtype=None, register: bool = True,
                 draft_params=None, draft_cfg: Optional[SliMEConfig] = None,
                 spec_k: int = 4, kv_quant: bool = False,
                 prefix_cache_mb: int = 512, prefix_block: int = 64, device=None,
                 mesh=None):
        """``device``: the engine's (the current CUDA device when None);
        ``params`` and ``draft_params`` must already be there. ``mesh``:
        tensor-parallel serving (this is rank 0; ``BatchDecodeEngine``)."""
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.model_name = model_name
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.engine = BatchDecodeEngine(params, cfg, max_slots=max_slots,
                                        cache_len=cache_len, compute_dtype=compute_dtype,
                                        draft_params=draft_params, draft_cfg=draft_cfg,
                                        spec_k=spec_k, kv_quant=kv_quant,
                                        prefix_cache_mb=prefix_cache_mb,
                                        prefix_block=prefix_block, device=device,
                                        mesh=mesh)
        self._grammar_cache = {}
        self.adapters = {}   # name -> adapter id (load_adapter)
        self._vocab_bytes = None
        self.engine.start()
        if register and controller_addr:
            self.register_to_controller()
            threading.Thread(target=self._heartbeat_loop, daemon=True).start()

    def register_to_controller(self) -> None:
        import requests
        requests.post(self.controller_addr + "/register_worker", json={
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.get_status(),
        }, timeout=10)

    def _heartbeat_loop(self) -> None:
        import requests
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            try:
                r = requests.post(self.controller_addr + "/receive_heart_beat", json={
                    "worker_name": self.worker_addr,
                    "queue_length": self.queue_length,
                }, timeout=5)
                if not r.json().get("exist", False):
                    self.register_to_controller()
            except Exception:
                pass

    @property
    def queue_length(self) -> int:
        return sum(s is not None for s in self.engine.slots) + self.engine.pending.qsize()

    def get_status(self) -> dict:
        st = {"model_names": [self.model_name], "speed": 1,
              "queue_length": self.queue_length}
        pc = self.engine.prefix_cache_stats()
        if pc is not None:
            st["prefix_cache"] = pc
        st["metrics"] = self.engine.metrics_summary()
        return st

    def register_prefix(self, p: dict) -> dict:
        """POST /worker_register_prefix {"prompt": "..."} -> {"prefix_id",
        "length"}. Later /worker_generate_stream calls pass the prefix_id and
        a prompt holding only the suffix."""
        ids = np.asarray(tokenizer_image_token(p["prompt"], self.tokenizer,
                                               return_tensors="np"))
        pid = self.engine.register_prefix(ids, prefix_id=p.get("prefix_id"))
        while pid not in self.engine.prefixes:       # under a mesh: the next tick
            time.sleep(0.005)
        return {"prefix_id": pid, "length": int(self.engine.prefixes[pid]["length"])}

    def _grammar_id(self, p: dict):
        """``regex`` / ``choices`` / ``json_schema`` payload keys -> an
        engine grammar_id: a token DFA over this model's vocabulary,
        compiled once per pattern."""
        from .grammar import (choices_regex, compile_token_dfa, json_schema_regex,
                              vocab_bytes_from_tokenizer)
        if p.get("regex"):
            pattern = str(p["regex"])
        elif p.get("choices"):
            pattern = choices_regex([str(c) for c in p["choices"]])
        elif p.get("json_schema"):
            pattern = json_schema_regex(p["json_schema"])
        else:
            return None
        if self._vocab_bytes is None:
            self._vocab_bytes = vocab_bytes_from_tokenizer(self.tokenizer,
                                                           self.cfg.llm.vocab_size)
        if pattern not in self._grammar_cache:
            tdfa = compile_token_dfa(pattern, self._vocab_bytes, eos_id=self.cfg.eos_token_id)
            self._grammar_cache[pattern] = self.engine.register_grammar(tdfa)
        return self._grammar_cache[pattern]

    def _adapter_id(self, p: dict):
        """Multi-LoRA: ``adapter`` (a name from ``load_adapter``) or
        ``adapter_id`` (an id from ``register_adapter``) in the payload."""
        if p.get("adapter"):
            return self.adapters.get(str(p["adapter"]))
        if p.get("adapter_id") is not None:
            return int(p["adapter_id"])
        return None

    def load_adapter(self, name: str, adapter_dir: str) -> int:
        """Load a reference-layout LoRA checkpoint directory
        (``adapter_model.bin`` + ``adapter_config.json``), stack it over the
        LLM's layers and register it with the engine -> its adapter id."""
        import json
        import os

        from ..train import lora as lora_lib
        with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
            acfg = json.load(f)
        sd = torch.load(os.path.join(adapter_dir, "adapter_model.bin"),
                        map_location="cpu", weights_only=True)
        state = lora_lib.import_peft({k: v.float() for k, v in sd.items()},
                                     r=int(acfg.get("r", 64)),
                                     alpha=int(acfg.get("lora_alpha", 16)))
        state = lora_lib.stack_adapter_state(state, self.cfg.llm.num_layers)
        aid = self.engine.register_adapter(state)
        self.adapters[name] = aid
        return aid

    def generate_stream(self, p: dict):
        try:
            prompt = p["prompt"]
            images = p.get("images") or []
            pix = cmask = None
            if images:
                from PIL import Image
                if prompt.count("<image>") != len(images):
                    yield {"text": "image count mismatch",
                           "error_code": ErrorCode["SERVER_ERROR"]}
                    return
                img = Image.open(io.BytesIO(base64.b64decode(images[0]))).convert("RGB")
                pix, cmask, _ = process_anyres_image_host(
                    img, tile=self.cfg.vision.image_size,
                    max_crops=1 + self.cfg.max_local_crops)

            pid = p.get("prefix_id")
            if pid is not None and pid not in self.engine.prefixes:
                yield {"text": f"unknown prefix_id {pid!r}",
                       "error_code": ErrorCode["SERVER_ERROR"]}
                return
            gid = self._grammar_id(p)
            ids = np.asarray(tokenizer_image_token(prompt, self.tokenizer,
                                                   return_tensors="np"))
            stop = p.get("stop")
            matcher = (StopStringMatcher([stop], self.tokenizer)
                       if isinstance(stop, str) and stop else None)
            req = Request(input_ids=ids, pixel_values=pix, crop_mask=cmask,
                          max_new_tokens=min(int(p.get("max_new_tokens", 256)), 1024),
                          temperature=float(p.get("temperature", 0.0)),
                          top_p=float(p.get("top_p", 1.0)),
                          top_k=int(p.get("top_k", 0)),
                          min_p=float(p.get("min_p", 0.0)),
                          repetition_penalty=float(p.get("repetition_penalty", 1.0)),
                          presence_penalty=float(p.get("presence_penalty", 0.0)),
                          frequency_penalty=float(p.get("frequency_penalty", 0.0)),
                          prefix_id=pid, grammar_id=gid,
                          adapter_id=self._adapter_id(p),
                          logprobs=int(p.get("logprobs") or 0))
            self.engine.submit(req)
            generated = []
            done = False
            try:
                for chunk in req.stream():
                    generated.extend(chunk)
                    text = self.tokenizer.decode(generated, skip_special_tokens=True)
                    out = {"text": text, "error_code": 0, "n_tokens": len(generated)}
                    if req.logprobs:
                        # entries land before their tokens (Request contract)
                        out["logprobs"] = [{"token_id": t, **e} for t, e in
                                           zip(generated, req.logprob_entries)]
                    if matcher is not None and matcher(generated):
                        out["text"] = matcher.trim(text)
                        out["stopped"] = True
                        yield out
                        return
                    yield out
                done = True
            finally:
                # the stream ended early (the client went away, or a stop
                # string cut it): free the slot now
                if not done:
                    self.engine.cancel(req.request_id)
        except Exception as e:  # noqa: BLE001
            yield {"text": f"{SERVER_ERROR_MSG} ({e})",
                   "error_code": ErrorCode["SERVER_ERROR"]}


def build_server(worker: BatchedWorker, host: str, port: int,
                 conv_mode: str = None) -> JsonHTTPServer:
    srv = JsonHTTPServer(host, port)
    srv.stream_route("/worker_generate_stream", worker.generate_stream)
    srv.route("/worker_get_status", lambda b: worker.get_status())
    srv.route("/worker_register_prefix", worker.register_prefix)
    # the OpenAI-compatible routes on the same port
    from .openai_api import attach_openai_routes
    attach_openai_routes(srv, worker, conv_mode=conv_mode)
    return srv


def main(argv=None):
    from .. import checkpoint as ckpt
    from ..data.tokenization import get_model_name_from_path
    from ..models.layers import resolve_device
    from ..parallel.mesh import tp_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=21003)
    ap.add_argument("--controller-address", default="http://localhost:21001")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--load-8bit", action="store_true")
    ap.add_argument("--load-4bit", action="store_true")
    ap.add_argument("--quantize-vision", action="store_true",
                    help="W8A8 vision tower (the K8 kernel on the card)")
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=2048)
    ap.add_argument("--no-register", action="store_true")
    ap.add_argument("--draft-model-path", default=None,
                    help="text-only draft for speculative rounds (same tokenizer)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--kv-cache-int8", action="store_true",
                    help="int8 KV cache with per-(position, head) scales")
    ap.add_argument("--adapter-path", action="append", default=[], metavar="NAME=DIR",
                    help="serve a LoRA adapter beside the base model (repeatable); "
                         'requests select it with {"adapter": NAME}')
    ap.add_argument("--conv-mode", default=None,
                    help="conversation template of the /v1 routes (default: from the "
                         "model name)")
    ap.add_argument("--prefix-cache-mb", type=int, default=512,
                    help="byte budget of the automatic prefix KV cache; 0 disables it")
    ap.add_argument("--tensor-parallel", type=int, default=1,
                    help="shard the model over N cards, one process each (torchrun "
                         "--nproc-per-node N); 1 = one card")
    ap.add_argument("--device", default=None,
                    help="where the worker runs (default: the current CUDA device)")
    args = ap.parse_args(argv)
    from transformers import AutoTokenizer

    mesh = tp_mesh(args.tensor_parallel, args.device)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = SliMEConfig.load(args.model_path)
    params = ckpt.load_for_serving(
        args.model_path, device=dev, cfg=cfg, model_base=args.model_base,
        load_bits=8 if args.load_8bit else (4 if args.load_4bit else None),
        quantize_vision=args.quantize_vision, mesh=mesh)
    tokenizer = AutoTokenizer.from_pretrained(args.model_base or args.model_path)
    name = args.model_name or get_model_name_from_path(args.model_path)
    draft_params = draft_cfg = None
    if args.draft_model_path:
        draft_cfg = SliMEConfig.load(args.draft_model_path)
        draft_params = ckpt.load_for_serving(args.draft_model_path, device=dev,
                                             cfg=draft_cfg, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        engine = BatchDecodeEngine(params, cfg, max_slots=args.max_slots,
                                   cache_len=args.cache_len, compute_dtype=torch.bfloat16,
                                   draft_params=draft_params, draft_cfg=draft_cfg,
                                   spec_k=args.spec_k, kv_quant=args.kv_cache_int8,
                                   prefix_cache_mb=args.prefix_cache_mb, device=dev,
                                   mesh=mesh)
        engine.follow()
        return
    worker = BatchedWorker(controller_addr=args.controller_address,
                           worker_addr=f"http://{args.host}:{args.port}", model_name=name,
                           params=params, cfg=cfg, tokenizer=tokenizer,
                           max_slots=args.max_slots, cache_len=args.cache_len,
                           compute_dtype=torch.bfloat16, register=not args.no_register,
                           draft_params=draft_params, draft_cfg=draft_cfg,
                           spec_k=args.spec_k, kv_quant=args.kv_cache_int8,
                           prefix_cache_mb=args.prefix_cache_mb, device=dev, mesh=mesh)
    for spec in args.adapter_path:
        nm, _, d = spec.partition("=")
        worker.load_adapter(nm, d or nm)
    srv = build_server(worker, args.host, args.port, conv_mode=args.conv_mode)
    print(f"batched worker {name} on {args.host}:{srv.port} (+ OpenAI /v1 routes), "
          f"device {dev}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
