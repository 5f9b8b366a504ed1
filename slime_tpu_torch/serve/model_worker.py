"""Model worker: serves streaming generation of one model, one request at a
time per semaphore slot, and heartbeats to the controller (port of
``slime_tpu/serve/model_worker.py``).

Registration and 15 s heartbeats, ``/worker_generate_stream`` with base64
images -> anyres crops -> ``tokenizer_image_token`` -> ``generate_stream``
on the worker's device, the token-budget check, a concurrency semaphore and
the error envelopes. A prompt with several images goes to ``generate_stream``
as [1, N, MC, ...] pixels: each ``<image>`` sentinel expands into its image's
tokens, in order (``slime.prepare_multimodal_multi``).

    python -m slime_tpu_torch.serve.model_worker --model-path DIR [--device cpu]
"""
from __future__ import annotations

import argparse
import base64
import io
import threading
import time
import uuid
from typing import Optional

import numpy as np
import torch

from ..config import SliMEConfig
from ..constants import WORKER_HEART_BEAT_INTERVAL
from ..data.image_ops import process_anyres_image_host
from ..data.tokenization import tokenizer_image_token
from ..models.layers import resolve_device
from .protocol import ErrorCode, SERVER_ERROR_MSG, JsonHTTPServer


class ModelWorker:
    def __init__(self, *, controller_addr: Optional[str], worker_addr: str,
                 model_name: str, params, cfg: SliMEConfig, tokenizer,
                 limit_concurrency: int = 5, compute_dtype=None,
                 register: bool = True, kv_quant: bool = False, device=None):
        """``params``: stacked LLM layers, on ``device`` (the current CUDA
        device when None)."""
        self.worker_id = uuid.uuid4().hex[:8]
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.model_name = model_name
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or torch.bfloat16
        self.kv_quant = kv_quant
        self.semaphore = threading.Semaphore(limit_concurrency)
        self.queue_length = 0
        self._ql_lock = threading.Lock()
        if register and controller_addr:
            self.register_to_controller()
            threading.Thread(target=self._heartbeat_loop, daemon=True).start()

    # -- controller plumbing -------------------------------------------------
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
                    self.register_to_controller()  # the controller forgot us
            except Exception:
                try:
                    self.register_to_controller()
                except Exception:
                    pass

    def get_status(self) -> dict:
        return {"model_names": [self.model_name], "speed": 1,
                "queue_length": self.queue_length}

    # -- generation ----------------------------------------------------------
    def generate_stream(self, params_req: dict):
        from ..generate import generate_stream

        acquired = self.semaphore.acquire(timeout=60)
        with self._ql_lock:
            self.queue_length += 1
        try:
            prompt = params_req["prompt"]
            images_b64 = params_req.get("images") or []
            temperature = float(params_req.get("temperature", 0.0))
            top_p = float(params_req.get("top_p", 1.0))
            max_new = min(int(params_req.get("max_new_tokens", 256)), 1024)
            stop = params_req.get("stop")
            stop_strings = [stop] if isinstance(stop, str) and stop else []

            pix = cmask = None
            if images_b64:
                from PIL import Image
                if prompt.count("<image>") != len(images_b64):
                    yield {"text": "Number of images does not match number of "
                           "<image> tokens in prompt",
                           "error_code": ErrorCode["SERVER_ERROR"]}
                    return
                MC = 1 + self.cfg.max_local_crops
                crops_l, mask_l = [], []
                for b64 in images_b64:
                    img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
                    c, m, _ = process_anyres_image_host(
                        img, tile=self.cfg.vision.image_size, max_crops=MC)
                    crops_l.append(c)
                    mask_l.append(m)
                pix = torch.from_numpy(np.stack(crops_l)).to(self.device)   # [N, MC, ...]
                cmask = torch.from_numpy(np.stack(mask_l)).to(self.device)
                if len(crops_l) > 1:
                    # multi-image: [1, N, MC, ...], one block a sentinel
                    pix, cmask = pix[None], cmask[None]

            ids = tokenizer_image_token(prompt, self.tokenizer, return_tensors="np")
            max_ctx = self.cfg.tokenizer_model_max_length
            if len(ids) + max_new >= max_ctx:
                max_new = max_ctx - len(ids) - 8
            if max_new <= 0:
                yield {"text": "Exceeds max token length.",
                       "error_code": ErrorCode["CONTEXT_OVERFLOW"]}
                return

            input_ids = torch.from_numpy(ids[None].astype(np.int64)).to(self.device)
            attn = torch.ones_like(input_ids, dtype=torch.bool)
            with torch.no_grad():
                for text in generate_stream(
                        self.params, self.cfg, self.tokenizer, input_ids, attn, pix, cmask,
                        max_new_tokens=max_new, temperature=temperature, top_p=top_p,
                        stop_strings=stop_strings,
                        compute_dtype=self.compute_dtype, kv_quant=self.kv_quant):
                    yield {"text": params_req.get("echo", False) * prompt + text,
                           "error_code": 0}
        except MemoryError:
            yield {"text": SERVER_ERROR_MSG, "error_code": ErrorCode["OUT_OF_MEMORY"]}
        except Exception as e:  # noqa: BLE001
            yield {"text": f"{SERVER_ERROR_MSG} ({e})",
                   "error_code": ErrorCode["SERVER_ERROR"]}
        finally:
            with self._ql_lock:
                self.queue_length -= 1
            if acquired:
                self.semaphore.release()


def build_server(worker: ModelWorker, host: str, port: int) -> JsonHTTPServer:
    srv = JsonHTTPServer(host, port)
    srv.stream_route("/worker_generate_stream", worker.generate_stream)
    srv.route("/worker_get_status", lambda b: worker.get_status())
    srv.route("/model_details", lambda b: {
        "context_length": worker.cfg.tokenizer_model_max_length})
    return srv


def main(argv=None):
    from .. import checkpoint as ckpt
    from ..data.tokenization import get_model_name_from_path

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--worker-address", default=None)
    ap.add_argument("--controller-address", default="http://localhost:21001")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--load-8bit", action="store_true")
    ap.add_argument("--load-4bit", action="store_true")
    ap.add_argument("--kv-cache-int8", action="store_true",
                    help="int8 KV cache with per-(position, head) scales")
    ap.add_argument("--model-name", default=None)
    ap.add_argument("--limit-model-concurrency", type=int, default=5)
    ap.add_argument("--no-register", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the worker runs (default: the current CUDA device)")
    args = ap.parse_args(argv)

    from transformers import AutoTokenizer
    dev = resolve_device(args.device)
    cfg = SliMEConfig.load(args.model_path)
    params = ckpt.load_for_serving(
        args.model_path, device=dev, cfg=cfg, model_base=args.model_base,
        load_bits=8 if args.load_8bit else (4 if args.load_4bit else None))
    tokenizer = AutoTokenizer.from_pretrained(args.model_base or args.model_path)
    name = args.model_name or get_model_name_from_path(args.model_path)
    addr = args.worker_address or f"http://{args.host}:{args.port}"
    worker = ModelWorker(controller_addr=args.controller_address, worker_addr=addr,
                         model_name=name, params=params, cfg=cfg, tokenizer=tokenizer,
                         limit_concurrency=args.limit_model_concurrency,
                         register=not args.no_register, kv_quant=args.kv_cache_int8,
                         device=dev)
    srv = build_server(worker, args.host, args.port)
    print(f"model worker {name} on {args.host}:{srv.port}, device {dev}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
