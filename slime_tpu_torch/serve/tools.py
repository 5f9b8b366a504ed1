"""Serving utilities (the port's own copy of ``slime_tpu/serve/tools.py``):
manual worker registration and a smoke-test client (reference
llava/serve/register_worker.py and test_message.py).
"""
from __future__ import annotations

import argparse
import json


def register_worker(controller_address: str, worker_name: str,
                    check_heart_beat: bool = True) -> dict:
    import requests
    r = requests.post(controller_address + "/register_worker", json={
        "worker_name": worker_name,
        "check_heart_beat": check_heart_beat,
        "worker_status": None,
    }, timeout=10)
    return r.json()


def send_test_message(controller_address: str, model_name: str,
                      message: str = "Tell me a story with more than 1000 words.",
                      max_new_tokens: int = 32, temperature: float = 0.0) -> str:
    """Stream a prompt through controller dispatch (test_message.py:10-49)."""
    import requests

    from ..conversation import conv_mode_from_model_name, conv_templates
    from .protocol import iter_stream_response

    r = requests.post(controller_address + "/list_models", json={}, timeout=10)
    models = r.json()["models"]
    if model_name not in models:
        raise RuntimeError(f"model {model_name} not in {models}")

    conv = conv_templates[conv_mode_from_model_name(model_name)].copy()
    conv.append_message(conv.roles[0], message)
    conv.append_message(conv.roles[1], None)

    resp = requests.post(controller_address + "/worker_generate_stream", json={
        "model": model_name,
        "prompt": conv.get_prompt(),
        "max_new_tokens": max_new_tokens,
        "temperature": temperature,
        "stop": conv.sep2 or conv.sep,
    }, stream=True, timeout=120)
    text = ""
    for chunk in iter_stream_response(resp):
        if chunk.get("error_code", 0) != 0:
            raise RuntimeError(chunk["text"])
        text = chunk["text"]
        print(text, end="\r", flush=True)
    print()
    return text


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("register")
    r.add_argument("--controller-address", required=True)
    r.add_argument("--worker-name", required=True)
    t = sub.add_parser("test")
    t.add_argument("--controller-address", default="http://localhost:21001")
    t.add_argument("--model-name", required=True)
    t.add_argument("--message", default="Tell me a story with more than 1000 words.")
    args = ap.parse_args()
    if args.cmd == "register":
        print(json.dumps(register_worker(args.controller_address, args.worker_name)))
    else:
        send_test_message(args.controller_address, args.model_name, args.message)


if __name__ == "__main__":
    main()
