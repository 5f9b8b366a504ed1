"""Gradio chat web UI talking to the controller (the port's own copy of
``slime_tpu/serve/gradio_web_server.py``).

Model listing, per-model conversation-template routing, image upload
(hashed and logged), vote logging and streamed chat through
/worker_generate_stream. Gradio is imported only by ``build_demo``, which
raises without it; the controller-facing logic lives in plain functions.
"""
from __future__ import annotations

import argparse
import base64
import datetime
import hashlib
import io
import json
import os
import time
from typing import List, Optional

from ..constants import LOGDIR
from ..conversation import Conversation, conv_mode_from_model_name, conv_templates
from .protocol import SERVER_ERROR_MSG, iter_stream_response

headers = {"User-Agent": "SliME-TPU Client"}

MODERATION_MSG = ("YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. "
                  "PLEASE TRY AGAIN.")


def violates_moderation(text: str) -> bool:
    """Screen user input via the OpenAI moderation API (reference:
    llava/utils.py:102-120, wired at gradio_web_server.py:133-137).

    No-op (returns False) unless both moderation is enabled (``--moderate`` /
    ``SLIME_MODERATE=1``) and ``OPENAI_API_KEY`` is set — this environment has
    zero egress, so the default path never makes a network call. Any API or
    network failure fails open, matching the reference."""
    if not os.environ.get("OPENAI_API_KEY"):
        return False
    import requests
    try:
        ret = requests.post(
            "https://api.openai.com/v1/moderations",
            headers={"Content-Type": "application/json",
                     "Authorization": "Bearer " + os.environ["OPENAI_API_KEY"]},
            json={"input": text.replace("\n", "")}, timeout=5)
        return bool(ret.json()["results"][0]["flagged"])
    except Exception:
        return False


def get_model_list(controller_url: str) -> List[str]:
    import requests
    r = requests.post(controller_url + "/refresh_all_workers", json={}, timeout=10)
    r = requests.post(controller_url + "/list_models", json={}, timeout=10)
    return sorted(r.json()["models"])


def get_conv_log_filename() -> str:
    t = datetime.datetime.now()
    return os.path.join(LOGDIR, f"{t.year}-{t.month:02d}-{t.day:02d}-conv.json")


def log_record(rec: dict) -> None:
    with open(get_conv_log_filename(), "a") as f:
        f.write(json.dumps(rec) + "\n")


def save_image(image, out_dir: str = None) -> str:
    """Hash + persist an uploaded image (gradio_web_server.py:221-228)."""
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    data = buf.getvalue()
    h = hashlib.md5(data).hexdigest()
    out_dir = out_dir or os.path.join(LOGDIR, "serve_images",
                                      datetime.datetime.now().strftime("%Y-%m-%d"))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{h}.png")
    if not os.path.exists(path):
        with open(path, "wb") as f:
            f.write(data)
    return base64.b64encode(data).decode()


def stream_chat(controller_url: str, model_name: str, conv: Conversation,
                image_b64: Optional[str], *, temperature: float = 0.2,
                top_p: float = 0.7, max_new_tokens: int = 512):
    """Generator of partial assistant texts (the http_bot core,
    gradio_web_server.py:154-310)."""
    import requests

    prompt = conv.get_prompt()
    stop = conv.sep2 if conv.sep2 else conv.sep
    payload = {
        "model": model_name,
        "prompt": prompt,
        "temperature": temperature,
        "top_p": top_p,
        "max_new_tokens": max_new_tokens,
        "stop": stop,
        "images": [image_b64] if image_b64 else [],
    }
    t0 = time.time()
    try:
        resp = requests.post(controller_url + "/worker_generate_stream",
                             json=payload, stream=True, timeout=120)
        for chunk in iter_stream_response(resp):
            if chunk.get("error_code", 0) != 0:
                yield chunk["text"]
                return
            yield chunk["text"]
    except requests.RequestException:
        yield SERVER_ERROR_MSG
    finally:
        log_record({"tstamp": time.time(), "type": "chat", "model": model_name,
                    "start": t0, "state": conv.dict()})


def build_demo(controller_url: str, moderate: bool = None):
    if moderate is None:
        moderate = os.environ.get("SLIME_MODERATE", "") not in ("", "0")
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed in this environment; the serving UI requires "
            "it. The controller/worker HTTP API (slime_tpu_torch.serve.controller / "
            "model_worker) and the CLI (slime_tpu_torch.serve.cli) are fully functional "
            "without it.") from e

    models = get_model_list(controller_url)

    with gr.Blocks(title="SliME-TPU") as demo:
        state = gr.State()
        model_selector = gr.Dropdown(choices=models,
                                     value=models[0] if models else None,
                                     label="Model")
        chatbot = gr.Chatbot(label="SliME-TPU Chatbot", height=550)
        imagebox = gr.Image(type="pil", label="Image")
        textbox = gr.Textbox(show_label=False,
                             placeholder="Enter text and press ENTER")
        with gr.Row():
            upvote = gr.Button("👍 Upvote")
            downvote = gr.Button("👎 Downvote")
            clear = gr.Button("🗑️ Clear")
        temperature = gr.Slider(0.0, 1.0, value=0.2, label="Temperature")
        top_p = gr.Slider(0.0, 1.0, value=0.7, label="Top P")
        max_tokens = gr.Slider(0, 1024, value=512, step=64,
                               label="Max output tokens")

        def add_text(history, model, text, image):
            if moderate and violates_moderation(text):
                # Flagged input: echo the moderation message instead of
                # forwarding to the worker (reference UX, gradio_web_server.py:133-137).
                return (history or []) + [[text, MODERATION_MSG]], None
            mode = conv_mode_from_model_name(model or "")
            conv = conv_templates[mode].copy()
            for u, a in history or []:
                conv.append_message(conv.roles[0], u)
                conv.append_message(conv.roles[1], a)
            msg = ("<image>\n" + text) if image is not None and not history else text
            conv.append_message(conv.roles[0], msg)
            conv.append_message(conv.roles[1], None)
            return (history or []) + [[text, None]], conv

        def bot(history, conv, model, image, temp, tp, mx):
            if conv is None:  # moderation-flagged turn: nothing to generate
                yield history
                return
            img_b64 = save_image(image) if image is not None else None
            for text in stream_chat(controller_url, model, conv, img_b64,
                                    temperature=temp, top_p=tp,
                                    max_new_tokens=int(mx)):
                history[-1][1] = text
                yield history

        def vote(kind):
            def fn(history, model):
                log_record({"tstamp": time.time(), "type": kind, "model": model,
                            "state": history})
            return fn

        textbox.submit(add_text, [chatbot, model_selector, textbox, imagebox],
                       [chatbot, state]).then(
            bot, [chatbot, state, model_selector, imagebox, temperature,
                  top_p, max_tokens], chatbot)
        upvote.click(vote("upvote"), [chatbot, model_selector], [])
        downvote.click(vote("downvote"), [chatbot, model_selector], [])
        clear.click(lambda: ([], None), [], [chatbot, state])
    return demo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--controller-url", default="http://localhost:21001")
    ap.add_argument("--share", action="store_true")
    ap.add_argument("--moderate", action="store_true",
                    help="screen inputs via the OpenAI moderation API "
                         "(requires OPENAI_API_KEY; reference --moderate)")
    args = ap.parse_args()
    demo = build_demo(args.controller_url, moderate=args.moderate)
    demo.queue().launch(server_name=args.host, server_port=args.port,
                        share=args.share)


if __name__ == "__main__":
    main()
