"""The port's HTTP serving stack on the CPU over real localhost HTTP: the
counterparts of ``tests/test_serve.py`` (controller, model worker,
heartbeats, dispatch, expiry, the Gradio helpers) and of the HTTP tests of
``tests/test_batch_engine.py`` (the batched worker, its prefix route, a
worker with a draft, cancellation on a closed generator and through the
controller's proxy), at ``SliMEConfig.tiny()`` with the JAX package's
random params through ``params.from_jax_numpy``, the offline
``tests/toy_tokenizer.py`` and fp32 compute.

Greedy text over HTTP equals the in-process engine's, the draftless
worker's, and JAX's batched worker's for the same prompt and params. A
two-image request streams the tokens of the in-process multi-image
``generate``.
"""
import base64
import io
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import requests
import torch

from slime_tpu.config import SliMEConfig as JCfg
from slime_tpu.models import llama as jllama
from slime_tpu.models import slime as jslime
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import SliMEConfig
from slime_tpu_torch.constants import CONTROLLER_HEART_BEAT_EXPIRATION
from slime_tpu_torch.serve.batched_worker import BatchedWorker
from slime_tpu_torch.serve.batched_worker import build_server as build_batched
from slime_tpu_torch.serve.controller import Controller
from slime_tpu_torch.serve.controller import build_server as build_controller
from slime_tpu_torch.serve.model_worker import ModelWorker
from slime_tpu_torch.serve.model_worker import build_server as build_worker
from slime_tpu_torch.serve.protocol import SERVER_ERROR_MSG, iter_stream_response

from .toy_tokenizer import ToyTokenizer

SEED_TEXT = "hello world this is a longer seed sentence for vocab what is in the picture"


def _jparams(seed):
    p = jax.device_get(jslime.init(jax.random.PRNGKey(seed), JCfg.tiny()))
    p["llm"]["layers"] = jax.device_get(jllama.stack_layers(p["llm"]["layers"]))
    return p


def _tok():
    tok = ToyTokenizer()
    tok(SEED_TEXT)
    return tok


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def models():
    jp = _jparams(0)
    return SliMEConfig.tiny(), bridge.from_jax_numpy(jp, device="cpu"), jp


@pytest.fixture(scope="module")
def stack(models):
    """Controller + model worker, registered."""
    cfg, params, _ = models
    tok = _tok()
    csrv = _serve(build_controller(Controller("shortest_queue"), "localhost", 0))
    worker = ModelWorker(controller_addr=f"http://localhost:{csrv.port}", worker_addr=None,
                         model_name="slime-tiny", params=params, cfg=cfg, tokenizer=tok,
                         compute_dtype=torch.float32, register=False, device="cpu")
    wsrv = _serve(build_worker(worker, "localhost", 0))
    worker.worker_addr = f"http://localhost:{wsrv.port}"
    worker.register_to_controller()
    yield csrv.port, wsrv.port, cfg, tok
    csrv.shutdown()
    wsrv.shutdown()


def _stream(url, body, timeout=300):
    return list(iter_stream_response(requests.post(url, json=body, stream=True,
                                                   timeout=timeout)))


def _b64img(color, size=(300, 300)):
    from PIL import Image
    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


# ------------------------------------------------------- controller + worker

def test_registration_and_listing(stack):
    cport, wport, _, _ = stack
    c = f"http://localhost:{cport}"
    assert requests.post(c + "/list_models", json={}, timeout=5).json()["models"] == [
        "slime-tiny"]
    assert requests.post(c + "/get_worker_address", json={"model": "slime-tiny"},
                         timeout=5).json()["address"] == f"http://localhost:{wport}"
    assert requests.post(c + "/get_worker_address", json={"model": "nope"},
                         timeout=5).json()["address"] == ""


def test_heartbeat(stack):
    cport, wport, _, _ = stack
    r = requests.post(f"http://localhost:{cport}/receive_heart_beat",
                      json={"worker_name": f"http://localhost:{wport}", "queue_length": 2},
                      timeout=5)
    assert r.json()["exist"] is True


def test_text_generation_stream(stack):
    _, wport, _, _ = stack
    chunks = _stream(f"http://localhost:{wport}/worker_generate_stream",
                     {"prompt": "hello world what is", "max_new_tokens": 6,
                      "temperature": 0.0})
    assert chunks and all(c["error_code"] == 0 for c in chunks)
    assert isinstance(chunks[-1]["text"], str)


def test_multimodal_generation_via_controller_proxy(stack):
    cport, _, _, _ = stack
    chunks = _stream(f"http://localhost:{cport}/worker_generate_stream",
                     {"model": "slime-tiny", "prompt": "<image>\nwhat is in the picture",
                      "images": [_b64img((0, 120, 240), (400, 300))], "max_new_tokens": 4,
                      "temperature": 0.0})
    assert chunks and chunks[-1]["error_code"] == 0


def test_image_count_mismatch_is_error(stack):
    _, wport, _, _ = stack
    chunks = _stream(f"http://localhost:{wport}/worker_generate_stream",
                     {"prompt": "no image token here", "images": ["aGVsbG8="],
                      "max_new_tokens": 4})
    assert chunks[-1]["error_code"] != 0


def test_two_image_generation_is_not_ported(stack, models):
    """Two images (multi-image prompts are ported): the worker streams the
    tokens of the in-process ``generate`` on the same [1, 2, MC, ...]
    crops, each ``<image>`` expanding into its own image."""
    from slime_tpu_torch.data.image_ops import process_anyres_image_host
    from slime_tpu_torch.data.tokenization import tokenizer_image_token
    from slime_tpu_torch.generate import generate, trim_at_eos
    from PIL import Image
    _, wport, cfg, tok = stack
    _, params, _ = models
    imgs = [_b64img((255, 0, 0)), _b64img((0, 0, 255), (400, 200))]
    prompt = "<image> and <image> what differs"
    chunks = _stream(f"http://localhost:{wport}/worker_generate_stream",
                     {"prompt": prompt, "images": imgs, "max_new_tokens": 5,
                      "temperature": 0.0})
    assert chunks and all(c["error_code"] == 0 for c in chunks)
    crops = [process_anyres_image_host(
        Image.open(io.BytesIO(base64.b64decode(b))).convert("RGB"),
        tile=cfg.vision.image_size, max_crops=1 + cfg.max_local_crops) for b in imgs]
    ids = torch.from_numpy(tokenizer_image_token(prompt, tok, return_tensors="np")[None]
                           .astype(np.int64))
    with torch.no_grad():
        out = generate(params, cfg, ids, torch.ones_like(ids, dtype=torch.bool),
                       torch.from_numpy(np.stack([c for c, _, _ in crops]))[None],
                       torch.from_numpy(np.stack([m for _, m, _ in crops]))[None],
                       max_new_tokens=5, compute_dtype=torch.float32)
    want = trim_at_eos(out, cfg.eos_token_id)[0]
    assert want and chunks[-1]["text"] == tok.decode(want, skip_special_tokens=True)


def test_multi_worker_dispatch():
    c = Controller("shortest_queue")
    c.register_worker("http://w1", False, {"model_names": ["m"], "speed": 1,
                                           "queue_length": 5})
    c.register_worker("http://w2", False, {"model_names": ["m"], "speed": 1,
                                           "queue_length": 0})
    assert c.get_worker_address("m") == "http://w2"
    for _ in range(6):
        c.get_worker_address("m")
    assert c.workers["http://w1"].queue_length >= 5
    lot = Controller("lottery")
    lot.register_worker("http://a", False, {"model_names": ["m"], "speed": 0,
                                            "queue_length": 0})
    lot.register_worker("http://b", False, {"model_names": ["m"], "speed": 2,
                                            "queue_length": 0})
    assert {lot.get_worker_address("m") for _ in range(20)} == {"http://b"}


def test_worker_expiry():
    c = Controller("shortest_queue")
    c.register_worker("http://dead", True, {"model_names": ["m"], "speed": 1,
                                            "queue_length": 0})
    c.workers["http://dead"].last_heart_beat = 0
    expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
    with c.lock:
        for n in [n for n, w in c.workers.items()
                  if w.check_heart_beat and w.last_heart_beat < expire]:
            del c.workers[n]
    assert "http://dead" not in c.workers


# ------------------------------------------------------------- gradio helpers

def test_gradio_get_model_list(stack):
    from slime_tpu_torch.serve import gradio_web_server as gws
    assert gws.get_model_list(f"http://localhost:{stack[0]}") == ["slime-tiny"]


def test_gradio_save_image_and_log(tmp_path, monkeypatch):
    import hashlib

    from PIL import Image

    from slime_tpu_torch.serve import gradio_web_server as gws
    img = Image.new("RGB", (32, 20), (200, 10, 10))
    b64 = gws.save_image(img, out_dir=str(tmp_path))
    assert (tmp_path / f"{hashlib.md5(base64.b64decode(b64)).hexdigest()}.png").exists()
    gws.save_image(img, out_dir=str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 1
    monkeypatch.setattr(gws, "get_conv_log_filename", lambda: str(tmp_path / "conv.json"))
    gws.log_record({"type": "upvote", "model": "m"})
    assert json.loads((tmp_path / "conv.json").read_text().strip())["type"] == "upvote"


def test_gradio_template_routing():
    from slime_tpu_torch.conversation import conv_mode_from_model_name, conv_templates
    mode = conv_mode_from_model_name("slime-llama3-8b")
    assert mode == "llama3"
    conv = conv_templates[mode].copy()
    conv.append_message(conv.roles[0], "<image>\nwhat is this?")
    conv.append_message(conv.roles[1], None)
    p = conv.get_prompt()
    assert "<image>" in p and p.rstrip().endswith("<|end_header_id|>")


def test_gradio_stream_chat_against_live_stack(stack):
    from slime_tpu_torch.conversation import conv_templates
    from slime_tpu_torch.serve import gradio_web_server as gws
    conv = conv_templates["v1"].copy()
    conv.append_message(conv.roles[0], "hello world what is")
    conv.append_message(conv.roles[1], None)
    texts = list(gws.stream_chat(f"http://localhost:{stack[0]}", "slime-tiny", conv, None,
                                 temperature=0.0, max_new_tokens=4))
    assert texts and all(isinstance(t, str) for t in texts)
    assert texts[-1] != SERVER_ERROR_MSG


def test_gradio_stream_chat_error_path(tmp_path, monkeypatch):
    from slime_tpu_torch.conversation import conv_templates
    from slime_tpu_torch.serve import gradio_web_server as gws
    monkeypatch.setattr(gws, "get_conv_log_filename", lambda: str(tmp_path / "conv.json"))
    conv = conv_templates["v1"].copy()
    conv.append_message(conv.roles[0], "hi")
    conv.append_message(conv.roles[1], None)
    assert list(gws.stream_chat("http://localhost:1", "m", conv, None)) == [SERVER_ERROR_MSG]
    assert (tmp_path / "conv.json").exists()


def test_gradio_build_demo_gate():
    from slime_tpu_torch.serve import gradio_web_server as gws
    try:
        import gradio  # noqa: F401
        pytest.skip("gradio installed here; gate not exercisable")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="gradio is not installed"):
        gws.build_demo("http://localhost:1")


def test_moderation_hook(monkeypatch):
    from slime_tpu_torch.serve import gradio_web_server as gws
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert gws.violates_moderation("anything") is False
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")

    class FakeResp:
        def __init__(self, flagged):
            self._flagged = flagged

        def json(self):
            return {"results": [{"flagged": self._flagged}]}
    monkeypatch.setattr(requests, "post", lambda *a, **k: FakeResp(True))
    assert gws.violates_moderation("bad text") is True
    monkeypatch.setattr(requests, "post", lambda *a, **k: FakeResp(False))
    assert gws.violates_moderation("fine text") is False

    def boom(*a, **k):
        raise requests.RequestException("no egress")
    monkeypatch.setattr(requests, "post", boom)
    assert gws.violates_moderation("text") is False


# ------------------------------------------------------------- batched worker

def _batched(models, **kw):
    cfg, params, _ = models
    kw.setdefault("max_slots", 2)
    kw.setdefault("cache_len", 96)
    worker = BatchedWorker(controller_addr=None, worker_addr="x", model_name="slime-tiny",
                           params=params, cfg=cfg, tokenizer=_tok(), register=False,
                           device="cpu", prefix_cache_mb=0, **kw)
    return worker, _serve(build_batched(worker, "localhost", 0))


def test_batched_worker_http(models):
    """Three concurrent streams; the greedy texts equal the in-process
    engine's tokens decoded; the status route answers."""
    from slime_tpu_torch.data.tokenization import tokenizer_image_token
    from slime_tpu_torch.serve.batch_engine import BatchDecodeEngine, Request

    cfg, params, _ = models
    worker, srv = _batched(models)
    url = f"http://localhost:{srv.port}"
    prompts = [f"hello world this is {w}" for w in ("a", "longer", "seed")]
    try:
        outs = [None] * 3

        def go(i):
            outs[i] = _stream(url + "/worker_generate_stream",
                              {"prompt": prompts[i], "max_new_tokens": 4})
        ts = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        st = requests.post(url + "/worker_get_status", json={}, timeout=30).json()
    finally:
        worker.engine.stop()
        srv.shutdown()
    assert all(o and o[-1]["error_code"] == 0 for o in outs)
    assert st["model_names"] == ["slime-tiny"] and st["metrics"]["completed"] == 3
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=96, device="cpu",
                            prefix_cache_mb=0)
    tok = worker.tokenizer
    for p, o in zip(prompts, outs):
        req = eng.submit(Request(input_ids=np.asarray(tokenizer_image_token(
            p, tok, return_tensors="np")), max_new_tokens=4))
        for _ in range(40):
            if eng.tick() == 0 and eng.pending.empty():
                break
        toks = [t for c in req.stream() for t in c]
        assert o[-1]["text"] == tok.decode(toks, skip_special_tokens=True)


def test_prefix_http_route(models):
    """/worker_register_prefix + a suffix with its prefix_id gives the full
    prompt's text; an unknown prefix_id is a clean error chunk."""
    worker, srv = _batched(models)
    base = f"http://localhost:{srv.port}"
    PRE, SUF = "hello world this is a", " longer seed sentence for vocab"
    try:
        full = _stream(base + "/worker_generate_stream",
                       {"prompt": PRE + SUF, "max_new_tokens": 5})[-1]
        reg = requests.post(base + "/worker_register_prefix", json={"prompt": PRE},
                            timeout=300).json()
        assert reg["length"] > 0
        pref = _stream(base + "/worker_generate_stream",
                       {"prompt": SUF, "prefix_id": reg["prefix_id"],
                        "max_new_tokens": 5})[-1]
        err = _stream(base + "/worker_generate_stream",
                      {"prompt": SUF, "prefix_id": "nope", "max_new_tokens": 2})[-1]
    finally:
        worker.engine.stop()
        srv.shutdown()
    assert pref["error_code"] == 0 and pref["text"] == full["text"]
    assert err["error_code"] != 0 and "prefix_id" in err["text"]


def test_batched_worker_with_draft_http(models):
    """A worker with a draft (speculative rounds) serves the draftless
    worker's greedy text."""
    dparams = bridge.from_jax_numpy(_jparams(7), device="cpu")

    def run(draft):
        worker, srv = _batched(models, draft_params=dparams if draft else None,
                               draft_cfg=models[0] if draft else None, spec_k=3)
        try:
            chunks = _stream(f"http://localhost:{srv.port}/worker_generate_stream",
                             {"prompt": "hello world this is", "max_new_tokens": 6,
                              "temperature": 0.0})
            return chunks[-1], dict(worker.engine.spec_stats)
        finally:
            worker.engine.stop()
            srv.shutdown()
    (spec, stats), (plain, _) = run(True), run(False)
    assert spec["error_code"] == plain["error_code"] == 0
    assert spec["text"] == plain["text"] and stats["dispatches"] >= 1


def test_batched_worker_matches_jax_worker(models):
    """Greedy text over HTTP: the port's batched worker and JAX's on the
    same params, prompt and toy tokenizer."""
    from slime_tpu.serve.batched_worker import BatchedWorker as JWorker
    from slime_tpu.serve.batched_worker import build_server as jbuild

    cfg, params, jp = models
    body = {"prompt": "hello world what is in the picture", "max_new_tokens": 8,
            "temperature": 0.0}
    texts = []
    for mk in ("port", "jax"):
        if mk == "port":
            worker, srv = _batched(models)
        else:
            worker = JWorker(controller_addr=None, worker_addr="x", model_name="m", params=jp,
                             cfg=JCfg.tiny(), tokenizer=_tok(), max_slots=2, cache_len=96,
                             register=False, prefix_cache_mb=0)
            srv = _serve(jbuild(worker, "localhost", 0))
        try:
            texts.append(_stream(f"http://localhost:{srv.port}/worker_generate_stream",
                                 body)[-1])
        finally:
            worker.engine.stop()
            srv.shutdown()
    assert texts[0]["error_code"] == texts[1]["error_code"] == 0
    assert texts[0]["text"] == texts[1]["text"] and texts[0]["n_tokens"] == 8


def test_batched_worker_grammar_payload(models):
    """A ``choices`` payload compiles once per pattern to an engine grammar
    and the reply is one of the choices."""
    worker, srv = _batched(models)
    body = {"prompt": "hello world", "max_new_tokens": 6, "choices": ["hello", "world"]}
    try:
        outs = [_stream(f"http://localhost:{srv.port}/worker_generate_stream", body)[-1]
                for _ in range(2)]
    finally:
        worker.engine.stop()
        srv.shutdown()
    assert all(o["error_code"] == 0 and o["text"] in ("hello", "world") for o in outs)
    assert len(worker.engine.grammars) == 1


def test_worker_generator_close_cancels_engine_request(models):
    """Closing the worker's stream generator (what the HTTP layer does on a
    client disconnect) cancels the engine request."""
    cfg, params, _ = models
    worker = BatchedWorker(controller_addr=None, worker_addr="x", model_name="m",
                           params=params, cfg=cfg, tokenizer=_tok(), max_slots=2,
                           cache_len=96, register=False, device="cpu")
    eng = worker.engine
    try:
        gen = worker.generate_stream({"prompt": "hello world this is long",
                                      "max_new_tokens": 64})
        assert next(gen).get("error_code") == 0
        gen.close()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if all(s is None for s in eng.slots) and eng.pending.empty():
                break
            time.sleep(0.02)
        assert all(s is None for s in eng.slots), "cancel must free the slot"
    finally:
        eng.stop()


def test_controller_proxy_disconnect_cancels_worker_request(models):
    """A client that resets its connection to the controller: the proxy
    closes its upstream connection and the worker cancels the request."""
    cfg, params, _ = models
    csrv = _serve(build_controller(Controller("shortest_queue"), "localhost", 0))
    worker = BatchedWorker(controller_addr=f"http://localhost:{csrv.port}",
                           worker_addr="pending", model_name="slime-tiny-prx",
                           params=params, cfg=cfg, tokenizer=_tok(), max_slots=2,
                           cache_len=96, register=False, device="cpu")
    wsrv = _serve(build_batched(worker, "localhost", 0))
    worker.worker_addr = f"http://localhost:{wsrv.port}"
    worker.register_to_controller()
    try:
        body = json.dumps({"model": "slime-tiny-prx", "prompt": "hello world this is long",
                           "max_new_tokens": 64}).encode()
        s = socket.create_connection(("localhost", csrv.port))
        s.sendall(b"POST /worker_generate_stream HTTP/1.1\r\nHost: x\r\nContent-Length: "
                  + str(len(body)).encode() + b"\r\n\r\n" + body)
        data = b""
        while b"\x00" not in data:
            data += s.recv(4096)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, b"\x01\x00\x00\x00\x00\x00\x00\x00")
        s.close()
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if all(sl is None for sl in worker.engine.slots) and worker.engine.pending.empty():
                break
            time.sleep(0.05)
        assert all(sl is None for sl in worker.engine.slots)
    finally:
        worker.engine.stop()
        wsrv.shutdown()
        csrv.shutdown()
