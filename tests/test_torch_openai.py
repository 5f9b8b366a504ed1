"""The OpenAI-compatible routes on the port's batched worker (the port's own
copy of ``serve/openai_api.py``): the counterparts of
``tests/test_openai_api.py`` against a live threaded server on the CPU at
``SliMEConfig.tiny()`` (the JAX package's random params through
``params.from_jax_numpy``, the offline toy tokenizer, fp32).

Chat completions as JSON and SSE (streamed text equal to the non-streamed
text at greedy), text completions, /v1/models, ``response_format``
through the constrained decoder, ``n`` choices (equal at greedy, usage
summed, streamed per index), and message rendering equal to the JAX
package's.
"""
import json
import threading

import jax
import pytest
import requests

from slime_tpu.config import SliMEConfig as JCfg
from slime_tpu.conversation import conv_templates as jconv_templates
from slime_tpu.models import slime as jslime
from slime_tpu.serve.openai_api import render_messages as jrender
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import SliMEConfig
from slime_tpu_torch.conversation import conv_templates
from slime_tpu_torch.models import llama
from slime_tpu_torch.serve.batched_worker import BatchedWorker, build_server
from slime_tpu_torch.serve.openai_api import render_messages

from .toy_tokenizer import ToyTokenizer

MSGS = [
    {"role": "system", "content": "Be terse."},
    {"role": "user", "content": [
        {"type": "text", "text": "what is this?"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,QUJD"}}]},
    {"role": "assistant", "content": "a cat"},
    {"role": "user", "content": "sure?"},
]


@pytest.fixture(scope="module")
def server():
    params = bridge.from_jax_numpy(jax.device_get(jslime.init(jax.random.PRNGKey(0),
                                                              JCfg.tiny())), device="cpu")
    params["llm"]["layers"] = llama.stack_layers(params["llm"]["layers"])
    tok = ToyTokenizer()
    tok("hello world this is a longer seed sentence for vocab yes no")
    worker = BatchedWorker(controller_addr=None, worker_addr="x", model_name="slime-tiny",
                           params=params, cfg=SliMEConfig.tiny(), tokenizer=tok,
                           max_slots=2, cache_len=128, register=False, device="cpu")
    srv = build_server(worker, "localhost", 0, conv_mode="llava_v1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://localhost:{srv.port}", worker
    worker.engine.stop()
    srv.shutdown()


def _post(url, body, timeout=180):
    return requests.post(url, json=body, timeout=timeout).json()


def test_render_messages_template_and_images():
    prompt, images = render_messages(MSGS, conv_templates["llava_v1"])
    assert prompt.startswith("Be terse.")
    assert "<image>\nwhat is this?" in prompt
    assert "USER" in prompt and "ASSISTANT" in prompt
    assert prompt.rstrip().endswith("ASSISTANT:")
    assert images == ["QUJD"]


@pytest.mark.parametrize("mode", ["llava_v1", "llama3", "chatml_direct", "mistral_instruct"])
def test_render_messages_matches_jax(mode):
    """The own copies of conversation.py and openai_api.py render what the
    JAX package's render, template by template."""
    assert render_messages(MSGS, conv_templates[mode]) == jrender(MSGS, jconv_templates[mode])


def test_render_rejects_unknown_role():
    with pytest.raises(ValueError):
        render_messages([{"role": "tool", "content": "x"}], conv_templates["llava_v1"])


def test_models_endpoint(server):
    url, _ = server
    got = _post(f"{url}/v1/models", {}, timeout=30)
    assert got["object"] == "list" and got["data"][0]["id"] == "slime-tiny"


def test_chat_completion_json(server):
    url, _ = server
    got = _post(f"{url}/v1/chat/completions",
                {"model": "slime-tiny", "max_tokens": 6, "temperature": 0,
                 "messages": [{"role": "user", "content": "hello world this is"}]})
    assert got["object"] == "chat.completion"
    ch = got["choices"][0]
    assert ch["message"]["role"] == "assistant" and isinstance(ch["message"]["content"], str)
    assert ch["finish_reason"] in ("stop", "length")
    u = got["usage"]
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    assert u["completion_tokens"] >= 1


def _sse(url, body):
    r = requests.post(url, json=body, stream=True, timeout=180)
    assert r.headers["Content-Type"].startswith("text/event-stream")
    frames, done = [], False
    for line in r.iter_lines():
        if not line:
            continue
        assert line.startswith(b"data: ")
        payload = line[len(b"data: "):]
        if payload == b"[DONE]":
            done = True
            break
        frames.append(json.loads(payload))
    assert done
    return frames


def test_chat_completion_stream_sse(server):
    url, _ = server
    body = {"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 5,
            "temperature": 0, "stream": True}
    frames = _sse(f"{url}/v1/chat/completions", body)
    assert frames[0]["choices"][0]["delta"].get("role") == "assistant"
    text = "".join(f["choices"][0]["delta"].get("content", "") for f in frames)
    assert len(text) > 0
    assert frames[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    body.pop("stream")
    got = _post(f"{url}/v1/chat/completions", body)
    assert got["choices"][0]["message"]["content"] == text


def test_text_completions(server):
    url, _ = server
    got = _post(f"{url}/v1/completions", {"prompt": "hello world this", "max_tokens": 4,
                                          "temperature": 0})
    assert got["object"] == "text_completion" and isinstance(got["choices"][0]["text"], str)


def test_response_format_json_object(server):
    """json_object goes through the constrained decoder; the toy vocabulary
    has no JSON punctuation, so no path is live and the output is empty
    (a forced stop), never malformed text."""
    url, worker = server
    got = _post(f"{url}/v1/chat/completions",
                {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 20,
                 "temperature": 0, "response_format": {"type": "json_object"}})
    assert got["choices"][0]["message"]["content"].strip() in ("", "{}", "{ }")
    assert len(worker.engine.grammars) >= 1


def test_chat_n_choices_greedy_identical(server):
    url, _ = server
    base = {"model": "slime-tiny", "max_tokens": 5, "temperature": 0,
            "messages": [{"role": "user", "content": "hello world this is"}]}
    one = _post(f"{url}/v1/chat/completions", base)
    got = _post(f"{url}/v1/chat/completions", {**base, "n": 3})
    assert [c["index"] for c in got["choices"]] == [0, 1, 2]
    for c in got["choices"]:
        assert c["message"]["content"] == one["choices"][0]["message"]["content"]
        assert c["finish_reason"] in ("stop", "length")
    assert got["usage"]["completion_tokens"] == 3 * one["usage"]["completion_tokens"]


def test_chat_n_choices_stream_interleaved(server):
    url, _ = server
    body = {"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 4,
            "temperature": 0, "n": 2, "stream": True}
    texts, finish = {0: "", 1: ""}, {}
    for f in _sse(f"{url}/v1/chat/completions", body):
        c = f["choices"][0]
        texts[c["index"]] += c["delta"].get("content") or ""
        if c["finish_reason"]:
            finish[c["index"]] = c["finish_reason"]
    assert set(finish) == {0, 1}
    got = _post(f"{url}/v1/chat/completions", {k: v for k, v in body.items() if k != "stream"})
    for c in got["choices"]:
        assert texts[c["index"]] == c["message"]["content"]


def test_completions_n_choices(server):
    url, _ = server
    got = _post(f"{url}/v1/completions", {"prompt": "hello world this", "max_tokens": 4,
                                          "temperature": 0, "n": 2})
    assert [c["index"] for c in got["choices"]] == [0, 1]
    assert got["choices"][0]["text"] == got["choices"][1]["text"]
