"""Shared serving protocol pieces (the port's own copy of
``slime_tpu/serve/protocol.py``; stdlib only): the error envelope and the
JSON-over-HTTP server.

The wire protocol is the reference's (llava/serve/*): JSON POST bodies,
streaming responses as b"\\0"-delimited JSON chunks, error_code envelopes;
OpenAI routes stream server-sent events.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable

SERVER_ERROR_MSG = ("**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE OR "
                    "REFRESH THIS PAGE.**")

ErrorCode = {
    "OK": 0,
    "SERVER_ERROR": 1,
    "OUT_OF_MEMORY": 2,
    "CONTEXT_OVERFLOW": 3,
}

DELIM = b"\0"


class JsonHTTPServer:
    """Minimal threaded JSON HTTP server: route table of
    path -> fn(body_dict) -> dict | iterator-of-dicts (streamed)."""

    def __init__(self, host: str, port: int):
        self.routes: Dict[str, Callable] = {}
        self.stream_routes: Dict[str, Callable] = {}
        self.sse_routes: Dict[str, Callable] = {}   # OpenAI-style SSE
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path in outer.sse_routes and (
                        body.get("stream")
                        or self.path not in outer.routes):
                    # server-sent events (the OpenAI streaming wire format):
                    # "data: <json>\n\n" frames, closed by "data: [DONE]".
                    # A path registered BOTH ways (OpenAI chat/completions)
                    # streams iff the body asks for it — OpenAI clients post
                    # stream=true to the same endpoint
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    gen = outer.sse_routes[self.path](body)
                    try:
                        for chunk in gen:
                            self.wfile.write(b"data: "
                                             + json.dumps(chunk).encode()
                                             + b"\n\n")
                            self.wfile.flush()
                        self.wfile.write(b"data: [DONE]\n\n")
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        # client went away: close the generator NOW so the
                        # producer can cancel its in-flight engine request
                        if hasattr(gen, "close"):
                            gen.close()
                    return
                if self.path in outer.stream_routes:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.end_headers()
                    gen = outer.stream_routes[self.path](body)
                    try:
                        for chunk in gen:
                            self.wfile.write(json.dumps(chunk).encode() + DELIM)
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        # client went away: close the generator NOW so the
                        # producer can cancel its in-flight engine request
                        if hasattr(gen, "close"):
                            gen.close()
                    return
                fn = outer.routes.get(self.path)
                if fn is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                out = fn(body)
                data = json.dumps(out or {}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def route(self, path: str, fn: Callable) -> None:
        self.routes[path] = fn

    def stream_route(self, path: str, fn: Callable) -> None:
        self.stream_routes[path] = fn

    def sse_route(self, path: str, fn: Callable) -> None:
        self.sse_routes[path] = fn

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()


def iter_stream_response(resp) -> Iterable[dict]:
    """Client side: parse a b'\\0'-delimited JSON stream (requests response)."""
    for chunk in resp.iter_lines(decode_unicode=False, delimiter=DELIM):
        if chunk:
            yield json.loads(chunk.decode())
