"""Serving controller (the port's own copy of
``slime_tpu/serve/controller.py``; stdlib HTTP, ``requests`` imported where
it is used): worker registry, heartbeats, dispatch, stream proxying.

Workers POST /register_worker and /receive_heart_beat; clients POST
/list_models, /get_worker_address and /worker_generate_stream (proxied to
the chosen worker). Dispatch: LOTTERY (speed-weighted random) or
SHORTEST_QUEUE (queue length over speed). Silent workers expire after
CONTROLLER_HEART_BEAT_EXPIRATION seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..constants import CONTROLLER_HEART_BEAT_EXPIRATION
from .protocol import ErrorCode, SERVER_ERROR_MSG, JsonHTTPServer, iter_stream_response


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        assert dispatch_method in ("lottery", "shortest_queue")
        self.dispatch_method = dispatch_method
        self.workers: Dict[str, WorkerInfo] = {}
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._hb_thread = threading.Thread(target=self._expire_loop, daemon=True)
        self._hb_thread.start()

    # -- registry ------------------------------------------------------------
    def register_worker(self, name: str, check_heart_beat: bool,
                        status: Optional[dict]) -> bool:
        if status is None:
            status = self._get_worker_status(name)
        if status is None:
            return False
        with self.lock:
            self.workers[name] = WorkerInfo(
                status["model_names"], status["speed"], status["queue_length"],
                check_heart_beat, time.time())
        return True

    def _get_worker_status(self, name: str) -> Optional[dict]:
        import requests
        try:
            r = requests.post(name + "/worker_get_status", json={}, timeout=5)
            return r.json() if r.status_code == 200 else None
        except Exception:
            return None

    def refresh_all_workers(self) -> None:
        with self.lock:
            old = dict(self.workers)
            self.workers = {}
        for name, info in old.items():
            self.register_worker(name, info.check_heart_beat, None)

    def receive_heart_beat(self, name: str, queue_length: int) -> bool:
        with self.lock:
            if name not in self.workers:
                return False
            self.workers[name].queue_length = queue_length
            self.workers[name].last_heart_beat = time.time()
            return True

    def _expire_loop(self) -> None:
        while not self._stop.wait(CONTROLLER_HEART_BEAT_EXPIRATION):
            expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
            with self.lock:
                dead = [n for n, w in self.workers.items()
                        if w.check_heart_beat and w.last_heart_beat < expire]
                for n in dead:
                    del self.workers[n]

    # -- dispatch ------------------------------------------------------------
    def list_models(self) -> List[str]:
        with self.lock:
            names = set()
            for w in self.workers.values():
                names.update(w.model_names)
        return sorted(names)

    def get_worker_address(self, model_name: str) -> str:
        with self.lock:
            cands = [(n, w) for n, w in self.workers.items()
                     if model_name in w.model_names]
        if not cands:
            return ""
        if self.dispatch_method == "lottery":
            speeds = np.asarray([w.speed for _, w in cands], np.float32)
            if speeds.sum() < 1e-4:
                return ""
            probs = speeds / speeds.sum()
            return cands[int(np.random.choice(len(cands), p=probs))][0]
        # shortest_queue: min queue_length normalized by speed
        qs = [w.queue_length / max(w.speed, 1e-4) for _, w in cands]
        idx = int(np.argmin(qs))
        name, w = cands[idx]
        with self.lock:
            if name in self.workers:
                self.workers[name].queue_length += 1
        return name

    def worker_api_generate_stream(self, params: dict):
        import requests
        addr = self.get_worker_address(params.get("model", ""))
        if not addr:
            yield {"text": SERVER_ERROR_MSG, "error_code": ErrorCode["SERVER_ERROR"]}
            return
        r = None
        try:
            r = requests.post(addr + "/worker_generate_stream", json=params,
                              stream=True, timeout=100)
            yield from iter_stream_response(r)
        except Exception:
            yield {"text": SERVER_ERROR_MSG, "error_code": ErrorCode["SERVER_ERROR"]}
        finally:
            # our client hung up (GeneratorExit lands at the yield): drop the
            # upstream connection too, so the worker sees the disconnect and
            # cancels its engine request instead of decoding to budget
            if r is not None:
                r.close()

    def worker_api_get_status(self) -> dict:
        names = self.list_models()
        with self.lock:
            speed = sum(w.speed for w in self.workers.values())
            ql = sum(w.queue_length for w in self.workers.values())
        return {"model_names": names, "speed": speed, "queue_length": ql}


def build_server(controller: Controller, host: str, port: int) -> JsonHTTPServer:
    srv = JsonHTTPServer(host, port)
    srv.route("/register_worker", lambda b: {"exist": controller.register_worker(
        b["worker_name"], b.get("check_heart_beat", True), b.get("worker_status"))})
    srv.route("/refresh_all_workers", lambda b: controller.refresh_all_workers())
    srv.route("/list_models", lambda b: {"models": controller.list_models()})
    srv.route("/get_worker_address", lambda b: {
        "address": controller.get_worker_address(b["model"])})
    srv.route("/receive_heart_beat", lambda b: {"exist": controller.receive_heart_beat(
        b["worker_name"], b["queue_length"])})
    srv.route("/worker_get_status", lambda b: controller.worker_api_get_status())
    srv.stream_route("/worker_generate_stream",
                     controller.worker_api_generate_stream)
    return srv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=21001)
    ap.add_argument("--dispatch-method", default="shortest_queue",
                    choices=["lottery", "shortest_queue"])
    args = ap.parse_args()
    c = Controller(args.dispatch_method)
    srv = build_server(c, args.host, args.port)
    print(f"controller listening on {args.host}:{srv.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
