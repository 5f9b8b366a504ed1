"""Train-state checkpoints: save and restore the parameters, the optimizer
state, the step and the generator, so an interrupted run resumes exactly.

Port of ``slime_tpu/train/state_ckpt.py`` (``save_train_state`` with its
asynchronous form, ``wait_for_saves``, ``restore_train_state``,
``load_meta``, ``latest_checkpoint``; :24-84). JAX writes with Orbax; the
port writes its own format: ``state.pt`` (``torch.save`` of the state, every
tensor copied to the host first) and ``trainer_meta.json`` with the keys
JAX's ``load_meta`` reads, in a ``state-<step>`` directory that appears
atomically. The two packages' state checkpoints are not interchangeable;
their model checkpoints (``checkpoint.save_checkpoint`` /
``save_lora_checkpoint``) are byte for byte the same.

A state is a dict tree whose leaves are tensors, numbers, objects with
``state_dict`` / ``load_state_dict`` (the optimizers) and
``torch.Generator``s (saved as their state).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Dict, List, Optional

import torch

_PENDING: List[threading.Thread] = []
_ERRORS: List[BaseException] = []


def _to_host(node):
    """The state with every tensor copied to the host (the copy a
    background write reads while training moves on)."""
    if isinstance(node, torch.Generator):
        return node.get_state()
    if hasattr(node, "state_dict") and not isinstance(node, torch.Tensor):
        return _to_host(node.state_dict())
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True)
    if isinstance(node, dict):
        return {k: _to_host(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_host(v) for v in node)
    return node


def _write(path: str, host_state: Dict, extra: Optional[Dict]) -> None:
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp-" + os.path.basename(path), dir=parent)
    torch.save(host_state, os.path.join(tmp, "state.pt"))
    if extra:
        with open(os.path.join(tmp, "trainer_meta.json"), "w") as f:
            json.dump(extra, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def save_train_state(path: str, state: Dict, extra: Optional[Dict] = None,
                     async_save: bool = False) -> None:
    """Save the state under ``path`` (a directory that appears atomically).
    ``async_save``: copy to the host now, write in a background thread and
    return (``wait_for_saves`` joins it); ``extra`` then also goes to
    ``<path>.meta.json`` at once, as JAX's asynchronous save writes it."""
    path = os.path.abspath(path)
    host = _to_host(state)
    if not async_save:
        _write(path, host, extra)
        return
    if extra:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)

    def run():
        try:
            _write(path, host, extra)
        except BaseException as e:  # noqa: BLE001 (re-raised by wait_for_saves)
            _ERRORS.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    _PENDING.append(t)


def wait_for_saves() -> None:
    """Block until every asynchronous save is on disk; re-raise a failed one."""
    while _PENDING:
        _PENDING.pop().join()
    if _ERRORS:
        raise _ERRORS.pop()


def _restore_into(target, saved):
    if isinstance(target, torch.Generator):
        target.set_state(saved)
        return target
    if hasattr(target, "load_state_dict") and not isinstance(target, torch.Tensor):
        target.load_state_dict(saved)
        return target
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(saved)
        return target
    if isinstance(target, dict):
        return {k: _restore_into(target[k], saved[k]) for k in target}
    if isinstance(target, (list, tuple)):
        return type(target)(_restore_into(t, s) for t, s in zip(target, saved))
    return saved


def restore_train_state(path: str, target: Optional[Dict] = None) -> Dict:
    """The saved state (host tensors), or, with ``target`` (a live state of
    the same structure), ``target`` with the saved values copied into its
    tensors in place (their devices and dtypes kept), its optimizers and
    generators loaded, and its numbers replaced."""
    saved = torch.load(os.path.join(os.path.abspath(path), "state.pt"),
                       map_location="cpu", weights_only=True)
    return saved if target is None else _restore_into(target, saved)


def load_meta(path: str) -> Dict:
    path = os.path.abspath(path)
    for fp in (os.path.join(path, "trainer_meta.json"), path + ".meta.json"):
        if os.path.exists(fp):
            with open(fp) as f:
                return json.load(f)
    return {}


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The most recent 'state-<step>' directory under output_dir, or None."""
    if not os.path.isdir(output_dir):
        return None
    cands = [(int(d[6:]), os.path.join(output_dir, d)) for d in os.listdir(output_dir)
             if d.startswith("state-") and d[6:].isdigit()]
    return max(cands)[1] if cands else None
