"""Training orchestration: SliME's staged training as one explicit loop.

Port of ``slime_tpu/train/trainer.py`` (``RunConfig``, ``Trainer`` without
its LoRA and DPO branches, ``run_stage``; :42-143, :145-251). The staged
pretraining runs through it:

- stage 1: ``tune_mm_mlp_adapter``, ``use_global_only``,
  ``mm_learnable_gated=0`` (the gated projector's MLP expert trains);
- stage 2: the same with ``mm_learnable_gated=1`` (the attention adapter);
- stage 3: ``tune_mm_mlp_adapter``, ``use_local_only`` (the compression
  layer, ``sampler``, and the projector).

In all three the LLM body and the vision tower are frozen.

The input pipeline's ``Prefetcher`` runs the host-to-device copy in its
producer thread, from pinned memory; a SIGTERM (``PreemptionGuard``) saves
the parameters and ends the loop; ``checkpoint.save_checkpoint`` writes the
reference's files (the staged ``mm_projector.bin`` / ``sampler.bin``). The
step counter stays on the host; device scalars are read only at log steps.

Not ported yet (ROADMAP): the Orbax train-state save and resume
(``state_ckpt``; a ``resume_from`` or a found ``state-*`` directory raises,
and a save step or a preemption writes the parameter checkpoint only), LoRA
and DPO.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .. import checkpoint as ckpt_lib
from ..config import SliMEConfig
from ..data.dataset import Prefetcher
from ..params import named_leaves
from . import state_ckpt
from .optim import TrainConfig
from .preemption import PreemptionGuard
from .step import init_train_state, make_train_step

_TODO = "is not ported yet (ROADMAP: the port's training queue)"


@dataclasses.dataclass
class RunConfig:
    output_dir: str = "./out"
    save_steps: int = 1000
    log_steps: int = 10
    max_steps: Optional[int] = None
    seed: int = 3407                      # reference fixed seed (train.py:1202-1213)
    adapters_only_save: bool = False      # staged pretrain: mm_projector/sampler only
    resume_from: Optional[str] = None
    handle_preemption: bool = True        # SIGTERM -> save + clean exit
    prefetch_depth: int = 2               # input-pipeline queue depth (0 = off)


def _first_device(params):
    return next(leaf for _, leaf in named_leaves(params)).device


class Trainer:
    def __init__(self, params, cfg: SliMEConfig, tc: TrainConfig, rc: RunConfig,
                 *, compute_dtype=None, use_kernel: Optional[bool] = None,
                 remat: bool = False, generator: Optional[torch.Generator] = None,
                 lora=None, dpo=None, ref_params=None):
        """``params``: the parameter tree on its device; the trainer trains
        copies of its trainable leaves and shares the frozen ones.
        ``generator`` feeds the training noise (default: a generator on the
        parameters' device seeded with ``rc.seed``)."""
        if lora is not None or dpo is not None or ref_params is not None:
            raise NotImplementedError(f"LoRA / DPO training {_TODO}")
        self.cfg, self.tc, self.rc = cfg, tc, rc
        self.compute_dtype = compute_dtype or torch.bfloat16
        self.state, self.tx = init_train_state(params, tc)
        self.step_fn = make_train_step(cfg, tc, self.tx, use_kernel=use_kernel,
                                       compute_dtype=self.compute_dtype, remat=remat)
        resume = rc.resume_from or state_ckpt.latest_checkpoint(rc.output_dir)
        if resume:
            raise NotImplementedError(f"resuming from {resume}: the train-state "
                                      f"checkpoint (state_ckpt) {_TODO}")
        self.device = _first_device(params)
        self.generator = generator or torch.Generator(device=self.device).manual_seed(rc.seed)
        self.metrics_file = os.path.join(rc.output_dir, "metrics.jsonl")
        os.makedirs(rc.output_dir, exist_ok=True)

    @property
    def params(self):
        return self.state["params"]

    def train(self, batches: Iterable[Dict]) -> Dict:
        guard = PreemptionGuard()
        use_guard = self.rc.handle_preemption and PreemptionGuard.install_ok()
        with (guard if use_guard else contextlib.nullcontext()):
            return self._train_loop(batches, guard if use_guard else None)

    def _put(self, batch):
        """Numpy batch -> tensors on the trainer's device (pinned, async)."""
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if cuda:
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=cuda)
        return out

    def _train_loop(self, batches: Iterable[Dict], guard) -> Dict:
        pf = None
        if self.rc.prefetch_depth > 0:
            pf = Prefetcher(iter(batches), depth=self.rc.prefetch_depth,
                            map_fn=self._put)
            batches = pf
        else:
            batches = (self._put(b) for b in batches)

        t_loop0 = last_log = time.perf_counter()
        tokens_since = 0
        step = self.state["step"]
        m = {}
        for batch in batches:
            if self.rc.max_steps is not None and step >= self.rc.max_steps:
                break
            if guard is not None and guard.triggered:
                print(f"[train] preemption signal: saving checkpoint-{step} "
                      "(parameters only) and exiting", flush=True)
                self.save(os.path.join(self.rc.output_dir, f"checkpoint-{step}"))
                break
            self.state, m = self.step_fn(self.state, batch, self.generator)
            tokens_since += int(np.prod(batch["input_ids"].shape))

            step += 1
            if step % self.rc.log_steps == 0:
                dt = time.perf_counter() - last_log
                rec = {"step": step, "loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "tokens_per_sec": tokens_since / max(dt, 1e-9)}
                if "n_target_tokens" in m:
                    rec["target_tokens"] = int(m["n_target_tokens"])
                if pf is not None:
                    rec["host_stall_frac"] = pf.stall_s / max(
                        time.perf_counter() - t_loop0, 1e-9)
                for k in m:
                    if k not in ("loss", "grad_norm", "n_target_tokens"):
                        rec[k] = float(m[k])
                print(f"[train] {json.dumps(rec)}", flush=True)
                with open(self.metrics_file, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                last_log = time.perf_counter()
                tokens_since = 0
            if self.rc.save_steps and step % self.rc.save_steps == 0:
                self.save(os.path.join(self.rc.output_dir, f"checkpoint-{step}"))
        return {k: float(v) for k, v in m.items()}

    def save(self, path: str) -> None:
        """Write a checkpoint directory (``checkpoint.save_checkpoint``): the
        projector and sampler only with ``adapters_only_save`` (the
        staged-pretrain files), else the whole tree."""
        params = self.params
        if self.rc.adapters_only_save:
            params = {k: params[k] for k in ("projector", "sampler") if k in params}
        ckpt_lib.save_checkpoint(path, params, self.cfg,
                                 adapters_only=self.rc.adapters_only_save)


def run_stage(params, cfg: SliMEConfig, tc: TrainConfig, rc: RunConfig,
              batches: Iterable[Dict], **trainer_kwargs):
    """Run one training stage -> (the trained parameter tree, the last step's
    metrics). ``trainer_kwargs`` go to ``Trainer`` (``remat``,
    ``use_kernel``, ``compute_dtype``, ``generator``)."""
    tr = Trainer(params, cfg, tc, rc, **trainer_kwargs)
    metrics = tr.train(batches)
    return tr.params, metrics
