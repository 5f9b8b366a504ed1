"""Training orchestration: SliME's staged training and SFT as one explicit loop.

Port of ``slime_tpu/train/trainer.py`` (``RunConfig``, ``Trainer``,
``run_stage``; :42-251). The staged pretraining runs through it:

- stage 1: ``tune_mm_mlp_adapter``, ``use_global_only``,
  ``mm_learnable_gated=0`` (the gated projector's MLP expert trains);
- stage 2: the same with ``mm_learnable_gated=1`` (the attention adapter);
- stage 3: ``tune_mm_mlp_adapter``, ``use_local_only`` (the compression
  layer, ``sampler``, and the projector).

In all three the LLM body and the vision tower are frozen. ``lora=`` (a
``train.lora`` state) is LoRA mode: only the adapters and the projector and
sampler train, over a frozen base that may be quantized (QLoRA); saves write
the reference's LoRA layout and ``params_host`` the merged tree. ``dpo=`` (a
``train.dpo.DPOConfig``) trains by DPO over stacked pair batches
(``data.dpo.dpo_loader``) in place of the SFT step: full-parameter against
``ref_params`` (by default the tree the trainer starts from, which it never
writes: its trainable leaves are copies), or LoRA-DPO against the frozen
base; logging, saving and resume are the SFT step's.

The input pipeline's ``Prefetcher`` runs the host-to-device copy in its
producer thread, from pinned memory. Every ``save_steps`` the trainer writes
a model checkpoint (``checkpoint-<step>``) and a train-state checkpoint
(``state-<step>``: parameters, optimizer, step and generator); a SIGTERM
(``PreemptionGuard``) writes the state and ends the loop. A new trainer in
the same output directory (or with ``resume_from``) resumes from the latest
state and continues exactly; like JAX's it feeds the batches it is given
from their start (consumed batches are not skipped). The step counter stays
on the host; device scalars are read only at log steps.

``mesh=`` trains on every rank of a ``parallel.mesh.Mesh`` (trainer.py:58-157):
each rank is given the global batches and feeds its rows of each
(``mesh.shard_batch``, data-major over data x fsdp as JAX's; DPO batches by
whole pairs, ``shard_pairs``), the parameters and the optimizer state are
this rank's shards, and the steps are the mesh steps of ``train.step``. Only
rank 0 logs and writes model checkpoints (the tensors gathered whole from
every rank first, so the files are a single card's); each rank writes its
own train-state shard (``state-<step>/rank-<r>``), which resumes only on a
mesh of the same shape (JAX's Orbax reshards; the port's format was never
exchangeable with it).
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
from ..parallel.memory_plan import check_grad_accum_fit
from ..parallel.mesh import on_mesh, shard_batch, shard_params, unshard_params
from ..params import map_leaves, named_leaves
from . import lora as lora_lib
from . import state_ckpt
from .optim import TrainConfig
from .preemption import PreemptionGuard
from .step import (init_lora_train_state, init_train_state, make_lora_train_step,
                   make_train_step)


@dataclasses.dataclass
class RunConfig:
    output_dir: str = "./out"
    save_steps: int = 1000
    log_steps: int = 10
    max_steps: Optional[int] = None
    seed: int = 3407                      # reference fixed seed (train.py:1202-1213)
    adapters_only_save: bool = False      # staged pretrain: mm_projector/sampler only
    resume_from: Optional[str] = None
    async_save: bool = False              # train-state saves written in the background
    handle_preemption: bool = True        # SIGTERM -> state save + clean exit
    prefetch_depth: int = 2               # input-pipeline queue depth (0 = off)


def _first_device(params):
    return next(leaf for _, leaf in named_leaves(params)).device


def shard_pairs(mesh, batch):
    """This rank's pairs of a stacked DPO batch ([2B] rows, chosen first;
    per-pair leaves [B]): the same pair rows from both halves, so a pair's
    chosen and rejected rows stay on one rank."""
    n = batch["input_ids"].shape[0] // 2

    def take(_, x):
        if x is None or np.ndim(x) == 0:
            return x
        if np.shape(x)[0] == 2 * n:
            halves = shard_batch(mesh, {"c": x[:n], "r": x[n:]})
            return np.concatenate([halves["c"], halves["r"]])
        return shard_batch(mesh, x)
    return map_leaves(take, batch)


class Trainer:
    def __init__(self, params, cfg: SliMEConfig, tc: TrainConfig, rc: RunConfig,
                 *, compute_dtype=None, use_kernel: Optional[bool] = None,
                 remat: bool = False, generator: Optional[torch.Generator] = None,
                 lora=None, dpo=None, ref_params=None, mesh=None):
        """``params``: the parameter tree on its device; the trainer trains
        copies of its trainable leaves and shares the frozen ones.
        ``lora``: a ``train.lora`` state switches to LoRA mode (``params``
        may hold a quantized LLM: QLoRA). ``dpo``: a ``train.dpo.DPOConfig``
        switches the objective to DPO; full-parameter DPO's reference is
        ``ref_params`` (default: ``params`` itself, never written), LoRA-DPO's
        the frozen base. ``generator`` feeds the training noise (default: a
        generator on the parameters' device seeded with ``rc.seed``); its
        state is part of the train-state checkpoint. ``mesh``: train on
        every rank of it (see the module docstring)."""
        self.cfg, self.tc, self.rc = cfg, tc, rc
        self.compute_dtype = compute_dtype or torch.bfloat16
        self.lora = lora
        self.dpo = dpo
        self.mesh = mesh
        self.main = mesh is None or mesh.rank == 0
        if mesh is not None and not on_mesh(params, mesh):
            params = shard_params(mesh, params)
        kw = dict(use_kernel=use_kernel, compute_dtype=self.compute_dtype, remat=remat,
                  mesh=mesh)
        if dpo is not None:
            from .dpo import make_dpo_train_step, make_lora_dpo_train_step
            if lora is not None:
                self.base, self.state, self.tx = init_lora_train_state(params, lora, tc,
                                                                       mesh=mesh)
                dpo_step = make_lora_dpo_train_step(cfg, tc, self.tx, dpo, rank=lora["rank"],
                                                    alpha=lora["alpha"], **kw)
                ref = self.base
            else:
                self.state, self.tx = init_train_state(params, tc, mesh=mesh)
                dpo_step = make_dpo_train_step(cfg, tc, self.tx, dpo, **kw)
                if ref_params is not None and mesh is not None:
                    ref_params = shard_params(mesh, ref_params)
                ref = map_leaves(lambda _, t: t.detach(),
                                 ref_params if ref_params is not None else params)
            self.step_fn = lambda state, batch, g: dpo_step(state, ref, batch, g)
        elif lora is not None:
            self.base, self.state, self.tx = init_lora_train_state(params, lora, tc,
                                                                   mesh=mesh)
            lora_step = make_lora_train_step(
                cfg, tc, self.tx, rank=lora["rank"], alpha=lora["alpha"], **kw)
            base = self.base    # bound here: a closure over self would make a cycle
            self.step_fn = lambda state, batch, g: lora_step(state, base, batch, g)
        else:
            self.state, self.tx = init_train_state(params, tc, mesh=mesh)
            self.step_fn = make_train_step(cfg, tc, self.tx, **kw)
        if tc.gradient_accumulation_steps > 1:
            # fail fast if the fp32 accumulator provably cannot fit next to
            # the state just built (only the trainable leaves accumulate)
            trainable = [leaf for _, leaf in named_leaves(self.state["params"])
                         if leaf.requires_grad]
            check_grad_accum_fit(trainable, tc.gradient_accumulation_steps)
        self.device = _first_device(params)
        self.generator = generator or torch.Generator(device=self.device).manual_seed(rc.seed)
        resume = rc.resume_from or state_ckpt.latest_checkpoint(rc.output_dir)
        if resume:
            self.state["step"] = state_ckpt.restore_train_state(
                self._state_path(resume, check=True), target=self._checkpointed())["step"]
            if self.main:
                print(f"[train] resumed from {resume} at step {self.state['step']}",
                      flush=True)
        self.metrics_file = os.path.join(rc.output_dir, "metrics.jsonl")
        os.makedirs(rc.output_dir, exist_ok=True)

    def _checkpointed(self) -> Dict:
        """What a train-state checkpoint holds: the trainable tree, the
        optimizer, the step and the generator."""
        return {"params": self.state["params"], "opt_state": self.tx,
                "step": self.state["step"], "generator": self.generator}

    def _mesh_shape(self):
        return None if self.mesh is None else [self.mesh.shape[a]
                                               for a in ("data", "fsdp", "model")]

    def _state_path(self, path: str, check: bool = False) -> str:
        """This rank's train-state directory under ``path``; ``check``
        refuses one written on another mesh (or without one)."""
        mine = path if self.mesh is None else os.path.join(path, f"rank-{self.mesh.rank}")
        if check:
            saved = state_ckpt.load_meta(mine).get("mesh") if os.path.isdir(mine) else "?"
            if saved != self._mesh_shape():
                raise ValueError(
                    f"train state {path} was written on mesh {saved} "
                    f"(data, fsdp, model); this run's is {self._mesh_shape()}. The "
                    f"port resumes a train state only on the mesh that wrote it")
        return mine

    def save_state(self, step: int, **meta) -> None:
        state_ckpt.save_train_state(
            self._state_path(os.path.join(self.rc.output_dir, f"state-{step}")),
            self._checkpointed(), extra={"step": step, **({"mesh": self._mesh_shape()}
                                                          if self.mesh is not None else {}),
                                         **meta},
            async_save=self.rc.async_save and not meta)

    @property
    def params(self):
        return self.state["params"]

    def train(self, batches: Iterable[Dict]) -> Dict:
        guard = PreemptionGuard()
        use_guard = self.rc.handle_preemption and PreemptionGuard.install_ok()
        with (guard if use_guard else contextlib.nullcontext()):
            return self._train_loop(batches, guard if use_guard else None)

    def _put(self, batch):
        """Numpy batch -> tensors on the trainer's device (pinned, async);
        under a mesh this rank's rows of it."""
        if self.mesh is not None:
            batch = (shard_pairs if self.dpo is not None else shard_batch)(self.mesh, batch)
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
        try:
            return self._steps(batches, pf, guard)
        finally:
            if pf is not None:
                pf.close()

    def _steps(self, batches, pf, guard) -> Dict:
        t_loop0 = last_log = time.perf_counter()
        tokens_since = 0
        step = self.state["step"]
        m = {}
        for batch in batches:
            if self.rc.max_steps is not None and step >= self.rc.max_steps:
                break
            if guard is not None and guard.triggered:
                if self.main:
                    print(f"[train] preemption signal: saving state-{step} and exiting",
                          flush=True)
                self.save_state(step, preempted=True)
                break
            self.state, m = self.step_fn(self.state, batch, self.generator)
            tokens_since += int(np.prod(batch["input_ids"].shape)) * (
                1 if self.mesh is None else self.mesh.axis_size("dp"))

            step += 1
            if step % self.rc.log_steps == 0 and self.main:
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
                self.save_state(step)
        state_ckpt.wait_for_saves()
        return {k: float(v) for k, v in m.items()}

    def save(self, path: str) -> None:
        """Write a checkpoint directory: in LoRA mode the reference's LoRA
        layout (``checkpoint.save_lora_checkpoint``: adapters, the
        projector and sampler); else ``checkpoint.save_checkpoint``, the
        projector and sampler only with ``adapters_only_save`` (the
        staged-pretrain files), or the whole tree. Under a mesh every rank
        calls it (the tensors are gathered) and rank 0 writes."""
        if self.lora is not None:
            trainable = self._whole(self.state["params"])
            if not self.main:
                return
            ckpt_lib.save_lora_checkpoint(
                path, trainable["extras"],
                {"rank": self.lora["rank"], "alpha": self.lora["alpha"],
                 "adapters": trainable["adapters"]}, self.cfg)
            return
        params = self.params
        if self.rc.adapters_only_save:
            params = {k: params[k] for k in ("projector", "sampler") if k in params}
        params = self._whole(params)
        if not self.main:
            return
        ckpt_lib.save_checkpoint(path, params, self.cfg,
                                 adapters_only=self.rc.adapters_only_save)

    def _whole(self, tree):
        """``tree`` with every shard gathered whole (a collective under a
        mesh; the tree itself without one)."""
        return tree if self.mesh is None else unshard_params(self.mesh, tree)

    def params_host(self):
        """The trained tree on the host: in LoRA mode the base with the
        trained extras and the adapters merged in (``lora.merge``); whole
        tensors under a mesh (every rank calls it)."""
        params = self._whole(self.params)
        if self.lora is not None:
            params = lora_lib.merge(
                {**self._whole(self.base), **params["extras"]},
                {"rank": self.lora["rank"], "alpha": self.lora["alpha"],
                 "adapters": params["adapters"]})
        return map_leaves(lambda _, t: t.detach().to("cpu"), params)


def run_stage(params, cfg: SliMEConfig, tc: TrainConfig, rc: RunConfig,
              batches: Iterable[Dict], **trainer_kwargs):
    """Run one training stage -> (the trained parameter tree, the last step's
    metrics). ``trainer_kwargs`` go to ``Trainer`` (``remat``,
    ``use_kernel``, ``compute_dtype``, ``generator``)."""
    tr = Trainer(params, cfg, tc, rc, **trainer_kwargs)
    metrics = tr.train(batches)
    return tr.params, metrics
