"""Direct Preference Optimization over stacked pair batches.

Port of ``slime_tpu/train/dpo.py`` (``DPOConfig``, ``dpo_losses``,
``_fused_weights``, ``pair_logps``, ``_dpo_metrics``, ``_dpo_objective``,
``make_dpo_train_step``, ``make_lora_dpo_train_step``; :60-296):

- One forward over the ``[2B, S]`` pair batch, chosen rows first, rejected
  after (``data.dpo.collate_dpo``); the pixels and crop masks of the ``B``
  pairs are tiled to both halves.
- Per-row log-probs come from ``ops.loss.chunked_sequence_logp``, so the
  ``[2B, S, V]`` logits never exist; each chunk is a checkpoint region in
  the policy's forward.
- The crop selection runs with ``training=False``: the implicit reward
  ``beta * (logp_policy - logp_ref)`` takes no selection noise.
- The reference's log-probs are computed under ``torch.no_grad()`` before
  the policy's forward: the backward spans the policy alone.
- Full-parameter DPO takes a frozen ``ref_params`` tree (the ``Trainer``'s
  default: the tree it started from, which its step never writes). LoRA-DPO's
  reference is the frozen base with the adapters off and the original
  projector and sampler; the policy trains copies of those (the extras).

Loss types: ``sigmoid`` -log sigmoid(beta h), ``ipo`` (h - 1/(2 beta))^2 and
``kto_pair`` (chosen and rejected terms against clipped batch-mean KLs,
[2B] losses), with h = (pi_c - pi_r) - (ref_c - ref_r). ``use_average``
divides each row's log-prob by its target mass; ``token_weighted`` takes the
batch's per-target weights (``target_weights`` [2B, T]) onto the fused rows;
``sft_weight`` adds the chosen rows' per-token NLL.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import IGNORE_INDEX, SliMEConfig
from ..models import slime
from ..models.layers import fp32_accumulation
from ..ops.loss import DEFAULT_LOSS_CHUNK, chunked_sequence_logp
from ..parallel import tensor_parallel as tp
from ..parallel.mesh import active as active_mesh, use_mesh
from . import lora as lora_lib
from .optim import TrainConfig

LOSS_TYPES = ("sigmoid", "ipo", "kto_pair")


@dataclasses.dataclass
class DPOConfig:
    """The reference's DPO fields (train.py:133-166)."""
    beta: float = 0.1                 # dpo_beta
    loss_type: str = "sigmoid"        # [sigmoid, ipo, kto_pair]
    use_average: bool = False         # dpo_use_average
    token_weighted: bool = False      # dpo_token_weighted
    token_weight: float = 1.1         # dpo_token_weight
    sft_weight: float = 0.0           # sft_weight
    dpo_weight: float = 1.0           # dpo_weight

    def __post_init__(self):
        if self.loss_type not in LOSS_TYPES:
            raise ValueError(f"loss_type {self.loss_type!r} not in {LOSS_TYPES}")


def _mean(x):
    """The mean over the global batch: under a mesh whose batch axes hold
    several ranks, each rank's sum and count are all-reduced (a pair's rows
    stay on one rank, ``trainer.shard_pairs``)."""
    mesh = active_mesh()
    if mesh is None or mesh.axis_size("dp") == 1:
        return x.mean()
    n = tp.reduce_dp(torch.tensor(float(x.numel()), device=x.device))
    return tp.reduce_dp(x.sum()) / n


def _sum(x):
    mesh = active_mesh()
    return x.sum() if mesh is None or mesh.axis_size("dp") == 1 else tp.reduce_dp(x.sum())


def dpo_losses(policy_chosen, policy_rejected, ref_chosen, ref_rejected, *,
               beta: float, loss_type: str = "sigmoid"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B] sequence log-probs -> (losses, chosen rewards, rejected rewards);
    the losses are [B] for sigmoid and ipo, [2B] for kto_pair."""
    h = (policy_chosen - policy_rejected) - (ref_chosen - ref_rejected)
    if loss_type == "sigmoid":
        losses = -F.logsigmoid(beta * h)
    elif loss_type == "ipo":
        losses = (h - 1.0 / (2.0 * beta)) ** 2
    elif loss_type == "kto_pair":
        # jnp.clip(x, 0) is maximum(0, x), whose gradient splits a tie in
        # half (the KLs are exactly 0 while the policy is the reference);
        # torch.maximum does the same, torch.clamp passes it whole
        zero = policy_chosen.new_zeros(())
        chosen_kl = torch.maximum(_mean(policy_chosen - ref_chosen), zero)
        rejected_kl = torch.maximum(_mean(policy_rejected - ref_rejected), zero)
        losses = torch.cat([
            1.0 - torch.sigmoid(beta * ((policy_chosen - ref_chosen) - rejected_kl)),
            1.0 - torch.sigmoid(beta * (chosen_kl - (policy_rejected - ref_rejected))),
        ])
    else:
        raise ValueError(loss_type)
    return (losses, beta * (policy_chosen - ref_chosen),
            beta * (policy_rejected - ref_rejected))


def _fused_weights(fused_labels, target_weights):
    """Host-side per-target weights [R, T] onto the fused rows [R, L]: the
    k-th valid label of a row takes the row's k-th weight (the splice keeps
    the text tokens' order); other positions take 0."""
    valid = fused_labels != IGNORE_INDEX
    k = torch.cumsum(valid.to(torch.int32), dim=1) - 1
    k = torch.clamp(k, 0, target_weights.shape[1] - 1).long()
    w = torch.gather(target_weights.to(torch.float32), 1, k)
    return torch.where(valid, w, 0.0)


def pair_logps(params, cfg: SliMEConfig, batch: Dict, *, compute_dtype=torch.bfloat16,
               use_kernel: Optional[bool] = None, remat: bool = False,
               loss_chunk="auto", token_weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward over the stacked [2B, S] pair batch -> ([2B] logp, [2B]
    target mass). ``pixel_values`` / ``crop_mask`` are per pair [B, ...]
    and are tiled to both halves."""
    if loss_chunk == "auto":
        loss_chunk = DEFAULT_LOSS_CHUNK if cfg.llm.vocab_size >= 16384 else None
    pv, cm = batch["pixel_values"], batch["crop_mask"]
    if pv.shape[0] * 2 == batch["input_ids"].shape[0]:
        pv = torch.cat([pv, pv], dim=0)
        cm = torch.cat([cm, cm], dim=0)
    hidden, fused = slime.forward(params, cfg, batch["input_ids"], batch["attention_mask"],
                                  pv, cm, batch["labels"], training=False,
                                  use_kernel=use_kernel, compute_dtype=compute_dtype,
                                  remat=remat, return_hidden=True)
    weights = None
    if token_weights is not None:
        weights = _fused_weights(fused.labels, token_weights)
    return chunked_sequence_logp(hidden, params["llm"]["lm_head"], fused.labels,
                                 chunk=loss_chunk, weights=weights)


def _dpo_metrics(chosen_rewards, rejected_rewards, pc, pr, n_chosen,
                 weighted: bool = False) -> Dict[str, torch.Tensor]:
    margin = chosen_rewards - rejected_rewards
    m = {"reward_margin": margin.mean(),
         "reward_accuracy": (margin > 0).to(torch.float32).mean(),
         "chosen_reward": chosen_rewards.mean(),
         "rejected_reward": rejected_rewards.mean(),
         "policy_chosen_logp": pc.mean(),
         "policy_rejected_logp": pr.mean()}
    if weighted:
        # under token weighting the mass is a sum of weights, not a count
        m["target_weight_mass"] = n_chosen
    else:
        m["n_target_tokens"] = n_chosen.to(torch.int32)
    return m


def _dpo_objective(logp, mass, ref_logp, ref_mass, dc: DPOConfig):
    """[2B] policy and reference log-probs -> (scalar loss, metrics)."""
    B = logp.shape[0] // 2
    if dc.use_average:
        p = logp / torch.clamp(mass, min=1e-9)
        r = ref_logp / torch.clamp(ref_mass, min=1e-9)
    else:
        p, r = logp, ref_logp
    pc, pr, rc, rr = p[:B], p[B:], r[:B], r[B:]
    losses, chosen_rewards, rejected_rewards = dpo_losses(
        pc, pr, rc, rr, beta=dc.beta, loss_type=dc.loss_type)
    loss = dc.dpo_weight * _mean(losses)
    if dc.sft_weight > 0.0:
        # plain NLL on the chosen rows, per target token (the SFT scale)
        sft = -_sum(logp[:B]) / torch.clamp(_sum(mass[:B]), min=1e-9)
        loss = loss + dc.sft_weight * sft
    n_chosen = mass[:B].sum()
    return loss, _dpo_metrics(chosen_rewards, rejected_rewards, pc, pr, n_chosen,
                              weighted=dc.token_weighted)


def _step_body(cfg, tx, dc, kw, policy, ref_params, batch, mesh=None):
    token_weights = batch.get("target_weights") if dc.token_weighted else None
    with fp32_accumulation(), use_mesh(mesh):
        with torch.no_grad():
            ref_logp, ref_mass = pair_logps(ref_params, cfg, batch,
                                            token_weights=token_weights, **kw)
        logp, mass = pair_logps(policy(), cfg, batch, token_weights=token_weights, **kw)
        loss, aux = _dpo_objective(logp, mass, ref_logp, ref_mass, dc)
        loss.backward()
        tp.sync_grads(tx.params)
        gnorm = tx.step()
    return {"loss": loss.detach(), "grad_norm": gnorm,
            **{k: v.detach() for k, v in aux.items()}}


def make_dpo_train_step(cfg: SliMEConfig, tc: TrainConfig, tx, dc: DPOConfig, *,
                        use_kernel: Optional[bool] = None, compute_dtype=torch.bfloat16,
                        remat: bool = False, loss_chunk="auto", mesh=None):
    """Full-parameter DPO: step(state, ref_params, batch, generator=None) ->
    (state, metrics); ``ref_params`` is the frozen reference policy. The
    generator is unused: the selection runs without noise. Under ``mesh``
    the batch holds this rank's pairs (both rows of each)."""
    del tc
    kw = dict(compute_dtype=compute_dtype, use_kernel=use_kernel, remat=remat,
              loss_chunk=loss_chunk)

    def step(state, ref_params, batch, generator=None):
        del generator
        m = _step_body(cfg, tx, dc, kw, lambda: state["params"], ref_params, batch, mesh)
        state["step"] += 1
        return state, m

    return step


def make_lora_dpo_train_step(cfg: SliMEConfig, tc: TrainConfig, tx, dc: DPOConfig, *,
                             rank: int, alpha: int, use_kernel: Optional[bool] = None,
                             compute_dtype=torch.bfloat16, remat: bool = False,
                             loss_chunk="auto", mesh=None):
    """LoRA/QLoRA DPO: step(state, base_params, batch, generator=None) ->
    (state, metrics). The reference is ``base_params`` itself (adapters off,
    the original projector and sampler); the policy is the base with the
    trained extras and the adapters attached."""
    del tc
    kw = dict(compute_dtype=compute_dtype, use_kernel=use_kernel, remat=remat,
              loss_chunk=loss_chunk)

    def step(state, base_params, batch, generator=None):
        del generator
        trainable = state["params"]

        def policy():
            params = {**base_params, **trainable["extras"]}
            return lora_lib.attach(params, {"rank": rank, "alpha": alpha,
                                            "adapters": trainable["adapters"]})
        m = _step_body(cfg, tx, dc, kw, policy, base_params, batch, mesh)
        state["step"] += 1
        return state, m

    return step
