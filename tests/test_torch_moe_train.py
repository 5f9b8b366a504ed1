"""Training and checkpoints of a Mixtral-family SliME (MoE LLM layers: E = 4,
top 2) in the port, against the JAX package on the CPU in fp32 (the
counterparts of ``test_moe_dispatch.py::test_aux_loss_in_training``, the
MoE cases of the LoRA steps and of ``checkpoint``'s Mixtral key mapping):

- ``slime.loss_fn`` with ``router_aux_loss_coef`` 0.02 on the multimodal
  and on the packed branch: JAX's loss and ``router_aux_loss``; the gate's
  gradient is non-zero; with coefficient 0 there is no aux key and the loss
  is lower; list and stacked layers give the same loss and aux;
- LoRA steps (``make_lora_train_step``) on MoE layers, with a float base
  and a 4-bit one (JAX's ``quantize_params`` at its default size floor:
  the attention projections quantized, experts and gates float): JAX's
  losses and trained leaves after 2 steps; the CLI's ``build_params`` with
  ``--bits 4`` quantizes the same leaves and keeps MoE layers a list;
- the ``Trainer`` logs ``router_aux_loss`` each log step;
- a Mixtral-shaped checkpoint written by JAX's ``save_checkpoint`` loads
  through the port's ``load_pretrained`` leaf for leaf; the port's export
  writes JAX's files byte for byte (the ``block_sparse_moe`` keys);
  ``load_for_serving`` stacks the MoE layers and serves the list layers'
  logits.

Tolerance: losses and the aux 1e-5 relative (the LoRA steps: those of
``test_torch_lora_train.py``); checkpoint leaves and files equal.
"""
import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slime_tpu.ops.encoder_attention as jea
from slime_tpu import checkpoint as jckpt
from slime_tpu.config import SliMEConfig as JCfg
from slime_tpu.constants import IGNORE_INDEX
from slime_tpu.models import slime as jslime
from slime_tpu.ops.quantization import quantize_params as jquantize
from slime_tpu_torch import checkpoint as tckpt
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import SliMEConfig
from slime_tpu_torch.models import llama as tllama
from slime_tpu_torch.models import slime as tslime
from slime_tpu_torch.ops.quantization import is_quantized
from slime_tpu_torch.train import cli
from slime_tpu_torch.train.trainer import RunConfig, Trainer

from .test_torch_lora_train import _batch, _lora_state, _run_both, _tc

RTOL = 1e-5


def _moe(cls, coef=0.02, wide=False):
    cfg = cls.tiny()
    llm = dataclasses.replace(cfg.llm, num_experts=4, num_experts_per_tok=2,
                              router_aux_loss_coef=coef)
    if wide:      # attention projections of 256 x 256: over quantize_params' floor
        llm = dataclasses.replace(llm, hidden_size=256, num_kv_heads=4, head_dim=64)
    return dataclasses.replace(cfg, llm=llm)


@pytest.fixture(autouse=True)
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg = _moe(JCfg)
    return _moe(SliMEConfig), jcfg, jax.device_get(jslime.init(jax.random.PRNGKey(0), jcfg))


def _packed(cfg, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.llm.vocab_size, (2, 16)).astype(np.int32)
    seg = np.array([[1] * 7 + [2] * 6 + [0] * 3, [1] * 16], np.int32)
    pos = np.array([list(range(7)) + list(range(6)) + [0] * 3, list(range(16))], np.int32)
    return {"input_ids": ids, "segment_ids": seg, "positions": pos,
            "labels": np.where(seg > 0, ids, IGNORE_INDEX).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_losses(tiny):
    """JAX's (loss, router_aux_loss) on the multimodal and the packed batch."""
    _, jcfg, p = tiny
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    loss_fn = jax.jit(lambda p, b: jslime.loss_fn(p, jcfg, b, training=False))
    out = {}
    for branch, batch in (("multimodal", _batch(jcfg, B=2, S=24)), ("packed", _packed(jcfg))):
        loss, m = loss_fn(jp, jax.tree_util.tree_map(jnp.asarray, batch))
        out[branch] = (float(loss), float(m["router_aux_loss"]))
    return out


def _loss(cfg, p, batch, stacked=False):
    tp = bridge.from_jax_numpy(p, device="cpu")
    if stacked:
        tp["llm"]["layers"] = tllama.stack_layers(tp["llm"]["layers"])
    for _, leaf in bridge.named_leaves(tp):
        leaf.requires_grad_(True)
    loss, m = tslime.loss_fn(tp, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                             training=False)
    return loss, m, tp


@pytest.mark.parametrize("branch", ["multimodal", "packed", "stacked"])
def test_loss_fn_with_router_aux_matches_jax(tiny, jax_losses, branch):
    cfg, _, p = tiny
    batch = _packed(cfg) if branch == "packed" else _batch(cfg, B=2, S=24)
    tloss, tm, tp = _loss(cfg, p, batch, stacked=branch == "stacked")
    jloss, jaux = jax_losses["packed" if branch == "packed" else "multimodal"]
    np.testing.assert_allclose(float(tloss.detach()), jloss, rtol=RTOL)
    np.testing.assert_allclose(float(tm["router_aux_loss"]), jaux, rtol=RTOL)
    assert jaux > 0 and not tm["router_aux_loss"].requires_grad
    tloss.backward()
    layers = tp["llm"]["layers"]
    gate = (layers if branch == "stacked" else layers[0])["gate"]["weight"]
    assert float(gate.grad.abs().sum()) > 0


def test_coef_zero_drops_the_aux(tiny, jax_losses):
    """Coefficient 0: no aux key, and the loss is JAX's cross entropy alone
    (its loss less 0.02 times its aux)."""
    cfg, _, p = tiny
    off = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, router_aux_loss_coef=0.0))
    loss, m, _ = _loss(off, p, _batch(cfg, B=2, S=24))
    jloss, jaux = jax_losses["multimodal"]
    assert "router_aux_loss" not in m
    np.testing.assert_allclose(float(loss.detach()), jloss - 0.02 * jaux, rtol=RTOL)
    assert float(loss.detach()) < jloss


def _quantize_jax(p, bits):
    if bits is None:
        return p
    return dict(p, llm=dict(p["llm"], layers=jax.device_get(jquantize(p["llm"]["layers"],
                                                                      bits))))


@pytest.mark.parametrize("bits", [None, 4], ids=["lora", "qlora4"])
def test_lora_steps_on_moe_layers_match_jax(bits):
    jcfg, cfg = _moe(JCfg, wide=True), _moe(SliMEConfig, wide=True)
    qp = _quantize_jax(jax.device_get(jslime.init(jax.random.PRNGKey(1), jcfg)), bits)
    lp = qp["llm"]["layers"][0]
    if bits:
        assert all(is_quantized(lp[n]["weight"]) for n in ("q_proj", "k_proj", "v_proj",
                                                             "o_proj"))
    assert not is_quantized(lp["gate"]["weight"])
    assert all(isinstance(lp["experts"][n], np.ndarray) for n in ("w1", "w2", "w3"))
    st = _lora_state(qp)
    assert not any("gate" in k or "experts" in k for k in st["adapters"])
    _run_both(jcfg, qp, st, _tc(), [_batch(cfg, seed=s) for s in (0, 1)])


def test_cli_bits4_quantizes_attention_and_keeps_moe_layers_a_list(tmp_path):
    cfg = _moe(SliMEConfig, wide=True)
    args = types.SimpleNamespace(model_path=str(tmp_path), model_base=None, bits=4, seed=0,
                                 lora_enable=False, pretrain_mm_mlp_adapter=None,
                                 pretrain_mm_re_sampler=None)
    params = cli.build_params(args, cfg, torch.device("cpu"))
    layers = params["llm"]["layers"]
    assert isinstance(layers, list)
    for lp in layers:
        assert all(is_quantized(lp[n]["weight"]) for n in ("q_proj", "o_proj"))
        assert isinstance(lp["gate"]["weight"], torch.Tensor)
        assert all(isinstance(lp["experts"][n], torch.Tensor) for n in ("w1", "w2", "w3"))


def test_trainer_logs_router_aux(tiny, tmp_path):
    cfg, _, p = tiny
    tc = _tc(total_steps=2)
    rc = RunConfig(output_dir=str(tmp_path), log_steps=1, save_steps=0, prefetch_depth=0,
                   handle_preemption=False, max_steps=2)
    tr = Trainer(bridge.from_jax_numpy(p, device="cpu"), cfg, tc, rc,
                 compute_dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    metrics = tr.train([_batch(cfg, seed=s) for s in range(2)])
    recs = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(recs) == 2 and all(r["router_aux_loss"] > 0 for r in recs)
    assert metrics["router_aux_loss"] == recs[-1]["router_aux_loss"]


def _ckpt_cfgs():
    jcfg = _moe(JCfg)
    return jcfg, SliMEConfig.from_json_dict(jcfg.to_json_dict())


def test_jax_mixtral_checkpoint_loads_leaf_for_leaf(tiny, tmp_path):
    _, _, p = tiny
    jcfg, cfg = _ckpt_cfgs()
    assert cfg.llm.num_experts == 4
    jckpt.save_checkpoint(str(tmp_path), p, jcfg)
    got = dict(bridge.named_leaves(tckpt.load_pretrained(str(tmp_path), cfg=cfg)))
    want = dict(bridge.named_leaves(jckpt.load_pretrained(str(tmp_path), cfg=jcfg)))
    assert sorted(got) == sorted(want)
    assert "llm/layers/1/experts/w2" in got and got["llm/layers/1/experts/w2"].shape == (
        4, cfg.llm.hidden_size, cfg.llm.intermediate_size)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)


def test_export_writes_jax_files(tiny, tmp_path):
    _, _, p = tiny
    jcfg, cfg = _ckpt_cfgs()
    jckpt.save_checkpoint(str(tmp_path / "jax"), p, jcfg)
    tckpt.save_checkpoint(str(tmp_path / "port"), bridge.from_jax_numpy(p, device="cpu"), cfg)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    keys = tckpt.export_state_dict(bridge.from_jax_numpy(p, device="cpu"), cfg)
    assert "model.layers.0.block_sparse_moe.experts.3.w2.weight" in keys
    assert "model.layers.0.block_sparse_moe.gate.weight" in keys


def test_load_for_serving_stacks_moe_layers(tiny, tmp_path):
    _, _, p = tiny
    jcfg, cfg = _ckpt_cfgs()
    jckpt.save_checkpoint(str(tmp_path), p, jcfg)
    served = tckpt.load_for_serving(str(tmp_path), cfg=cfg, device="cpu",
                                    dtype=torch.float32)
    assert served["llm"]["layers"]["experts"]["w1"].shape[:2] == (cfg.llm.num_layers, 4)
    listed = bridge.from_jax_numpy(p, device="cpu")["llm"]
    ids = torch.from_numpy(np.random.default_rng(2).integers(5, 500, (2, 20)))
    a, _, aux_a = tllama.forward(served["llm"], tllama.embed(served["llm"], ids), cfg.llm,
                                 return_aux=True)
    b, _, aux_b = tllama.forward(listed, tllama.embed(listed, ids), cfg.llm, return_aux=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(aux_a, aux_b, rtol=0, atol=0)
