"""DPO (``train/dpo.py``, ``data/dpo.py``, ``ops/loss.chunked_sequence_logp``)
against the JAX package, at ``SliMEConfig.tiny`` widths in fp32 (the
counterpart of ``tests/test_dpo.py``):

- ``chunked_sequence_logp`` against JAX's, chunked (S not a multiple of the
  chunk) and dense, weighted and not, with a fully masked row; its gradient
  through the checkpointed chunks against the dense version's;
- ``dpo_losses`` for the three loss types, and ``_fused_weights``;
- one full-parameter DPO step and one LoRA-DPO step against JAX's
  ``make_dpo_train_step`` / ``make_lora_dpo_train_step`` (loss, the DPO
  metrics, every trained leaf);
- ``test_dpo.py``'s model tests on the port: the first loss is log 2, a few
  steps separate the pair, each variant's loss decreases, ``use_average``
  with the SFT mix, LoRA-DPO's base is its reference, the token-weighted
  step;
- ``PreferenceDataset``, ``collate_dpo`` and ``dpo_loader`` equal to JAX's
  on the same records (text and image), array for array.

Adam runs with eps 1e-6 in both packages in the step comparisons, as in
``test_torch_lora_train.py`` (an entry whose gradient is near zero carries
the fp32 rounding of its gradient into its step at eps 1e-8). JAX's ViT
attention runs its Pallas kernel in interpret mode. Tolerance: 1e-5 relative
(1e-6 absolute) for log-probs, losses and metrics, trained leaves 1e-5
relative with an absolute floor of 5e-3 of the step size lr; the data side
exact.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import slime_tpu.ops.encoder_attention as jea
from slime_tpu.config import SliMEConfig
from slime_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from slime_tpu.data import dpo as jdata
from slime_tpu.models import slime as jslime
from slime_tpu.ops import loss as jloss
from slime_tpu.train import dpo as jdpo
from slime_tpu.train import lora as jlora
from slime_tpu.train import optim as joptim
from slime_tpu.train import step as jstep
from slime_tpu_torch import params as bridge
from slime_tpu_torch.data import dpo as tdata
from slime_tpu_torch.ops import loss as tloss
from slime_tpu_torch.train import dpo as tdpo
from slime_tpu_torch.train import optim as toptim
from slime_tpu_torch.train import step as tstep

from .toy_tokenizer import ToyTokenizer

TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
METRICS = ("reward_margin", "reward_accuracy", "chosen_reward", "rejected_reward",
           "policy_chosen_logp", "policy_rejected_logp")


@pytest.fixture(autouse=True)
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tiny steps' ops are too small to gain from more threads, and the
    suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("chunk", [None, 4, 7])
def test_chunked_sequence_logp_matches_jax(chunk, weighted):
    rng = np.random.default_rng(0)
    B, S, H, V = 3, 20, 16, 37
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    w = rng.standard_normal((V, H)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[:, :5] = IGNORE_INDEX
    labels[2] = IGNORE_INDEX                     # a fully masked row
    weights = (rng.random((B, S)) + 0.5).astype(np.float32) if weighted else None
    jl, jm = jloss.chunked_sequence_logp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                         chunk=chunk, weights=None if weights is None
                                         else jnp.asarray(weights))
    tl, tm = tloss.chunked_sequence_logp(_t(x), _t(w), _t(labels), chunk=chunk,
                                         weights=None if weights is None else _t(weights))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    assert float(tm[2]) == 0.0 and float(tl[2]) == 0.0


def test_chunked_sequence_logp_gradient_is_the_dense_one():
    rng = np.random.default_rng(1)
    B, S, H, V = 2, 13, 8, 19
    x0 = rng.standard_normal((B, S, H)).astype(np.float32)
    w0 = rng.standard_normal((V, H)).astype(np.float32)
    labels = _t(rng.integers(0, V, (B, S)).astype(np.int32))
    weights = _t((rng.random((B, S)) + 0.5).astype(np.float32))
    grads = []
    for chunk in (None, 4):
        x, w = _t(x0).requires_grad_(True), _t(w0).requires_grad_(True)
        lp, mass = tloss.chunked_sequence_logp(x, w, labels, chunk=chunk, weights=weights)
        (lp * torch.tensor([1.0, -2.0])).sum().backward()
        grads.append((x.grad, w.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("loss_type", ["sigmoid", "ipo", "kto_pair"])
def test_dpo_losses_match_jax(loss_type):
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal(5).astype(np.float32) for _ in range(4)]
    j = jdpo.dpo_losses(*(jnp.asarray(a) for a in xs), beta=0.3, loss_type=loss_type)
    t = tdpo.dpo_losses(*(_t(a) for a in xs), beta=0.3, loss_type=loss_type)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert t[0].shape == ((10,) if loss_type == "kto_pair" else (5,))
    with pytest.raises(ValueError):
        tdpo.DPOConfig(loss_type="nope")


def test_fused_weights_match_jax():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 50, (4, 15)).astype(np.int32)
    labels[rng.random((4, 15)) < 0.4] = IGNORE_INDEX
    tw = (rng.random((4, 6)) + 0.5).astype(np.float32)
    want = jdpo._fused_weights(jnp.asarray(labels), jnp.asarray(tw))
    got = tdpo._fused_weights(_t(labels), _t(tw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def tiny():
    cfg = SliMEConfig.tiny()
    return cfg, jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))


def _pair_batch(cfg, B=2, S=16, seed=0, weights=False):
    rng = np.random.default_rng(seed)
    t, MC = cfg.vision.image_size, 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (2 * B, S)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    ids[B:, :-6] = ids[:B, :-6]                  # a shared prompt; the answers differ
    labels = np.full_like(ids, IGNORE_INDEX)
    labels[:, -6:] = ids[:, -6:]
    batch = {"input_ids": ids, "labels": labels,
             "attention_mask": np.ones((2 * B, S), bool),
             "pixel_values": rng.standard_normal((B, MC, 3, t, t)).astype(np.float32),
             "crop_mask": np.ones((B, MC), bool)}
    if weights:
        batch["target_weights"] = (rng.random((2 * B, 6)) + 0.5).astype(np.float32)
    return batch


def _tc(**kw):
    return toptim.TrainConfig(**{**dict(learning_rate=LR, total_steps=10,
                                        lr_schedule="constant", adam_eps=1e-6), **kw})


def _compare_step(tm, jm, tparams, jparams):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)
    want = dict(bridge.named_leaves(jax.device_get(jparams)))
    moved = 0
    for path, leaf in bridge.named_leaves(tparams):
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], rtol=1e-5,
                                   atol=5e-3 * LR, err_msg=path)
        moved += int(leaf.requires_grad)
    assert moved


@pytest.mark.parametrize("dc", [dict(), dict(loss_type="kto_pair", token_weighted=True,
                                            sft_weight=0.2, use_average=True)],
                         ids=["sigmoid", "kto_pair_weighted_avg_sft"])
def test_full_parameter_dpo_step_matches_jax(tiny, dc):
    cfg, p = tiny
    tc = _tc()
    batch = _pair_batch(cfg, weights=dc.get("token_weighted", False))
    jtc = joptim.TrainConfig(**dataclasses.asdict(tc))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jstate, jtx = jstep.init_train_state(jp, jtc)
    jfn = jdpo.make_dpo_train_step(cfg, jtc, jtx, jdpo.DPOConfig(**dc),
                                   compute_dtype=jnp.float32)
    jstate, jm = jfn(jstate, jp, jax.tree_util.tree_map(jnp.asarray, batch),
                     jax.random.PRNGKey(0))

    ref = bridge.from_jax_numpy(p, device="cpu")
    state, tx = tstep.init_train_state(ref, tc)
    step = tdpo.make_dpo_train_step(cfg, tc, tx, tdpo.DPOConfig(**dc),
                                    compute_dtype=torch.float32)
    state, tm = step(state, ref, {k: _t(v) for k, v in batch.items()})
    _compare_step(tm, jm, state["params"], jstate["params"])
    key = "target_weight_mass" if dc.get("token_weighted") else "n_target_tokens"
    np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL)


def test_lora_dpo_step_matches_jax(tiny):
    cfg, p = tiny
    tc = _tc()
    batch = _pair_batch(cfg, seed=5)
    lora = jax.device_get(jlora.init_lora(jax.random.PRNGKey(1), p, r=4, alpha=8))
    # B != 0, so the policy differs from the reference from the first step
    lora["adapters"] = {k: {"A": v["A"], "B": np.full_like(v["B"], 0.01)}
                        for k, v in lora["adapters"].items()}
    jtc = joptim.TrainConfig(**dataclasses.asdict(tc))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jbase, jstate, jtx = jstep.init_lora_train_state(
        jp, jax.tree_util.tree_map(jnp.asarray, lora), jtc)
    jfn = jdpo.make_lora_dpo_train_step(cfg, jtc, jtx, jdpo.DPOConfig(), rank=4, alpha=8,
                                        compute_dtype=jnp.float32)
    jstate, jm = jfn(jstate, jbase, jax.tree_util.tree_map(jnp.asarray, batch),
                     jax.random.PRNGKey(0))
    tbase, state, tx = tstep.init_lora_train_state(
        bridge.from_jax_numpy(p, device="cpu"), bridge.from_jax_numpy(lora, device="cpu"), tc)
    step = tdpo.make_lora_dpo_train_step(cfg, tc, tx, tdpo.DPOConfig(), rank=4, alpha=8,
                                         compute_dtype=torch.float32)
    state, tm = step(state, tbase, {k: _t(v) for k, v in batch.items()})
    assert abs(float(tm["loss"]) - np.log(2.0)) > 1e-4
    _compare_step(tm, jm, state["params"], jstate["params"])


def _port_full_step(cfg, p, dc, tc=None):
    ref = bridge.from_jax_numpy(p, device="cpu")
    state, tx = tstep.init_train_state(ref, tc or _tc())
    return ref, state, tdpo.make_dpo_train_step(cfg, tc or _tc(), tx, dc,
                                                compute_dtype=torch.float32)


def test_dpo_initial_loss_is_log2(tiny):
    cfg, p = tiny
    ref, state, step = _port_full_step(cfg, p, tdpo.DPOConfig())
    _, m = step(state, ref, {k: _t(v) for k, v in _pair_batch(cfg).items()})
    np.testing.assert_allclose(float(m["loss"]), np.log(2.0), rtol=1e-4)
    np.testing.assert_allclose(float(m["reward_margin"]), 0.0, atol=1e-5)


def test_dpo_training_separates_pair(tiny):
    cfg, p = tiny
    ref, state, step = _port_full_step(cfg, p, tdpo.DPOConfig(beta=0.1),
                                       _tc(learning_rate=5e-3))
    batch = {k: _t(v) for k, v in _pair_batch(cfg).items()}
    margins = []
    for _ in range(6):
        state, m = step(state, ref, batch)
        margins.append(float(m["reward_margin"]))
    assert float(m["loss"]) < np.log(2.0) * 0.8
    assert margins[-1] > margins[0]
    assert float(m["reward_accuracy"]) == 1.0
    assert float(m["chosen_reward"]) > float(m["rejected_reward"])


@pytest.mark.parametrize("loss_type", ["ipo", "kto_pair"])
def test_dpo_variant_losses_decrease(tiny, loss_type):
    cfg, p = tiny
    ref, state, step = _port_full_step(cfg, p, tdpo.DPOConfig(beta=0.2, loss_type=loss_type),
                                       _tc(learning_rate=5e-3))
    batch = {k: _t(v) for k, v in _pair_batch(cfg, seed=3).items()}
    losses = []
    for _ in range(4):
        state, m = step(state, ref, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_dpo_use_average_and_sft_mix(tiny):
    cfg, p = tiny
    ref, state, step = _port_full_step(cfg, p, tdpo.DPOConfig(use_average=True,
                                                              sft_weight=0.5))
    _, m = step(state, ref, {k: _t(v) for k, v in _pair_batch(cfg).items()})
    # log 2 + 0.5 x the chosen rows' per-token NLL (about log V at random init)
    assert np.log(2.0) < float(m["loss"]) < np.log(2.0) + 0.5 * 2 * np.log(cfg.llm.vocab_size)


def test_lora_dpo_base_is_reference(tiny):
    """At adapter init (B = 0) the policy is the base: log 2; steps then move
    only the adapters and the extras and separate the pair."""
    from slime_tpu_torch.train import lora as tlora
    cfg, p = tiny
    tc = _tc(learning_rate=5e-3)
    tp = bridge.from_jax_numpy(p, device="cpu")
    lora = tlora.init_lora(tp, generator=torch.Generator().manual_seed(1), r=4, alpha=8)
    base, state, tx = tstep.init_lora_train_state(tp, lora, tc)
    step = tdpo.make_lora_dpo_train_step(cfg, tc, tx, tdpo.DPOConfig(), rank=4, alpha=8,
                                         compute_dtype=torch.float32)
    before = {k: v.clone() for k, v in bridge.named_leaves(base)}
    batch = {k: _t(v) for k, v in _pair_batch(cfg, seed=5).items()}
    state, m = step(state, base, batch)
    np.testing.assert_allclose(float(m["loss"]), np.log(2.0), rtol=1e-4)
    for _ in range(5):
        state, m = step(state, base, batch)
    assert float(m["loss"]) < np.log(2.0) and float(m["reward_margin"]) > 0
    for k, v in bridge.named_leaves(base):
        assert torch.equal(v, before[k]), k


def test_dpo_token_weighted_step(tiny):
    cfg, p = tiny
    ref, state, step = _port_full_step(cfg, p, tdpo.DPOConfig(token_weighted=True))
    batch = _pair_batch(cfg, weights=True)
    batch["target_weights"][:] = 1.0              # all-ones weights: the unweighted loss
    _, m = step(state, ref, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), np.log(2.0), rtol=1e-4)
    assert "target_weight_mass" in m and "n_target_tokens" not in m


def test_normalize_record_and_token_weights_match_jax():
    recs = [{"conversations": [{"from": "human", "value": "q"},
                               {"from": "gpt", "value": "orig"}],
             "chosen": "good", "rejected": {"value": "bad"}},
            {"question": "q2", "output_1": {"value": "a"}, "output_2": {"value": "b"},
             "preference": 2}]
    for r in recs:
        assert tdata.normalize_record(r) == jdata.normalize_record(r)
    for bad in ({"conversations": []}, {"question": "q", "output_1": "a", "output_2": "b"},
                {"question": "q", "output_1": "a", "output_2": "b", "preference": 0}):
        with pytest.raises(ValueError):
            tdata.normalize_record(bad)
    for a, b in (([1, 2, 3, 4, 5], [1, 2, 9, 9, 4, 5]), ([7, 8], [7, 8]), ([], [3])):
        for x, y in zip(tdata.target_token_weights(a, b, 1.5),
                        jdata.target_token_weights(a, b, 1.5)):
            np.testing.assert_array_equal(x, y)


def test_preference_dataset_and_loader_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    (tmp_path / "img").mkdir()
    Image.fromarray(rng.integers(0, 255, (80, 120, 3), dtype=np.uint8)).save(
        tmp_path / "img" / "a.png")
    recs = [{"id": i, "conversations": [{"from": "human",
                                         "value": ("<image>\n" if i % 2 else "")
                                         + f"question {i}"}],
             "chosen": f"good answer {i} here", "rejected": f"bad answer {i}"}
            for i in range(5)]
    for r in recs[1::2]:
        r["image"] = "a.png"
    path = tmp_path / "pref.json"
    path.write_text(json.dumps(recs))
    kw = dict(image_folder=str(tmp_path / "img"), conv_version="v1", token_weighted=True,
              pixel_dtype="uint8", use_native_preprocess=False)
    tds = tdata.PreferenceDataset([str(path)], ToyTokenizer(), **kw)
    jds = jdata.PreferenceDataset([str(path)], ToyTokenizer(), **kw)
    assert len(tds) == len(jds) == 5
    for i in range(5):
        a, b = tds[i], jds[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for num_workers in (0, 2):
        tb = list(tdata.dpo_loader(tds, batch_size=2, seq_len=24, pad_token_id=0, seed=3,
                                   num_workers=num_workers))
        jb = list(jdata.dpo_loader(jds, batch_size=2, seq_len=24, pad_token_id=0, seed=3,
                                   num_workers=num_workers))
        assert len(tb) == len(jb) == 2
        for x, y in zip(tb, jb):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    items = [tds[i] for i in range(3)]
    t = tdata.collate_dpo(items, pad_token_id=7, seq_len=9)
    j = jdata.collate_dpo(items, pad_token_id=7, seq_len=9)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t["input_ids"].shape == (6, 9) and t["pixel_values"].shape[0] == 3
