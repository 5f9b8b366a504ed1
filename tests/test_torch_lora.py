"""LoRA in the port against ``slime_tpu.train.lora`` and the JAX layers, at
small widths (mirrors ``tests/test_lora.py``).

- ``find_linear_targets`` on a list-layer tree and on its int8 / NF4
  quantization: the same paths as JAX;
- ``init_lora``'s zero B is the identity; ``apply_to_params`` equals
  ``merge``; ``merge``, ``attach``, ``export_peft`` / ``import_peft`` and
  ``stack_adapter_state`` equal JAX's on the same factors (carried across
  with ``params.from_jax_numpy``, which takes a lora state both ways);
- only the adapters get gradients through ``attach`` + ``slime.loss_fn``;
- ``layers.linear``'s ``lora`` and ``lora_b`` branches and the loss head's
  ``lora`` against JAX, in fp32 and bf16.

Tolerances: fp32 1e-5 relative (1e-6 absolute); bf16 results are held to
JAX's within one bf16 ulp of the output (2 ** -7 relative): the products'
fp32 sums run in another order, and one rounding to bf16 may land on the
other side. Merges and PEFT files are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.config import SliMEConfig
from slime_tpu.constants import IGNORE_INDEX
from slime_tpu.models import layers as JL
from slime_tpu.models import slime as jslime
from slime_tpu.ops import loss as jloss
from slime_tpu.ops import quantization as JQ
from slime_tpu.train import lora as jlora
from slime_tpu_torch import params as bridge
from slime_tpu_torch.models import layers as TL
from slime_tpu_torch.models import slime as tslime
from slime_tpu_torch.ops import loss as tloss
from slime_tpu_torch.ops import quantization as TQ
from slime_tpu_torch.train import lora as tlora


@pytest.fixture(scope="module")
def tiny():
    cfg = SliMEConfig.tiny()
    params = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    return cfg, params


def _nonzero(state, seed=2, scale=0.05):
    r = np.random.default_rng(seed)
    out = {"rank": state["rank"], "alpha": state["alpha"], "adapters": {}}
    for p, ab in sorted(state["adapters"].items()):
        out["adapters"][p] = {"A": np.asarray(ab["A"]),
                              "B": (r.standard_normal(np.shape(ab["B"])) * scale
                                    ).astype(np.float32)}
    return out


def _quantized(params, bits):
    q = dict(params)
    q["llm"] = dict(params["llm"])
    q["llm"]["layers"] = jax.device_get(JQ.quantize_params(params["llm"]["layers"], bits,
                                                           min_size=0))
    return q


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_targets_match_jax(tiny, bits):
    cfg, params = tiny
    p = params if bits is None else _quantized(params, bits)
    want = jlora.find_linear_targets(p)
    got = tlora.find_linear_targets(bridge.from_jax_numpy(p, device="cpu"))
    assert got == want and any("q_proj" in s for s in got) and any("down_proj" in s for s in got)
    assert all(s.startswith("llm/") for s in got)
    for s in got:
        tw = tlora._get(bridge.from_jax_numpy(p, device="cpu"), s)["weight"]
        assert tlora.weight_shape(tw) == jlora.weight_shape(jlora._get(p, s)["weight"]), s


def test_init_is_identity_and_functional_equals_merge(tiny):
    cfg, params = tiny
    tp = bridge.from_jax_numpy(params, device="cpu")
    state = tlora.init_lora(tp, generator=torch.Generator().manual_seed(1), r=4, alpha=8)
    assert set(state["adapters"]) == set(jlora.find_linear_targets(params))
    a = state["adapters"]["llm/layers/0/q_proj"]
    assert a["A"].shape == (4, cfg.llm.hidden_size) and not a["B"].any()
    same = tlora.apply_to_params(tp, state)
    assert torch.equal(same["llm"]["layers"][0]["q_proj"]["weight"],
                       tp["llm"]["layers"][0]["q_proj"]["weight"])
    live = bridge.from_jax_numpy(_nonzero(bridge.to_jax_numpy(state)), device="cpu")
    fn, mg = tlora.apply_to_params(tp, live), tlora.merge(tp, live)
    for p in live["adapters"]:
        np.testing.assert_allclose(tlora._get(fn, p)["weight"].numpy(),
                                   tlora._get(mg, p)["weight"].numpy(), atol=1e-6)
    assert torch.equal(tp["llm"]["layers"][0]["q_proj"]["weight"],
                       torch.from_numpy(params["llm"]["layers"][0]["q_proj"]["weight"]))


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_merge_and_attach_match_jax(tiny, bits):
    cfg, params = tiny
    p = params if bits is None else _quantized(params, bits)
    state = _nonzero(jax.device_get(jlora.init_lora(jax.random.PRNGKey(1), p, r=4, alpha=8)))
    tp = bridge.from_jax_numpy(p, device="cpu")
    ts = bridge.from_jax_numpy(state, device="cpu")
    assert ts["rank"] == 4 and ts["alpha"] == 8
    back = bridge.to_jax_numpy(ts)
    assert back["rank"] == 4 and back["alpha"] == 8
    want = jax.device_get(jlora.merge(p, state))
    got = tlora.merge(tp, ts)
    for path in state["adapters"]:
        w = tlora._get(got, path)["weight"]
        jw = np.asarray(jlora._get(want, path)["weight"])
        assert str(w.dtype).split(".")[-1] == str(jw.dtype), path
        np.testing.assert_array_equal(bridge.to_jax_numpy(w), jw, err_msg=path)
    jatt = jax.device_get(jlora.attach(p, state))
    tatt = tlora.attach(tp, ts)
    for path in state["adapters"]:
        for k in ("A", "B"):
            np.testing.assert_array_equal(tlora._get(tatt, path)["lora"][k].numpy(),
                                          np.asarray(jlora._get(jatt, path)["lora"][k]))


def test_peft_roundtrip_and_stack_match_jax(tiny):
    cfg, params = tiny
    state = _nonzero(jax.device_get(jlora.init_lora(jax.random.PRNGKey(1), params, r=4,
                                                    alpha=8)))
    ts = bridge.from_jax_numpy(state, device="cpu")
    jsd, tsd = jlora.export_peft(state), tlora.export_peft(ts)
    assert list(tsd) == list(jsd) and any(k.endswith("lora_A.weight") for k in tsd)
    for k in jsd:
        np.testing.assert_array_equal(tsd[k].numpy(), jsd[k], err_msg=k)
    back = tlora.import_peft(tsd, r=4, alpha=8)
    jback = jlora.import_peft(jsd, r=4, alpha=8)
    assert set(back["adapters"]) == set(jback["adapters"]) == set(state["adapters"])
    stacked = tlora.stack_adapter_state(back, cfg.llm.num_layers)
    jstacked = jlora.stack_adapter_state(jback, cfg.llm.num_layers)
    assert set(stacked["adapters"]) == set(jstacked["adapters"])
    for p, ab in jstacked["adapters"].items():
        for k in ("A", "B"):
            np.testing.assert_array_equal(stacked["adapters"][p][k].numpy(), np.asarray(ab[k]))
    one = {"rank": 2, "alpha": 4, "adapters": {"llm/layers/1/q_proj": {
        "A": torch.ones((2, 8)), "B": torch.full((8, 2), 2.0)}}}
    ab = tlora.stack_adapter_state(one, 3)["adapters"]["llm/layers/q_proj"]
    assert ab["A"].shape == (3, 2, 8) and float(ab["A"][1].sum()) == 16
    assert float(ab["A"][0].sum()) == 0 and float(ab["A"][2].sum()) == 0


def _batch(cfg, B=2, S=12, seed=0):
    from slime_tpu.constants import IMAGE_TOKEN_INDEX
    rng = np.random.default_rng(seed)
    t, MC = cfg.vision.image_size, 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (B, S)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    return {"input_ids": ids, "attention_mask": np.ones((B, S), bool),
            "pixel_values": rng.standard_normal((B, MC, 3, t, t)).astype(np.float32),
            "crop_mask": np.ones((B, MC), bool),
            "labels": np.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids).astype(np.int32)}


def test_gradients_flow_through_adapters_only(tiny):
    cfg, params = tiny
    tp = bridge.from_jax_numpy(params, device="cpu")
    state = bridge.from_jax_numpy(_nonzero(jax.device_get(
        jlora.init_lora(jax.random.PRNGKey(1), params, r=4, alpha=8))), device="cpu")
    for ab in state["adapters"].values():
        for t in ab.values():
            t.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, _ = tslime.loss_fn(tlora.attach(tp, state), cfg, batch, training=False)
    loss.backward()
    assert all(leaf.grad is None for _, leaf in bridge.named_leaves(tp))
    grads = [t.grad for ab in state["adapters"].values() for t in ab.values()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0


def _ulp_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", ["dense", "int8", "nf4"])
def test_linear_lora_branches_match_jax(dtype, base):
    r = np.random.default_rng(3)
    B, S, IN, OUT, R = 3, 5, 64, 48, 4
    x = r.standard_normal((B, S, IN)).astype(np.float32)
    w = (r.standard_normal((OUT, IN)) * 0.1).astype(np.float32)
    a = (r.standard_normal((R, IN)) * 0.1).astype(np.float32)
    b = (r.standard_normal((OUT, R)) * 0.1).astype(np.float32)
    ab = (r.standard_normal((B, R, IN)) * 0.1).astype(np.float32)
    bb = (r.standard_normal((B, OUT, R)) * 0.1).astype(np.float32)
    jw = jnp.asarray(w)
    if base == "int8":
        jw = JQ.quantize_weight(jw, 8)
    elif base == "nf4":
        jw = JQ.quantize_weight_nf4(jw, group=64)
    tw = bridge.from_jax_numpy(jax.device_get(jw), device="cpu")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for entry in ({"lora": {"A": a, "B": b}}, {"lora_b": {"A": ab, "B": bb}},
                  {"lora": {"A": a, "B": b}, "lora_b": {"A": ab, "B": bb}}):
        jp = {"weight": jw, **{k: {n: jnp.asarray(v) for n, v in e.items()}
                               for k, e in entry.items()}}
        tp = {"weight": tw, **{k: {n: torch.from_numpy(v) for n, v in e.items()}
                               for k, e in entry.items()}}
        want = JL.linear(jp, jnp.asarray(x).astype(jdt))
        got = TL.linear(tp, torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        _ulp_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
    # lora_b on rows taken b-major ([B * S, in], as the engine's decode)
    tp = {"weight": tw, "lora_b": {"A": torch.from_numpy(ab), "B": torch.from_numpy(bb)}}
    flat = TL.linear(tp, torch.from_numpy(x).reshape(B * S, IN))
    np.testing.assert_allclose(flat.numpy(), TL.linear(tp, torch.from_numpy(x)).reshape(
        B * S, OUT).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("base", ["int8", "nf4"])
def test_quantized_linear_backward_matches_plain_autograd(base):
    """Under autograd the quantized product saves the packed weight and
    dequantizes again in the backward: dX equals autograd of the
    dequantized product, bit for bit."""
    r = np.random.default_rng(4)
    w = torch.from_numpy((r.standard_normal((48, 64)) * 0.1).astype(np.float32))
    qw = TQ.quantize_weight(w, 8) if base == "int8" else TQ.quantize_weight_nf4(w, 64)
    x = torch.from_numpy(r.standard_normal((3, 64)).astype(np.float32)).to(torch.bfloat16)
    cot = torch.from_numpy(r.standard_normal((3, 48)).astype(np.float32)).to(torch.bfloat16)
    x1 = x.clone().requires_grad_(True)
    y1 = TL.linear({"weight": qw}, x1)
    y1.backward(cot)
    x2 = x.clone().requires_grad_(True)
    y2 = torch.matmul(x2, TQ.dequantize_weight(qw).to(torch.bfloat16).T)
    y2.backward(cot)
    assert torch.equal(y1, y2) and torch.equal(x1.grad, x2.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, None])
def test_loss_head_lora_matches_jax(dtype, chunk):
    r = np.random.default_rng(5)
    B, S, H, V, R = 2, 20, 16, 97, 4
    x = r.standard_normal((B, S, H)).astype(np.float32)
    w = (r.standard_normal((V, H)) * 0.5).astype(np.float32)
    a = (r.standard_normal((R, H)) * 0.3).astype(np.float32)
    b = (r.standard_normal((V, R)) * 0.3).astype(np.float32)
    labels = r.integers(0, V, (B, S)).astype(np.int32)
    labels[r.random((B, S)) < 0.3] = IGNORE_INDEX
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    head = {"weight": w, "lora": {"A": a, "B": b}}

    def jsum(xx):
        return jloss.chunked_cross_entropy(
            xx, jax.tree_util.tree_map(jnp.asarray, head), jnp.asarray(labels),
            chunk=chunk)[0]

    jx = jnp.asarray(x).astype(jdt)
    want, want_g = jax.value_and_grad(jsum)(jx)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    total, count = tloss.chunked_cross_entropy(
        tx, {"weight": torch.from_numpy(w),
             "lora": {"A": torch.from_numpy(a), "B": torch.from_numpy(b)}},
        torch.from_numpy(labels), chunk=chunk)
    total.backward()
    assert int(count) == int((labels[:, 1:] != IGNORE_INDEX).sum())
    rtol = 1e-5 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(float(total), float(want), rtol=rtol)
    _ulp_close(tx.grad.float().numpy(), np.asarray(want_g.astype(jnp.float32)), dtype)
