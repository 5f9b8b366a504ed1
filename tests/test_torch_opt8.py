"""8-bit Adam moments (``train/opt8.py``) against the JAX package's
``slime_tpu/train/opt8.py``, on the CPU in fp32 (the counterpart of
``tests/test_opt8.py``):

- ``_quantize`` / ``_dequantize`` at ragged sizes: codes equal byte for byte,
  scales bit for bit;
- three ``scale_by_adam8bit`` updates on a small tree (JAX's update called
  un-jitted): codes and scales byte-equal after each, updates to 1e-6
  relative (1 ulp of the fp32 arithmetic);
- ``test_opt8.py``'s bounds: the round trip within half a scale, the
  square-root domain beating the linear one for v, one step within 0.03 of
  fp32 Adam, ``state_bytes``;
- the block-sliced update equal to the whole-leaf update, exactly;
- ``GroupedAdamW`` with ``optim="adamw8bit"`` over two label groups with
  clipping and weight decay against JAX's ``make_optimizer``, three steps:
  the parameters to 1e-5 relative (1e-6 absolute), as the fp32 optimizer's
  test; the unclipped group's codes and scales byte-equal; the clipped
  group's gradients carry the global norm, whose fp32 sum runs in another
  order in each package, so there its scales agree to 1e-6 relative and
  its codes to one step at no more than 1 in 10^4 of them (at least one);
- a ``state_dict`` round trip resumes exactly, under ``MultiSteps`` too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slime_tpu.train import opt8 as J
from slime_tpu.train import optim as joptim
from slime_tpu_torch import params as bridge
from slime_tpu_torch.train import opt8 as T
from slime_tpu_torch.train import optim as toptim
from slime_tpu_torch.train import step as tstep


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [1000, 257, 256 * 3, 5])
def test_quantize_is_jax_byte_for_byte(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-6, 2, n))).astype(np.float32)
    x[:3] = 0.0
    jq, js = J._quantize(jnp.asarray(x))
    tq, ts = T._quantize(_t(x))
    assert tq.dtype == torch.int8 and tq.shape == (-(-n // 256), 256)
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    back = T._dequantize(tq, ts, (n,))
    assert back.numpy().tobytes() == np.asarray(J._dequantize(jq, js, (n,))).tobytes()
    # linear absmax: each error within half its block's scale
    scales = np.repeat(ts.numpy()[:, 0], 256)[:n]
    assert (np.abs(back.numpy() - x) <= scales * 0.5 + 1e-9).all()


def _tree(rng):
    return {"w": rng.standard_normal((37, 50)).astype(np.float32),
            "b": rng.standard_normal((300,)).astype(np.float32),
            "s": rng.standard_normal((3,)).astype(np.float32)}


def test_three_updates_are_jax_byte_for_byte():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    tx = J.scale_by_adam8bit()
    jst = tx.init(jax.tree_util.tree_map(jnp.asarray, tree))
    tst = {k: T.init_leaf(_t(v)) for k, v in tree.items()}
    for count in range(1, 4):
        g = {k: (rng.standard_normal(v.shape) * 10.0 ** -count).astype(np.float32)
             for k, v in tree.items()}
        upd, jst = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jst)
        bc1, bc2 = T.bias_corrections(count, 0.9, 0.999, "cpu")
        for k in tree:
            got = np.zeros(g[k].size, np.float32)
            for lo, hi, u in T.update_leaf(_t(g[k]), tst[k], bc1=bc1, bc2=bc2, b1=0.9,
                                           b2=0.999, eps=1e-8, slice_blocks=1):
                got[lo:hi] = u.numpy()
            for name in ("m_q", "m_s", "v_q", "v_s"):
                assert (tst[k][name].numpy().tobytes()
                        == np.asarray(getattr(jst, name)[k]).tobytes()), (count, k, name)
            want = np.asarray(upd[k]).reshape(-1)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_sliced_update_is_the_whole_leaf_update():
    rng = np.random.default_rng(1)
    g0, g1 = (_t(rng.standard_normal((9, 300)).astype(np.float32)) for _ in range(2))
    whole = T.init_leaf(g0)
    sliced = T.init_leaf(g0)
    for count, g in enumerate((g0, g1), 1):
        bc1, bc2 = T.bias_corrections(count, 0.9, 0.999, "cpu")
        u, *codes = T.leaf_update(g, whole["m_q"], whole["m_s"], whole["v_q"],
                                  whole["v_s"], bc1=bc1, bc2=bc2)
        whole = dict(zip(("m_q", "m_s", "v_q", "v_s"), codes))
        got = torch.cat([s for _, _, s in T.update_leaf(
            g, sliced, bc1=bc1, bc2=bc2, b1=0.9, b2=0.999, eps=1e-8, slice_blocks=2)])
        assert torch.equal(got, u.reshape(-1))
        for k in whole:
            assert torch.equal(sliced[k], whole[k]), k


def test_sqrt_domain_wins_for_v():
    rng = np.random.default_rng(1)
    v = _t((rng.standard_normal(4096) ** 2 * np.exp(rng.uniform(-12, 0, 4096))
            ).astype(np.float32))
    q_lin, s_lin = T._quantize(v)
    v_lin = T._dequantize(q_lin, s_lin, v.shape).clamp(min=0)
    q_sq, s_sq = T._quantize(torch.sqrt(v))
    v_sq = T._dequantize(q_sq, s_sq, v.shape) ** 2
    tgt = torch.sqrt(v) + 1e-12
    e_lin = (torch.sqrt(v_lin) - tgt).abs() / (tgt + 1e-8)
    e_sq = (torch.sqrt(v_sq) - tgt).abs() / (tgt + 1e-8)
    assert e_sq.median() < 0.5 * e_lin.median()


def test_single_step_matches_fp32_adam_and_state_bytes():
    rng = np.random.default_rng(2)
    for shape in ((64, 64), (64,)):
        g = _t(rng.standard_normal(shape).astype(np.float32) * 0.1)
        bc1, bc2 = T.bias_corrections(1, 0.9, 0.999, "cpu")
        st = T.init_leaf(g)
        u, *_ = T.leaf_update(g, st["m_q"], st["m_s"], st["v_q"], st["v_s"],
                              bc1=bc1, bc2=bc2)
        m, v = 0.1 * g, 0.001 * g * g
        ref = (m / 0.1) / (torch.sqrt(v / 0.001) + 1e-8)
        assert float((u - ref).abs().max() / ref.abs().max()) < 0.03
    params = {"w": torch.zeros((1000, 100)), "b": torch.zeros((300,))}
    b = T.state_bytes(params)
    assert b == J.state_bytes({k: jnp.zeros(v.shape) for k, v in params.items()})
    assert 3.5 < b["ratio"] < 4.0
    st = T.init_leaf(params["w"])
    assert st["m_q"].dtype == torch.int8 and st["v_s"].dtype == torch.float32


def _opt_params(seed):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)   # noqa: E731
    return {"vision": {"w": f(4, 3)},
            "projector": {"projection": {"layers": [{"weight": f(5, 300), "bias": f(5)}]},
                          "attn": {"ln_q": {"weight": f(4)}}},
            "sampler": {"post_qformer": {"kv_proj": {"weight": f(3, 4)}}},
            "llm": {"norm": {"weight": f(5)}, "embed_tokens": f(70, 5)}}


def _jax_codes(opt_state, label, path):
    st = opt_state.inner_states[label].inner_state[1][0]
    node = {k: getattr(st, k) for k in ("m_q", "m_s", "v_q", "v_s")}
    for part in path.split("/"):
        key = int(part) if part.isdigit() else part
        node = {k: v[key] for k, v in node.items()}
    return node


def _port_codes(ttx, params):
    ids = {id(t): p for p, t in bridge.named_leaves(params)}
    out = {}
    for g in ttx.groups:
        opt = g["opt"]
        leaves = [p for pg in opt.param_groups for p in pg["params"]]
        for p, st in zip(leaves, opt.state):
            out[ids[id(p)]] = st
    return out


def test_grouped_adamw8bit_matches_jax_make_optimizer():
    """Three steps over the projector/sampler group (mm_projector_lr,
    clipped: its gradients are large) and the LLM group (not clipped: its
    gradients are small),
    weight decay on the ndim >= 2 leaves without "norm", the vision tower
    frozen."""
    tc = toptim.TrainConfig(learning_rate=3e-2, mm_projector_lr=5e-2, weight_decay=0.1,
                            total_steps=5, warmup_ratio=0.2, max_grad_norm=1.0,
                            lr_schedule="cosine", optim="adamw8bit")
    jtc = joptim.TrainConfig(**dataclasses.asdict(tc))
    p = _opt_params(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tx, jlabels = joptim.make_optimizer(jp, jtc)
    opt_state = tx.init(jp)
    state, ttx = tstep.init_train_state(bridge.from_jax_numpy(p, device="cpu"), tc)
    labels = dict(bridge.named_leaves(jax.device_get(jlabels)))
    r = np.random.default_rng(1)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: r.standard_normal(x.shape).astype(np.float32), p)
        grads["projector"] = jax.tree_util.tree_map(lambda g: g * 5.0, grads["projector"])
        grads["llm"] = jax.tree_util.tree_map(lambda g: g * 0.02, grads["llm"])
        flat = dict(bridge.named_leaves(grads))
        for path, leaf in bridge.named_leaves(state["params"]):
            if leaf.requires_grad:
                leaf.grad = torch.from_numpy(flat[path].copy())
        gnorm = float(ttx.step())
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        want = dict(bridge.named_leaves(jax.device_get(jp)))
        for path, leaf in bridge.named_leaves(state["params"]):
            np.testing.assert_allclose(leaf.detach().numpy(), want[path], rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {step} {path}")
        llm_norm = float(optax.global_norm(grads["llm"]))
        assert llm_norm < tc.max_grad_norm < gnorm
        codes = _port_codes(ttx, state["params"])
        assert set(codes) == {k for k, v in labels.items() if v != "frozen"}
        for path, st in codes.items():
            jc = _jax_codes(opt_state, labels[path], path)
            for k in st:
                got, want = st[k].numpy(), np.asarray(jc[k])
                if labels[path] == "base":
                    assert got.tobytes() == want.tobytes(), (step, path, k)
                elif k.endswith("_s"):
                    np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=path)
                else:
                    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                    assert diff.max() <= 1 and (diff > 0).sum() <= max(1, diff.size // 10 ** 4)
    assert torch.equal(state["params"]["vision"]["w"], torch.from_numpy(p["vision"]["w"]))


@pytest.mark.parametrize("accum", [1, 2])
def test_state_dict_round_trip_resumes_exactly(accum):
    tc = toptim.TrainConfig(learning_rate=1e-2, weight_decay=0.05, total_steps=8,
                            optim="adamw8bit", gradient_accumulation_steps=accum)
    p = bridge.from_jax_numpy(_opt_params(3), device="cpu")
    r = np.random.default_rng(4)
    grads = [{path: torch.from_numpy(r.standard_normal(t.shape).astype(np.float32))
              for path, t in bridge.named_leaves(p)} for _ in range(6)]

    def run(state, tx, gs):
        for g in gs:
            for path, leaf in bridge.named_leaves(state["params"]):
                if leaf.requires_grad:
                    leaf.grad = g[path].clone()
            tx.step()

    a, atx = tstep.init_train_state(p, tc)
    run(a, atx, grads[:3])
    saved = {"params": {k: v.detach().clone() for k, v in bridge.named_leaves(a["params"])},
             "opt": torch.utils._pytree.tree_map(
                 lambda x: x.clone() if isinstance(x, torch.Tensor) else x, atx.state_dict())}
    run(a, atx, grads[3:])
    b, btx = tstep.init_train_state(p, tc)
    with torch.no_grad():
        for path, leaf in bridge.named_leaves(b["params"]):
            leaf.copy_(saved["params"][path])
    btx.load_state_dict(saved["opt"])
    run(b, btx, grads[3:])
    for (path, x), (_, y) in zip(bridge.named_leaves(a["params"]),
                                 bridge.named_leaves(b["params"])):
        assert torch.equal(x, y), path
