"""Port's common layers and int8 quantization against the JAX package (fp32).

Same seeded numpy inputs through ``slime_tpu.models.layers`` /
``slime_tpu.ops.quantization`` and their ``slime_tpu_torch`` counterparts.
Tolerance 1e-5 relative for module math (fp32 sums in another order);
quantized bytes and scales must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.config import LLMConfig
from slime_tpu.models import layers as JL
from slime_tpu.models import llama as jllama
from slime_tpu.ops import quantization as JQ
from slime_tpu_torch.models import layers as TL
from slime_tpu_torch.models import llama as tllama
from slime_tpu_torch.ops import quantization as TQ

RTOL, ATOL = 1e-5, 1e-6


def _r(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_dense(bias):
    r = _r(1)
    x = r.standard_normal((2, 5, 48)).astype(np.float32)
    p = {"weight": r.standard_normal((40, 48)).astype(np.float32) * 0.1}
    if bias:
        p["bias"] = r.standard_normal((40,)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    _close(TL.linear(tp, _t(x)),
           JL.linear({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


def test_linear_int8():
    r = _r(2)
    x = r.standard_normal((3, 64)).astype(np.float32)
    w = r.standard_normal((32, 64)).astype(np.float32) * 0.05
    jq = JQ.quantize_weight(jnp.asarray(w), 8)
    tq = {k: _t(v) for k, v in jq.items()}
    b = r.standard_normal((32,)).astype(np.float32)
    _close(TL.linear({"weight": tq, "bias": _t(b)}, _t(x)),
           JL.linear({"weight": jq, "bias": jnp.asarray(b)}, jnp.asarray(x)))


def test_linear_rejects_unported_formats():
    """Every weight format and both adapter entries are ported
    (``tests/test_torch_lora.py`` holds them to JAX); a per-row ``lora_b``
    entry whose batch does not divide x's rows is refused, and a zero
    adapter changes nothing."""
    x = torch.ones(3, 4)
    with pytest.raises(RuntimeError):
        TL.linear({"weight": torch.zeros(4, 4), "lora_b": {"A": torch.zeros(2, 1, 4),
                                                           "B": torch.zeros(2, 4, 1)}}, x)
    w = torch.arange(16.0).reshape(4, 4)
    zero = {"A": torch.zeros(1, 4), "B": torch.zeros(4, 1)}
    assert torch.equal(TL.linear({"weight": w, "lora": zero}, x), TL.linear({"weight": w}, x))


def test_norms():
    r = _r(3)
    x = r.standard_normal((2, 7, 32)).astype(np.float32) * 3
    w = r.standard_normal((32,)).astype(np.float32)
    b = r.standard_normal((32,)).astype(np.float32)
    _close(TL.rms_norm({"weight": _t(w)}, _t(x), eps=1e-5),
           JL.rms_norm({"weight": jnp.asarray(w)}, jnp.asarray(x), eps=1e-5))
    _close(TL.layer_norm({"weight": _t(w), "bias": _t(b)}, _t(x), eps=1e-6),
           JL.layer_norm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                         jnp.asarray(x), eps=1e-6))


@pytest.mark.parametrize("masked", [False, True])
def test_mha(masked):
    r = _r(4)
    E, H = 32, 4
    p = {"in_proj_weight": r.standard_normal((3 * E, E)).astype(np.float32) * 0.2,
         "in_proj_bias": r.standard_normal((3 * E,)).astype(np.float32) * 0.1,
         "out_proj": {"weight": r.standard_normal((E, E)).astype(np.float32) * 0.2,
                      "bias": r.standard_normal((E,)).astype(np.float32) * 0.1}}
    q = r.standard_normal((2, 5, E)).astype(np.float32)
    kv = r.standard_normal((2, 9, E)).astype(np.float32)
    mask = np.zeros((2, 9), bool)
    if masked:
        mask[0, 6:] = True
        mask[1, :2] = True
    jp = {"in_proj_weight": jnp.asarray(p["in_proj_weight"]),
          "in_proj_bias": jnp.asarray(p["in_proj_bias"]),
          "out_proj": {k: jnp.asarray(v) for k, v in p["out_proj"].items()}}
    tp = {"in_proj_weight": _t(p["in_proj_weight"]),
          "in_proj_bias": _t(p["in_proj_bias"]),
          "out_proj": {k: _t(v) for k, v in p["out_proj"].items()}}
    _close(TL.mha(tp, _t(q), _t(kv), _t(kv), H,
                  key_padding_mask=_t(mask) if masked else None),
           JL.mha(jp, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), H,
                  key_padding_mask=jnp.asarray(mask) if masked else None))


def test_host_tables_are_identical():
    np.testing.assert_array_equal(TL.sincos_2d(64, 5), JL.sincos_2d(64, 5))
    for src, dst in ((24, 2), (24, 7), (672, 336), (500, 336)):
        np.testing.assert_array_equal(TL.bicubic_weight_matrix(src, dst),
                                      JL.bicubic_weight_matrix(src, dst))
        np.testing.assert_array_equal(TL.pil_resize_matrix(src, dst),
                                      JL.pil_resize_matrix(src, dst))


@pytest.mark.parametrize("tgt", [(24, 24), (12, 12), (5, 7)])
def test_interp_pos_embed(tgt):
    pos = _r(5).standard_normal((576, 16)).astype(np.float32)
    _close(TL.interp_pos_embed(_t(pos), tgt),
           JL.interp_pos_embed(jnp.asarray(pos), tgt))


@pytest.mark.parametrize("shape", [(24, 64), (3, 24, 64)])
def test_quantize_dequantize_equal(shape):
    w = _r(6).standard_normal(shape).astype(np.float32)
    w.reshape(-1, 64)[3] = 0.0                       # an all-zero row: scale 1
    jq = JQ.quantize_weight(jnp.asarray(w), 8)
    tq = TQ.quantize_weight(_t(w), 8)
    np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    np.testing.assert_array_equal(TQ.dequantize_weight(tq).numpy(),
                                  np.asarray(JQ.dequantize_weight(jq)))
    # int4 and group-scaled int8 (ported since): the same bytes and values
    for bits, group in ((4, None), (8, 16)):
        jg = JQ.quantize_weight(jnp.asarray(w), bits, group=group)
        tg = TQ.quantize_weight(_t(w), bits, group=group)
        for k in jg:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        np.testing.assert_array_equal(TQ.dequantize_weight(tg).numpy(),
                                      np.asarray(JQ.dequantize_weight(jg)))


def test_rope():
    cfg = LLMConfig.tiny()
    cos_t, sin_t = tllama.rope_table(cfg, 1024, device="cpu")
    cos_j, sin_j = jllama.rope_table(cfg, 1024)
    # fp32 tables; angles grow with position, so compare in absolute terms
    _close(cos_t, cos_j, rtol=0, atol=1e-5)
    _close(sin_t, sin_j, rtol=0, atol=1e-5)
    x = _r(7).standard_normal((2, 6, 4, cfg.head_dim)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [9, 10, 11, 500, 700, 1000]])
    _close(tllama.apply_rope(_t(x), cos_t[_t(pos)], sin_t[_t(pos)]),
           jllama.apply_rope(jnp.asarray(x), cos_j[pos], sin_j[pos]), atol=1e-5)
