"""Every weight storage format of the port against the JAX package, byte for
byte: int8 and int4 (``q``/``q4``) per row or per group, group-128 ``q4g``,
NF4, the ``quantize_params`` schemes and their dequantization, on the same
fp32 weights (2-D and stacked [L, out, in]); and the parameter bridge
carrying each format both ways unchanged.

Tolerance: none. Integers, scales and dequantized values must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.ops import quantization as JQ
from slime_tpu_torch import params as bridge
from slime_tpu_torch.ops import quantization as TQ


def _w(shape, seed=0):
    """Gaussian weights with a zero row (scale 1) and exact .5 ties after
    scaling, so the rounding mode shows."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 1, :] = 0.0
    w[..., 2, :8] = np.array([7, 3.5, -3.5, 0.5, -0.5, 1.5, 2.5, -7], np.float32)
    return w


def _equal(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _equal_dict(td, jd):
    assert td.keys() == jd.keys()
    for k in jd:
        assert str(td[k].dtype).replace("torch.", "") == str(np.asarray(jd[k]).dtype)
        _equal(td[k], jd[k])


FORMATS = [("q", 8, None), ("q", 8, 64), ("q4", 4, None), ("q4", 4, 64), ("q4", 4, 128),
           ("q4g", 4, 128), ("q4g", 4, 64), ("nf4", 4, 64)]


def _quantize(pkg, w, kind, bits, group):
    if kind == "q4g":
        return pkg.quantize_weight_q4g(w, group=group)
    if kind == "nf4":
        return pkg.quantize_weight_nf4(w, group=group)
    return pkg.quantize_weight(w, bits, group=group)


@pytest.mark.parametrize("shape", [(64, 256), (2, 48, 512)])
@pytest.mark.parametrize("kind,bits,group", FORMATS)
def test_format_bytes_and_values_equal(shape, kind, bits, group):
    w = _w(shape)
    jq = _quantize(JQ, jnp.asarray(w), kind, bits, group)
    tq = _quantize(TQ, torch.from_numpy(w), kind, bits, group)
    _equal_dict(tq, jq)
    _equal(TQ.dequantize_weight(tq), JQ.dequantize_weight(jq))


def test_q4g_packing_is_the_group_interleave():
    """Packed block b holds group 2b in its low nibbles and 2b+1 in its high
    ones: a weight whose value names its group and column shows each nibble's
    place."""
    col = np.arange(512)
    w = ((col // 128) + 1 - 4 * (col % 2)).astype(np.float32)[None].repeat(3, 0)
    q = TQ.quantize_weight_q4g(torch.from_numpy(w))
    vals = TQ.int_values(q).numpy()
    np.testing.assert_array_equal(vals, np.round(w / q["scale"].numpy().repeat(128, -1)))
    p = q["q4g"].numpy().astype(np.uint8)
    lo, hi = p & 0xF, p >> 4
    # block 1 (packed bytes 128..255) holds groups 2 (low) and 3 (high)
    np.testing.assert_array_equal(((lo[:, 128:] ^ 8).astype(np.int8) - 8), vals[:, 256:384])
    np.testing.assert_array_equal(((hi[:, 128:] ^ 8).astype(np.int8) - 8), vals[:, 384:512])


@pytest.mark.parametrize("bits,scheme", [(8, "default"), (4, "default"), (4, "absmax"),
                                         (4, "group")])
def test_quantize_params_schemes_equal(bits, scheme):
    """The scheme rules: 2-D floating leaves of at least min_size; NF4 where
    in % 64 == 0, q4g where in % 256 == 0, per-row otherwise; 1-D and
    stacked 3-D leaves pass through."""
    r = np.random.default_rng(1)
    tree = {"a": {"weight": r.standard_normal((64, 512)).astype(np.float32)},
            "b": [{"weight": r.standard_normal((32, 96)).astype(np.float32)},
                  {"weight": r.standard_normal((16, 8)).astype(np.float32)}],
            "norm": r.standard_normal((512,)).astype(np.float32),
            "stacked": r.standard_normal((2, 64, 512)).astype(np.float32)}
    jt = JQ.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree), bits,
                            min_size=1024, scheme=scheme)
    tt = TQ.quantize_params(jax.tree_util.tree_map(torch.from_numpy, tree), bits,
                            min_size=1024, scheme=scheme)
    want_a = {8: "q", 4: {"default": "nf4", "absmax": "q4", "group": "q4g"}[scheme]}[bits]
    assert want_a in tt["a"]["weight"]
    # in = 96: NF4 (96 % 64 != 0) and q4g fall back to per-row quantize_weight
    assert ("q" if bits == 8 else "q4") in tt["b"][0]["weight"]
    assert isinstance(tt["b"][1]["weight"], torch.Tensor)          # under min_size
    assert isinstance(tt["stacked"], torch.Tensor)                 # ndim 3
    for path, leaf in jax.tree_util.tree_leaves_with_path(jt):
        node = tt
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        _equal(node, leaf)
    for path, leaf in jax.tree_util.tree_leaves_with_path(JQ.dequantize_params(jt)):
        node = TQ.dequantize_params(tt)
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        _equal(node, leaf)


@pytest.mark.parametrize("kind,bits,group", [("q4", 4, None), ("q4g", 4, 128), ("nf4", 4, 64),
                                             ("q4", 4, 128)])
def test_bridge_round_trips_each_format(kind, bits, group):
    """from_jax_numpy and to_jax_numpy carry q4, q4g and NF4 dicts (stacked
    and in a list) bit for bit, scales kept fp32 under a dtype cast."""
    w = _w((2, 64, 256), seed=3)
    jq = jax.device_get(_quantize(JQ, jnp.asarray(w), kind, bits, group))
    tree = {"layers": {"q_proj": {"weight": jq}},
            "list": [{"weight": jax.device_get(_quantize(JQ, jnp.asarray(w[0]), kind, bits,
                                                         group))}]}
    t = bridge.from_jax_numpy(tree, device="cpu", dtype=torch.bfloat16)
    _equal_dict(t["layers"]["q_proj"]["weight"], jq)
    assert t["layers"]["q_proj"]["weight"]["scale"].dtype == torch.float32
    back = bridge.to_jax_numpy(t)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_round_is_half_to_even():
    w = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 7.0, 3.5, -3.5]], np.float32)
    _equal(TQ.quantize_weight(torch.from_numpy(w), 4)["q4"],
           JQ.quantize_weight(jnp.asarray(w), 4)["q4"])
    vals = TQ.int_values(TQ.quantize_weight(torch.from_numpy(w), 4)).numpy()
    np.testing.assert_array_equal(vals, [[0, 2, 2, 0, -2, 7, 4, -4]])
