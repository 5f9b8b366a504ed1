"""Fused decode kernels and the decode step: the port's plain versions against
the JAX Pallas kernels in interpret mode (dense, int8 and q4g weights), and
the port's ``decode_step`` against JAX's ``decode_step(..., fused=True)``
and ``decode_step(..., fused=False)`` (fp32, int8, per-row q4, NF4 and a
mixed q4g/q4 tree, which takes the non-fused path by itself).

Inputs come from one seeded numpy generator and run in fp32 through both
packages, at a non-zero layer index of a 2-layer stack. Tolerance 1e-5
relative: the same rounding points, fp32 sums in another order. q4g needs
contractions that are multiples of 256, so its cases run at hidden 256.

bf16 activations on dense bf16 weights (a bf16 checkpoint, whose chunks and
verify chunks the card runs on tensor cores) are held at the rows of the
decode step, the 8-slot tick and the verify and fused chunks: one bf16 ulp
of each output (the same rounding points, fp32 sums in another order can
flip a bf16 rounding), and for K1 also the one-ulp bound of its bf16
intermediate (``fused_mlp.intermediate_ulp_bound``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.config import LLMConfig
from slime_tpu.models import llama as jllama
from slime_tpu.ops import fused_mlp as jmlp
from slime_tpu.ops import fused_qkvo as jqkvo
from slime_tpu.ops.quantization import quantize_params, quantize_weight
from slime_tpu_torch import params as bridge
from slime_tpu_torch.models import llama as tllama
from slime_tpu_torch.ops import fused_mlp as tmlp
from slime_tpu_torch.ops import fused_qkvo as tqkvo
from slime_tpu_torch.ops import quantization as tquant

RTOL, ATOL = 1e-5, 1e-5


def _cfg(fmt="fp32"):
    if fmt in ("q4g", "mixed"):       # contractions of 256; mixed: down's in 384
        return LLMConfig(vocab_size=96, hidden_size=256,
                         intermediate_size=384 if fmt == "mixed" else 512,
                         num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                         max_position_embeddings=64)
    return LLMConfig(vocab_size=96, hidden_size=64, intermediate_size=256,
                     num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                     max_position_embeddings=64)


def _H(fmt):
    return _cfg(fmt).hidden_size


def _layers(fmt, seed=0):
    """Stacked JAX layer dict (numpy leaves) with random norms; fmt 'fp32'
    (dense), 'int8' (per-row int8 on all seven projections) or a
    ``quantize_params`` int4 scheme: 'q4' (absmax), 'nf4' (default), 'q4g'
    and 'mixed' (group; down's in 384 falls back to per-row q4)."""
    cfg = _cfg(fmt)
    r = np.random.default_rng(seed)
    p = jax.device_get(jllama.init(jax.random.PRNGKey(seed), cfg))
    for lp in p["layers"]:
        for n in ("input_layernorm", "post_attention_layernorm"):
            lp[n]["weight"] = (1 + 0.1 * r.standard_normal(cfg.hidden_size)
                               ).astype(np.float32)
        if fmt == "int8":
            for n in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                      "up_proj", "down_proj"):
                lp[n]["weight"] = jax.device_get(quantize_weight(lp[n]["weight"], 8))
    if fmt in ("q4", "nf4", "q4g", "mixed"):
        scheme = {"q4": "absmax", "nf4": "default"}.get(fmt, "group")
        p["layers"] = jax.device_get(quantize_params(p["layers"], 4, min_size=1024,
                                                     scheme=scheme))
    p["layers"] = jax.device_get(jllama.stack_layers(p["layers"]))
    return p


def _x(B, H, seed):
    return np.random.default_rng(seed).standard_normal((B, H)).astype(np.float32)


# the speculative verify chunk's rows (4 slots x 5), where K2 and K3 run on
# int8 weights' tensor-core instance on the card
VERIFY_ROWS = 20


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
@pytest.mark.parametrize("B", [1, 4, VERIFY_ROWS])
def test_qkv_ref_matches_jax_kernel(fmt, B):
    layers = _layers(fmt)["layers"]
    x = _x(B, _H(fmt), seed=B)
    want = jqkvo.fused_qkv_decode(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, layers), 1, eps=1e-5, interpret=True)
    got = tqkvo.fused_qkv_decode_ref(torch.from_numpy(x),
                                     bridge.from_jax_numpy(layers, device="cpu"), 1, eps=1e-5)
    for t, j in zip(got, want):
        _close(t, j)


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
@pytest.mark.parametrize("B", [1, 4, VERIFY_ROWS])
def test_o_residual_ref_matches_jax_kernel(fmt, B):
    layers = _layers(fmt)["layers"]
    attn, x = _x(B, _H(fmt), seed=10 + B), _x(B, _H(fmt), seed=20 + B)
    want = jqkvo.fused_o_residual(jnp.asarray(attn), jnp.asarray(x),
                                  jax.tree_util.tree_map(jnp.asarray, layers), 1,
                                  interpret=True)
    got = tqkvo.fused_o_residual_ref(torch.from_numpy(attn), torch.from_numpy(x),
                                     bridge.from_jax_numpy(layers, device="cpu"), 1)
    _close(got, want)


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
@pytest.mark.parametrize("B", [1, 4])
def test_mlp_ref_matches_jax_kernel(fmt, B):
    layers = _layers(fmt)["layers"]
    x = _x(B, _H(fmt), seed=30 + B)
    want = jmlp.fused_mlp_decode(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, layers), 1, eps=1e-5, block_inter=128, interpret=True)
    got = tmlp.fused_mlp_decode_ref(torch.from_numpy(x),
                                    bridge.from_jax_numpy(layers, device="cpu"), 1, eps=1e-5)
    _close(got, want)


@pytest.mark.parametrize("fmt", ["int8", "q4g"])
def test_f32_mlp_on_the_ring_route_matches_jax_kernel(fmt):
    """fp32 x at B = 1 with int8 and q4g weights, where the card's rule now
    takes the weight ring (``k1_route`` "ring", 4-byte activations): the
    wrapper (on CPU tensors, the plain version) against JAX's interpret-mode
    kernel at 1e-5 relative and absolute (fp32 sums in another order; the
    ring keeps h and a in fp32, the int8 scale on the fp32 row sum and the
    q4g scales on each group's partial sum, as the plain version does)."""
    cfg = _cfg(fmt)
    code = tqkvo.INT8 if fmt == "int8" else tqkvo.Q4G
    assert tmlp.k1_route(1, torch.float32, code, cfg.hidden_size, cfg.intermediate_size,
                         132) == "ring"
    layers = _layers(fmt)["layers"]
    x = _x(1, _H(fmt), seed=77)
    want = jmlp.fused_mlp_decode(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, layers), 1, eps=1e-5, block_inter=128, interpret=True)
    got = tmlp.fused_mlp_decode(torch.from_numpy(x),
                                bridge.from_jax_numpy(layers, device="cpu"), 1, eps=1e-5)
    assert got.dtype == torch.float32
    _close(got, want)


# bf16 rows on dense bf16 weights: a decode step, the engine's 8-slot tick,
# the verify chunks of 4 and 8 slots, the fused chunk
DENSE_BF16_ROWS = (1, 8, VERIFY_ROWS, 40, 64)
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _bf16_layers():
    """The fp32 stack with every projection's weight rounded to bf16 (JAX's
    bfloat16 arrays), the norms fp32: what a bf16 checkpoint loads into."""
    layers = _layers("fp32")["layers"]
    for n in PROJ:
        layers[n]["weight"] = np.asarray(jnp.asarray(layers[n]["weight"], jnp.bfloat16))
    return layers


def _x_bf16(B, H, seed):
    return np.asarray(jnp.asarray(_x(B, H, seed), jnp.bfloat16))


def _bf16_ulp(a):
    """The spacing of bf16 at |a| (fp32 numpy): 2^(floor(log2 |a|) - 7)."""
    a = np.maximum(np.abs(a), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _within_one_bf16_ulp(got, want, floor=0.0):
    """|got - want| <= one bf16 ulp of the larger of the two (+ ``floor``),
    elementwise."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    excess = np.abs(g - w) - _bf16_ulp(np.maximum(np.abs(g), np.abs(w))) - floor
    assert (excess <= 0).all(), f"beyond one bf16 ulp by {excess.max():.3g}"


@pytest.mark.parametrize("B", DENSE_BF16_ROWS)
def test_dense_bf16_qkv_ref_matches_jax_kernel(B):
    layers = _bf16_layers()
    x = _x_bf16(B, _H("fp32"), seed=40 + B)
    want = jqkvo.fused_qkv_decode(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, layers), 1, eps=1e-5, interpret=True)
    got = tqkvo.fused_qkv_decode_ref(bridge.from_jax_numpy(x, device="cpu"),
                                     bridge.from_jax_numpy(layers, device="cpu"), 1, eps=1e-5)
    for t, j in zip(got, want):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        _within_one_bf16_ulp(t, j)


@pytest.mark.parametrize("B", DENSE_BF16_ROWS)
def test_dense_bf16_o_residual_ref_matches_jax_kernel(B):
    layers = _bf16_layers()
    attn, x = _x_bf16(B, _H("fp32"), seed=50 + B), _x_bf16(B, _H("fp32"), seed=60 + B)
    want = jqkvo.fused_o_residual(jnp.asarray(attn), jnp.asarray(x),
                                  jax.tree_util.tree_map(jnp.asarray, layers), 1,
                                  interpret=True)
    got = tqkvo.fused_o_residual_ref(bridge.from_jax_numpy(attn, device="cpu"),
                                     bridge.from_jax_numpy(x, device="cpu"),
                                     bridge.from_jax_numpy(layers, device="cpu"), 1)
    assert got.dtype == torch.bfloat16
    _within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("B", DENSE_BF16_ROWS)
def test_dense_bf16_mlp_ref_matches_jax_kernel(B):
    layers = _bf16_layers()
    x = _x_bf16(B, _H("fp32"), seed=70 + B)
    want = jmlp.fused_mlp_decode(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, layers), 1, eps=1e-5, block_inter=128, interpret=True)
    tx = bridge.from_jax_numpy(x, device="cpu")
    tl = bridge.from_jax_numpy(layers, device="cpu")
    got = tmlp.fused_mlp_decode_ref(tx, tl, 1, eps=1e-5)
    assert got.dtype == torch.bfloat16
    _within_one_bf16_ulp(got, want, tmlp.intermediate_ulp_bound(tx, tl, 1).numpy())



def test_norm_flips_tells_rounding_flips_from_a_wrong_norm():
    """``fused_qkvo.norm_flips``, which the card's checks of dense K2 hold a
    kernel's row norm h with: the plain h has no difference; h rounded the
    other way where x r w lies on a bf16 rounding midpoint is a flip, not a
    fault; one ulp off elsewhere, or two ulps at the midpoint, is a fault.
    And ``qkv_proj_ref`` of the plain h is the plain version."""
    g = np.random.default_rng(9)
    x = torch.from_numpy(g.standard_normal((3, 256)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((1 + 0.1 * g.standard_normal(256)).astype(np.float32))
    eps = 1e-5
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(-1) + eps)
    mid = 1.5 + 2.0 ** -8                     # between bf16 1.5 and 1.5078125
    w[7] = mid / (xf[1, 7] * r[1])
    h = tqkvo.rms_h(x, w, eps)
    assert tqkvo.norm_flips(h, x, w, eps) == (0, 0)
    near = h.clone()
    near[1, 7] = 1.5 + 2.0 ** -7 if h[1, 7].item() == 1.5 else 1.5
    assert tqkvo.norm_flips(near, x, w, eps) == (1, 0)
    far = h.clone()
    v = far[0, 3].float()
    far[0, 3] = v + torch.sign(v) * torch.exp2(torch.floor(torch.log2(v.abs())) - 7)
    assert far[0, 3] != h[0, 3]
    assert tqkvo.norm_flips(far, x, w, eps) == (1, 1)
    two = h.clone()
    two[1, 7] = h[1, 7].float() + (2.0 ** -6 if h[1, 7].item() == 1.5 else -2.0 ** -6)
    assert tqkvo.norm_flips(two, x, w, eps) == (1, 1)
    layers = {"input_layernorm": {"weight": w[None].repeat(2, 1)}}
    for n, out in (("q_proj", 128), ("k_proj", 64), ("v_proj", 64)):
        layers[n] = {"weight": torch.from_numpy(
            (0.02 * g.standard_normal((2, out, 256))).astype(np.float32)).to(torch.bfloat16)}
    for a, b in zip(tqkvo.qkv_proj_ref(h, layers, 1),
                    tqkvo.fused_qkv_decode_ref(x, layers, 1, eps=eps)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

def test_cpu_dispatch_takes_the_plain_versions():
    layers = bridge.from_jax_numpy(_layers("int8")["layers"], device="cpu")
    x = torch.from_numpy(_x(2, 64, seed=5))
    counts = (tqkvo.fused_qkv_decode.launches, tqkvo.fused_o_residual.launches,
              tmlp.fused_mlp_decode.launches)
    for a, b in zip(tqkvo.fused_qkv_decode(x, layers, 0),
                    tqkvo.fused_qkv_decode_ref(x, layers, 0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(tqkvo.fused_o_residual(x, x, layers, 0),
                               tqkvo.fused_o_residual_ref(x, x, layers, 0),
                               rtol=0, atol=0)
    torch.testing.assert_close(tmlp.fused_mlp_decode(x, layers, 0),
                               tmlp.fused_mlp_decode_ref(x, layers, 0),
                               rtol=0, atol=0)
    assert counts == (tqkvo.fused_qkv_decode.launches,
                      tqkvo.fused_o_residual.launches,
                      tmlp.fused_mlp_decode.launches)


def test_unported_weight_format_raises():
    """NF4 has no fused kernel (decode runs it through the non-fused path)."""
    layers = bridge.from_jax_numpy(_layers("int8")["layers"], device="cpu")
    layers["q_proj"] = {"weight": tquant.quantize_weight_nf4(
        torch.ones((2, 64, 64)))}
    with pytest.raises(NotImplementedError):
        tqkvo.fused_qkv_decode(torch.zeros(1, 64), layers, 0)


def _decode_both(fmt, j_fused, t_fused, B=2):
    """Three decode steps through both packages from one random cache;
    greedy tokens from JAX's logits feed both."""
    cfg = _cfg(fmt)
    p = _layers(fmt, seed=3)
    r = np.random.default_rng(4)
    T, KVH, hd = 24, cfg.num_kv_heads, cfg.head_dim
    k0 = (r.standard_normal((2, B, T, KVH, hd)) * 0.3).astype(np.float32)
    v0 = (r.standard_normal((2, B, T, KVH, hd)) * 0.3).astype(np.float32)
    lengths = (np.array([3, 9], np.int32) if B == 2
               else r.integers(1, T - 4, B).astype(np.int32))
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
              "length": jnp.asarray(lengths)}
    tcache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
              "length": torch.from_numpy(lengths.copy())}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = bridge.from_jax_numpy(p, device="cpu")
    toks = (np.array([5, 17], np.int32) if B == 2
            else r.integers(0, cfg.vocab_size, B).astype(np.int32))
    for _ in range(3):
        jl, jcache = jllama.decode_step(jp, jcache, jnp.asarray(toks), cfg,
                                        fused=j_fused)
        tl, tcache = tllama.decode_step(tp, tcache, torch.from_numpy(toks).long(),
                                        cfg, fused=t_fused)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
        toks = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4g"])
def test_decode_step_matches_jax_fused(fmt):
    """The port's automatic choice (fused=None) takes the fused structure for
    these formats, as JAX's fused=True."""
    assert tllama._fused_auto_ok(bridge.from_jax_numpy(_layers(fmt)["layers"],
                                                       device="cpu"))
    _decode_both(fmt, True, None)


@pytest.mark.parametrize("fmt", ["int8", "q4g"])
def test_decode_step_fused_past_64_rows(fmt):
    """B = 65, one row past the decode kernels' former limit: the automatic
    choice still takes the fused path (as JAX does at any B) and matches
    JAX's ``_decode_step_fused`` with its kernels in interpret mode."""
    _decode_both(fmt, True, None, B=65)


@pytest.mark.parametrize("fmt", ["fp32", "int8", "q4", "nf4", "mixed"])
def test_decode_step_matches_jax_unfused(fmt):
    """fused=False on both sides: each layer through ``layers.linear``. The
    automatic choice makes the same call where no fused kernel can serve the
    MLP (per-row q4, NF4, mixed formats)."""
    layers = bridge.from_jax_numpy(_layers(fmt)["layers"], device="cpu")
    auto = tllama._fused_auto_ok(layers)
    assert auto == (fmt in ("fp32", "int8"))
    _decode_both(fmt, False, None if not auto else False)


def test_decode_step_unfused_takes_list_layers():
    """The non-fused path also runs on a list of layers; fused=True raises
    there."""
    cfg = _cfg()
    p = jax.device_get(jllama.init(jax.random.PRNGKey(5), cfg))
    tp = bridge.from_jax_numpy(p, device="cpu")
    cache = tllama.init_kv_cache(cfg, 1, 8, device="cpu")
    logits, cache = tllama.decode_step(tp, cache, torch.tensor([3]), cfg, fused=False)
    assert logits.shape == (1, cfg.vocab_size) and int(cache["length"][0]) == 1
    with pytest.raises(ValueError):
        tllama.decode_step(tp, cache, torch.tensor([3]), cfg, fused=True)
