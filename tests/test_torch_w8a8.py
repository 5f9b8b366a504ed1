"""The W8A8 matmul's plain version and the W8A8 vision tower against the
JAX package.

- ``w8a8_matmul_ref`` (K8's plain version) against JAX's
  ``w8a8_matmul(interpret=True)`` and ``w8a8_matmul_ref``, in fp32 and bf16,
  with and without a bias, a zero row and ragged tiles; ``w8a8_linear`` keeps
  leading dims;
- ``quantize_tower`` and ``pack_qkv_tower`` give JAX's trees byte for byte,
  and ``vit.apply`` on them agrees with JAX's (JAX's ViT attention runs its
  Pallas kernel in interpret mode, as in ``test_torch_vision.py``).

Tolerances: the integer dot is exact and both round at the same points, so
fp32 agrees to 1e-6 relative (the epilogue's products may fuse differently)
and bf16 to one bf16 ulp. The packed fp32 tower agrees to 1e-4. In the W8A8
tower the two packages' fp32 sums (patch embedding, attention) differ in
order by ~1e-7, and an activation on a rounding boundary then quantizes one
step apart: a few elements move by a quantum. It is held to 1e-3 of the
features' norm (measured 1.6e-4; W8A8 itself is 1.2e-3 from the fp32
tower) and 1e-2 absolute.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slime_tpu.ops.encoder_attention as jea
from slime_tpu.config import VisionConfig
from slime_tpu.models import vit as jvit
from slime_tpu.ops import quantization as JQ
from slime_tpu.ops import w8a8_matmul as jw8
from slime_tpu_torch import params as bridge
from slime_tpu_torch.models import vit as tvit
from slime_tpu_torch.ops import w8a8_matmul as tw8


def _case(M, K, N, seed, zero_row=True):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((M, K)) * 2).astype(np.float32)
    if zero_row:
        x[1] = 0.0                                  # activation scale 1
    w = (r.standard_normal((N, K)) * 0.05).astype(np.float32)
    b = r.standard_normal(N).astype(np.float32)
    return x, JQ.quantize_weight(jnp.asarray(w), 8), b


def _torch(qw):
    return {k: torch.from_numpy(np.array(v)) for k, v in qw.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("M,K,N", [(256, 128, 128), (300, 256, 192)])
def test_plain_matches_jax_kernel_and_ref(dtype, bias, M, K, N):
    x, qw, b = _case(M, K, N, seed=M + N)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x, jt)
    jb = jnp.asarray(b) if bias else None
    tb = torch.from_numpy(b) if bias else None
    got = tw8.w8a8_matmul_ref(torch.from_numpy(x).to(getattr(torch, dtype)), _torch(qw), tb)
    assert str(got.dtype) == f"torch.{dtype}"
    rtol = 2 ** -7 if dtype == "bfloat16" else 1e-6
    for want in (jw8.w8a8_matmul_ref(jx, qw, jb),
                 jw8.w8a8_matmul(jx, qw, jb, block_rows=128, block_out=64, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=rtol, atol=1e-6)


def test_w8a8_linear_keeps_leading_dims_and_takes_the_plain_version_on_cpu():
    x, qw, b = _case(6, 128, 64, seed=3, zero_row=False)
    p = {"weight": _torch(qw), "bias": torch.from_numpy(b)}
    before = tw8.w8a8_matmul.launches
    got = tw8.w8a8_linear(p, torch.from_numpy(x).reshape(2, 3, 128))
    assert got.shape == (2, 3, 64) and tw8.w8a8_matmul.launches == before
    want = jw8.w8a8_linear({"weight": qw, "bias": jnp.asarray(b)},
                           jnp.asarray(x).reshape(2, 3, 128))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _vcfg():
    # 577 tokens per view as CLIP-L/336; 3 layers of which 2 run
    return VisionConfig(image_size=336, patch_size=14, hidden_size=256,
                        intermediate_size=512, num_layers=3, num_heads=4)


@pytest.fixture(scope="module")
def vision():
    return jax.device_get(jvit.init(jax.random.PRNGKey(0), _vcfg()))


@pytest.fixture
def jax_kernel_attention(monkeypatch):
    monkeypatch.setattr(jea, "encoder_attention",
                        functools.partial(jea.encoder_attention, interpret=True))


def _assert_trees_equal(t, j):
    tl = dict(bridge.named_leaves(t))
    jl = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
          for path, leaf in jax.tree_util.tree_leaves_with_path(j)}
    assert tl.keys() == jl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]), err_msg=k)


@pytest.mark.parametrize("transform", ["quantize_tower", "pack_qkv_tower"])
def test_tower_transforms_equal(vision, transform):
    cfg = _vcfg()
    want = getattr(jvit, transform)(jax.tree_util.tree_map(jnp.asarray, vision), cfg)
    got = getattr(tvit, transform)(bridge.from_jax_numpy(vision, device="cpu"), cfg)
    _assert_trees_equal(got, want)
    assert "qkv" in got["layers"][1] and "q_proj" in got["layers"][2]   # layer 3 is not run


@pytest.mark.parametrize("transform", ["quantize_tower", "pack_qkv_tower"])
def test_vit_apply_on_transformed_towers(vision, jax_kernel_attention, transform):
    cfg = _vcfg()
    px = np.random.default_rng(1).standard_normal((2, 3, 336, 336)).astype(np.float32)
    jp = getattr(jvit, transform)(jax.tree_util.tree_map(jnp.asarray, vision), cfg)
    want = jvit.apply(jp, jnp.asarray(px), cfg)
    tp = getattr(tvit, transform)(bridge.from_jax_numpy(vision, device="cpu"), cfg)
    got = tvit.apply(tp, torch.from_numpy(px), cfg).numpy()
    want = np.asarray(want)
    assert got.shape == (2, 576, 256)
    if transform == "pack_qkv_tower":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.linalg.norm(got - want) < 1e-3 * np.linalg.norm(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
