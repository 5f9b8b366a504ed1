"""The int4 probes' plain versions (P1, P4) and K9's plain version at the
shapes its kernel now takes, held to the JAX package on the CPU; and the
pure rules of the kernels' wrappers (K7's route and split, K9's operand
rule, the copy of views TMA cannot read).

- P1 (``slime_tpu_torch/probes/quant_matmul.py``): its plain version is K6's
  ``quant_matmul_ref``; held to JAX's ``quant_matmul`` in interpret mode on a
  per-row q4 weight, and the twodot variant's column permutation to the same
  function.
- P4 (``slime_tpu_torch/probes/q4g_unpack.py``): its plain results and the
  TPU kernel's [8, 128] checksum formed from them, against a numpy rewrite
  of the JAX probe's ``kern`` at the script's tiny shape (L, I, H) = (2, 512,
  256) with its 256-row blocks, and at 1024-row blocks.
- K9: ``ring_attention_rdma`` on CPU tensors (its plain version) in fp32 at
  D = 8 and 80 and at S/n = 12 against JAX's
  ``ring_attention_rdma(interpret=True)`` on a mesh of the virtual CPU
  devices, at JAX's tolerance (2e-5).
"""
import numpy as np
import pytest
import torch

from slime_tpu_torch.ops import _cuda
from slime_tpu_torch.ops import quant_matmul as qm
from slime_tpu_torch.ops import quantization as quant
from slime_tpu_torch.ops import ring_attention_rdma as trd
from slime_tpu_torch.probes import q4g_unpack as p4
from slime_tpu_torch.probes import quant_matmul as p1

RDMA_TOL = dict(atol=2e-5, rtol=2e-5)       # JAX's tests/test_ring_attention_rdma.py


def _mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


# --------------------------------------------------------------------------
# P1
# --------------------------------------------------------------------------

@pytest.mark.parametrize("out,inp", [(64, 256), (512, 512)])
def test_p1_plain_matches_jax_quant_matmul(out, inp):
    """P1's plain version (K6's) against JAX's K6 in interpret mode on a
    per-row q4 weight whose packed bytes take all 256 values (the probe's
    inputs): exact products, fp32 sums, bf16 out."""
    import jax.numpy as jnp
    from slime_tpu.ops.quant_matmul import quant_matmul as jqm
    r = np.random.default_rng(out + inp)
    x = r.standard_normal((1, inp)).astype(np.float32)
    packed = r.integers(-128, 128, (out, inp // 2), dtype=np.int8)
    scale = np.full((out, 1), 0.01, np.float32)
    want = jqm(jnp.asarray(x, jnp.bfloat16), {"q4": jnp.asarray(packed),
                                              "scale": jnp.asarray(scale)}, interpret=True)
    got = p1.plain(torch.from_numpy(x).to(torch.bfloat16),
                   {"q4": torch.from_numpy(packed), "scale": torch.from_numpy(scale)})
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_p1_twodot_permutation_is_k6():
    """The twodot variant's arithmetic in plain torch: the low nibbles
    against x's even columns, the high ones against its odd columns (the
    permuted x's two halves), two sums added, is K6's function."""
    x, qw = p1.make_inputs("cpu", seed=3, out=32)
    xp = p1.permute_even_odd(x).float()
    u = qw["q4"].to(torch.int32) & 0xFF
    lo, hi = ((u & 0xF) ^ 8) - 8, (((u >> 4) & 0xF) ^ 8) - 8
    half = x.shape[1] // 2
    y = (xp[:, :half] @ lo.float().T + xp[:, half:] @ hi.float().T) * qw["scale"][:, 0]
    torch.testing.assert_close(y.to(torch.bfloat16), p1.plain(x, qw), rtol=2 ** -7, atol=1e-6)


# --------------------------------------------------------------------------
# P4
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(p4.MODES))
@pytest.mark.parametrize("shape,bi", [((2, 512, 256), 256), ((2, 2048, 256), 1024)],
                         ids=["tiny", "bi1024"])
def test_p4_plain_checksum_matches_kern(mode, shape, bi):
    """P4's plain result, folded into the TPU kernel's [8, 128] checksum,
    against a numpy rewrite of ``kern`` run block by block (fp32 sums)."""
    packed, h = p4.make_inputs("cpu", seed=0, shape=shape)
    got = p4.checksum(mode, p4.plain(mode, packed, h), bi)
    want = p4.kern_numpy(mode, packed.numpy(), h.float().numpy(), bi)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)


def test_p4_unpack_rows_is_q4g_order():
    """P4's unpack is the q4g layout's: the same values as int_values."""
    packed, _ = p4.make_inputs("cpu", seed=1, shape=(1, 8, 512))
    qw = {"q4g": packed[0], "scale": torch.ones((8, 4))}
    assert torch.equal(p4.unpack_rows(packed[0]), quant.int_values(qw).to(torch.int32))


# --------------------------------------------------------------------------
# K9's plain version at the shapes its kernel now takes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", [(4, 2, 2, 8, 8, True), (4, 4, 2, 8, 80, False),
                                  (2, 4, 1, 12, 80, True), (4, 4, 2, 12, 8, True)],
                         ids=["d8", "d80-full", "d80-sn12", "d8-sn12"])
def test_ring_attention_rdma_plain_fp32_matches_jax(case):
    from slime_tpu.ops.ring_attention_rdma import ring_attention_rdma as jrdma
    n, H, KVH, Sn, D, causal = case
    r = np.random.default_rng(n * Sn + D)
    q = r.standard_normal((1, H, n * Sn, D)).astype(np.float32)
    k = r.standard_normal((1, KVH, n * Sn, D)).astype(np.float32)
    v = r.standard_normal((1, KVH, n * Sn, D)).astype(np.float32)
    want = jrdma(q, k, v, mesh=_mesh(n), causal=causal, interpret=True)
    got = trd.ring_attention_rdma(*map(torch.from_numpy, (q, k, v)), ring=n, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RDMA_TOL)


def test_ring_attention_rdma_operand_rule():
    """What the kernel reads: one dtype, bf16 only when all three are bf16
    (fp16 or a mix computes in fp32, as JAX's kernel does); q with unit
    stride over D; for the bf16 wgmma kernel (D = 128, 256) a q TMA reads,
    else a copy."""
    q = torch.zeros((1, 2, 64, 128), dtype=torch.bfloat16)
    assert [t.dtype for t in trd.kernel_operands(q, q, q)] == [torch.bfloat16] * 3
    assert [t.dtype for t in trd.kernel_operands(q.half(), q.half(), q.half())] == \
        [torch.float32] * 3
    assert [t.dtype for t in trd.kernel_operands(q, q.float(), q)] == [torch.float32] * 3
    flat = torch.zeros(2 * 64 * 128 + 8, dtype=torch.bfloat16)
    view = flat[1:1 + 2 * 64 * 128].view(1, 2, 64, 128)
    kq = trd.kernel_operands(view, view, view)[0]
    assert _cuda.tma_ready(kq) and torch.equal(kq, view)
    small = flat[1:1 + 2 * 64 * 12].view(1, 2, 64, 12)
    assert trd.kernel_operands(small, small, small)[0].data_ptr() == small.data_ptr()
    strided = torch.zeros((1, 2, 64, 24))[..., ::2]
    assert trd.kernel_operands(strided, strided, strided)[0].stride(-1) == 1


# --------------------------------------------------------------------------
# the wrappers' pure rules
# --------------------------------------------------------------------------

def test_tma_operand_copies_only_what_tma_cannot_read():
    flat = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    aligned = flat[:4 * 64].view(4, 64)
    assert _cuda.tma_operand(aligned) is aligned
    off = flat[1:1 + 4 * 64].view(4, 64)
    copy = _cuda.tma_operand(off)
    assert copy.data_ptr() != off.data_ptr() and _cuda.tma_ready(copy)
    assert torch.equal(copy, off)


@pytest.mark.parametrize("rows,dtype,route", [
    (64, torch.bfloat16, "wgmma"), (2048, torch.bfloat16, "wgmma"),
    (63, torch.bfloat16, "mma"), (1, torch.bfloat16, "mma"),
    (2048, torch.float32, "ffma"), (1, torch.float32, "ffma")])
def test_q4g_route(rows, dtype, route):
    """K7's kernel is a pure function of x's rows and dtype."""
    assert qm.q4g_route(rows, dtype) == route


def test_q4g_wgmma_splits():
    """A split over K only where the 128 x 128 tiles fill at most half the
    132 SMs; the splits cover every packed block once."""
    assert qm.wgmma_splits(2048, 14336, 4096, 132) == (1, 16)
    assert qm.wgmma_splits(2048, 1024, 4096, 132) == (1, 16)
    splits, per = qm.wgmma_splits(64, 1024, 4096, 132)
    assert splits > 1 and (splits - 1) * per < 16 <= splits * per
    splits, per = qm.wgmma_splits(100, 4096, 14336, 132)
    assert (splits - 1) * per < 56 <= splits * per
