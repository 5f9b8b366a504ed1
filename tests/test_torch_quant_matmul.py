"""The quantized matmuls' plain versions and the port's ``layers.linear``
against the JAX package.

- ``quant_matmul_ref`` (K6: per-row ``q4`` and int8) and
  ``quant_matmul_q4g_ref`` (K7: group-128 ``q4g``) against JAX's Pallas
  kernels in interpret mode, in fp32 and bf16, with ragged row and output
  counts (K6 at the rows where its routing changes instance: 1, 8, 9, 37,
  64, 65), K6 also at K = 200 and 1000; the contraction rule of the kernels;
- K6's routing (``k6_route``) at each boundary of rows, dtype and K, and a
  model of its ``wgmma`` loader's addressing: every A-fragment
  register holds, after the kernel's conversion, the integer weights of its
  (row, column) pairs;
- the port's CPU ``linear`` against JAX's CPU ``layers.linear`` for per-row
  q4, grouped q4, q4g and NF4 (on the CPU both dequantize and matmul), and
  the CPU wrappers taking the plain versions without counting a launch.

Tolerances: fp32 1e-5 relative and absolute (the same exact products,
fp32 sums in another order); bf16 outputs one bf16 ulp (2^-7 relative)
plus 1e-6, and after a bias one ulp of the largest output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slime_tpu.models import layers as JL
from slime_tpu.ops import quant_matmul as jqm
from slime_tpu.ops import quantization as JQ
from slime_tpu_torch.models import layers as TL
from slime_tpu_torch.ops import quant_matmul as tqm
from slime_tpu_torch.ops import quantization as TQ

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-6)}


def _data(M, N, K, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((M, K)).astype(np.float32),
            (r.standard_normal((N, K)) * 0.05).astype(np.float32))


def _inputs(x, qw_j, dtype):
    """The same x and weight dict for both packages, x in ``dtype``."""
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw = {k: torch.from_numpy(np.array(v)) for k, v in qw_j.items()}
    return jx, tx, tw


def _close(t, j, dtype, atol=None):
    assert str(t.dtype) == f"torch.{dtype}"
    rtol, floor = TOL[dtype]
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=rtol, atol=floor if atol is None else atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M,N,K", [(1, 256, 256), (37, 320, 512), (8, 256, 256),
                                   (9, 256, 256), (64, 320, 512), (65, 320, 512)])
def test_k6_plain_matches_jax_kernel(dtype, bits, M, N, K):
    x, w = _data(M, N, K, seed=M + bits)
    qw = JQ.quantize_weight(jnp.asarray(w), bits)
    jx, tx, tw = _inputs(x, qw, dtype)
    want = jqm.quant_matmul(jx, qw, block_out=128, block_rows=32, interpret=True)
    _close(tqm.quant_matmul_ref(tx, tw), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K", [200, 1000])
def test_k6_plain_matches_jax_kernel_any_k(dtype, bits, K):
    """K6 at a K that is not a multiple of 128 (int8 any K, q4 any even K: the
    kernel masks its last k-tile; JAX's takes the whole row in one block),
    with a ragged M and N."""
    M, N = 37, 320
    x, w = _data(M, N, K, seed=K + bits)
    qw = JQ.quantize_weight(jnp.asarray(w), bits)
    jx, tx, tw = _inputs(x, qw, dtype)
    want = jqm.quant_matmul(jx, qw, block_out=128, block_rows=16, interpret=True)
    _close(tqm.quant_matmul_ref(tx, tw), want, dtype)


def test_k6_contraction_rule():
    """What K the kernels take: any with int8, even with q4 (pairs of
    nibbles), multiples of 256 with q4g (two groups a packed block, as JAX
    asserts)."""
    assert (tqm.k_multiple(tqm._INT8), tqm.k_multiple(tqm._Q4), tqm.k_multiple(tqm._Q4G)) == (
        1, 2, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,K,bk", [(3, 256, 512, 512), (40, 384, 1024, 512),
                                      (5, 320, 768, 768)])
def test_k7_plain_matches_jax_kernel(dtype, M, N, K, bk):
    x, w = _data(M, N, K, seed=N)
    qw = JQ.quantize_weight_q4g(jnp.asarray(w), group=128)
    jx, tx, tw = _inputs(x, qw, dtype)
    want = jqm.quant_matmul_q4g(jx, qw, block_out=128, block_in=bk, interpret=True)
    _close(tqm.quant_matmul_q4g_ref(tx, tw), want, dtype)


def _fmt(w, kind):
    if kind == "q4":
        return JQ.quantize_weight(w, 4)
    if kind == "q4_group":
        return JQ.quantize_weight(w, 4, group=64)
    if kind == "q4g":
        return JQ.quantize_weight_q4g(w, group=128)
    return JQ.quantize_weight_nf4(w, group=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["q4", "q4_group", "q4g", "nf4"])
def test_cpu_linear_matches_jax_linear(dtype, kind):
    """JAX on the CPU rounds the dequantized weight to x's dtype and runs
    one dot; the port on the CPU does the same, whatever the format."""
    x, w = _data(6, 192, 256, seed=9)
    b = np.random.default_rng(10).standard_normal(192).astype(np.float32)
    qw = _fmt(jnp.asarray(w), kind)
    jx, tx, tw = _inputs(x.reshape(2, 3, 256), qw, dtype)
    want = JL.linear({"weight": qw, "bias": jnp.asarray(b)}, jx)
    got = TL.linear({"weight": tw, "bias": torch.from_numpy(b)}, tx)
    assert got.shape == (2, 3, 192)
    # the bias is added after the rounding to x's dtype: in bf16 a sum that
    # cancels keeps the one-ulp difference of its larger term
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    _close(got, want, dtype, atol=TOL[dtype][0] * scale if dtype == "bfloat16" else None)


def test_cpu_wrappers_take_the_plain_versions():
    x, w = _data(4, 128, 256, seed=2)
    tx = torch.from_numpy(x)
    q4 = TQ.quantize_weight(torch.from_numpy(w), 4)
    q8 = TQ.quantize_weight(torch.from_numpy(w), 8)
    q4g = TQ.quantize_weight_q4g(torch.from_numpy(w))
    counts = (tqm.quant_matmul.q4_launches, tqm.quant_matmul.int8_launches,
              tqm.quant_matmul_q4g.launches)
    for qw in (q4, q8):
        torch.testing.assert_close(tqm.quant_matmul(tx, qw), tqm.quant_matmul_ref(tx, qw),
                                   rtol=0, atol=0)
    torch.testing.assert_close(tqm.quant_matmul_q4g(tx, q4g),
                               tqm.quant_matmul_q4g_ref(tx, q4g), rtol=0, atol=0)
    assert counts == (tqm.quant_matmul.q4_launches, tqm.quant_matmul.int8_launches,
                      tqm.quant_matmul_q4g.launches)
    with pytest.raises(ValueError):        # K6 takes per-row scales only
        tqm.quant_matmul_ref(tx, TQ.quantize_weight(torch.from_numpy(w), 4, group=64))


def test_plain_versions_scale_after_the_exact_dot():
    """K6 applies the per-row scale to the fp32 sum of exact integer
    products; K7 scales each group's partial sum (not the weight)."""
    x = np.ones((1, 256), np.float32)
    w = np.zeros((2, 256), np.float32)
    w[0, :128], w[0, 128:] = 0.7, -0.07            # group scales 0.1 and 0.01
    w[1] = 0.35
    q4g = TQ.quantize_weight_q4g(torch.from_numpy(w))
    y = tqm.quant_matmul_q4g_ref(torch.from_numpy(x), q4g)
    s = q4g["scale"]
    want0 = np.float32(np.float32(128 * 7) * s[0, 0].item()) + np.float32(
        np.float32(128 * -7) * s[0, 1].item())
    assert y[0, 0].item() == pytest.approx(float(want0), rel=1e-6)
    q4 = TQ.quantize_weight(torch.from_numpy(w), 4)
    y = tqm.quant_matmul_ref(torch.from_numpy(x), q4)
    assert y[0, 1].item() == pytest.approx(256 * 7 * q4["scale"][1, 0].item(), rel=1e-6)


# k6_route at each boundary: decode rows (1, 8) take the weight ring where
# a plan exists, 9-63 the mma.sync GEMM, 64 and more wgmma where TMA reads
# the rows (K a multiple of 16 bytes of int8 / q4 weights); K = 1000 and 1002
# have rows neither reads; fp32 x always takes the FFMA GEMM
@pytest.mark.parametrize("fmt", ["q4", "int8"])
@pytest.mark.parametrize("K", [4096, 14336, 1000, 1002])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows", [1, 8, 9, 63, 64, 2048])
def test_k6_route(rows, dtype, K, fmt):
    code = tqm._Q4 if fmt == "q4" else tqm._INT8
    whole = K in (4096, 14336)          # rows of whole 16-byte vectors in both formats
    if dtype == torch.float32:
        want = "ffma"
    elif rows <= 8 and whole:
        want = "ring"
    elif rows >= 64 and whole:
        want = "wgmma"
    else:
        want = "mma"
    for N in (4096, 1024, 14336):
        assert tqm.k6_route(rows, K, dtype, code, N, 132) == want


def _sw128_offset(row: int, byte: int) -> int:
    """Where byte ``byte`` (< 128) of row ``row`` of a tile of 128-byte rows
    lands in shared memory under TMA's 128-byte swizzle: 16-byte piece c of
    row r at piece c ^ (r % 8)."""
    return row * 128 + (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15)


def _fragment_bytes(fmt: str, row: int, kk: int, t: int, x: int):
    """The shared-memory bytes of a stage's weight tile that K6's ``wgmma``
    loader (``k6_frags`` in ``csrc/quant_matmul.cu``) reads for A-fragment
    register ``x`` (0-3) of k16 step ``kk`` in lane (g, t) whose tile row is
    ``row`` (rows 16 w + g for x = 0, 2; + 8 for x = 1, 3). q4: one byte,
    8 kk + t (+ 4 for x >= 2), its low and high nibble; int8: two, 16 kk +
    2t (+ 8) and the next."""
    if fmt == "q4":
        return [_sw128_offset(row, 8 * kk + t + 4 * (x >> 1))]
    first = 16 * kk + 2 * t + 8 * (x >> 1)
    return [_sw128_offset(row, first), _sw128_offset(row, first + 1)]


def _fragment_cols(kk: int, t: int, x: int):
    """The columns (within a stage) that A-fragment register ``x`` of k16
    step ``kk`` holds in lane (g, t), as wgmma's m64k16 A layout places
    them: k = 2t, 2t + 1 for x = 0, 1 and 2t + 8, 2t + 9 for x = 2, 3."""
    c = 16 * kk + 2 * t + 8 * (x >> 1)
    return c, c + 1


def _swizzled_stage(packed: np.ndarray, col0_byte: int) -> np.ndarray:
    """A stage's weight tile as TMA lands it: 128 bytes from ``col0_byte`` of
    every row, in the 128-byte swizzle (zero past the row's end)."""
    rows, width = packed.shape
    tile = np.zeros(rows * 128, np.uint8)
    for r in range(rows):
        for b in range(128):
            if col0_byte + b < width:
                tile[_sw128_offset(r, b)] = packed[r, col0_byte + b]
    return tile


def _bf16x2(v: np.uint32):
    """The two bf16 halves of a 32-bit word as fp32 (low half first)."""
    return (np.array([v << 16, v & 0xFFFF0000], np.uint32)).view(np.float32)


@pytest.mark.parametrize("fmt", ["q4", "int8"])
def test_k6_wgmma_fragment_map(fmt):
    """The wgmma loader's model (``_fragment_bytes``): for every row of a
    256-row tile, k16 step and lane, the bytes each A-fragment register reads
    from the swizzled stage, converted as the kernel converts them (q4: (b *
    0x1001) & 0x000F000F ^ 0x43084308 as bf16x2, minus 136; int8: each byte
    XOR 0x80 into 2^23's mantissa, minus 2^23 + 128), are the integer
    weights ``int_values`` puts at the register's (row, column) pairs; in the
    second stage of a row and in one that runs past K (zero fill: 0)."""
    r = np.random.default_rng(3)
    K = 640 if fmt == "q4" else 320            # stages of 256 / 128 columns: 2.5 of them
    w = torch.from_numpy(r.standard_normal((256, K)).astype(np.float32))
    qw = TQ.quantize_weight(w, 4 if fmt == "q4" else 8)
    packed = (qw["q4"] if fmt == "q4" else qw["q"]).numpy().view(np.uint8)
    ints = TQ.int_values(qw).numpy().astype(np.float32)
    bk, steps = (256, 16) if fmt == "q4" else (128, 8)
    for stage in (1, 2):
        tile = _swizzled_stage(packed, 128 * stage)
        for row in range(256):
            for kk in range(steps):
                for t in range(4):
                    for x in range(4):
                        got_bytes = [int(tile[o]) for o in _fragment_bytes(fmt, row, kk, t, x)]
                        if fmt == "q4":
                            v = np.uint32(((got_bytes[0] * 0x1001) & 0x000F000F) ^ 0x43084308)
                            got = _bf16x2(v) - np.float32(136.0)
                        else:
                            got = np.array([(np.array(b ^ 0x80 | 0x4B000000, np.uint32)
                                             .view(np.float32)) - np.float32(8388736.0)
                                            for b in got_bytes], np.float32)
                        cols = [stage * bk + c for c in _fragment_cols(kk, t, x)]
                        want = [ints[row, c] if c < K else 0.0 for c in cols]
                        np.testing.assert_array_equal(got, np.array(want, np.float32))


def test_cpu_quant_matmul_takes_the_plain_version_at_every_route():
    """bf16 x at the ring's, wgmma's and mma.sync's rows: on the CPU K6 is its
    plain version and counts no launch of any instance."""
    names = [f"{f}{sfx}_launches" for f in ("q4", "int8")
             for sfx in ("", "_f32", "_ring", "_wgmma")]
    before = [getattr(tqm.quant_matmul, n) for n in names]
    for M in (1, 8, 9, 64):
        x, w = _data(M, 64, 512, seed=M)
        tx = torch.from_numpy(x).to(torch.bfloat16)
        for bits in (4, 8):
            qw = TQ.quantize_weight(torch.from_numpy(w), bits)
            torch.testing.assert_close(tqm.quant_matmul(tx, qw), tqm.quant_matmul_ref(tx, qw),
                                       rtol=0, atol=0)
    assert [getattr(tqm.quant_matmul, n) for n in names] == before
