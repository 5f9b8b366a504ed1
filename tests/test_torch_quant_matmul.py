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
# a plan exists, in bf16 and (up to K6_F32_RING_ROWS) fp32; bf16 9-63 rows
# the mma.sync GEMM, 64 and more wgmma where TMA reads the rows (K a
# multiple of 16 bytes of int8 / q4 weights); fp32 from F32_TILES_MIN_ROWS
# rows the register tiles where K is a multiple of 128, else the first FFMA
# GEMM; K = 1000 and 1002 have rows neither the ring nor TMA reads
@pytest.mark.parametrize("fmt", ["q4", "int8"])
@pytest.mark.parametrize("K", [4096, 14336, 1000, 1002])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows", [1, 8, 9, 63, 64, 2048])
def test_k6_route(rows, dtype, K, fmt):
    code = tqm._Q4 if fmt == "q4" else tqm._INT8
    whole = K in (4096, 14336)          # rows of whole 16-byte vectors in both formats
    f32 = dtype == torch.float32
    if rows <= (tqm.K6_F32_RING_ROWS if f32 else 8) and whole:
        want = "ring"
    elif f32:
        want = "tiles" if rows >= tqm.F32_TILES_MIN_ROWS and K % 128 == 0 else "ffma"
    elif rows >= 64 and whole:
        want = "wgmma"
    else:
        want = "mma"
    for N in (4096, 1024, 14336):
        assert tqm.k6_route(rows, K, dtype, code, N, 132) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rows", [1, 8, 9, 63, 64, 65, 128, 2048])
def test_q4g_route(rows, dtype):
    """K7's rule: bf16 below 64 rows mma.sync, from 64 wgmma; fp32 below
    F32_TILES_MIN_ROWS the first FFMA GEMM, from there the register tiles
    (config A's fp32 prefill at 2048 rows); no weight ring (K7's decode
    rows run the fused q4g K1-K3)."""
    if dtype == torch.float32:
        want = "tiles" if rows >= tqm.F32_TILES_MIN_ROWS else "ffma"
    else:
        want = "wgmma" if rows >= tqm.WGMMA_MIN_ROWS else "mma"
    assert tqm.q4g_route(rows, dtype) == want


@pytest.mark.parametrize("M,N,K", [(2048, 4096, 4096), (2048, 1024, 4096), (2048, 14336, 4096),
                                   (2048, 4096, 14336), (64, 4096, 4096), (65, 4096, 4096),
                                   (128, 1024, 4096), (300, 1002, 512), (1, 4096, 4096)])
@pytest.mark.parametrize("sms", [132, 7])
def test_f32_tiles_plan(M, N, K, sms):
    """The register tiles' split over K (``tiles_plan``): 128-column tiles,
    every split non-empty and together exactly K's, a split only where the
    128 x 128 output tiles fill at most half the SMs (one block an SM), and
    then no more blocks than the SMs hold at once; the prefill's shapes on
    132 SMs run unsplit."""
    splits, per = tqm.tiles_plan(M, N, K, sms)
    n_kt, blocks = K // 128, -(-N // 128) * -(-M // 128)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < n_kt <= splits * per
    if 2 * blocks > sms:
        assert splits == 1
    else:
        assert blocks * splits <= max(sms, blocks)
    if M == 2048 and sms == 132:
        assert splits == 1


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
    """bf16 and fp32 x at the ring's, wgmma's, mma.sync's, the register
    tiles' and the first FFMA GEMM's rows: on the CPU K6 and K7 are their
    plain versions and count no launch of any instance."""
    names = [f"{f}{sfx}_launches" for f in ("q4", "int8")
             for sfx in ("", "_f32", "_f32_tiles", "_ring", "_f32_ring", "_wgmma")]
    k7 = ("launches", "f32_launches", "f32_tiles_launches", "wgmma_launches")
    counts = lambda: ([getattr(tqm.quant_matmul, n) for n in names]  # noqa: E731
                      + [getattr(tqm.quant_matmul_q4g, n) for n in k7])
    before = counts()
    for M in (1, 8, 9, 64):
        x, w = _data(M, 64, 512, seed=M)
        for dtype in (torch.bfloat16, torch.float32):
            tx = torch.from_numpy(x).to(dtype)
            for bits in (4, 8):
                qw = TQ.quantize_weight(torch.from_numpy(w), bits)
                torch.testing.assert_close(tqm.quant_matmul(tx, qw),
                                           tqm.quant_matmul_ref(tx, qw), rtol=0, atol=0)
            q4g = TQ.quantize_weight_q4g(torch.from_numpy(w))
            torch.testing.assert_close(tqm.quant_matmul_q4g(tx, q4g),
                                       tqm.quant_matmul_q4g_ref(tx, q4g), rtol=0, atol=0)
    assert counts() == before


@pytest.mark.parametrize("fmt,M", [("q4", 1), ("q4", 8), ("q4", 65), ("int8", 3),
                                   ("int8", 70), ("q4g", 1), ("q4g", 65)])
def test_f32_wrappers_match_jax_kernels(fmt, M):
    """K6 and K7 through their wrappers with fp32 x (the port on the CPU
    takes the plain versions) against JAX's Pallas kernels in interpret
    mode, at the rows the card sends to the weight ring (1-8) and to the
    register tiles (65 and more), with a ragged output count: the same
    exact integer products, fp32 sums in another order."""
    N, K = 320, 512
    x, w = _data(M, N, K, seed=M + N)
    if fmt == "q4g":
        qw = JQ.quantize_weight_q4g(jnp.asarray(w), group=128)
        jx, tx, tw = _inputs(x, qw, "float32")
        want = jqm.quant_matmul_q4g(jx, qw, block_out=128, block_in=256, interpret=True)
        got = tqm.quant_matmul_q4g(tx, tw)
    else:
        qw = JQ.quantize_weight(jnp.asarray(w), 4 if fmt == "q4" else 8)
        jx, tx, tw = _inputs(x, qw, "float32")
        want = jqm.quant_matmul(jx, qw, block_out=128, block_rows=16, interpret=True)
        got = tqm.quant_matmul(tx, tw)
    _close(got, want, "float32")


def _tiles_consts():
    """The register-tile kernel's tile, stage width and x row pitch, read
    from csrc/quant_matmul.cu."""
    import re
    from pathlib import Path
    src = (Path(tqm.__file__).resolve().parent.parent / "csrc" / "quant_matmul.cu").read_text()
    tt = int(re.search(r"constexpr int kTT = (\d+);", src).group(1))
    tk = int(re.search(r"constexpr int kTK = (\d+);", src).group(1))
    assert "constexpr int kTLX = kTK + 4;" in src
    return tt, tk, tk + 4


def _f32_of_bits(bits):
    return np.array(bits, np.uint32).view(np.float32)


@pytest.mark.parametrize("fmt", ["q4", "int8", "q4g"])
def test_f32_tiles_unpack_model(fmt):
    """The register tiles' weight path, modelled as ``tile_issue`` and
    ``tile_unpack`` in csrc/quant_matmul.cu address it: each of the 256
    threads copies its own packed bytes of a stage (weight row tid % 128;
    q4 8 bytes, int8 and q4g 16, at columns 16 (tid / 128 + 2 q)) and
    converts them by the 2^23 trick (int8: b ^ 0x80 in the mantissa minus
    2^23 + 128; a nibble: n ^ 8 minus 2^23 + 8; q4g the low nibbles for an
    even group, the high for an odd one) into depths of the fp32 tile: every
    (row, depth) of every stage exactly once, equal to ``int_values``; a
    warp's unpack writes one depth of 32 consecutive rows (32 banks); a
    warp's x reads (4 rows lm + 4 r apart by one, at one depth) fall in 4
    distinct bank groups."""
    tt, tk, tlx = _tiles_consts()
    r = np.random.default_rng(11)
    K = 512
    w = torch.from_numpy(r.standard_normal((tt, K)).astype(np.float32))
    qw = (TQ.quantize_weight_q4g(w) if fmt == "q4g"
          else TQ.quantize_weight(w, 4 if fmt == "q4" else 8))
    packed = qw["q" if fmt == "int8" else fmt].numpy().view(np.uint8)
    ints = TQ.int_values(qw).numpy().astype(np.float32)
    for k0 in range(0, K, tk):
        tile = np.full((tk, tt), np.nan, np.float32)
        for tid in range(256):
            n = tid % tt
            for q in range(tk // 32):
                d0 = 16 * (tid // 128 + 2 * q)
                col = k0 + d0
                if fmt == "q4":
                    src = packed[n, col // 2:col // 2 + 8]
                    vals = [_f32_of_bits(0x4B000000 | (((int(src[j // 2]) >> (4 * (j & 1))) & 0xF)
                                                       ^ 8)) - np.float32(8388616)
                            for j in range(16)]
                elif fmt == "int8":
                    src = packed[n, col:col + 16]
                    vals = [_f32_of_bits(0x4B000000 | (int(src[j]) ^ 0x80)) - np.float32(8388736)
                            for j in range(16)]
                else:
                    at = (col // 256) * 128 + col % 128
                    src, shift = packed[n, at:at + 16], ((k0 // 128) & 1) * 4
                    vals = [_f32_of_bits(0x4B000000 | (((int(src[j]) >> shift) & 0xF) ^ 8))
                            - np.float32(8388616) for j in range(16)]
                for j in range(16):
                    assert np.isnan(tile[d0 + j, n])
                    tile[d0 + j, n] = vals[j]
        np.testing.assert_array_equal(tile, ints[:, k0:k0 + tk].T)
    for warp in range(8):                       # the unpack's writes: tid -> (depth, row)
        tids = range(32 * warp, 32 * warp + 32)
        assert len({(t % tt) % 32 for t in tids}) == 32 and len({t // 128 for t in tids}) == 1
        for rr in range(8):                     # the x reads of one depth
            rows = [32 * (warp >> 1) + lm + 4 * rr for lm in range(4)]
            assert len({(row * tlx // 4) % 8 for row in rows}) == 4
