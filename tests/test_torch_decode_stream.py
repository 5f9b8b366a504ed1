"""K1-K3's weight ring (``ops/weight_ring.py``, ``fused_mlp.ring_plan``,
``fused_qkvo.qkv_ring_route`` / ``o_ring_route``) on the CPU.

The ring's kernel (``csrc/fused_decode.cu`` ``weight_ring_kernel``) runs
only on the card (``tests/test_torch_kernels_cuda.py``); what decides which
inputs reach it and how it is launched is plain Python, held here: the
routing rule of K1, K2 and K3 for every (B, dtype, weight format) that
``chip_smoke.py``'s phase 1 sends them, and at layers too wide for the
ring's shared memory (they take the row-per-warp kernels instead of
raising); the launch plans at SliME-8B's width and at small widths whose
row counts are ragged against the blocks and the stages (every output row
in exactly one band and one bulk copy, landing where the consumer warps
read it, no copy crossing from one matrix into the next, every copy 16-byte
aligned and a multiple of 16 bytes, the shared memory the kernel's check
asks for and no more than a block has); the exact int8 / int4 -> fp32
conversion the kernel does without I2F, on every byte and nibble; and that
CPU calls take the plain versions and count no launch. K6 (``quant_matmul``)
runs the same kernel at decode rows: its rule (``weight_ring.k6_ring_route``)
and plans for int8 and per-row q4 at B = 1-8, and the q4 consumers'
de-interleaved activation staging, are held here too.
"""
import itertools

import numpy as np
import pytest
import torch

from slime_tpu_torch.ops import fused_mlp as fm
from slime_tpu_torch.ops import fused_qkvo as fq
from slime_tpu_torch.ops import weight_ring as wr
from slime_tpu_torch.ops.fused_qkvo import DENSE, INT8, Q4G

SMS = 132                       # an H100 SXM's SMs
WIDTHS = [(4096, 14336),        # SliME-8B (Llama-3-8B): H, I
          (768, 1280), (256, 512), (512, 2816)]

# phase 1's decode cases: (weight format, activation dtype) -> batch rows
PHASE1 = {(INT8, torch.bfloat16): (1, 8, 65, 128), (Q4G, torch.bfloat16): (1, 64, 65, 128),
          (INT8, torch.float32): (1, 65), (Q4G, torch.float32): (1, 65)}


@pytest.mark.parametrize("fmt_dtype", list(PHASE1), ids=lambda fd: f"{fd[0]}-{fd[1]}")
def test_ring_instance_rule(fmt_dtype):
    """bf16 activations with int8 or q4g weights at 1 <= B <= 8 take the ring,
    every other input phase 1 sends (fp32, B > 8) the row-per-warp kernels."""
    fmt, dtype = fmt_dtype
    for B in PHASE1[fmt_dtype] + tuple(range(1, 10)):
        assert wr.ring_instance(B, dtype, fmt) == (dtype == torch.bfloat16 and B <= 8)
    assert not any(wr.ring_instance(B, dtype, DENSE) for B in range(1, 10))
    assert not wr.ring_instance(0, torch.bfloat16, fmt)


def _need(ln: wr.RingLaunch, K: int) -> int:
    """The shared memory ``ring_projection`` (csrc/fused_decode.cu) checks a
    plan for: ring, activations, barriers and issued indices, the folded
    norm's partial sums, epilogue."""
    S, q4g = ln.stages, ln.scale_bytes > 0
    band_cap = -(-ln.rows // ln.grid) + ln.align
    ep = ((0 if q4g else ln.mats) + (ln.batch_rows if ln.mats == 1 else 0)) * band_cap
    return S * ln.stage_bytes + ln.batch_rows * K * 2 + 8 * 2 * S + 4 * S + 4 * 8 * 16 + 4 * ep


def _assert_covers_every_row_once(ln: wr.RingLaunch, K: int, B: int, mat_rows):
    """One projection's plan against the kernel's needs: shared memory,
    activation groups, bands, and the bulk copies of every band. ``mat_rows``:
    the row count of each matrix a copy may read (gate/up: two of N rows;
    K2: W_q, W_k, W_v; else one). Every row of every matrix, and for q4g
    its scales, lies in exactly one band and one copy, which puts it where
    the consumer warps read band row t (stage t // R in slot (t // R) % S,
    row t % R of its matrix's block); no copy runs past the end of its
    matrix; every copy is 16-byte aligned and a multiple of 16 bytes."""
    N, R, mats = ln.rows, ln.rows_per_stage, ln.mats
    assert ln.stage_bytes == mats * R * (ln.row_bytes + ln.scale_bytes)
    assert ln.stage_bytes % 16 == 0 and ln.stages >= 2
    assert ln.warps % R == 0 and R % ln.align == 0
    assert wr.SMEM_HALF <= ln.smem <= wr.SMEM_MAX and _need(ln, K) <= ln.smem
    # activation rows: one launch a group, each group's rows 16-byte aligned
    assert 1 <= ln.batch_rows <= 8 and ln.batch_rows * K * 2 <= wr.ACT_BYTES
    groups = list(range(0, B, ln.batch_rows))
    assert sum(min(ln.batch_rows, B - b0) for b0 in groups) == B
    assert all(b0 * K * 2 % 16 == 0 for b0 in groups)
    # bands: contiguous, non-empty, every row once, starts on `align`
    bands = ln.bands()
    assert bands[0][0] == 0 and bands[-1][1] == N and len(bands) == ln.grid
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    assert all(r1 > r0 and r0 % ln.align == 0 for r0, r1 in bands)
    assert max(r1 - r0 for r0, r1 in bands) <= -(-N // ln.grid) + ln.align
    # the matrices' first rows in the row space (gate/up: both at 0)
    starts = [0] * mats if mats > 1 else list(np.cumsum([0] + list(mat_rows[:-1])))
    assert (sum(mat_rows) if mats == 1 else mat_rows[0]) == N
    covered = [np.zeros((2, n), dtype=np.int64) for n in mat_rows]   # weights, scales
    for r0, r1 in bands:
        copies = ln.copies(r0, r1)
        if len(mat_rows) == mats:       # one part: one copy a matrix (and its scales) a stage
            per_stage = mats * (2 if ln.scale_bytes else 1)
            assert len(copies) == per_stage * -(-(r1 - r0) // R)
        for mat, is_scale, dst, src, n in copies:
            assert dst % 16 == 0 and src % 16 == 0 and n % 16 == 0 and n > 0
            slot = dst // ln.stage_bytes
            assert slot < ln.stages and dst + n <= (slot + 1) * ln.stage_bytes
            unit = ln.scale_bytes if is_scale else ln.row_bytes
            assert src % unit == 0 and n % unit == 0
            first, count = src // unit, n // unit
            assert first + count <= mat_rows[mat]          # never into the next matrix
            covered[mat][int(is_scale), first:first + count] += 1
            # where the consumers read the copy's first row
            t = starts[mat] + first - r0
            m = mat if mats > 1 else 0
            base = (m * R + t % R) * unit + (mats * R * ln.row_bytes if is_scale else 0)
            assert 0 <= t < r1 - r0 and dst == (t // R) % ln.stages * ln.stage_bytes + base
        # a stage's copies (consecutive copies into one slot) lie side by side
        # in its slot, none overlapping
        for _, stage in itertools.groupby(copies, key=lambda c: c[2] // ln.stage_bytes):
            spans = sorted((dst, dst + n) for _, _, dst, _, n in stage)
            assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    for c in covered:
        assert (c[0] == 1).all() and (c[1] == (1 if ln.scale_bytes else 0)).all()


@pytest.mark.parametrize("fmt", [INT8, Q4G], ids=["int8", "q4g"])
@pytest.mark.parametrize("width", WIDTHS, ids=lambda w: f"H{w[0]}-I{w[1]}")
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("sms", [SMS, 7])
def test_ring_plan_covers_every_row_once(fmt, width, B, sms):
    H, I = width
    gate_up, down, ints = fm.ring_plan(B, H, I, fmt, sms)
    assert list(ints) == gate_up.ints() + down.ints()
    for ln, K, N, mats in ((gate_up, H, I, 2), (down, I, H, 1)):
        assert (ln.rows, ln.mats, ln.parts) == (N, mats, ())
        assert ln.row_bytes == (K // 2 if fmt == Q4G else K)
        assert ln.scale_bytes == (K // 128 * 4 if fmt == Q4G else 0)
        assert ln.grid == min(sms, N)
        _assert_covers_every_row_once(ln, K, B, [N] * mats)


def test_ring_plan_at_8b_width():
    """SliME-8B at B = 1: stages of one int8 gate/up row pair (8 KB) or two
    q4g ones, 128 KB of ring; down one row a stage; every block takes more
    than half an SM's shared memory (one ring block an SM)."""
    gu, dn, _ = fm.ring_plan(1, 4096, 14336, INT8, SMS)
    assert (gu.rows_per_stage, gu.stage_bytes, gu.stages) == (1, 8192, 16)
    assert (dn.rows_per_stage, dn.stage_bytes, dn.stages) == (1, 14336, 9)
    gu, dn, _ = fm.ring_plan(1, 4096, 14336, Q4G, SMS)
    assert (gu.rows_per_stage, gu.stage_bytes) == (2, 2 * 2 * (2048 + 128))
    assert (dn.rows_per_stage, dn.stage_bytes) == (1, 7168 + 448)
    assert all(ln.smem > wr.SMEM_HALF for ln in (gu, dn))
    # B = 8: h fits one launch; a [8, 14336] does not (two launches of 4 rows)
    gu, dn, _ = fm.ring_plan(8, 4096, 14336, INT8, SMS)
    assert (gu.batch_rows, dn.batch_rows) == (8, 4)


def test_ring_plan_refuses_rows_too_long():
    with pytest.raises(ValueError, match="no weight-ring plan"):
        wr.ring_launch(1, 1 << 17, 256, INT8, 2, SMS)


# K2 (H, NQ, NKV) and K3 (NQ, H) widths: SliME-8B, and small ragged ones
# (int8 NKV 40 and 136: stages of 8 rows that meet W_q's or W_k's end; q4g
# at H 768, 6 scales a row, whose bands and parts start on even rows)
QKV_WIDTHS = {INT8: [(4096, 4096, 1024), (256, 256, 64), (256, 256, 40), (768, 512, 136)],
              Q4G: [(4096, 4096, 1024), (512, 512, 256), (768, 512, 256), (256, 256, 32)]}


@pytest.mark.parametrize("fmt", [INT8, Q4G], ids=["int8", "q4g"])
@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("sms", [SMS, 7])
def test_qkv_and_o_ring_plans_cover_every_row_once(fmt, case, B, sms):
    """K2's one launch over the row space [W_q; W_k; W_v] and K3's over W_o:
    every row of q, k, v and y in exactly one band and one bulk copy, none
    crossing a matrix (a stage that meets W_q's end splits its copy there),
    16-byte aligned, shared memory within a block's."""
    H, NQ, NKV = QKV_WIDTHS[fmt][case]
    bf = torch.bfloat16
    qkv, c_qkv = fq.qkv_ring_route(B, bf, fmt, H, NQ, NKV, sms)
    o, c_o = fq.o_ring_route(B, bf, fmt, NQ, H, sms)
    assert list(c_qkv) == qkv.ints() and list(c_o) == o.ints()
    assert (qkv.rows, qkv.mats, qkv.parts) == (NQ + 2 * NKV, 1, (NQ, NKV, NKV))
    assert (o.rows, o.mats, o.parts) == (H, 1, ())
    for ln, K, mat_rows in ((qkv, H, [NQ, NKV, NKV]), (o, NQ, [H])):
        assert ln.row_bytes == (K // 2 if fmt == Q4G else K)
        assert ln.grid == min(sms, ln.rows // ln.align)
        _assert_covers_every_row_once(ln, K, B, mat_rows)


def test_qkv_ring_splits_a_stage_at_a_matrix_end():
    """At SliME-8B's int8 width a stage holds 2 rows; on 11 SMs the band
    over W_q's end starts on an odd row (3909), so one stage holds W_q's
    last row and W_k's first: two copies, one from each matrix."""
    qkv, _ = fq.qkv_ring_route(1, torch.bfloat16, INT8, 4096, 4096, 1024, 11)
    assert qkv.rows_per_stage == 2
    split = [c for r0, r1 in qkv.bands() for c in qkv.copies(r0, r1)
             if (c[0] == 0 and c[3] == 4095 * 4096) or (c[0] == 1 and c[3] == 0)]
    assert [(m, n) for m, _, _, _, n in split] == [(0, 4096), (1, 4096)]
    assert split[1][2] == split[0][2] + 4096          # side by side in one slot


# (weight format, activation dtype) -> batch rows that phase 1 sends K1-K3
RING_FORMATS = [(f, d, B) for (f, d), bs in PHASE1.items() for B in bs + tuple(range(1, 10))]


@pytest.mark.parametrize("fmt,dtype,B", RING_FORMATS,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_ring_routes_at_phase1(fmt, dtype, B):
    """K1, K2 and K3 at SliME-8B width take the ring exactly where
    ``ring_instance`` holds (every plan exists there), the row-per-warp
    kernels elsewhere."""
    want = wr.ring_instance(B, dtype, fmt)
    assert (fm.ring_route(B, dtype, fmt, 4096, 14336, SMS) is not None) == want
    assert (fq.qkv_ring_route(B, dtype, fmt, 4096, 4096, 1024, SMS) is not None) == want
    assert (fq.o_ring_route(B, dtype, fmt, 4096, 4096, SMS) is not None) == want
    for route in (lambda d: fm.ring_route(B, d, DENSE, 4096, 14336, SMS),
                  lambda d: fq.qkv_ring_route(B, d, DENSE, 4096, 4096, 1024, SMS),
                  lambda d: fq.o_ring_route(B, d, DENSE, 4096, 4096, SMS)):
        assert route(dtype) is None


# layers too wide for the ring's shared memory, where K1 raised before: int8
# from I = 58048 (down) or H = 32784 (gate/up), q4g from I = 56576 or H =
# 30976 (a wide H lacks gate/up's plan, a wide I down's)
WIDE = [(INT8, 4096, 58048), (INT8, 32784, 14336), (Q4G, 4096, 56576),
        (Q4G, 30976, 14336)]


@pytest.mark.parametrize("fmt,H,I", WIDE, ids=lambda v: str(v))
@pytest.mark.parametrize("B", [1, 8])
def test_wide_layers_route_to_the_row_per_warp_kernels(fmt, H, I, B):
    """The repaired fault: where a projection has no ring plan the call
    takes the row-per-warp kernels, which take the same operands, and the
    rule itself never raises. The plan that is missing raises when asked
    for directly."""
    bf = torch.bfloat16
    assert wr.ring_instance(B, bf, fmt)
    assert fm.ring_route(B, bf, fmt, H, I, SMS) is None
    assert fm.ring_plan(B, H, I, fmt, SMS) is None
    with pytest.raises(ValueError, match="no weight-ring plan"):
        if H > 16384:
            wr.ring_launch(B, H, I, fmt, 2, SMS)
        else:
            wr.ring_launch(B, I, H, fmt, 1, SMS)
    # K2 and K3 at the same H: a route where their own plans exist
    for route, ln in ((fq.qkv_ring_route(B, bf, fmt, H, 4096, 1024, SMS),
                       wr.launch_or_none(B, H, 6144, fmt, 1, SMS, (4096, 1024, 1024))),
                      (fq.o_ring_route(B, bf, fmt, 4096, H, SMS),
                       wr.launch_or_none(B, 4096, H, fmt, 1, SMS))):
        assert (route is None) == (ln is None)


@pytest.mark.parametrize("B", [1, 8])
def test_wide_qkv_and_o_route_to_the_row_per_warp_kernels(B):
    """K2 at H = 58112 and K3 at NQ = 58112 (int8, one matrix a stage: two
    stages and the activations no longer fit from 57920) take the
    row-per-warp kernels; at 57344 the ring."""
    bf = torch.bfloat16
    assert fq.qkv_ring_route(B, bf, INT8, 58112, 256, 128, SMS) is None
    assert fq.o_ring_route(B, bf, INT8, 58112, 256, SMS) is None
    assert fq.qkv_ring_route(B, bf, INT8, 57344, 256, 128, SMS) is not None
    assert fq.o_ring_route(B, bf, INT8, 57344, 256, SMS) is not None
    with pytest.raises(ValueError, match="no weight-ring plan"):
        wr.ring_launch(B, 58112, 256, INT8, 1, SMS)


def test_int8_int4_to_fp32_without_i2f():
    """The kernel's conversion on every value: the byte XOR 0x80 (or the
    nibble XOR 8) as the low mantissa of 2^23, minus 2^23 + 128 (or + 8), is
    the signed value exactly."""
    b = np.arange(256, dtype=np.uint32)
    f = ((b ^ 0x80) | 0x4B000000).view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(f, b.astype(np.uint8).view(np.int8).astype(np.float32))
    n = np.arange(16, dtype=np.uint32)
    f = ((n ^ 8) | 0x4B000000).view(np.float32) - np.float32(8388616.0)
    np.testing.assert_array_equal(f, np.where(n < 8, n, n.astype(np.int64) - 16))


def _counts():
    return [getattr(fn, a) for fn in (fm.fused_mlp_decode, fq.fused_qkv_decode,
                                      fq.fused_o_residual)
            for a in ("launches", "ring_launches", "q4g_ring_launches")]


def test_cpu_qkv_and_o_take_the_plain_version_and_count_nothing():
    """bf16 x with int8 weights at B = 3, where the card takes the ring: on
    the CPU K2 and K3 are their plain versions and count no launch."""
    g = torch.Generator().manual_seed(1)

    def q(out_d, in_d):
        return {"weight": {"q": torch.randint(-127, 128, (2, out_d, in_d), dtype=torch.int8,
                                              generator=g),
                           "scale": torch.full((2, out_d, 1), 1e-3)}}
    layers = {"input_layernorm": {"weight": 1 + 0.1 * torch.randn((2, 256), generator=g)},
              "q_proj": q(256, 256), "k_proj": q(64, 256), "v_proj": q(64, 256),
              "o_proj": q(256, 256)}
    x = torch.randn((3, 256), generator=g).to(torch.bfloat16)
    attn = torch.randn((3, 256), generator=g).to(torch.bfloat16)
    assert fq.qkv_ring_route(3, x.dtype, INT8, 256, 256, 64, SMS) is not None
    assert fq.o_ring_route(3, x.dtype, INT8, 256, 256, SMS) is not None
    before = _counts()
    for got, want in zip(fq.fused_qkv_decode(x, layers, 1),
                         fq.fused_qkv_decode_ref(x, layers, 1)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(fq.fused_o_residual(attn, x, layers, 1),
                               fq.fused_o_residual_ref(attn, x, layers, 1), rtol=0, atol=0)
    assert _counts() == before


def test_cpu_call_takes_the_plain_version_and_counts_nothing():
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, (2, 512, 256), dtype=torch.int8, generator=g)
    layers = {"post_attention_layernorm": {"weight": torch.ones((2, 256))},
              "gate_proj": {"weight": {"q": q, "scale": torch.full((2, 512, 1), 1e-3)}},
              "up_proj": {"weight": {"q": q.flip(1), "scale": torch.full((2, 512, 1), 1e-3)}},
              "down_proj": {"weight": {"q": q.transpose(1, 2).contiguous(),
                                       "scale": torch.full((2, 256, 1), 1e-3)}}}
    x = torch.randn((3, 256), generator=g).to(torch.bfloat16)
    assert wr.ring_instance(3, x.dtype, INT8)
    counts = (fm.fused_mlp_decode.launches, fm.fused_mlp_decode.ring_launches)
    torch.testing.assert_close(fm.fused_mlp_decode(x, layers, 1),
                               fm.fused_mlp_decode_ref(x, layers, 1), rtol=0, atol=0)
    assert counts == (fm.fused_mlp_decode.launches, fm.fused_mlp_decode.ring_launches)


# K6 on the ring: Llama-3-8B's projections (q/o 4096, k/v 1024, gate/up 14336
# rows at K = 4096; down 4096 at K = 14336) and ragged small widths
K6_WIDTHS = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
             (1000, 512), (136, 1024), (7, 4128)]


@pytest.mark.parametrize("fmt", [INT8, wr.ROW_Q4], ids=["int8", "q4"])
@pytest.mark.parametrize("width", K6_WIDTHS, ids=lambda w: f"N{w[0]}-K{w[1]}")
@pytest.mark.parametrize("B", range(1, 9))
def test_k6_ring_plan_covers_every_row_once(fmt, width, B):
    """K6's one launch a row group on the ring: one matrix a stage, no norm,
    no residual, the per-row scale read by the epilogue (no scale bytes in a
    stage); every output row in exactly one band and one bulk copy, where
    the consumers read it, on 132 SMs and (ragged) on 7."""
    N, K = width
    bf = torch.bfloat16
    for sms in (SMS, 7):
        ln, c_plan = wr.k6_ring_route(B, K, N, bf, fmt, sms)
        assert list(c_plan) == ln.ints()
        assert (ln.rows, ln.mats, ln.parts, ln.scale_bytes) == (N, 1, (), 0)
        assert ln.row_bytes == (K // 2 if fmt == wr.ROW_Q4 else K)
        assert ln.grid == min(sms, N)
        _assert_covers_every_row_once(ln, K, B, [N])


def test_k6_ring_route_rule():
    """k6_ring_route plans bf16 x at 1 <= B <= 8 with int8 or per-row q4
    weights, and is None for fp32 x, B > 8, q4g or dense weights, and rows
    that are not whole 16-byte vectors (int8 K = 1000, q4 K = 1008)."""
    bf = torch.bfloat16
    for fmt in (INT8, wr.ROW_Q4):
        assert wr.k6_ring_route(1, 4096, 4096, bf, fmt, SMS) is not None
        assert wr.k6_ring_route(8, 14336, 4096, bf, fmt, SMS) is not None
        assert wr.k6_ring_route(9, 4096, 4096, bf, fmt, SMS) is None
        assert wr.k6_ring_route(1, 4096, 4096, torch.float32, fmt, SMS) is None
    for fmt in (Q4G, DENSE):
        assert wr.k6_ring_route(1, 4096, 4096, bf, fmt, SMS) is None
    assert wr.k6_ring_route(1, 1000, 4096, bf, INT8, SMS) is None
    assert wr.k6_ring_route(1, 1008, 4096, bf, wr.ROW_Q4, SMS) is None
    # the q4 down projection at B = 8 stages 4 activation rows a launch: 2 launches
    ln, _ = wr.k6_ring_route(8, 14336, 4096, bf, wr.ROW_Q4, SMS)
    assert (ln.batch_rows, ln.rows_per_stage) == (4, 1)
    with pytest.raises(ValueError, match="no weight-ring plan"):
        wr.ring_launch(1, 4096, 512, wr.ROW_Q4, 2, SMS)         # q4 streams one matrix a stage


def _act_chunk(j):
    return j ^ ((j >> 3) & 1)


def test_k6_ring_q4_activations_deinterleaved():
    """The q4 consumers' view of x (``stage_act_q4`` then ``load_act16`` in
    csrc/fused_decode.cu): a row staged chunk by chunk, evens to the first
    half and odds to the second, each half chunk-swizzled; the 16 columns a
    lane's vector c reads from each half are x's columns 32 c + 2 i (low
    nibbles of its bytes i) and 32 c + 2 i + 1 (high nibbles); and the eight
    lanes of a quarter-warp read 16-byte chunks on eight distinct bank groups."""
    K = 4096
    x = np.arange(K)
    smem = np.full(K, -1)
    for j in range(K // 8):                   # stage_act_q4, one chunk a thread
        cols = x[8 * j:8 * j + 8]
        for half, vals in ((0, cols[0::2]), (1, cols[1::2])):
            at = half * (K // 2) + 8 * _act_chunk(j >> 1) + 4 * (j & 1)
            smem[at:at + 4] = vals
    assert (np.sort(smem) == x).all()
    for c in range(K // 32):                  # load_act16(half, c): chunks 2c, 2c + 1
        sw = (c >> 2) & 1
        for half in (0, 1):
            base = half * (K // 2)
            got = np.concatenate([smem[base + 8 * (2 * c + (sw ^ k)):][:8] for k in (0, 1)])
            np.testing.assert_array_equal(got, 32 * c + 2 * np.arange(16) + half)
    for half in (0, 1):
        for q in range(0, 32, 8):             # a quarter-warp's first chunks
            banks = {(_act_chunk(2 * c) % 8) for c in range(q, q + 8)}
            assert len(banks) == 8
