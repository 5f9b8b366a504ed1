"""K1-K3's weight ring (``ops/weight_ring.py``, ``fused_mlp.ring_plan``,
``fused_qkvo.qkv_ring_route`` / ``o_ring_route``) and K1-K3's tensor-core
instances (``fused_mlp.k1_route``, ``fused_qkvo.k2_route`` / ``k3_route``,
``fused_qkvo.wgmma_plan``) on the CPU.

The ring's kernel (``csrc/fused_decode.cu`` ``weight_ring_kernel``) runs
only on the card (``tests/test_torch_kernels_cuda.py``); what decides which
inputs reach it and how it is launched is plain Python, held here: the
routing rule of K1, K2 and K3 for every (B, dtype, weight format) that
``chip_smoke.py``'s phase 1 sends them, and at layers too wide for the
ring's shared memory (they take the row-per-warp kernels instead of
raising), dense bf16 weights included (K1-K3 at <= 4 rows on the ring,
from 5 on tensor cores); K1's choice among the ring, its
tensor-core instance (bf16 x, int8 weights from 9 rows or dense bf16 ones
from DENSE_WGMMA_MIN_ROWS, rows TMA reads) and the row-per-warp kernels,
and the split over I of that instance's down projection (every stage
once, one wave of blocks; 128 int8 or 64 dense columns a stage); K2's and
K3's same choice (K2 also needs NQ and NQ + NKV on 128-row blocks) and
their splits over H and NQ, dense K3's launch planned with its weight
format; the
launch plans at
SliME-8B's width, the 0.6B draft's and small widths whose row counts are
ragged against the blocks and the stages (every output row in exactly one
band and one bulk copy, landing where the consumer warps
read it, no copy crossing from one matrix into the next, every copy 16-byte
aligned and a multiple of 16 bytes, the shared memory the kernel's check
asks for and no more than a block has); the exact int8 / int4 -> fp32
conversion the kernel does without I2F, on every byte and nibble; the
dense consumers' view of the swizzled activations; and that CPU calls take
the plain versions and count no launch. K6 (``quant_matmul``) runs the same
kernel at decode rows: its rule (``weight_ring.k6_ring_route``) and plans
for int8 and per-row q4 at B = 1-8, and the q4 consumers' de-interleaved
activation staging, are held here too. K1 and K6 take fp32 activations on
the ring (K1: int8 and q4g weights, B <= ``fused_mlp.F32_RING_ROWS``; K6:
int8 and per-row q4, B <= ``quant_matmul.K6_F32_RING_ROWS``): their rules,
their plans with 4-byte activations, the fp32 consumers' swizzled view of
them (K6's q4 de-interleaved), and that K2's and K3's rules still keep fp32
off the ring.
"""
import itertools

import numpy as np
import pytest
import torch

from slime_tpu_torch.ops import fused_mlp as fm
from slime_tpu_torch.ops import fused_qkvo as fq
from slime_tpu_torch.ops import quant_matmul as qm
from slime_tpu_torch.ops import weight_ring as wr
from slime_tpu_torch.ops.fused_qkvo import DENSE, INT8, Q4G

SMS = 132                       # an H100 SXM's SMs
WIDTHS = [(4096, 14336),        # SliME-8B (Llama-3-8B): H, I
          (768, 1280), (256, 512), (512, 2816)]
DRAFT = (2048, 5504)            # chip_smoke.DRAFT_LLM, the 0.6B bf16 draft: H, I

# phase 1's decode cases: (weight format, activation dtype) -> batch rows
PHASE1 = {(INT8, torch.bfloat16): (1, 8, 65, 128), (Q4G, torch.bfloat16): (1, 64, 65, 128),
          (INT8, torch.float32): (1, 65), (Q4G, torch.float32): (1, 65),
          (DENSE, torch.bfloat16): (1, 4, 8)}


@pytest.mark.parametrize("fmt_dtype", list(PHASE1), ids=lambda fd: f"{fd[0]}-{fd[1]}")
def test_ring_instance_rule(fmt_dtype):
    """bf16 activations with dense bf16, int8 or q4g weights at 1 <= B <= 8
    suit the ring, every other input phase 1 sends (fp32, B > 8) the
    row-per-warp kernels; dense fp32 weights never take it."""
    fmt, dtype = fmt_dtype
    for B in PHASE1[fmt_dtype] + tuple(range(1, 10)):
        assert wr.ring_instance(B, dtype, fmt) == (dtype == torch.bfloat16 and B <= 8)
        assert wr.ring_instance(B, dtype, DENSE) == (dtype == torch.bfloat16 and B <= 8)
    assert not any(wr.ring_instance(B, d, wr.DENSE_F32) for B in range(1, 10)
                   for d in (torch.bfloat16, torch.float32))
    assert not wr.ring_instance(0, torch.bfloat16, fmt)


def _need(ln: wr.RingLaunch, K: int) -> int:
    """The shared memory ``ring_projection`` (csrc/fused_decode.cu) checks a
    plan for: ring, activations, barriers and issued indices, the folded
    norm's partial sums, epilogue (a row scale a row for int8 and q4, none
    for q4g, whose scales ride in the stages, or dense bf16, 2 K bytes a row)."""
    S, q4g, dense = ln.stages, ln.scale_bytes > 0, ln.row_bytes == 2 * K
    band_cap = -(-ln.rows // ln.grid) + ln.align
    ep = ((0 if q4g or dense else ln.mats) + (ln.batch_rows if ln.mats == 1 else 0)) * band_cap
    G = 2 if ln.mats == 1 and ln.rows_per_stage % 2 == 0 else 1
    bt = next(b for b in (1, 2, 4, 8) if b >= ln.batch_rows)
    part = 4 * 2 * ln.warps * ln.mats * G * bt if dense else 0     # a split row's warp sums
    return (S * ln.stage_bytes + ln.batch_rows * K * ln.act_bytes + 8 * 2 * S + 4 * S
            + 4 * 8 * 16 + 4 * ep + part)


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
    # split warps a row (dense only): a group of them for every row in
    # flight, and the kernel's G rows a group dividing its groups
    G = 2 if mats == 1 and R % 2 == 0 else 1
    groups = ln.warps // ln.split
    assert ln.split == 1 or ln.row_bytes == 2 * K
    assert ln.warps % ln.split == 0 and groups % (R // G) == 0
    assert groups >= ln.stages * R // G or ln.split == 1
    assert wr.SMEM_HALF <= ln.smem <= wr.SMEM_MAX and _need(ln, K) <= ln.smem
    # activation rows: one launch a group, each group's rows 16-byte aligned
    assert 1 <= ln.batch_rows <= 8 and ln.batch_rows * K * ln.act_bytes <= wr.ACT_BYTES
    groups = list(range(0, B, ln.batch_rows))
    assert sum(min(ln.batch_rows, B - b0) for b0 in groups) == B
    assert all(b0 * K * ln.act_bytes % 16 == 0 for b0 in groups)
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


ROW_BYTES = {DENSE: lambda K: 2 * K, INT8: lambda K: K, Q4G: lambda K: K // 2}


@pytest.mark.parametrize("fmt", [INT8, Q4G, DENSE], ids=["int8", "q4g", "dense"])
@pytest.mark.parametrize("width", WIDTHS, ids=lambda w: f"H{w[0]}-I{w[1]}")
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("sms", [SMS, 7])
def test_ring_plan_covers_every_row_once(fmt, width, B, sms):
    H, I = width
    gate_up, down, ints = fm.ring_plan(B, H, I, fmt, sms)
    assert list(ints) == gate_up.ints() + down.ints()
    for ln, K, N, mats in ((gate_up, H, I, 2), (down, I, H, 1)):
        assert (ln.rows, ln.mats, ln.parts) == (N, mats, ())
        assert ln.row_bytes == ROW_BYTES[fmt](K)
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


def test_dense_ring_plan_at_8b_width():
    """Dense bf16 at SliME-8B's width: gate/up a stage of one row of each
    (16 KB), 8 stages, each row pair summed by 2 warps; down one 28 KB row a
    stage, 4 stages, each row by 4 warps, and 4 activation rows a launch (B
    = 4, phase 12's batch, in one launch; B = 8 in two); K2 one 8 KB row a
    stage, 16 stages, a warp a row, every row of the row space [W_q; W_k;
    W_v] on one of 132 bands."""
    for B in (1, 4, 8):
        gu, dn, _ = fm.ring_plan(B, 4096, 14336, DENSE, SMS)
        assert (gu.rows_per_stage, gu.stage_bytes, gu.stages, gu.split) == (1, 16384, 8, 2)
        assert (dn.rows_per_stage, dn.stage_bytes, dn.stages, dn.split) == (1, 28672, 4, 4)
        assert (gu.batch_rows, dn.batch_rows) == (B, min(B, 4))
        assert gu.scale_bytes == dn.scale_bytes == 0
        qkv, _ = fq.qkv_ring_route(B, torch.bfloat16, DENSE, 4096, 4096, 1024, SMS)
        assert (qkv.rows_per_stage, qkv.stage_bytes, qkv.stages, qkv.grid, qkv.split) == (
            1, 8192, 16, SMS, 1)
        assert all(ln.smem > wr.SMEM_HALF for ln in (gu, dn, qkv))


@pytest.mark.parametrize("B", [1, 3, 4, 8])
@pytest.mark.parametrize("sms", [SMS, 7])
def test_dense_ring_plans_at_the_draft_width(B, sms):
    """The 0.6B draft's widths (H 2048, I 5504; NQ 2048, NKV 1024): K1's two
    projections and K2's row space on the ring (K2 two 4 KB rows a stage:
    the kernel's two-rows-a-warp instance), and K3's (routed at B <= 4,
    held as the kernel would take it at 8), every row once."""
    H, I = DRAFT
    bf = torch.bfloat16
    assert (fm.ring_route(B, bf, DENSE, H, I, sms) is not None) == (B <= 4)
    gate_up, down, _ = fm.ring_plan(B, H, I, DENSE, sms)
    qkv, _ = fq.qkv_ring_route(B, bf, DENSE, H, 2048, 1024, sms)
    o, _ = wr.projection_plan(B, 2048, H, DENSE, sms)
    route = fq.o_ring_route(B, bf, DENSE, 2048, H, sms)
    assert (route is not None) == (B <= fq.DENSE_O_RING_ROWS)
    assert route is None or route[0] == o
    assert qkv.rows_per_stage == 2 and qkv.parts == (2048, 1024, 1024)
    for ln, K, mat_rows in ((gate_up, H, [I, I]), (down, I, [H]),
                            (qkv, H, [2048, 1024, 1024]), (o, 2048, [H])):
        assert ln.row_bytes == 2 * K and ln.scale_bytes == 0
        _assert_covers_every_row_once(ln, K, B, mat_rows)


def test_dense_mlp_ring_row_limit():
    """Dense K1 takes the ring at 1-4 rows and the row-per-warp kernels at
    5-8, where its ring plans exist all the same (``mlp_launch(ring=True)``
    runs them: phase 1's comparison); int8 and q4g keep the ring to 8."""
    bf = torch.bfloat16
    assert fm.DENSE_RING_ROWS == 4
    for B in range(1, 9):
        assert (fm.ring_route(B, bf, DENSE, 4096, 14336, SMS) is not None) == (B <= 4)
        assert fm.ring_plan(B, 4096, 14336, DENSE, SMS) is not None
        for fmt in (INT8, Q4G):
            assert fm.ring_route(B, bf, fmt, 4096, 14336, SMS) is not None


def test_dense_o_ring_row_limit():
    """Dense K3 takes the ring at 1-4 rows (``DENSE_O_RING_ROWS``: the card
    measured it faster than row per warp at 1 and 4 and slower at 6), the
    tensor-core instance from 5, where its plans exist all the same
    (``o_launch(ring=True)`` runs them: phase 1's comparison); at
    SliME-8B's width (W_o [4096, 4096]) one 8 KB row a stage, 16 stages, a
    warp a row, one band an SM, all of B <= 8 rows in one launch."""
    bf = torch.bfloat16
    assert fq.DENSE_O_RING_ROWS == 4
    for B in range(1, 10):
        route = fq.o_ring_route(B, bf, DENSE, 4096, 4096, SMS)
        assert (route is not None) == (B <= 4)
        if B <= 8:
            o, c_o = wr.projection_plan(B, 4096, 4096, DENSE, SMS)
            assert route is None or (o, list(c_o)) == (route[0], list(route[1]))
            assert list(c_o) == o.ints()
            assert (o.rows_per_stage, o.stage_bytes, o.stages, o.split, o.grid) == (
                1, 8192, 16, 1, SMS)
            assert (o.batch_rows, o.row_bytes, o.scale_bytes) == (B, 8192, 0)
            assert o.smem > wr.SMEM_HALF


# K1's rows at SliME-8B's width: the ring's 1-8, one past it, the verify
# chunks' 20 and 40 (4 and 8 slots), the fused chunk's 64, and one and two
# token tiles past it
K1_ROUTE_ROWS = tuple(range(1, 9)) + (9, 20, 40, 64, 65, 128)


@pytest.mark.parametrize("fmt", [INT8, Q4G, DENSE, wr.DENSE_F32],
                         ids=["int8", "q4g", "dense", "dense_f32"])
@pytest.mark.parametrize("B", K1_ROUTE_ROWS)
def test_k1_route_rule(fmt, B):
    """bf16 x: int8 weights take the ring at 1-8 rows and the tensor-core
    instance from 9, q4g the ring at 1-8 and the row-per-warp kernels from
    9, dense bf16 the ring at 1-4 and the tensor-core instance from 5; fp32
    x with int8 or q4g weights the ring at 1-F32_RING_ROWS rows and row per
    warp past them, on dense (bf16 or fp32) weights always row per warp."""
    bf, f32 = torch.bfloat16, torch.float32
    want = {INT8: "ring" if B <= 8 else "wgmma", Q4G: "ring" if B <= 8 else "rows",
            DENSE: "ring" if B <= 4 else "wgmma", wr.DENSE_F32: "rows"}
    assert fm.k1_route(B, bf, fmt, 4096, 14336, SMS) == want[fmt]
    f32_ring = fmt in (INT8, Q4G) and B <= fm.F32_RING_ROWS
    assert fm.k1_route(B, f32, fmt, 4096, 14336, SMS) == ("ring" if f32_ring else "rows")
    assert fm.K1_WGMMA_MIN_ROWS == 9
    assert fm.DENSE_RING_ROWS == 4 and fm.DENSE_WGMMA_MIN_ROWS == 5


# (H, I, route at B >= 9 with int8 weights): rows TMA reads (multiples of 16
# bytes, at least 256: quant_matmul.k6_wgmma_strides) and rows it does not
K1_STRIDES = [(4096, 14336, "wgmma"), (2048, 5504, "wgmma"), (256, 512, "wgmma"),
              (256, 336, "wgmma"), (4104, 14336, "rows"), (4096, 14344, "rows"),
              (4096, 1000, "rows"), (128, 512, "rows"), (256, 240, "rows")]


@pytest.mark.parametrize("H,I,want", K1_STRIDES, ids=lambda v: str(v))
@pytest.mark.parametrize("B", [9, 20, 64, 65, 128])
def test_k1_route_needs_rows_tma_reads(H, I, want, B):
    """int8 weights from 9 rows take the tensor-core instance only where TMA
    reads h's, a's and the weights' rows; elsewhere the row-per-warp
    kernels, which take any row of 16-byte vectors. Rows up to 8 never take
    it, also where the ring has no plan (a layer too wide for it)."""
    bf = torch.bfloat16
    assert fm.k1_route(B, bf, INT8, H, I, SMS) == want
    assert fm.k1_route(8, bf, INT8, 4096, 58048, SMS) == "rows"


@pytest.mark.parametrize("width", WIDTHS + [DRAFT, (256, 336)], ids=lambda w: f"H{w[0]}-I{w[1]}")
@pytest.mark.parametrize("B", [9, 20, 33, 64, 65, 128, 512])
@pytest.mark.parametrize("sms", [SMS, 7])
def test_k1_wgmma_down_split_covers_every_stage_once(width, B, sms):
    """The down projection's split over I: every 128-column stage in exactly
    one split, none empty; the blocks (128 output rows a 64-token tile, a
    split) one wave of one an SM where the tiles alone leave room, and no
    block running more stages than the best one-wave split gives it."""
    H, I = width
    _assert_one_wave_split(B, H, I, sms)


def _assert_one_wave_split(B, N, K, sms, fmt=INT8):
    """``wgmma_plan``'s split of K's stages (128 int8 or 64 dense bf16
    columns) for a row space of N rows: every stage in exactly one split,
    none empty; the blocks (128 rows a 64-token tile, a split) one wave of
    one an SM where the tiles alone leave room, and no block running more
    stages than the best one-wave split gives it."""
    splits, per = fq.wgmma_plan(B, N, K, sms, fmt=fmt)
    n_kb = -(-K // fq.wgmma_stage_cols(fmt))
    ranges = [range(z * per, min(n_kb, (z + 1) * per)) for z in range(splits)]
    assert all(len(r) for r in ranges)
    assert sorted(k for r in ranges for k in r) == list(range(n_kb))
    blocks = -(-N // 128) * -(-B // fq.WGMMA_TOK)
    assert blocks * splits <= max(sms, blocks)
    assert per == min(-(-n_kb // z) for z in range(1, max(1, sms // blocks) + 1))


def test_k1_wgmma_plan_at_8b_width():
    """SliME-8B's down (W_down [4096, 14336]: 32 row blocks a token tile, 112
    stages): 4 splits of 28 stages, 128 blocks on 132 SMs, up to 64 rows; 2
    of 56 at 65-128 rows (two tiles). A fifth split would give 160 blocks,
    a second wave on a card of one such block an SM; and however the 32 x
    112 = 3584 block-stages are dealt to 132 blocks, one block runs at least
    28, as each of these 128 does."""
    for B in (9, 20, 64):
        assert fq.wgmma_plan(B, 4096, 14336, SMS) == (4, 28)
    for B in (65, 128):
        assert fq.wgmma_plan(B, 4096, 14336, SMS) == (2, 56)
    assert 4 * 32 <= SMS < 5 * 32


# K2 (H, NQ, NKV) at B >= 9 with int8 weights: the route, "wgmma" where TMA
# reads rows of H bytes (multiples of 16, at least 256) and NQ and NQ + NKV
# fall on 128-row blocks; K3 (NQ, H) needs only rows of NQ bytes TMA reads
K2_WGMMA_WIDTHS = [((4096, 4096, 1024), "wgmma"), ((2048, 2048, 1024), "wgmma"),
                   ((256, 256, 128), "wgmma"), ((512, 384, 256), "wgmma"),
                   ((4104, 4096, 1024), "rows"), ((4096, 4096, 1000), "rows"),
                   ((4096, 4000, 1024), "rows"), ((256, 256, 64), "rows"),
                   ((128, 256, 128), "rows"), ((240, 256, 128), "rows")]
K3_WGMMA_WIDTHS = [((4096, 4096), "wgmma"), ((2048, 2048), "wgmma"), ((256, 256), "wgmma"),
                   ((336, 4000), "wgmma"), ((4104, 4096), "rows"), ((128, 256), "rows"),
                   ((240, 256), "rows"), ((1000, 4096), "rows")]


@pytest.mark.parametrize("fmt", [INT8, Q4G, DENSE, wr.DENSE_F32],
                         ids=["int8", "q4g", "dense", "dense_f32"])
@pytest.mark.parametrize("B", K1_ROUTE_ROWS)
def test_k2_k3_route_rule(fmt, B):
    """bf16 x at SliME-8B's width: int8 weights take the ring at 1-8 rows
    and the tensor-core instance from 9, as K1's; q4g the ring at 1-8 and
    the row-per-warp kernels from 9; dense bf16 K2 and K3 the ring at 1-4
    and the tensor-core instance from 5; fp32 x always row per warp."""
    bf, f32 = torch.bfloat16, torch.float32
    ring = {INT8: 8, Q4G: 8, DENSE: 4, wr.DENSE_F32: 0}[fmt]
    o_ring = 4 if fmt == DENSE else ring
    deep = "wgmma" if fmt in (INT8, DENSE) else "rows"
    assert fq.k2_route(B, bf, fmt, 4096, 4096, 1024, SMS) == ("ring" if B <= ring else deep)
    assert fq.k3_route(B, bf, fmt, 4096, 4096, SMS) == (
        "ring" if B <= o_ring else deep)
    assert fq.k2_route(B, f32, fmt, 4096, 4096, 1024, SMS) == "rows"
    assert fq.k3_route(B, f32, fmt, 4096, 4096, SMS) == "rows"
    assert fq.K1_WGMMA_MIN_ROWS == fm.K1_WGMMA_MIN_ROWS == 9
    assert fq.DENSE_WGMMA_MIN_ROWS == fm.DENSE_WGMMA_MIN_ROWS == 5
    assert fq.DENSE_O_RING_ROWS == 4


@pytest.mark.parametrize("widths,want", K2_WGMMA_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("B", [9, 20, 64, 65, 128])
def test_k2_route_needs_rows_tma_reads_and_whole_blocks(widths, want, B):
    """K2 from 9 int8 rows takes the tensor-core instance only where TMA
    reads the rows of h and of the weights and a 128-row block never spans
    two of W_q, W_k, W_v; elsewhere the row-per-warp kernels. The pure
    instance check agrees, and 8 rows stay on the ring (or row per warp
    where it has no plan)."""
    H, NQ, NKV = widths
    bf = torch.bfloat16
    assert fq.k2_route(B, bf, INT8, H, NQ, NKV, SMS) == want
    assert fq.qkv_wgmma_instance(bf, INT8, H, NQ, NKV) == (want == "wgmma")
    assert fq.k2_route(8, bf, INT8, H, NQ, NKV, SMS) != "wgmma"
    assert fq.k2_route(8, bf, INT8, 58112, 256, 128, SMS) == "rows"


@pytest.mark.parametrize("widths,want", K3_WGMMA_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("B", [9, 20, 64, 65, 128])
def test_k3_route_needs_rows_tma_reads(widths, want, B):
    """K3 from 9 int8 rows takes the tensor-core instance where TMA reads
    the rows of attn and W_o (NQ a multiple of 16, at least 256), at any H
    (its output rows need no block boundary); elsewhere row per warp."""
    NQ, H = widths
    bf = torch.bfloat16
    assert fq.k3_route(B, bf, INT8, NQ, H, SMS) == want
    assert fq.o_wgmma_instance(bf, INT8, NQ) == (want == "wgmma")
    assert fq.k3_route(8, bf, INT8, 58112, 256, SMS) == "rows"


# the row spaces and contractions of K2 (N = NQ + 2 NKV, K = H) and K3 (N =
# H, K = NQ): SliME-8B's, the 0.6B draft's (H = NQ = 2048, NKV 1024) and
# small ragged ones
SPLIT_SHAPES = [(6144, 4096), (4096, 4096), (4096, 2048), (2048, 2048), (512, 256),
                (384, 768), (1280, 336), (256, 4000)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda v: f"N{v[0]}-K{v[1]}")
@pytest.mark.parametrize("B", [9, 20, 33, 64, 65, 128, 512])
@pytest.mark.parametrize("sms", [SMS, 11, 7])
def test_k2_k3_wgmma_split_covers_every_stage_once(shape, B, sms):
    """K2's split over H and K3's over NQ: every stage once, in one wave of
    blocks where the tiles leave room (``wgmma_plan``, K1's down's rule)."""
    N, K = shape
    _assert_one_wave_split(B, N, K, sms)


def test_k2_k3_wgmma_plan_at_8b_width():
    """SliME-8B on 132 SMs: K2's row space [W_q; W_k; W_v] (6144 rows, 48
    blocks a token tile) over H = 4096 (32 stages) in 2 splits of 16, 96
    blocks, a third split would start a second wave (144); K3 (W_o [4096,
    4096]: 32 blocks, 32 stages) in 4 splits of 8, 128 blocks. At 65-128
    rows (two tiles) K2 runs unsplit (96 blocks) and K3 in 2 of 16. The
    draft's widths (H = NQ = 2048, NKV = 1024): K2 4 of 4 (128 blocks), K3
    8 of 2. Asked for 3 splits, K2 takes 11, 11 and 10 stages."""
    for B in (9, 20, 64):
        assert fq.wgmma_plan(B, 6144, 4096, SMS) == (2, 16)
        assert fq.wgmma_plan(B, 4096, 4096, SMS) == (4, 8)
        assert fq.wgmma_plan(B, 4096, 2048, SMS) == (4, 4)
        assert fq.wgmma_plan(B, 2048, 2048, SMS) == (8, 2)
    for B in (65, 128):
        assert fq.wgmma_plan(B, 6144, 4096, SMS) == (1, 32)
        assert fq.wgmma_plan(B, 4096, 4096, SMS) == (2, 16)
    assert fq.wgmma_plan(64, 6144, 4096, SMS, splits=3) == (3, 11)
    assert 2 * 48 <= SMS < 3 * 48


# dense bf16 (H, I, route at B >= 9): rows TMA reads (2 K bytes a multiple of
# 16, at least 256 columns: ``fused_qkvo.wgmma_strides``) and rows it does not
K1_DENSE_STRIDES = [(4096, 14336, "wgmma"), (2048, 5504, "wgmma"), (256, 264, "wgmma"),
                    (264, 512, "wgmma"), (4100, 14336, "rows"), (4096, 14340, "rows"),
                    (128, 512, "rows"), (256, 248, "rows")]
# dense K2 (H, NQ, NKV): H as TMA reads it, NQ and NQ + NKV on 128-row blocks
K2_DENSE_WIDTHS = [((4096, 4096, 1024), "wgmma"), ((2048, 2048, 1024), "wgmma"),
                   ((264, 512, 128), "wgmma"), ((4100, 4096, 1024), "rows"),
                   ((4096, 4000, 1024), "rows"), ((256, 256, 64), "rows"),
                   ((248, 256, 128), "rows")]


@pytest.mark.parametrize("H,I,want", K1_DENSE_STRIDES, ids=lambda v: str(v))
@pytest.mark.parametrize("B", [9, 20, 40, 64, 65, 128])
def test_k1_dense_route_needs_rows_tma_reads(H, I, want, B):
    """Dense bf16 K1 from 9 rows takes the tensor-core instance only where
    TMA reads the rows of h, a and the weights (multiples of 8 bf16
    columns, at least 256); elsewhere the row-per-warp kernels, which take
    any row of 16-byte vectors. At 1-4 rows the ring, wherever it has a
    plan; fp32 x never the tensor cores."""
    bf = torch.bfloat16
    assert fm.k1_route(B, bf, DENSE, H, I, SMS) == want
    assert fm.wgmma_instance(bf, DENSE, H, I) == (want == "wgmma")
    assert not fm.wgmma_instance(torch.float32, wr.DENSE_F32, H, I)
    assert not fm.wgmma_instance(torch.float32, DENSE, H, I)
    assert fm.k1_route(4, bf, DENSE, H, I, SMS) == (
        "ring" if fm.ring_plan(4, H, I, DENSE, SMS) is not None else "rows")


@pytest.mark.parametrize("widths,want", K2_DENSE_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("B", [9, 20, 40, 64, 65, 128])
def test_k2_dense_route_needs_rows_tma_reads_and_whole_blocks(widths, want, B):
    """Dense bf16 K2 from 9 rows takes the tensor-core instance where TMA
    reads the rows of h and of the weights and a 128-row block never spans
    two of W_q, W_k, W_v; elsewhere the row-per-warp kernels. Dense K3 takes
    its tensor-core instance at each of these widths: TMA reads every NQ
    here (rows of attn and W_o, 8 bf16 columns a 16 bytes, at least 256)
    and its output rows need no block boundary."""
    H, NQ, NKV = widths
    bf = torch.bfloat16
    assert fq.k2_route(B, bf, DENSE, H, NQ, NKV, SMS) == want
    assert fq.qkv_wgmma_instance(bf, DENSE, H, NQ, NKV) == (want == "wgmma")
    assert fq.k3_route(B, bf, DENSE, NQ, H, SMS) == "wgmma"
    assert fq.o_wgmma_instance(bf, DENSE, NQ)


# dense K3 (NQ, H): rows of attn and W_o TMA reads (NQ a multiple of 8 bf16
# columns, at least 256; int8 needs NQ % 16), at any H; and rows it does not
K3_DENSE_WIDTHS = [((4096, 4096), "wgmma"), ((2048, 2048), "wgmma"), ((264, 512), "wgmma"),
                   ((1000, 4096), "wgmma"), ((256, 264), "wgmma"), ((4100, 4096), "rows"),
                   ((248, 256), "rows"), ((128, 256), "rows")]


@pytest.mark.parametrize("widths,want", K3_DENSE_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("B", [5, 6, 8, 9, 20, 40, 64, 65, 128])
def test_k3_dense_route_needs_rows_tma_reads(widths, want, B):
    """Dense bf16 K3 from DENSE_WGMMA_MIN_ROWS (5) takes the tensor-core
    instance where TMA reads the rows of attn and W_o; elsewhere the
    row-per-warp kernel. NQ 1000 is dense's and not int8's (int8 rows of
    1000 bytes are no multiple of 16); fp32 x never takes it; at 4 rows the
    ring wherever it has a plan."""
    NQ, H = widths
    bf = torch.bfloat16
    assert fq.k3_route(B, bf, DENSE, NQ, H, SMS) == want
    assert fq.o_wgmma_instance(bf, DENSE, NQ) == (want == "wgmma")
    assert not fq.o_wgmma_instance(torch.float32, DENSE, NQ)
    assert not fq.o_wgmma_instance(torch.float32, wr.DENSE_F32, NQ)
    assert fq.o_wgmma_instance(bf, INT8, 1000) is False
    assert fq.k3_route(4, bf, DENSE, NQ, H, SMS) == (
        "ring" if fq.o_ring_route(4, bf, DENSE, NQ, H, SMS) is not None else "rows")


def test_dense_k3_wgmma_plan_at_8b_width():
    """Dense K3 at SliME-8B's width (W_o [4096, 4096]: 32 row blocks a token
    tile, 64 dense stages of 64 columns) on 132 SMs: 4 splits of 16 stages
    (128 blocks) from 5 to 64 rows, 2 of 32 at 65-128 (two tiles); int8's
    128-column stages give 4 of 8."""
    for B in (5, 8, 20, 40, 64):
        assert fq.wgmma_plan(B, 4096, 4096, SMS, fmt=DENSE) == (4, 16)
    for B in (65, 128):
        assert fq.wgmma_plan(B, 4096, 4096, SMS, fmt=DENSE) == (2, 32)
    assert fq.wgmma_plan(64, 4096, 4096, SMS) == (4, 8)


@pytest.mark.parametrize("fmt,B,want", [(DENSE, 5, (4, 16)), (DENSE, 64, (4, 16)),
                                        (DENSE, 128, (2, 32)), (INT8, 64, (4, 8))],
                         ids=lambda v: str(v))
def test_o_launch_plans_with_the_weight_format(monkeypatch, fmt, B, want):
    """``o_launch`` on K3's tensor-core instance passes the weight's format
    to ``slime_o_wgmma`` and plans the split with it (``wgmma_plan(fmt=)``:
    64-column dense stages, 128-column int8 ones), at SliME-8B's width on
    132 SMs: the C library, the device checks and the SM count are stood in
    for, so the launch's arguments are read on the CPU."""
    from slime_tpu_torch.ops import _cuda
    calls = []

    class Lib:
        def slime_o_wgmma(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_cuda, "library", lambda: Lib())
    monkeypatch.setattr(_cuda, "require_cuda", lambda *t: None)
    monkeypatch.setattr(_cuda, "stream", lambda: 0)
    monkeypatch.setattr(wr, "sm_count", lambda device: SMS)
    g = torch.Generator().manual_seed(B)
    if fmt == DENSE:
        w = {"weight": torch.randn((2, 4096, 4096), generator=g).to(torch.bfloat16)}
    else:
        w = {"weight": {"q": torch.zeros((2, 4096, 4096), dtype=torch.int8),
                        "scale": torch.ones((2, 4096, 1))}}
    attn, x = (torch.randn((B, 4096), generator=g).to(torch.bfloat16) for _ in range(2))
    assert fq.k3_route(B, torch.bfloat16, fmt, 4096, 4096, SMS) == "wgmma"
    y, got_fmt, route = fq.o_launch(attn, x, {"o_proj": w}, 1)
    assert (got_fmt, route, y.shape, y.dtype) == (fmt, "wgmma", x.shape, torch.bfloat16)
    (args,) = calls
    assert args[0] == fmt and args[5:8] == (B, 4096, 4096)
    assert args[-3:-1] == want and fq.wgmma_plan(B, 4096, 4096, SMS, fmt=fmt) == want
    assert (args[-4] is None) == (fmt == DENSE)


@pytest.mark.parametrize("shape", [(4096, 14336), (2048, 5504), (6144, 4096), (4096, 2048),
                                   (512, 256), (384, 264), (1280, 520)],
                         ids=lambda v: f"N{v[0]}-K{v[1]}")
@pytest.mark.parametrize("B", [5, 9, 20, 40, 64, 65, 128, 512])
@pytest.mark.parametrize("sms", [SMS, 11, 7])
def test_dense_wgmma_split_covers_every_stage_once(shape, B, sms):
    """The dense instances' split launches (K1's down over I, K2 over H) at
    the 64-column dense stage: every stage once, in one wave of blocks where
    the tiles leave room, on 132, 11 and 7 SMs."""
    N, K = shape
    _assert_one_wave_split(B, N, K, sms, fmt=DENSE)


def test_dense_wgmma_plan_at_8b_width():
    """SliME-8B on 132 SMs with dense bf16 weights, 64 columns a stage: K1's
    down (W_down [4096, 14336]: 224 stages, 32 row blocks a token tile) in 4
    splits of 56 up to 64 rows and 2 of 112 at 65-128; K2 (6144 rows over
    H's 64 stages) in 2 splits of 32, unsplit at 65-128. The stage widths:
    128 int8 columns, 64 dense."""
    for B in (5, 8, 9, 20, 40, 64):
        assert fq.wgmma_plan(B, 4096, 14336, SMS, fmt=DENSE) == (4, 56)
        assert fq.wgmma_plan(B, 6144, 4096, SMS, fmt=DENSE) == (2, 32)
    for B in (65, 128):
        assert fq.wgmma_plan(B, 4096, 14336, SMS, fmt=DENSE) == (2, 112)
        assert fq.wgmma_plan(B, 6144, 4096, SMS, fmt=DENSE) == (1, 64)
    assert (fq.wgmma_stage_cols(INT8), fq.wgmma_stage_cols(DENSE)) == (128, 64)


def test_ring_plan_refuses_rows_too_long():
    with pytest.raises(ValueError, match="no weight-ring plan"):
        wr.ring_launch(1, 1 << 17, 256, INT8, 2, SMS)


# K2 (H, NQ, NKV) and K3 (NQ, H) widths: SliME-8B, and small ragged ones
# (int8 NKV 40 and 136: stages of 8 rows that meet W_q's or W_k's end; q4g
# at H 768, 6 scales a row, whose bands and parts start on even rows)
QKV_WIDTHS = {INT8: [(4096, 4096, 1024), (256, 256, 64), (256, 256, 40), (768, 512, 136)],
              Q4G: [(4096, 4096, 1024), (512, 512, 256), (768, 512, 256), (256, 256, 32)],
              DENSE: [(4096, 4096, 1024), (256, 256, 64), (256, 256, 40), (768, 512, 136)]}


@pytest.mark.parametrize("fmt", [INT8, Q4G, DENSE], ids=["int8", "q4g", "dense"])
@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("sms", [SMS, 7])
def test_qkv_and_o_ring_plans_cover_every_row_once(fmt, case, B, sms):
    """K2's one launch over the row space [W_q; W_k; W_v] and K3's over W_o:
    every row of q, k, v and y in exactly one band and one bulk copy, none
    crossing a matrix (a stage that meets W_q's end splits its copy there),
    16-byte aligned, shared memory within a block's; dense K3's rows of
    2 NQ bytes too (routed at B <= DENSE_O_RING_ROWS; past it its plan is
    held as the kernel would take it)."""
    H, NQ, NKV = QKV_WIDTHS[fmt][case]
    bf = torch.bfloat16
    qkv, c_qkv = fq.qkv_ring_route(B, bf, fmt, H, NQ, NKV, sms)
    if fmt == DENSE and B > fq.DENSE_O_RING_ROWS:
        assert fq.o_ring_route(B, bf, fmt, NQ, H, sms) is None
        o, c_o = wr.projection_plan(B, NQ, H, fmt, sms)
    else:
        o, c_o = fq.o_ring_route(B, bf, fmt, NQ, H, sms)
    assert list(c_qkv) == qkv.ints() and list(c_o) == o.ints()
    assert (qkv.rows, qkv.mats, qkv.parts) == (NQ + 2 * NKV, 1, (NQ, NKV, NKV))
    assert (o.rows, o.mats, o.parts) == (H, 1, ())
    for ln, K, mat_rows in ((qkv, H, [NQ, NKV, NKV]), (o, NQ, [H])):
        assert ln.row_bytes == ROW_BYTES[fmt](K)
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
    kernels elsewhere; on dense bf16 weights K2 and K3 so (K3 up to
    DENSE_O_RING_ROWS, 4), K1 at B <= 4 only (the card measured the
    ring slower at 8 rows)."""
    want = wr.ring_instance(B, dtype, fmt)
    # K1 alone admits fp32 (int8, q4g) up to F32_RING_ROWS
    k1 = wr.ring_instance(B, dtype, fmt, f32_rows=fm.F32_RING_ROWS)
    assert k1 == (want or (dtype == torch.float32 and B <= fm.F32_RING_ROWS))
    assert (fm.ring_route(B, dtype, fmt, 4096, 14336, SMS) is not None) == (
        k1 and (fmt != DENSE or B <= fm.DENSE_RING_ROWS))
    assert (fq.qkv_ring_route(B, dtype, fmt, 4096, 4096, 1024, SMS) is not None) == want
    assert (fq.o_ring_route(B, dtype, fmt, 4096, 4096, SMS) is not None) == (
        want and (fmt != DENSE or B <= fq.DENSE_O_RING_ROWS))
    dense = dtype == torch.bfloat16 and B <= 8
    assert (fm.ring_route(B, dtype, DENSE, 4096, 14336, SMS) is not None) == (
        dense and B <= 4)
    assert (fq.qkv_ring_route(B, dtype, DENSE, 4096, 4096, 1024, SMS) is not None) == dense
    assert (fq.o_ring_route(B, dtype, DENSE, 4096, 4096, SMS) is not None) == (
        dense and B <= fq.DENSE_O_RING_ROWS)


# layers too wide for the ring's shared memory, where K1 raised before: int8
# from I = 58048 (down) or H = 32784 (gate/up), q4g from I = 56576 or H =
# 30976 (a wide H lacks gate/up's plan, a wide I down's); dense bf16 from I
# = 32784 or H = 16400 (the 128 KB ring holds two stages of rows of 2 I or
# 2 x 2 H bytes up to there; at B = 8 the activations leave less)
WIDE = [(INT8, 4096, 58048), (INT8, 32784, 14336), (Q4G, 4096, 56576),
        (Q4G, 30976, 14336), (DENSE, 4096, 32784), (DENSE, 16400, 14336)]


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
                       None if fmt == DENSE and B > fq.DENSE_O_RING_ROWS
                       else wr.launch_or_none(B, 4096, H, fmt, 1, SMS))):
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


@pytest.mark.parametrize("B,last,first_missing", [(1, 32768, 32784), (8, 28896, 28912)])
def test_wide_dense_qkv_routes_to_the_row_per_warp_kernels(B, last, first_missing):
    """Dense K2 at SliME-8B's row space (one matrix a stage, rows of 2 H
    bytes) has a ring plan up to H = 32768 at B = 1 (the 128 KB ring holds
    two 64 KB stages) and 28896 at B = 8 (two stages, the activations and
    the epilogue fill shared memory); from the next 16 columns the call
    takes the row-per-warp kernels."""
    bf = torch.bfloat16
    assert fq.qkv_ring_route(B, bf, DENSE, last, 4096, 1024, SMS) is not None
    assert fq.qkv_ring_route(B, bf, DENSE, first_missing, 4096, 1024, SMS) is None
    with pytest.raises(ValueError, match="no weight-ring plan"):
        wr.ring_launch(B, first_missing, 6144, DENSE, 1, SMS, (4096, 1024, 1024))
    with pytest.raises(ValueError, match="no weight-ring plan"):
        wr.ring_launch(1, 4096, 512, wr.DENSE_F32, 1, SMS)       # no fp32 ring


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
            for a in ("launches", "ring_launches", "q4g_ring_launches", "dense_launches",
                      "dense_ring_launches", "wgmma_launches")]


@pytest.mark.parametrize("B", [3, 20])
def test_cpu_qkv_and_o_take_the_plain_version_and_count_nothing(B):
    """bf16 x with int8 weights at B = 3, where the card takes the ring, and
    at B = 20, where it takes the tensor-core instances: on the CPU K2 and
    K3 are their plain versions and count no launch, on the ring's counters
    or on ``.wgmma_launches``."""
    g = torch.Generator().manual_seed(1)

    def q(out_d, in_d):
        return {"weight": {"q": torch.randint(-127, 128, (2, out_d, in_d), dtype=torch.int8,
                                              generator=g),
                           "scale": torch.full((2, out_d, 1), 1e-3)}}
    layers = {"input_layernorm": {"weight": 1 + 0.1 * torch.randn((2, 256), generator=g)},
              "q_proj": q(256, 256), "k_proj": q(128, 256), "v_proj": q(128, 256),
              "o_proj": q(256, 256)}
    x = torch.randn((B, 256), generator=g).to(torch.bfloat16)
    attn = torch.randn((B, 256), generator=g).to(torch.bfloat16)
    want = "ring" if B <= 8 else "wgmma"
    assert fq.k2_route(B, x.dtype, INT8, 256, 256, 128, SMS) == want
    assert fq.k3_route(B, x.dtype, INT8, 256, 256, SMS) == want
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


def test_cpu_dense_calls_take_the_plain_version_and_count_nothing():
    """bf16 x with dense bf16 weights at B = 4, where the card takes the ring
    for K1, K2 and K3: on the CPU K1-K3 are their plain versions, count no
    launch, and agree with the fp32 products rounded once."""
    g = torch.Generator().manual_seed(2)

    def w(out_d, in_d):
        return {"weight": (0.05 * torch.randn((2, out_d, in_d), generator=g)).to(torch.bfloat16)}
    layers = {"input_layernorm": {"weight": 1 + 0.1 * torch.randn((2, 256), generator=g)},
              "post_attention_layernorm": {"weight": torch.ones((2, 256))},
              "q_proj": w(256, 256), "k_proj": w(64, 256), "v_proj": w(64, 256),
              "o_proj": w(256, 256), "gate_proj": w(512, 256), "up_proj": w(512, 256),
              "down_proj": w(256, 512)}
    x = torch.randn((4, 256), generator=g).to(torch.bfloat16)
    attn = torch.randn((4, 256), generator=g).to(torch.bfloat16)
    assert fm.ring_route(4, x.dtype, DENSE, 256, 512, SMS) is not None
    assert fq.qkv_ring_route(4, x.dtype, DENSE, 256, 256, 64, SMS) is not None
    assert fq.o_ring_route(4, x.dtype, DENSE, 256, 256, SMS) is not None
    before = _counts()
    h = fq.rms_h(x, layers["input_layernorm"]["weight"][1], 1e-5).float()
    for got, name in zip(fq.fused_qkv_decode(x, layers, 1), ("q_proj", "k_proj", "v_proj")):
        want = (h @ layers[name]["weight"][1].float().T).to(torch.bfloat16)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(fq.fused_o_residual(attn, x, layers, 1),
                               fq.fused_o_residual_ref(attn, x, layers, 1), rtol=0, atol=0)
    torch.testing.assert_close(fm.fused_mlp_decode(x, layers, 1),
                               fm.fused_mlp_decode_ref(x, layers, 1), rtol=0, atol=0)
    assert _counts() == before


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


@pytest.mark.parametrize("K", [4096, 14336, 5504, 256])
def test_dense_ring_activations_read_in_place(K):
    """The dense consumers' view of an activation row (staged chunk j at
    ``act_chunk(j)``, read by ``ring_dot_bf16`` in csrc/fused_decode.cu): a
    lane's 16-byte weight vector c holds columns 8 c .. 8 c + 7, and the
    chunk it reads holds exactly those columns; the eight lanes of a
    quarter-warp (vectors c .. c + 7, c a multiple of 8: the warp's 32 lanes
    take 32 vectors in a row, and BT = 1's second vector is 32 further) read
    chunks on eight distinct bank groups, 128 bytes on all 32 banks."""
    x = np.arange(K)
    smem = np.full(K, -1)
    for j in range(K // 8):                   # the consumers' staging, one chunk a thread
        smem[8 * _act_chunk(j):8 * _act_chunk(j) + 8] = x[8 * j:8 * j + 8]
    assert (np.sort(smem) == x).all()
    for c in range(K // 8):
        np.testing.assert_array_equal(smem[8 * _act_chunk(c):][:8], 8 * c + np.arange(8))
    for q in range(0, K // 8, 8):
        chunks = [_act_chunk(c) for c in range(q, min(q + 8, K // 8))]
        assert len({ch % 8 for ch in chunks}) == len(chunks)
        assert len({ch // 8 for ch in chunks}) == 1     # one 128-byte line


# K1 with fp32 activations (the entry points' default compute dtype) on the
# ring: int8 and q4g weights, 4 bytes an activation in the plans
F32_FORMATS = [INT8, Q4G]


@pytest.mark.parametrize("fmt", F32_FORMATS, ids=["int8", "q4g"])
@pytest.mark.parametrize("B", range(1, 9))
def test_f32_ring_plans_at_8b_width(fmt, B):
    """SliME-8B's gate/up [14336, 4096] and down [4096, 14336] with fp32
    activations: h's rows are 16 KB, so all 8 fit ACT_BYTES in one launch;
    a's are 56 KB, so down stages 1 row a launch at B = 1 (beside its 128 KB
    ring) and 2 from B = 2 (ceil(B / 2) launches); shared memory within a
    block's, every row once. The rule's plan at B <= F32_RING_ROWS is this
    one."""
    gu, dn, ints = fm.ring_plan(B, 4096, 14336, fmt, SMS, 4)
    assert list(ints) == gu.ints() + dn.ints()
    assert gu.act_bytes == dn.act_bytes == 4
    assert (gu.batch_rows, dn.batch_rows) == (B, min(B, 2))
    assert gu.smem <= wr.SMEM_MAX and dn.smem <= wr.SMEM_MAX
    if B == 1:
        assert dn.batch_rows * 14336 * 4 == 57344 and dn.stages >= 9
    for ln, K, N, mats in ((gu, 4096, 14336, 2), (dn, 14336, 4096, 1)):
        assert ln.row_bytes == ROW_BYTES[fmt](K)
        _assert_covers_every_row_once(ln, K, B, [N] * mats)
    route = fm.ring_route(B, torch.float32, fmt, 4096, 14336, SMS)
    assert (route is not None) == (B <= fm.F32_RING_ROWS)
    assert route is None or route == fm.ring_plan(B, 4096, 14336, fmt, SMS, 4)


@pytest.mark.parametrize("fmt", F32_FORMATS, ids=["int8", "q4g"])
@pytest.mark.parametrize("width", WIDTHS[1:] + [(2048, 5632)], ids=lambda w: f"H{w[0]}-I{w[1]}")
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("sms", [SMS, 7])
def test_f32_ring_plan_covers_every_row_once(fmt, width, B, sms):
    """K1's fp32 plans at small and ragged widths (q4g at H = 768: bands on
    even rows; the 0.6B draft's H with an I that q4g takes): every row in
    exactly one band and one copy, 4-byte activations in shared memory."""
    H, I = width
    gate_up, down, _ = fm.ring_plan(B, H, I, fmt, sms, 4)
    for ln, K, N, mats in ((gate_up, H, I, 2), (down, I, H, 1)):
        assert (ln.rows, ln.mats, ln.act_bytes) == (N, mats, 4)
        _assert_covers_every_row_once(ln, K, B, [N] * mats)


@pytest.mark.parametrize("B", range(1, 10))
def test_f32_stays_off_the_ring_for_k2_k3_k6(B):
    """Only K1 and K6 admit fp32 activations, each through its own row
    limit: K2's and K3's rules keep fp32 off the ring at every row count
    (row per warp), as does any caller that admits none (``f32_rows`` 0:
    K6's rule without its limit); K6 with its limit
    (``quant_matmul.K6_F32_RING_ROWS``) takes the ring at 1-8 rows with
    int8 and per-row q4 weights, K1's rule never takes per-row q4, and
    dense weights never take it in fp32."""
    f32 = torch.float32
    for fmt in F32_FORMATS:
        assert fq.qkv_ring_route(B, f32, fmt, 4096, 4096, 1024, SMS) is None
        assert fq.o_ring_route(B, f32, fmt, 4096, 4096, SMS) is None
        assert fq.k2_route(B, f32, fmt, 4096, 4096, 1024, SMS) == "rows"
        assert fq.k3_route(B, f32, fmt, 4096, 4096, SMS) == "rows"
        assert not wr.ring_instance(B, f32, fmt)
    for fmt in (INT8, wr.ROW_Q4):
        assert wr.k6_ring_route(B, 4096, 4096, f32, fmt, SMS) is None
        k6 = wr.k6_ring_route(B, 4096, 4096, f32, fmt, SMS, qm.K6_F32_RING_ROWS)
        assert (k6 is not None) == (B <= qm.K6_F32_RING_ROWS)
        assert k6 is None or k6[0].act_bytes == 4
        assert wr.ring_instance(B, f32, fmt, f32_rows=8) == (B <= 8)
        assert qm.k6_route(B, 4096, f32, qm._Q4 if fmt == wr.ROW_Q4 else qm._INT8, 4096,
                           SMS) == ("ring" if B <= qm.K6_F32_RING_ROWS else "ffma")
    for fmt in (DENSE, wr.DENSE_F32):
        assert not wr.ring_instance(B, f32, fmt, f32_rows=8)
    for fmt in (DENSE, wr.DENSE_F32, wr.ROW_Q4):
        assert fm.ring_route(B, f32, fmt, 4096, 14336, SMS) is None


def test_f32_ring_plan_refuses_other_formats():
    """4-byte activations only with int8, q4g or per-row q4 weights (one
    matrix a stage for q4); 2 or 4 bytes only."""
    with pytest.raises(ValueError, match="no weight-ring plan"):
        wr.ring_launch(1, 4096, 4096, DENSE, 1, SMS, act_bytes=4)
    with pytest.raises(ValueError, match="no weight-ring plan"):
        wr.ring_launch(1, 4096, 4096, wr.ROW_Q4, 2, SMS, act_bytes=4)
    assert wr.ring_launch(1, 4096, 4096, wr.ROW_Q4, 1, SMS, act_bytes=4).act_bytes == 4
    with pytest.raises(ValueError, match="no weight-ring plan"):
        wr.ring_launch(1, 4096, 4096, INT8, 1, SMS, act_bytes=3)
    assert wr.act_bytes(torch.float32) == 4 and wr.act_bytes(torch.bfloat16) == 2


def _act_chunk_f32(j):
    return j ^ ((j >> 3) & 3)


@pytest.mark.parametrize("K", [4096, 14336, 256, 768])
def test_f32_ring_activations_swizzled(K):
    """The fp32 consumers' view of an activation row (the staging puts
    16-byte chunk j, 4 floats, at ``act_chunk_f32(j)``; ``load_act16`` reads
    columns 16 c .. 16 c + 15 as chunks act_chunk_f32(4 c + k), k < 4): every
    column where it belongs; for each k the eight lanes of a quarter-warp
    (int8 vectors c .. c + 7, c a multiple of 8; q4g pairs 16 blk + 0..7 and
    their high halves 8 further) read chunks on eight distinct bank groups,
    where unswizzled chunks would fall on two (a 4-way conflict) and bf16's
    swizzle on four (2-way)."""
    x = np.arange(K)
    smem = np.full(K, -1)
    for j in range(K // 4):
        smem[4 * _act_chunk_f32(j):4 * _act_chunk_f32(j) + 4] = x[4 * j:4 * j + 4]
    assert (np.sort(smem) == x).all()
    for c in range(K // 16):
        got = np.concatenate([smem[4 * _act_chunk_f32(4 * c + k):][:4] for k in range(4)])
        np.testing.assert_array_equal(got, 16 * c + np.arange(16))
    lanes = [list(range(q, q + 8)) for q in range(0, K // 16, 8)]          # int8
    lanes += [[16 * blk + i + hi for i in range(8)] for blk in range(K // 256)
              for hi in (0, 8)]                                             # q4g
    for group in lanes:
        for k in range(4):
            assert len({_act_chunk_f32(4 * c + k) % 8 for c in group}) == 8
            assert len({(4 * c + k) % 8 for c in group}) == 2
            assert len({_act_chunk(4 * c + k) % 8 for c in group}) == 4


# K6 with fp32 x on the ring at SliME-8B's widths: q/o, k/v, gate/up at K =
# 4096 and down at K = 14336
K6_F32_WIDTHS = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)]


@pytest.mark.parametrize("fmt", [INT8, wr.ROW_Q4], ids=["int8", "q4"])
@pytest.mark.parametrize("width", K6_F32_WIDTHS, ids=lambda w: f"N{w[0]}-K{w[1]}")
@pytest.mark.parametrize("B", range(1, 9))
def test_k6_f32_ring_plans_at_8b_width(fmt, width, B):
    """K6's fp32 plans (``k6_ring_route`` admitting fp32 at every row count
    the ring takes; the rule's limit ``quant_matmul.K6_F32_RING_ROWS``
    lies within them): 4-byte
    activations; x's rows are 16 KB at K = 4096, so all B fit ACT_BYTES in
    one launch, and 56 KB at K = 14336, so down stages 2 rows a launch
    (ceil(B / 2) launches, each streaming the weights); one matrix a stage,
    no scale bytes; every output row in exactly one band and one copy, the
    shared memory within a block's."""
    N, K = width
    assert 1 <= qm.K6_F32_RING_ROWS <= wr.RING_MAX_ROWS
    ln, c_plan = wr.k6_ring_route(B, K, N, torch.float32, fmt, SMS, wr.RING_MAX_ROWS)
    assert list(c_plan) == ln.ints()
    assert (ln.rows, ln.mats, ln.parts, ln.scale_bytes, ln.act_bytes) == (N, 1, (), 0, 4)
    assert ln.row_bytes == (K // 2 if fmt == wr.ROW_Q4 else K)
    assert ln.batch_rows == (B if K == 4096 else min(B, 2))
    assert ln.smem <= wr.SMEM_MAX
    _assert_covers_every_row_once(ln, K, B, [N])


@pytest.mark.parametrize("K", [4096, 14336, 1056])
def test_k6_f32_ring_q4_activations_deinterleaved(K):
    """The fp32 q4 consumers' view of x (``stage_act_q4(float*)`` then
    ``load_act16(const float*)`` in csrc/fused_decode.cu): chunk j of a row
    (columns 4 j .. 4 j + 3) puts its two even columns into half-chunk j % 2
    of chunk j / 2 of the even half and its odd ones likewise into the odd
    half (K / 2 further), each half swizzled by ``act_chunk_f32`` as a row
    of K / 2; the 16 columns a lane's vector c reads from each half (chunks
    act_chunk_f32(4 c + k)) are x's columns 32 c + 2 i (low nibbles of its
    bytes i) and 32 c + 2 i + 1 (high nibbles); and for each k the eight
    lanes of a quarter-warp read chunks on eight distinct bank groups."""
    x = np.arange(K)
    smem = np.full(K, -1)
    for j in range(K // 4):                   # one 16-byte chunk a thread
        for half in (0, 1):
            at = half * (K // 2) + 4 * _act_chunk_f32(j >> 1) + 2 * (j & 1)
            smem[at:at + 2] = x[4 * j + half:4 * j + 4:2]
    assert (np.sort(smem) == x).all()
    for c in range(K // 32):
        for half in (0, 1):
            base = half * (K // 2)
            got = np.concatenate([smem[base + 4 * _act_chunk_f32(4 * c + k):][:4]
                                  for k in range(4)])
            np.testing.assert_array_equal(got, 32 * c + 2 * np.arange(16) + half)
    for q in range(0, K // 32 - 7, 8):        # a quarter-warp's vectors c .. c + 7
        for k in range(4):
            assert len({_act_chunk_f32(4 * c + k) % 8 for c in range(q, q + 8)}) == 8


def test_cpu_f32_call_takes_the_plain_version_and_counts_nothing():
    """fp32 x with int8 weights at B = 1, where the card takes the ring: on
    the CPU K1 is its plain version and counts no launch, the fp32 ring's
    counters included."""
    g = torch.Generator().manual_seed(4)
    q = torch.randint(-127, 128, (2, 512, 256), dtype=torch.int8, generator=g)
    layers = {"post_attention_layernorm": {"weight": torch.ones((2, 256))},
              "gate_proj": {"weight": {"q": q, "scale": torch.full((2, 512, 1), 1e-3)}},
              "up_proj": {"weight": {"q": q.flip(1), "scale": torch.full((2, 512, 1), 1e-3)}},
              "down_proj": {"weight": {"q": q.transpose(1, 2).contiguous(),
                                       "scale": torch.full((2, 256, 1), 1e-3)}}}
    x = torch.randn((1, 256), generator=g)
    assert fm.k1_route(1, x.dtype, INT8, 256, 512, SMS) == "ring"
    f = fm.fused_mlp_decode
    counts = (f.launches, f.ring_launches, f.f32_ring_launches, f.f32_q4g_ring_launches)
    got = fm.fused_mlp_decode(x, layers, 1)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, fm.fused_mlp_decode_ref(x, layers, 1), rtol=0, atol=0)
    assert counts == (f.launches, f.ring_launches, f.f32_ring_launches, f.f32_q4g_ring_launches)
