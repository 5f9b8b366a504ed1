"""K1's weight ring (``fused_mlp.ring_instance``, ``ring_plan``) on the CPU.

The ring's kernel (``csrc/fused_decode.cu`` ``mlp_ring_kernel``) runs only
on the card (``tests/test_torch_kernels_cuda.py``); what decides which inputs
reach it and how it is launched is plain Python, held here: the routing rule
for every (B, dtype, weight format) that ``chip_smoke.py``'s phase 1 sends
to ``fused_mlp_decode``; the launch plans at SliME-8B's width and at small
widths whose row counts are ragged against the blocks and the stages (every
output row in exactly one band and one bulk copy, every copy 16-byte aligned
and a multiple of 16 bytes, the shared memory the kernel's check asks for
and no more than a block has); and the exact int8 / int4 -> fp32 conversion
the kernel does without I2F, on every byte and nibble.
"""
import numpy as np
import pytest
import torch

from slime_tpu_torch.ops import fused_mlp as fm
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
        assert fm.ring_instance(B, dtype, fmt) == (dtype == torch.bfloat16 and B <= 8)
    assert not any(fm.ring_instance(B, dtype, DENSE) for B in range(1, 10))
    assert not fm.ring_instance(0, torch.bfloat16, fmt)


def _need(ln: fm.RingLaunch, K: int) -> int:
    """The shared memory ``ring_projection`` (csrc/fused_decode.cu) checks a
    plan for: ring, activations, barriers and issued indices, epilogue."""
    S, q4g = ln.stages, ln.scale_bytes > 0
    band_cap = -(-ln.rows // ln.grid) + ln.align
    ep = ((0 if q4g else ln.mats) + (ln.batch_rows if ln.mats == 1 else 0)) * band_cap
    return S * ln.stage_bytes + ln.batch_rows * K * 2 + 8 * (2 * S + 1) + 4 * S + 4 * ep


@pytest.mark.parametrize("fmt", [INT8, Q4G], ids=["int8", "q4g"])
@pytest.mark.parametrize("width", WIDTHS, ids=lambda w: f"H{w[0]}-I{w[1]}")
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("sms", [SMS, 7])
def test_ring_plan_covers_every_row_once(fmt, width, B, sms):
    H, I = width
    gate_up, down, ints = fm.ring_plan(B, H, I, fmt, sms)
    assert list(ints) == gate_up.ints() + down.ints()
    for ln, K, N, mats in ((gate_up, H, I, 2), (down, I, H, 1)):
        assert (ln.rows, ln.mats) == (N, mats)
        assert ln.row_bytes == (K // 2 if fmt == Q4G else K)
        assert ln.scale_bytes == (K // 128 * 4 if fmt == Q4G else 0)
        assert ln.grid == min(sms, N) and ln.warps % ln.rows_per_stage == 0
        assert ln.stage_bytes == mats * ln.rows_per_stage * (ln.row_bytes + ln.scale_bytes)
        assert ln.stage_bytes % 16 == 0 and ln.stages >= 2
        assert fm.SMEM_HALF <= ln.smem <= fm.SMEM_MAX and _need(ln, K) <= ln.smem
        # activation rows: one launch a group, each group's rows 16-byte aligned
        assert 1 <= ln.batch_rows <= 8 and ln.batch_rows * K * 2 <= fm.ACT_BYTES
        groups = list(range(0, B, ln.batch_rows))
        assert sum(min(ln.batch_rows, B - b0) for b0 in groups) == B
        assert all(b0 * K * 2 % 16 == 0 for b0 in groups)
        # bands: contiguous, non-empty, every row once, starts on `align`
        bands = ln.bands()
        assert bands[0][0] == 0 and bands[-1][1] == N and len(bands) == ln.grid
        assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
        assert all(r1 > r0 and r0 % ln.align == 0 for r0, r1 in bands)
        assert max(r1 - r0 for r0, r1 in bands) <= -(-N // ln.grid) + ln.align
        covered = np.zeros((mats, N), dtype=np.int64)
        for r0, r1 in bands:
            per_stage = mats * (2 if ln.scale_bytes else 1)
            copies = ln.copies(r0, r1)
            assert len(copies) == per_stage * -(-(r1 - r0) // ln.rows_per_stage)
            for j, (dst, src, n) in enumerate(copies):
                assert dst % 16 == 0 and src % 16 == 0 and n % 16 == 0 and n > 0
                slot = dst // ln.stage_bytes
                assert slot < ln.stages and dst + n <= (slot + 1) * ln.stage_bytes
                m, is_scale = divmod(j % per_stage, 2) if ln.scale_bytes else (j % per_stage, 0)
                unit = ln.scale_bytes if is_scale else ln.row_bytes
                assert src % unit == 0 and n % unit == 0
                if not is_scale:
                    covered[m, src // unit:src // unit + n // unit] += 1
            # a stage's copies lie side by side in its slot, none overlapping
            for i in range(0, len(copies), per_stage):
                spans = sorted((d, d + n) for d, _, n in copies[i:i + per_stage])
                assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert (covered == 1).all()


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
    assert all(ln.smem > fm.SMEM_HALF for ln in (gu, dn))
    # B = 8: h fits one launch; a [8, 14336] does not (two launches of 4 rows)
    gu, dn, _ = fm.ring_plan(8, 4096, 14336, INT8, SMS)
    assert (gu.batch_rows, dn.batch_rows) == (8, 4)


def test_ring_plan_refuses_rows_too_long():
    with pytest.raises(ValueError, match="no weight-ring plan"):
        fm.ring_launch(1, 1 << 17, 256, INT8, 2, SMS)


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


def test_cpu_call_takes_the_plain_version_and_counts_nothing():
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, (2, 512, 256), dtype=torch.int8, generator=g)
    layers = {"post_attention_layernorm": {"weight": torch.ones((2, 256))},
              "gate_proj": {"weight": {"q": q, "scale": torch.full((2, 512, 1), 1e-3)}},
              "up_proj": {"weight": {"q": q.flip(1), "scale": torch.full((2, 512, 1), 1e-3)}},
              "down_proj": {"weight": {"q": q.transpose(1, 2).contiguous(),
                                       "scale": torch.full((2, 256, 1), 1e-3)}}}
    x = torch.randn((3, 256), generator=g).to(torch.bfloat16)
    assert fm.ring_instance(3, x.dtype, INT8)
    counts = (fm.fused_mlp_decode.launches, fm.fused_mlp_decode.ring_launches)
    torch.testing.assert_close(fm.fused_mlp_decode(x, layers, 1),
                               fm.fused_mlp_decode_ref(x, layers, 1), rtol=0, atol=0)
    assert counts == (fm.fused_mlp_decode.launches, fm.fused_mlp_decode.ring_launches)
