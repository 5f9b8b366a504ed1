"""The decode kernels' weight formats, and the weight ring's launch plans.

K1-K3 (``fused_mlp_decode``, ``fused_qkv_decode``, ``fused_o_residual``) in
bf16 with int8 or q4g weights, and K6 (``quant_matmul``) in bf16 with int8
or per-row q4 weights, at 1 <= B <= 8 (``ring_instance``: the decode steps
of the int8 and 4-bit serving paths) run on the weight ring,
``weight_ring_kernel`` in ``csrc/fused_decode.cu``: a persistent grid, one
block an SM, each block a band of output rows whose whole weight rows one
producer thread streams into a ring of shared-memory stages by 1-D bulk
copies, sixteen consumer warps each summing whole rows. ``ring_launch`` is
the plan of one such launch, checked again by the C side, which refuses one
it cannot run.

The routing rule (``fused_mlp.ring_route``, ``fused_qkvo.qkv_ring_route``
and ``o_ring_route``): a call takes the ring where ``ring_instance`` holds
and every launch of the call has a plan; every other call takes the
row-per-warp kernels, which take the same operands. A plan
is missing where two stages and the activations do not fit in a block's
shared memory: from K = 57920 int8 or 56576 q4g columns with one matrix a
stage (K1's down, K2, K3), from 32784 or 30976 with two (gate/up); and where
a weight row is not a whole number of 16-byte vectors (K6 at K = 1000). K6's
rule is ``k6_ring_route`` (one matrix a stage, no norm, no residual, the
per-row scale read by the epilogue as int8's is); where it has no plan K6
takes its ``mma.sync`` GEMM (``quant_matmul.k6_route``).

This is plain Python, so the CPU tests hold it
(``tests/test_torch_decode_stream.py``).
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from dataclasses import dataclass

import torch

# Weight formats (the kernels' format codes): dense bf16 (any float on the
# CPU), per-row int8, group-128 q4g, dense fp32 (fp32 activations only),
# per-row q4 (K6 only; quant_matmul.py's own codes 0-2 are another table).
DENSE, INT8, Q4G, DENSE_F32, ROW_Q4 = 0, 1, 2, 3, 4

RING_MAX_ROWS = 8             # activation rows the ring takes (one launch holds 8 at most)
RING_BYTES = 128 * 1024       # the ring of stages of one block
STAGE_BYTES = 8 * 1024        # a stage's weights at most, unless one row of each is more
ACT_BYTES = 128 * 1024        # activations one launch stages in shared memory, at most
SMEM_MAX = 232448             # shared memory one block can use (227 KB)
SMEM_HALF = 116 * 1024        # above half of an SM's 228 KB less a block's 1 KB
RING_WARPS = 16               # consumer warps a block (at most 16)
RED_BYTES = 4 * RING_MAX_ROWS * 16   # the folded row norm's partial sums, [rows][warps] fp32
PDL = True                    # chain a call's launches (programmatic dependent launch)


def ring_instance(B: int, dtype, fmt: int) -> bool:
    """Whether the decode kernels' operands suit the weight ring: bf16
    activations, int8, q4g or (K6) per-row q4 weights, 1 <= B <= 8. Such a
    call takes the ring where its plans exist; everything else takes the
    row-per-warp kernels (K6: its mma.sync GEMM)."""
    return dtype == torch.bfloat16 and fmt in (INT8, Q4G, ROW_Q4) and 1 <= B <= RING_MAX_ROWS


@dataclass(frozen=True)
class RingLaunch:
    """One projection's launches: ``grid`` persistent blocks, each a band of
    output rows (``bands``); stages of ``rows_per_stage`` whole rows of each
    of ``mats`` matrices (and for q4g their scales), ``stage_bytes``, in a
    ring of ``stages``; ``batch_rows`` activation rows a launch (B rows take
    ceil(B / batch_rows) launches, each streaming the weights); ``smem``
    bytes of shared memory a block; bands start at multiples of ``align``
    rows. With one matrix a stage, the row space may be several matrices
    one after another (``parts``: their row counts; K2's W_q, W_k, W_v)."""
    rows: int                 # N, output rows
    row_bytes: int            # weight bytes a row
    scale_bytes: int          # q4g scale bytes a row (0 for int8 and q4: loaded by the epilogue)
    mats: int                 # matrices streamed together (gate/up 2, else 1)
    grid: int
    rows_per_stage: int
    stages: int
    stage_bytes: int
    batch_rows: int
    smem: int
    align: int
    warps: int                # consumer warps a block
    parts: tuple = ()         # row counts of the row space's matrices (mats 1); () = (rows,)

    def bands(self):
        """[(first row, end row)] of every block, as the kernel cuts them
        (``band_start``)."""
        starts = [g * self.rows // self.grid // self.align * self.align
                  for g in range(self.grid)] + [self.rows]
        return list(zip(starts[:-1], starts[1:]))

    def copies(self, r0: int, r1: int):
        """[(matrix, is scale, byte offset in the ring, byte offset in the
        source, bytes)] of the bulk copies of band [r0, r1) in the order the
        kernel's producer issues them (``ring_load``): per stage, per part
        of the row space the stage's rows meet, per matrix, the weight rows,
        then (q4g) their scales. The matrix is gate/up's m with two a stage,
        else the part; source offsets are within that matrix."""
        R, out = self.rows_per_stage, []
        ends = list(itertools.accumulate(self.parts or (self.rows,)))
        for i, row in enumerate(range(r0, r1, R)):
            n, slot = min(R, r1 - row), (i % self.stages) * self.stage_bytes
            for q, (lo, hi) in enumerate(zip([0] + ends[:-1], ends)):
                a, b = max(row, lo), min(row + n, hi)
                if a >= b:
                    continue
                for m in range(self.mats):
                    mat, at = (q if self.mats == 1 else m), m * R + a - row
                    out.append((mat, False, slot + at * self.row_bytes,
                                (a - lo) * self.row_bytes, (b - a) * self.row_bytes))
                    if self.scale_bytes:
                        out.append((mat, True, slot + self.mats * R * self.row_bytes
                                    + at * self.scale_bytes, (a - lo) * self.scale_bytes,
                                    (b - a) * self.scale_bytes))
        return out

    def ints(self):
        return [self.grid, self.rows_per_stage, self.stages, self.stage_bytes,
                self.batch_rows, self.smem, self.align, self.warps]


def ring_launch(B: int, K: int, N: int, fmt: int, mats: int, sms: int,
                parts=None) -> RingLaunch:
    """The launch plan of one projection of N rows over K columns of int8
    (K bytes a row), q4g (K / 2, and K / 128 fp32 scales) or per-row q4 (K /
    2) weights, for B activation rows, on a card of ``sms`` SMs: one block an SM, each band
    at least ``align`` rows; R, the most rows (8, 4, 2 or 1, at least
    ``align``) whose weights stay within STAGE_BYTES; as many activation
    rows a launch as ACT_BYTES holds; as many stages (at least 2) as
    RING_BYTES holds and shared memory leaves room for. q4g bands, and every
    part of the row space (``parts``, row counts summing to N; one matrix a
    stage only), start at multiples of the fewest rows whose scales are
    whole 16-byte units. Raises where two stages do not fit."""
    q4g = fmt == Q4G
    parts = tuple(parts) if parts else (N,)
    row_bytes, scale_bytes = (K // 2, K // 128 * 4) if q4g else (K // 2 if fmt == ROW_Q4 else K, 0)
    align = next(a for a in (1, 2, 4) if a * scale_bytes % 16 == 0)
    R = next(r for r in (8, 4, 2, 1)
             if r == align or mats * r * row_bytes <= STAGE_BYTES)
    stage = mats * R * (row_bytes + scale_bytes)
    bg = max(1, min(B, RING_MAX_ROWS, ACT_BYTES // (2 * K)))
    grid = min(sms, N // align)           # at least `align` rows a band: none empty
    # the epilogue's operands of a band: int8 row scales, the residual rows
    band_cap = -(-N // grid) + align
    epilogue = ((0 if q4g else mats) + (bg if mats == 1 else 0)) * band_cap * 4
    rest = bg * K * 2 + epilogue + RED_BYTES      # activations, epilogue, the norm's sums
    # a stage, its two barriers and its issued index
    stages = min(RING_BYTES // stage, (SMEM_MAX - rest) // (stage + 20))
    if (stages < 2 or row_bytes % 16 or K % 16 or sum(parts) != N or min(parts) < 1
            or (fmt == ROW_Q4 and (mats > 1 or len(parts) > 1))
            or any(n % align for n in parts) or (mats > 1 and len(parts) > 1)
            or len(parts) > 3):
        raise ValueError(f"no weight-ring plan for [{N}, {K}] ({row_bytes} bytes a row, "
                         f"stages of {stage} bytes, parts {parts})")
    # more than half an SM's shared memory: one block of a ring kernel an SM,
    # also when the next kernel's blocks start early (PDL) on SMs that free up
    smem = max(stages * (stage + 20) + rest, SMEM_HALF)
    return RingLaunch(N, row_bytes, scale_bytes, mats, grid, R, stages, stage, bg, smem,
                      align, RING_WARPS, parts if len(parts) > 1 else ())


def launch_or_none(B: int, K: int, N: int, fmt: int, mats: int, sms: int, parts=None):
    """``ring_launch``'s plan, or None where it has none."""
    try:
        return ring_launch(B, K, N, fmt, mats, sms, parts)
    except ValueError:
        return None


def c_plan(*launches):
    """The C array of the launches' plans, as the ring's entry points take it."""
    ints = [i for ln in launches for i in ln.ints()]
    return (ctypes.c_int * len(ints))(*ints)


_SMS = {}


def sm_count(device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


@functools.lru_cache(maxsize=None)
def projection_plan(B: int, K: int, N: int, fmt: int, sms: int, parts=None):
    """(plan, its C array) of one MATS-1 projection on the ring (K2's row
    space of ``parts``, K3's o projection), or None where it has none."""
    ln = launch_or_none(B, K, N, fmt, 1, sms, parts)
    return None if ln is None else (ln, c_plan(ln))


def k6_ring_route(B: int, K: int, N: int, dtype, fmt: int, sms: int):
    """K6's routing rule on the ring: (plan, its C array) of x [B, K] @ W.T
    for W [N, K] int8 (``INT8``) or per-row q4 (``ROW_Q4``) where the call takes
    the weight ring (bf16 x, 1 <= B <= 8, and a plan exists: one matrix a
    stage, no norm, no residual), else None."""
    if fmt not in (INT8, ROW_Q4) or not ring_instance(B, dtype, fmt):
        return None
    return projection_plan(B, K, N, fmt, sms)
