"""P4: the q4g load / unpack / dot probe on the card.

Counterpart of the TPU probe ``run`` in ``scripts/bench_q4g_unpack_probe.py``
(:90, kernel ``kern`` :54), which isolated the weight stream from the nibble
unpack of K1's and K7's q4g weights. One hand-written kernel
(``csrc/int4_probes.cu`` ``p4_stream_kernel``) streams a stacked q4g
gate_proj, [L, I, H / 2] = [32, 14336, 2048] int8 (0.94 GB), in three modes
(``MODES``): ``dma`` (load and integer-sum the bytes), ``unpack`` (load,
unpack to bf16 with K7's exact conversion, sum the values) and
``unpack_dot`` (load, unpack, per-group dot with a [1, H] bf16 activation).
Each mode is held to its plain version (``plain``), and both keep the JAX
kernel's checksum output: an [8, 128] fp32 block that, for ``dma`` and
``unpack``, holds the total everywhere and, for ``unpack_dot``, sums the
rows' dots per position of JAX's ``bi``-row blocks (bi >= 1024) or the
total (``checksum``). Each mode prints ``q4g_probe_<mode>_b<bi>`` in ms and
GB/s, then the unpack overhead (``unpack - dma``): whether the unpack hides
behind the weight stream.

Run on a machine with a CUDA card and nvcc, from the repository root:

    python3 -m slime_tpu_torch.probes.q4g_unpack
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import cuda_ms
from ..ops import _cuda

SHAPE = (32, 14336, 4096)         # (L, I, H): H unpacked, stored as H / 2 bytes
BLOCK = 1024                      # JAX's bi (SLIME_PROBE_BLOCK's default)
GROUP = 128
MODES = {"dma": 0, "unpack": 1, "unpack_dot": 2}


def make_inputs(device, seed: int = 0, shape=SHAPE):
    """The packed stack (uniform bytes) and h [1, H] bf16 (N(0, 0.1)), from
    a seeded generator on ``device``."""
    L, I, H = shape
    g = torch.Generator(device=device).manual_seed(seed)
    packed = torch.randint(-128, 128, (L, I, H // 2), dtype=torch.int8, device=device,
                           generator=g)
    h = (torch.randn((1, H), device=device, generator=g) * 0.1).to(torch.bfloat16)
    return packed, h


def unpack_rows(p: torch.Tensor) -> torch.Tensor:
    """[..., H / 2] packed q4g -> [..., H] signed values in group order:
    block b's low nibbles are group 2b, its high nibbles group 2b + 1."""
    u = p.to(torch.int32) & 0xFF
    lo = (((u & 0xF) ^ 8) - 8).unflatten(-1, (-1, GROUP))
    hi = ((((u >> 4) & 0xF) ^ 8) - 8).unflatten(-1, (-1, GROUP))
    return torch.stack([lo, hi], dim=-2).flatten(-3)


def plain(mode: str, packed: torch.Tensor, h: torch.Tensor):
    """The mode's plain result: an exact integer total (``dma``: the signed
    bytes; ``unpack``: the nibble values) or ``unpack_dot``'s y [L * I] fp32
    (each row's dot with h over the unpacked groups, fp32 sums). One layer
    at a time, so the unpacked values of one layer are live at once."""
    total, ys = 0, []
    for layer in packed:
        if mode == "dma":
            total += int(layer.to(torch.int64).sum())
        elif mode == "unpack":
            total += int(unpack_rows(layer).to(torch.int64).sum())
        else:
            ys.append(torch.matmul(unpack_rows(layer).to(torch.float32),
                                   h.to(torch.float32)[0]))
    return total if mode != "unpack_dot" else torch.cat(ys)


def checksum(mode: str, result, bi: int = BLOCK) -> torch.Tensor:
    """The TPU kernel's [8, 128] output from a mode's result: the total in
    every element (``dma``, ``unpack``); for ``unpack_dot`` with bi >= 1024,
    element j the sum over bi-row blocks of row j's dot, else the sum of all
    dots everywhere."""
    if mode != "unpack_dot":
        return torch.full((8, 128), float(result), dtype=torch.float32)
    y = result.to(torch.float32).reshape(-1, bi)
    if bi >= 8 * 128:
        return y[:, :8 * 128].sum(dim=0).reshape(8, 128)
    return torch.full((8, 128), float(y.sum()), dtype=torch.float32)


def stream(mode: str, packed: torch.Tensor, h: torch.Tensor):
    """One launch of the probe kernel in ``mode`` -> the same result as
    ``plain`` (an int total, or y [rows] fp32 on the card)."""
    _cuda.require_cuda(packed, h)
    rows = packed.numel() // packed.shape[-1]
    if (packed.dtype != torch.int8 or packed.shape[-1] != 2048 or not packed.is_contiguous()
            or h.shape != (1, 4096) or h.dtype != torch.bfloat16 or mode not in MODES):
        raise ValueError("P4 takes packed int8 [..., 2048] (H = 4096), h [1, 4096] bf16, "
                         f"mode in {list(MODES)}")
    total = torch.zeros((), dtype=torch.int64, device=packed.device)
    y = torch.empty((rows,), dtype=torch.float32, device=packed.device)
    sms = torch.cuda.get_device_properties(packed.device).multi_processor_count
    _cuda.check(_cuda.library().slime_p4_stream(
        MODES[mode], packed.data_ptr(), rows, h.contiguous().data_ptr(), total.data_ptr(),
        y.data_ptr(), 8 * sms, _cuda.stream()), "p4_stream")
    stream.launches += 1
    return y if mode == "unpack_dot" else total


stream.launches = 0


def run(device=None, *, runs: int = 10, seed: int = 0, log=print):
    """Check each mode against its plain version (totals exactly, dots at
    fp32 tolerance, and the checksums), time them (the 0.94 GB stack is far
    past the 50 MB L2, so no flush is needed) and print one JSON line each
    plus the overhead line; returns {mode: {ms, gbps, max_abs_err}} and the
    plain versions' times."""
    if not torch.cuda.is_available():
        raise RuntimeError("the P4 probe runs on a CUDA card")
    dev = torch.device(device) if device is not None else torch.device("cuda")
    packed, h = make_inputs(dev, seed)
    gb = packed.numel() / 1e9
    res, plain_ms = {}, {}
    for mode in MODES:
        got, want = stream(mode, packed, h), plain(mode, packed, h)
        if mode == "unpack_dot":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4,
                                       msg=lambda m: f"P4 {mode}: {m}")
            err = (got - want).abs().max().item()
            got, want = got.cpu(), want.cpu()
        else:
            got = int(got)
            err = abs(got - want)
            if err:
                raise AssertionError(f"P4 {mode}: total {got} != plain {want}")
        torch.testing.assert_close(checksum(mode, got), checksum(mode, want), rtol=1e-5,
                                   atol=1e-2, msg=lambda m: f"P4 {mode} checksum: {m}")
        ms = cuda_ms(lambda: stream(mode, packed, h), runs)
        plain_ms[mode] = cuda_ms(lambda: plain(mode, packed, h), 2)
        res[mode] = {"ms": ms, "gbps": gb / ms * 1e3, "max_abs_err": err}
        log(json.dumps({"metric": f"q4g_probe_{mode}_b{BLOCK}", "value": ms,
                        "unit": f"ms for {gb:.2f} GB packed ({gb / ms * 1e3:.0f} GB/s "
                                f"effective)"}))
    log(json.dumps({"metric": "q4g_probe_unpack_overhead",
                    "value": res["unpack"]["ms"] - res["dma"]["ms"],
                    "unit": f"ms unpack cost per {gb:.2f} GB packed (dot adds "
                            f"{res['unpack_dot']['ms'] - res['unpack']['ms']:.4f} ms)"}))
    return res, plain_ms


def kern_numpy(mode: str, packed: np.ndarray, h: np.ndarray, bi: int) -> np.ndarray:
    """A numpy rewrite of the JAX probe's ``kern`` run over its grid (fp32
    accumulation block by block, as the TPU kernel does): the [8, 128]
    checksum, for the CPU tests."""
    L, I, HP = packed.shape
    o = np.zeros((8, 128), np.float32)
    x = h.astype(np.float32)
    for c in range(L * (I // bi)):
        blk = packed[c // (I // bi), (c % (I // bi)) * bi:(c % (I // bi) + 1) * bi]
        p = blk.astype(np.int32)
        if mode == "dma":
            o += np.float32(p.sum())
            continue
        acc = np.float32(0) if mode == "unpack" else None
        for b in range(HP // GROUP):
            pg = p[:, b * GROUP:(b + 1) * GROUP]
            lo = ((pg << 28) >> 28).astype(np.float32)
            hi = ((pg << 24) >> 28).astype(np.float32)
            if mode == "unpack":
                acc = acc + lo.sum(dtype=np.float32) + hi.sum(dtype=np.float32)
                continue
            for j, w in ((0, lo), (1, hi)):
                gi = 2 * b + j
                y = (x[:, gi * GROUP:(gi + 1) * GROUP] @ w.T).astype(np.float32)
                acc = y if acc is None else acc + y
        if mode == "unpack":
            o += acc
        elif acc.shape[-1] >= 8 * 128:
            o += acc[0, :8 * 128].reshape(8, 128)
        else:
            o += np.float32(acc.sum())
    return o


if __name__ == "__main__":
    run()
