"""Build and load the port's hand-written CUDA kernels (``slime_tpu_torch/csrc``).

Every ``csrc/*.cu`` compiles with nvcc for ``sm_90a`` (one nvcc process per
source, all started together) and links into one shared library with a plain
C interface, loaded with ctypes. The build runs at first use into
``slime_tpu_torch/_build/``, keyed by a hash of the sources, the headers
(``csrc/*.cuh``) and the flags, so a checkout builds once and a changed source
rebuilds. Importing this module builds nothing: the CPU tests import every
module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_LLP = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "slime_rms_norm": [_I, _P, _P, _P, _I, _I, _F, _P],
    "slime_qkv_gemv": [_I, _I, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _I,
                       _P, _P, _P, _P],
    "slime_resid_gemv": [_I, _I, _P, _I, _I, _P, _P, _I, _P, _P, _P],
    "slime_gate_up_gemv": [_I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P],
    "slime_mlp_ring": [_I, _I, _I, _P, _P, _F, _P, _P, _P, _I, _I, _I] + [_P] * 8,
    "slime_qkv_ring": [_I, _I, _P, _P, _F, _I, _I, _I, _I] + [_P] * 11,
    "slime_o_ring": [_I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "slime_mlp_wgmma": [_I, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I] + [_P] * 6 + [_I, _I, _P],
    "slime_o_wgmma": [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P],
    "slime_qkv_wgmma": [_I, _P, _P, _F, _P, _P, _I, _I, _I, _I] + [_P] * 9 + [_I, _I, _P],
    "slime_quant_ring": [_I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "slime_encoder_attention": [_P, _P, _P, _P, _I, _I, _I, _I]
                               + [_LL] * 9 + [_F, _I, _I, _P],
    "slime_flash_fwd": [_P] * 6 + [_LLP] + [_I] * 7 + [_F, _I, _P],
    "slime_flash_bwd_dkdv": [_P] * 9 + [_LLP] + [_I] * 7 + [_F, _P],
    "slime_flash_bwd_dq": [_P] * 8 + [_LLP] + [_I] * 7 + [_F, _P],
    "slime_ring_attend": [_P] * 9 + [_LLP] + [_I] * 11 + [_F, _P],
    "slime_quant_matmul": [_I, _I, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P],
    "slime_quant_matmul_f32_tiles": [_I, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P],
    "slime_quant_matmul_q4g_wgmma": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P],
    "slime_quant_matmul_wgmma": [_I, _I, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P],
    "slime_w8a8_matmul": [_I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P],
    "slime_int8_dot": [_I, _I, _P, _I, _I, _P, _I, _P, _I, _P],
    "slime_hopper_selftest": [_P] * 9,
    "slime_hopper_selftest_s8": [_P] * 5,
    "slime_bulk_selftest": [_P, _P, _I, _I, _P],
    "slime_p1_matvec": [_I, _I, _P, _P, _P, _P, _I, _P],
    "slime_p4_stream": [_I, _P, _LL, _P, _P, _P, _I, _P],
}

# the loaded library, and the seconds nvcc took if this process built it
_lib = None
build_seconds = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels cannot be built")
    return path


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/*.cu`` if needed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        key.update(src.name.encode())
        key.update(src.read_bytes())
    so = BUILD_DIR / f"libslime_kernels_{key.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            objs = [os.path.join(tmp, f"{src.stem}.o") for src in sources]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)
                     for src, obj in zip(sources, objs)]
            errors = []
            for src, proc in zip(sources, procs):
                _, err = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"{src.name} (exit {proc.returncode}):\n{err}")
            if errors:
                raise RuntimeError("nvcc failed: " + "\n".join(errors))
            lib_tmp = os.path.join(tmp, so.name)
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(lib_tmp, so)           # atomic: no half-written library
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.slime_error_string.argtypes = [ctypes.c_int]
    lib.slime_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = library().slime_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream() -> int:
    """The current PyTorch CUDA stream, as the ``cudaStream_t`` the kernels take."""
    return torch.cuda.current_stream().cuda_stream


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless ``tensors`` all lie on the current CUDA device (the one
    the kernels launch on)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"kernel inputs must lie on the current CUDA device "
                             f"{dev}, got {[str(x.device) for x in tensors]}")


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t`` with TMA tiles (or 16-byte loads):
    unit stride over the last dim, 16-byte aligned data, and the stride of
    every other dim longer than 1 a multiple of 16 bytes. A pure function of
    the tensor's layout, so CPU tests can check it."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * size % 16 == 0
                    for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels can read it by TMA (``tma_ready``), else a fresh
    contiguous copy they can: the wrappers launch the same kernel on the
    copy, so an unaligned view computes instead of raising."""
    return t if tma_ready(t) else t.clone(memory_format=torch.contiguous_format)


def tma_strides(t: torch.Tensor, dims):
    """Element strides of ``t`` over ``dims``; a dim of length 1 (always at
    coordinate 0) gets a 16-byte multiple instead of whatever torch gave it,
    so the tensor map takes it."""
    fill = -(-t.numel() // 8) * 8
    return [t.stride(d) if t.shape[d] > 1 else fill for d in dims]


def longs(values):
    """A C array of 64-bit ints (the stride tables the flash kernels take)."""
    return (ctypes.c_longlong * len(values))(*values)


def ptr(t):
    """Device pointer of ``t`` (None for a missing optional tensor)."""
    return None if t is None else t.data_ptr()


def hopper_selftest(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor):
    """Run ``csrc/hopper_selftest.cu`` on contiguous bf16 a, b [64, 64] and v
    [64, 128] on the card -> (s = a . b^T, o = bf16(s) . v [64, 128], t =
    b . a^T, p1 = bf16(s) . b, p2 = bf16(t) . a) in fp32: one TMA load, and
    every operand form of the attention kernels' tile vocabulary
    (``hopper_common.cuh``): SS wgmma with both operands K-major either way
    round, RS wgmma from the accumulator's register fragments with the
    shared operand read MN-major (v over two 64-column chunks; b and a, the
    tiles s and t read K-major)."""
    require_cuda(a, b, v)
    for t, shape in ((a, (64, 64)), (b, (64, 64)), (v, (64, 128))):
        if t.shape != shape or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"hopper_selftest takes contiguous bf16 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    s, t, p1, p2 = (torch.empty((64, 64), dtype=torch.float32, device=a.device)
                    for _ in range(4))
    o = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    check(library().slime_hopper_selftest(a.data_ptr(), b.data_ptr(), v.data_ptr(),
                                          s.data_ptr(), o.data_ptr(), t.data_ptr(),
                                          p1.data_ptr(), p2.data_ptr(), stream()),
          "hopper_selftest")
    return s, o, t, p1, p2


def hopper_selftest_s8(a: torch.Tensor, b: torch.Tensor):
    """Run the int8 self-test of ``csrc/hopper_selftest.cu`` on contiguous
    int8 a [64, 256] and b [256, 256] on the card -> (c128 = a . b[:128]^T
    [64, 128], c256 = a . b^T [64, 256]) in int32: TMA loads of 128-byte
    int8 boxes over two K chunks, and the SS s8 ``wgmma`` (both operands
    K-major) of P3 and K8 at N = 128 and 256 over 8 k32 steps."""
    require_cuda(a, b)
    for t, shape in ((a, (64, 256)), (b, (256, 256))):
        if t.shape != shape or t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError(f"hopper_selftest_s8 takes contiguous int8 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    c128 = torch.empty((64, 128), dtype=torch.int32, device=a.device)
    c256 = torch.empty((64, 256), dtype=torch.int32, device=a.device)
    check(library().slime_hopper_selftest_s8(a.data_ptr(), b.data_ptr(), c128.data_ptr(),
                                             c256.data_ptr(), stream()),
          "hopper_selftest_s8")
    return c128, c256


def bulk_selftest(src: torch.Tensor, bytes0: int, bytes1: int) -> torch.Tensor:
    """Run the 1-D bulk copy self-test of ``csrc/hopper_selftest.cu``: the
    first bytes0 + bytes1 bytes of ``src`` (contiguous uint8 on the card,
    16-byte aligned) through shared memory by two bulk copies on one
    mbarrier (``bulk_load``, the decode weight ring's copy) -> a new uint8
    tensor of those bytes. Sizes must be multiples of 16 bytes."""
    require_cuda(src)
    n = bytes0 + bytes1
    if (src.dtype != torch.uint8 or src.dim() != 1 or not src.is_contiguous()
            or src.data_ptr() % 16 or bytes0 % 16 or bytes1 % 16 or min(bytes0, bytes1) < 16
            or src.numel() < n):
        raise ValueError(f"bulk_selftest takes 16-byte aligned contiguous uint8 of at least "
                         f"{n} bytes and sizes that are multiples of 16, got {src.dtype} "
                         f"{tuple(src.shape)} at {src.data_ptr() % 16} mod 16, {bytes0}, "
                         f"{bytes1}")
    dst = torch.empty(n, dtype=torch.uint8, device=src.device)
    check(library().slime_bulk_selftest(src.data_ptr(), dst.data_ptr(), bytes0, bytes1,
                                        stream()), "bulk_selftest")
    return dst
