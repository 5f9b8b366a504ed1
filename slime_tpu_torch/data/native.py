"""ctypes bindings for the native C++ image preprocessing library.

Port of ``slime_tpu/data/native.py``: one C++ call per image
(``slime_tpu_torch/native/slime_preprocess.cpp``, the port's own copy of
``native/slime_preprocess.cpp``) produces the fixed-shape anyres crop stack
that the PIL path builds in Python. The library is host code, not a kernel.

It is built at first use with the system C++ compiler and ``native/Makefile``'s
flags into ``slime_tpu_torch/_build/``, keyed by a hash of the source and the
flags, so an edited source never loads a stale binary. Where it cannot be
built (no compiler), ``available()`` is False and callers of
``image_ops.process_anyres_image_host(use_native=True)`` fall back to PIL,
with one warning, as the JAX package's contract says.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..constants import IMAGE_WIDTH, MAX_CROPS

SOURCE = Path(__file__).resolve().parent.parent / "native" / "slime_preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()     # loader threads call available() at once
_U8 = ctypes.POINTER(ctypes.c_uint8)
_F32 = ctypes.POINTER(ctypes.c_float)
_INT = ctypes.POINTER(ctypes.c_int)


def _compiler_flags(cxx: str):
    """``native/Makefile``'s flags: -march=native where the compiler takes it."""
    probe = subprocess.run([cxx, "-march=native", "-E", "-x", "c++", os.devnull],
                           capture_output=True)
    return CXXFLAGS + (("-march=native",) if probe.returncode == 0 else ())


def build_native() -> Optional[Path]:
    """The library's path, built from the source if needed; None when no
    compiler can build it."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    flags = _compiler_flags(cxx)
    key = hashlib.sha256(" ".join(flags).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libslime_preprocess_{key}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, so.name)
        proc = subprocess.run([cxx, *flags, "-o", out, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            warnings.warn(f"native preprocess build failed: {proc.stderr[-2000:]}")
            return None
        os.replace(out, so)                  # atomic: no half-written library
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _TRIED
    with _LOCK:
        if not _TRIED:
            _open()
            _TRIED = True
    return _LIB


def _open() -> None:
    global _LIB
    so = build_native()
    if so is None:
        warnings.warn("the native preprocess library could not be built; "
                      "anyres preprocessing falls back to PIL")
        return
    lib = ctypes.CDLL(str(so))
    lib.slime_anyres_preprocess.restype = ctypes.c_int
    lib.slime_anyres_preprocess.argtypes = [_U8, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, _F32, _U8, _INT, _INT]
    lib.slime_square_preprocess.restype = None
    lib.slime_square_preprocess.argtypes = [_U8, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            _F32]
    lib.slime_anyres_preprocess_u8.restype = ctypes.c_int
    lib.slime_anyres_preprocess_u8.argtypes = [_U8, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int, _U8, _U8, _INT,
                                               _INT]
    _LIB = lib


def available() -> bool:
    return _load() is not None


def anyres_preprocess_native(img_hwc: np.ndarray, *, tile: int = IMAGE_WIDTH,
                             max_crops: int = MAX_CROPS, normalize: bool = True
                             ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """uint8 HWC image -> (crops [max_crops, 3, t, t], mask, (cols, rows)).
    ``normalize``: CLIP-normalized float32 crops; else raw uint8 crops (the
    device normalizes those)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native preprocess library is not built")
    img = np.ascontiguousarray(img_hwc, dtype=np.uint8)
    h, w = img.shape[:2]
    mask = np.zeros((max_crops,), np.uint8)
    cols, rows = ctypes.c_int(0), ctypes.c_int(0)
    if normalize:
        out = np.empty((max_crops, 3, tile, tile), np.float32)
        fn, ptr = lib.slime_anyres_preprocess, out.ctypes.data_as(_F32)
    else:
        out = np.empty((max_crops, 3, tile, tile), np.uint8)
        fn, ptr = lib.slime_anyres_preprocess_u8, out.ctypes.data_as(_U8)
    n = fn(img.ctypes.data_as(_U8), h, w, tile, max_crops, ptr, mask.ctypes.data_as(_U8),
           ctypes.byref(cols), ctypes.byref(rows))
    if n <= 0:
        raise ValueError("the crop grid exceeds max_crops")
    return out, mask.astype(bool), (cols.value, rows.value)


def square_preprocess_native(img_hwc: np.ndarray, *, tile: int = IMAGE_WIDTH) -> np.ndarray:
    """uint8 HWC image -> one CLIP-normalized [3, t, t] square resize."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native preprocess library is not built")
    img = np.ascontiguousarray(img_hwc, dtype=np.uint8)
    h, w = img.shape[:2]
    out = np.empty((3, tile, tile), np.float32)
    lib.slime_square_preprocess(img.ctypes.data_as(_U8), h, w, tile, out.ctypes.data_as(_F32))
    return out
