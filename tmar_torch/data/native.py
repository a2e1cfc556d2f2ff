"""ctypes bindings for the native host-side data-path library (the port's own
copy of ``tmar.data.native``).

The C++ source is ``tmar_torch/native/tmar_host.cc``.  At first use it is
compiled with ``g++`` (the flags of ``native/Makefile``) into
``tmar_torch/kernels/_build/libtmar_host-<hash>.so``, the hash covering the
source and the flags, so an edited source rebuilds.  Every function has a
numpy version that computes the same result; it runs when no compiler is
found, and ``available()`` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "tmar_host.cc")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_error: Optional[str] = None  # why the library is missing, once a load failed


def library_path() -> str:
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtmar_host-{h.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build finds a whole file or none


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    global _lib, build_error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            if not build:
                return None
            try:
                _build(path)
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                build_error = str(e)
                return None
        lib = ctypes.CDLL(path)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64

        lib.tmar_normalize01_pm1.argtypes = [f32p, f32p, i64]
        lib.tmar_hu_window.argtypes = [f32p, f32p, i64, ctypes.c_float, ctypes.c_float]
        lib.tmar_assemble_batch.argtypes = [
            f32p, f32p, i64, i64, i64, i64, i64, i64, i32p, i32p, u8p, u8p,
        ]
        lib.tmar_metal_mask_dilate.argtypes = [f32p, f32p, i64, i64, ctypes.c_float, ctypes.c_int]
        lib.tmar_li_rowwise.argtypes = [f32p, u8p, f32p, i64, i64]
        lib.tmar_li_rowwise.restype = i64
        lib.tmar_li_colwise.argtypes = [f32p, u8p, f32p, i64, i64]
        lib.tmar_li_colwise.restype = i64
        _lib = lib
        return lib


def available() -> bool:
    """True when the compiled library runs; False when the numpy versions do
    (``build_error`` then says why)."""
    return load_library() is not None


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# ---- the numpy versions: the plain reference of each C++ function ----------

def normalize01_pm1_np(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0, 1) * 2 - 1).astype(np.float32)


def hu_window_np(x: np.ndarray, hu_min: float = -1000.0, hu_max: float = 2000.0) -> np.ndarray:
    v = np.clip(x, hu_min, hu_max)
    return (((v - hu_min) / (hu_max - hu_min)) * 2 - 1).astype(np.float32)


def assemble_batch_np(samples, patch, rows, cols, hflip, vflip) -> np.ndarray:
    B, K = samples.shape[:2]
    out = np.empty((B, K, patch, patch), np.float32)
    for b in range(B):
        sl = samples[b, :, rows[b] : rows[b] + patch, cols[b] : cols[b] + patch]
        if hflip[b]:
            sl = sl[:, :, ::-1]
        if vflip[b]:
            sl = sl[:, ::-1, :]
        out[b] = sl
    return out


def metal_mask_dilate_np(img: np.ndarray, threshold: float = 0.6, radius: int = 5) -> np.ndarray:
    from scipy.ndimage import maximum_filter

    m = (img > threshold).astype(np.float32)
    return maximum_filter(m, size=2 * radius + 1, mode="constant") if radius else m


def li_interpolate_np(img: np.ndarray, mask_u8: np.ndarray) -> np.ndarray:
    H, W = img.shape
    out = img.copy()
    xs = np.arange(W)
    for r in range(H):
        m = mask_u8[r].astype(bool)
        if m.any() and (~m).sum() >= 2:
            out[r, m] = np.interp(xs[m], xs[~m], out[r, ~m])
    ys = np.arange(H)
    for c in range(W):
        m = mask_u8[:, c].astype(bool) & (out[:, c] == img[:, c])
        if m.any() and (~m).sum() >= 2:
            out[m, c] = np.interp(ys[m], ys[~m], out[~m, c])
    return out


# ---- the entry points: the library when it loads, else the numpy versions --

def normalize01_pm1(x: np.ndarray) -> np.ndarray:
    lib = load_library()
    x = np.ascontiguousarray(x, np.float32)
    if lib is None:
        return normalize01_pm1_np(x)
    out = np.empty_like(x)
    lib.tmar_normalize01_pm1(_f32(x), _f32(out), x.size)
    return out


def hu_window(x: np.ndarray, hu_min: float = -1000.0, hu_max: float = 2000.0) -> np.ndarray:
    lib = load_library()
    x = np.ascontiguousarray(x, np.float32)
    if lib is None:
        return hu_window_np(x, hu_min, hu_max)
    out = np.empty_like(x)
    lib.tmar_hu_window(_f32(x), _f32(out), x.size, hu_min, hu_max)
    return out


def assemble_batch(
    samples: np.ndarray,
    patch: int,
    rows: Sequence[int],
    cols: Sequence[int],
    hflip: Sequence[bool],
    vflip: Sequence[bool],
) -> np.ndarray:
    """samples [B, K, H, W] float32 -> cropped/flipped [B, K, patch, patch]."""
    samples = np.ascontiguousarray(samples, np.float32)
    B, K, H, W = samples.shape
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    hf = np.ascontiguousarray(hflip, np.uint8)
    vf = np.ascontiguousarray(vflip, np.uint8)
    lib = load_library()
    if lib is None:
        return assemble_batch_np(samples, patch, rows, cols, hf, vf)
    out = np.empty((B, K, patch, patch), np.float32)
    lib.tmar_assemble_batch(
        _f32(samples), _f32(out), B, K, H, W, patch, patch,
        _i32(rows), _i32(cols), _u8(hf), _u8(vf),
    )
    return out


def metal_mask_dilate(img: np.ndarray, threshold: float = 0.6, radius: int = 5) -> np.ndarray:
    img = np.ascontiguousarray(img, np.float32)
    H, W = img.shape
    lib = load_library()
    if lib is None:
        return metal_mask_dilate_np(img, threshold, radius)
    out = np.empty_like(img)
    lib.tmar_metal_mask_dilate(_f32(img), _f32(out), H, W, threshold, radius)
    return out


def li_interpolate(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Pseudo-clean LI: row-wise then column-wise masked linear interpolation
    (the column pass fixes what the row pass could not: fully masked rows)."""
    img = np.ascontiguousarray(img, np.float32)
    mask_u8 = np.ascontiguousarray(mask > 0, np.uint8)
    H, W = img.shape
    lib = load_library()
    if lib is None:
        return li_interpolate_np(img, mask_u8)
    tmp = np.empty_like(img)
    lib.tmar_li_rowwise(_f32(img), _u8(mask_u8), _f32(tmp), H, W)
    remaining = (mask_u8 > 0) & (tmp == img)
    if remaining.any():
        out = np.empty_like(img)
        lib.tmar_li_colwise(_f32(tmp), _u8(np.ascontiguousarray(remaining, np.uint8)), _f32(out), H, W)
        return out
    return tmp
