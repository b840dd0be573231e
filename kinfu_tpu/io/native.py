"""ctypes bindings to the native IO library (native/libkinfu_io.so).

The reference leans on OpenCV's C++ imread/PLY machinery
(depth_sensor.cpp:190-192, kinectfusion.cpp:148-166); the equivalent here is
a small zlib-based C++ PNG codec + PLY writer built by native/Makefile.
Falls back gracefully (available() == False) when the library isn't built —
callers then use the standard-library codec in kinfu_tpu/io/images.py.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native", "libkinfu_io.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.kio_read_png.restype = ctypes.c_int
    lib.kio_read_png.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),  # width
        ctypes.POINTER(ctypes.c_int),  # height
        ctypes.POINTER(ctypes.c_int),  # channels
        ctypes.POINTER(ctypes.c_int),  # bit depth
        ctypes.c_void_p,  # out buffer (caller-allocated max)
        ctypes.c_size_t,  # out buffer capacity
    ]
    lib.kio_write_png.restype = ctypes.c_int
    lib.kio_write_png.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.kio_write_ply.restype = ctypes.c_int
    lib.kio_write_ply.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


_MAX_BYTES = 64 * 1024 * 1024


def _read_png(path: str):
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    bits = ctypes.c_int()
    buf = np.empty(_MAX_BYTES, dtype=np.uint8)
    rc = lib.kio_read_png(
        path.encode(),
        ctypes.byref(w),
        ctypes.byref(h),
        ctypes.byref(ch),
        ctypes.byref(bits),
        buf.ctypes.data_as(ctypes.c_void_p),
        buf.nbytes,
    )
    if rc != 0:
        raise IOError(f"native PNG decode failed ({rc}): {path}")
    return w.value, h.value, ch.value, bits.value, buf


def native_read_png_gray16(path: str) -> np.ndarray:
    w, h, ch, bits, buf = _read_png(path)
    if bits == 16:
        arr = buf[: w * h * ch * 2].view(">u2").astype(np.uint16)
    else:
        arr = buf[: w * h * ch].astype(np.uint16)
    arr = arr.reshape(h, w, ch) if ch > 1 else arr.reshape(h, w)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return np.ascontiguousarray(arr)


def native_read_png_rgb8(path: str) -> np.ndarray:
    w, h, ch, bits, buf = _read_png(path)
    if bits == 16:
        arr = (buf[: w * h * ch * 2].view(">u2") >> 8).astype(np.uint8)
    else:
        arr = buf[: w * h * ch].copy()
    arr = arr.reshape(h, w, ch) if ch > 1 else arr.reshape(h, w)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    elif arr.shape[-1] == 4:
        arr = arr[..., :3]
    return np.ascontiguousarray(arr)


def native_write_png_gray16(path: str, depth: np.ndarray) -> None:
    lib = _load()
    h, w = depth.shape
    be = depth.astype(">u2")
    rc = lib.kio_write_png(
        path.encode(), w, h, 1, 16, be.ctypes.data_as(ctypes.c_void_p)
    )
    if rc != 0:
        raise IOError(f"native PNG encode failed ({rc}): {path}")


def native_write_png_rgb8(path: str, rgb: np.ndarray) -> None:
    lib = _load()
    h, w, _ = rgb.shape
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    rc = lib.kio_write_png(
        path.encode(), w, h, 3, 8, rgb.ctypes.data_as(ctypes.c_void_p)
    )
    if rc != 0:
        raise IOError(f"native PNG encode failed ({rc}): {path}")


def native_write_ply(path: str, points: np.ndarray, binary: bool) -> None:
    lib = _load()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    rc = lib.kio_write_ply(
        path.encode(),
        pts.ctypes.data_as(ctypes.c_void_p),
        pts.shape[0],
        1 if binary else 0,
    )
    if rc != 0:
        raise IOError(f"native PLY write failed ({rc}): {path}")
