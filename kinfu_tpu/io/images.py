"""Image decoding for dataset loaders.

Primary path: the native C++ PNG codec (native/pngio.cpp, built with zlib by
`make -C native` — the equivalent of the reference's OpenCV imread
dependency, depth_sensor.cpp:190-192). Fallback when that library is not
built: a codec written with the standard library's zlib and numpy, for the
same scope (8/16-bit grey, grey+alpha, RGB and RGBA, non-interlaced). Both
return numpy arrays: depth PNGs as uint16 [H, W], color PNGs as uint8
[H, W, 3] RGB.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> samples per pixel (palette, type 3, is unsupported)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _try_native():
    try:
        from kinfu_tpu.io import native

        return native if native.available() else None
    except Exception:
        return None


_NATIVE = None
_NATIVE_CHECKED = False


def _native():
    global _NATIVE, _NATIVE_CHECKED
    if not _NATIVE_CHECKED:
        _NATIVE = _try_native()
        _NATIVE_CHECKED = True
    return _NATIVE


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray, bpp: int):
    """Reverse one scanline's PNG filter (RFC 2083 section 6)."""
    if ftype == 0:
        return line
    if ftype == 1:  # Sub: running sum per byte lane, mod 256
        lanes = line.reshape(-1, bpp)
        return np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return line + prev
    if ftype not in (3, 4):
        raise ValueError(f"bad PNG filter type {ftype}")
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = up[x]
        if ftype == 3:  # Average
            out[x] = (out[x] + ((a + b) >> 1)) & 0xFF
        else:  # Paeth
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[x] = (out[x] + pred) & 0xFF
    return np.frombuffer(bytes(out), dtype=np.uint8)


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 or uint16 array, [H, W] or [H, W, C]."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, bits, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or bits not in (8, 16) or interlace:
        raise ValueError(
            f"unsupported PNG (colour type {ctype}, {bits}-bit, "
            f"interlace {interlace})"
        )
    ch = _CHANNELS[ctype]
    bpp = ch * bits // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("PNG image data too short")
    rows = raw[: h * (stride + 1)].reshape(h, stride + 1)
    filters = rows[:, 0]
    if not filters.any():
        pix = rows[:, 1:]
    else:
        pix = np.empty((h, stride), dtype=np.uint8)
        prev = np.zeros(stride, dtype=np.uint8)
        for y in range(h):
            prev = pix[y] = _unfilter_row(int(filters[y]), rows[y, 1:], prev, bpp)
    if bits == 16:
        arr = pix.reshape(-1).view(">u2").astype(np.uint16).reshape(h, w * ch)
    else:
        arr = np.ascontiguousarray(pix)
    return arr.reshape(h, w, ch) if ch > 1 else arr.reshape(h, w)


def png_encode(arr: np.ndarray) -> bytes:
    """uint8/uint16 [H, W] grey or [H, W, 3] RGB -> PNG bytes (filter None
    on every row, zlib default compression)."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG encode needs uint8 or uint16, got {arr.dtype}")
    if arr.ndim == 2:
        ctype = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"PNG encode needs [H,W] or [H,W,3], got {arr.shape}")
    h, w = arr.shape[:2]
    bits = 8 * arr.dtype.itemsize
    body = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder(">"))
    body = body.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), body], axis=1)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(payload, zlib.crc32(tag))
        return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, bits, ctype, 0, 0, 0)
    return (
        _SIG
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw.tobytes()))
        + chunk(b"IEND", b"")
    )


def _read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return png_decode(f.read())


def read_depth_png(path: str) -> np.ndarray:
    """16-bit (or 8-bit) grayscale depth PNG -> uint16 [H, W]."""
    nat = _native()
    if nat is not None:
        return nat.native_read_png_gray16(path)
    arr = _read_png(path)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint16)


def read_color_png(path: str) -> np.ndarray:
    """Color PNG -> uint8 [H, W, 3] RGB."""
    nat = _native()
    if nat is not None:
        return nat.native_read_png_rgb8(path)
    arr = _read_png(path)
    if arr.dtype == np.uint16:
        arr = (arr >> 8).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    elif arr.shape[-1] == 2:  # grey + alpha
        arr = np.repeat(arr[..., :1], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def write_depth_png(path: str, depth: np.ndarray) -> None:
    nat = _native()
    depth = np.asarray(depth, dtype=np.uint16)
    if nat is not None:
        nat.native_write_png_gray16(path, depth)
        return
    with open(path, "wb") as f:
        f.write(png_encode(depth))


def write_color_png(path: str, rgb: np.ndarray) -> None:
    nat = _native()
    rgb = np.asarray(rgb, dtype=np.uint8)
    if nat is not None:
        nat.native_write_png_rgb8(path, rgb)
        return
    with open(path, "wb") as f:
        f.write(png_encode(rgb))
