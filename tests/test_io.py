"""IO round-trip tests: PNG codec (native C++ + standard-library fallback),
PLY, trajectory formats, and the bundled-dataset loader.

The reference has no tests at all (SURVEY.md section 4); its IO is OpenCV
imread/imwrite (depth_sensor.cpp:190-196) and a hand-rolled ascii PLY writer
(kinectfusion.cpp:148-166)."""

import os
import struct
import zlib

import numpy as np
import pytest

from kinfu_tpu.io import images
from kinfu_tpu.io.images import (
    png_decode,
    png_encode,
    read_color_png,
    read_depth_png,
    write_color_png,
    write_depth_png,
)
from kinfu_tpu.io.ply import read_ply, write_ply
from kinfu_tpu.io.poses import (
    read_poses_reference_format,
    write_poses_reference_format,
)


def test_depth_png_roundtrip(tmp_path):
    d = np.random.default_rng(0).integers(0, 60000, (48, 64)).astype(np.uint16)
    p = str(tmp_path / "d.png")
    write_depth_png(p, d)
    back = read_depth_png(p)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, d)


def test_color_png_roundtrip(tmp_path):
    c = np.random.default_rng(1).integers(0, 256, (48, 64, 3)).astype(np.uint8)
    p = str(tmp_path / "c.png")
    write_color_png(p, c)
    np.testing.assert_array_equal(read_color_png(p), c)


def _sample_image(kind, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "grey16":
        return rng.integers(0, 65536, (h, w)).astype(np.uint16)
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("kind", ["grey16", "rgb8"])
@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (33, 17)])
def test_stdlib_png_roundtrip_odd_sizes(kind, hw):
    arr = _sample_image(kind, *hw)
    back = png_decode(png_encode(arr))
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_with_filter(arr, ftype):
    """Encode with one PNG filter type on every row, written per byte from
    RFC 2083 section 6 — independent of the codec under test."""
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    bits = 8 * arr.dtype.itemsize
    bpp = ch * bits // 8
    raw = np.ascontiguousarray(arr, arr.dtype.newbyteorder(">")).view(np.uint8)
    raw = raw.reshape(h, -1).astype(int)
    out = bytearray()
    for y in range(h):
        out.append(ftype)
        for x in range(raw.shape[1]):
            a = raw[y, x - bpp] if x >= bpp else 0
            b = raw[y - 1, x] if y else 0
            c = raw[y - 1, x - bpp] if (y and x >= bpp) else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][ftype]
            out.append((raw[y, x] - pred) % 256)
    ctype = {1: 0, 3: 2, 4: 6}[ch]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_stdlib_png_decodes_every_filter_type(ftype):
    for arr in (_sample_image("rgb8", 9, 11, ftype),
                _sample_image("grey16", 6, 5, ftype)):
        np.testing.assert_array_equal(png_decode(_png_with_filter(arr, ftype)), arr)


@pytest.mark.parametrize("kind", ["grey16", "rgb8"])
def test_stdlib_png_agrees_with_pillow(kind):
    """Pillow (where installed) reads what the codec writes, and the codec
    reads what Pillow writes with its own adaptive filters."""
    import io

    Image = pytest.importorskip("PIL.Image")
    yy, xx = np.mgrid[:45, :71]
    arr = _sample_image(kind, 45, 71, 3)
    arr[::3] = ((yy + 2 * xx)[::3] * 37 % 251)[..., None] if arr.ndim == 3 else (
        (yy + 2 * xx)[::3] * 97
    )
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png_encode(arr)))), arr)
    buf = io.BytesIO()
    if kind == "grey16":
        Image.fromarray(arr.astype(np.int32), "I").convert("I;16").save(buf, "PNG")
    else:
        Image.fromarray(arr, "RGB").save(buf, "PNG")
    np.testing.assert_array_equal(png_decode(buf.getvalue()), arr)


def test_fallback_readers_convert_channels(tmp_path, monkeypatch):
    """Without the native library, colour readers return RGB from grey and
    RGBA files, and depth readers the first channel."""
    monkeypatch.setattr(images, "_native", lambda: None)
    rgba = np.random.default_rng(7).integers(0, 256, (5, 6, 4)).astype(np.uint8)
    p = tmp_path / "rgba.png"
    p.write_bytes(_png_with_filter(rgba, 1))
    np.testing.assert_array_equal(read_color_png(str(p)), rgba[..., :3])
    grey = rgba[..., 0].copy()
    p.write_bytes(_png_with_filter(grey, 2))
    np.testing.assert_array_equal(read_color_png(str(p)), np.repeat(grey[..., None], 3, -1))
    np.testing.assert_array_equal(read_depth_png(str(p)), grey.astype(np.uint16))
    d = _sample_image("grey16", 4, 9)
    write_depth_png(str(tmp_path / "d.png"), d)
    np.testing.assert_array_equal(read_depth_png(str(tmp_path / "d.png")), d)


def test_native_and_pil_agree(tmp_path):
    """When the native codec is built, it must agree with PIL both ways."""
    from kinfu_tpu.io import native

    if not native.available():
        pytest.skip("native IO library not built")
    from PIL import Image

    d = np.random.default_rng(2).integers(0, 65535, (32, 40)).astype(np.uint16)
    p1 = str(tmp_path / "native.png")
    native.native_write_png_gray16(p1, d)
    np.testing.assert_array_equal(np.asarray(Image.open(p1)), d)

    c = np.random.default_rng(3).integers(0, 256, (32, 40, 3)).astype(np.uint8)
    p2 = str(tmp_path / "pil.png")
    Image.fromarray(c, "RGB").save(p2)
    np.testing.assert_array_equal(native.native_read_png_rgb8(p2), c)


@pytest.mark.parametrize("binary", [False, True])
def test_ply_roundtrip(tmp_path, binary):
    pts = np.random.default_rng(4).normal(size=(257, 3)).astype(np.float32)
    p = str(tmp_path / "cloud.ply")
    write_ply(p, pts, binary=binary)
    back = read_ply(p)
    np.testing.assert_allclose(back, pts, atol=0 if binary else 1e-4)


def test_poses_reference_format_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    poses = []
    for _ in range(4):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.normal(size=3)
        poses.append(T)
    p = str(tmp_path / "poses.txt")
    write_poses_reference_format(p, poses)
    back = read_poses_reference_format(p)
    assert len(back) == 4
    for a, b in zip(poses, back):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_reference_golden_poses_parse():
    """The format parser must read the reference's own doc/poses.txt."""
    path = "/root/reference/doc/poses.txt"
    if not os.path.exists(path):
        pytest.skip("reference not mounted")
    poses = read_poses_reference_format(path)
    assert len(poses) == 50
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-6)
    # all valid rigid transforms: R orthonormal, det +1
    for T in poses:
        R = T[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
        assert np.linalg.det(R) > 0.9


def test_bundled_dataset_loader(tmp_path):
    from kinfu_tpu.data.bundled import BundledDataset

    os.makedirs(tmp_path / "color")
    os.makedirs(tmp_path / "depth")
    rng = np.random.default_rng(6)
    for i in range(3):
        write_color_png(
            str(tmp_path / "color" / f"{i:04d}.png"),
            rng.integers(0, 256, (24, 32, 3)).astype(np.uint8),
        )
        write_depth_png(
            str(tmp_path / "depth" / f"{i:04d}.png"),
            rng.integers(0, 5000, (24, 32)).astype(np.uint16),
        )
    (tmp_path / "intr.txt").write_text("525.0 159.5 525.0 119.5 1000\n")
    ds = BundledDataset(str(tmp_path))
    assert len(ds) == 3
    assert ds.intrinsics.width == 32 and ds.intrinsics.height == 24
    assert ds.intrinsics.fx == 525.0
    # 5th value is units-per-metre; loader exposes metres-per-unit
    assert abs(ds.intrinsics.depth_scale - 1e-3) < 1e-9
    color, depth = ds[0]
    assert color.shape == (24, 32, 3) and depth.shape == (24, 32)
    assert depth.dtype == np.float32


def test_bundled_dataset_missing(tmp_path):
    from kinfu_tpu.data.bundled import BundledDataset

    with pytest.raises(FileNotFoundError):
        BundledDataset(str(tmp_path / "nope"))
