"""Loader for the reference's bundled dataset layout.

Layout (depth_sensor.cpp:13-46): a folder containing ``color/*.png``,
``depth/*.png`` (16-bit, millimetres) and ``intr.txt`` with five positive
values ``fx cx fy cy c`` (any separators; values <= 0.1 are skipped, matching
the reference parser). Image size comes from the first color frame.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.io.images import read_color_png, read_depth_png


class BundledDataset:
    def __init__(self, path: str):
        self.path = path
        self.color_files = sorted(glob.glob(os.path.join(path, "color", "*.png")))
        self.depth_files = sorted(glob.glob(os.path.join(path, "depth", "*.png")))
        if not self.color_files or not self.depth_files:
            raise FileNotFoundError(f"no camera! (no frames under {path})")
        self.intrinsics = self._read_intr(os.path.join(path, "intr.txt"))

    def _read_intr(self, intr_path: str) -> Intrinsics:
        with open(intr_path) as f:
            text = f.read()
        vals = [float(v) for v in re.split(r"[\s,;]+", text.strip()) if v]
        vals = [v for v in vals if v > 0.1][:5]
        if len(vals) != 5:
            raise ValueError(f"intr.txt must contain 5 values, got {vals}")
        fx, cx, fy, cy, c = vals
        first = read_color_png(self.color_files[0])
        h, w = first.shape[:2]
        # the 5th value is depth units per metre (1000 for mm, like TUM's
        # 5000) — the reference's > 0.1 parser filter implies the divisor
        # convention (a metres-per-unit scale like 0.001 would be dropped).
        # The reference parses it then ignores it, hardcoding 0.001
        # (image_process.cu:14); here it feeds KinFuParams.depth_scale.
        return Intrinsics(
            width=w, height=h, fx=fx, fy=fy, cx=cx, cy=cy, depth_scale=1.0 / c
        )

    def __len__(self) -> int:
        return min(len(self.color_files), len(self.depth_files))

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(color u8 [H,W,3] RGB, depth f32 [H,W] raw sensor units)."""
        color = read_color_png(self.color_files[i])
        depth = read_depth_png(self.depth_files[i]).astype(np.float32)
        return color, depth

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]


def write_bundled(
    root: str,
    frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    intr: Intrinsics,
    gt_poses: Optional[Sequence[np.ndarray]] = None,
) -> None:
    """Write (depth raw millimetres [H,W], color u8 [H,W,3]) frames in the
    layout above, with intr.txt (5th value 1000 depth units per metre) and,
    when given, gt_poses.txt: world-from-camera 4x4 per frame in the
    reference's doc/poses.txt format, normalised so frame 0 is identity
    (the tracker's frame)."""
    from kinfu_tpu.io.images import write_color_png, write_depth_png
    from kinfu_tpu.io.poses import write_poses_reference_format

    os.makedirs(os.path.join(root, "color"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    for i, (depth_raw, color) in enumerate(frames):
        write_depth_png(
            os.path.join(root, "depth", f"{i:06d}.png"),
            np.round(depth_raw).astype(np.uint16),
        )
        write_color_png(os.path.join(root, "color", f"{i:06d}.png"), color)
    with open(os.path.join(root, "intr.txt"), "w") as f:
        f.write(f"{intr.fx} {intr.cx} {intr.fy} {intr.cy} 1000.0\n")
    if gt_poses is not None:
        T0inv = np.linalg.inv(gt_poses[0])
        write_poses_reference_format(
            os.path.join(root, "gt_poses.txt"), [T0inv @ T for T in gt_poses]
        )
