"""Sensor abstraction — the runtime equivalent of the reference's L4 layer.

The reference selects one of three backends at *compile time* with #define
DATASET / KINECT2 / REALSENSE (depth_sensor.h:4-15) and exposes
`open/getFrame/release` plus the intrinsics (depth_sensor.h:20-49). Here the
same surface is a runtime-pluggable interface:

  - DatasetSensor: replays a BundledDataset or TUMDataset folder
    (depth_sensor.cpp:186-196 semantics — pops the next frame pair)
  - SyntheticSensor: renders an analytic scene along a trajectory (test /
    bench backend; no reference equivalent)
  - Live Kinect/RealSense backends require their vendor SDKs, which do not
    are not installed here; `open_sensor("kinect2"|"realsense")` raises a
    clear error pointing at the dataset replay path instead
    (depth_sensor.cpp:48-131 is the reference's host-side implementation).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from kinfu_tpu.geometry.intrinsics import Intrinsics


class Sensor:
    """getFrame() -> (color u8 [H,W,3] RGB, depth f32 [H,W] raw units) or
    None when the stream ends. `intrinsics.depth_scale` converts depth units
    to metres."""

    intrinsics: Intrinsics

    def get_frame(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def release(self) -> None:
        pass

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            f = self.get_frame()
            if f is None:
                return
            yield f


class DatasetSensor(Sensor):
    def __init__(self, path: str, kind: str = "auto"):
        import os

        if kind == "auto":
            kind = "tum" if os.path.exists(os.path.join(path, "rgb.txt")) else "bundled"
        if kind == "tum":
            from kinfu_tpu.data.tum import TUMDataset

            self.dataset = TUMDataset(path)
        else:
            from kinfu_tpu.data.bundled import BundledDataset

            self.dataset = BundledDataset(path)
        self.intrinsics = self.dataset.intrinsics
        self._i = 0

    def get_frame(self):
        if self._i >= len(self.dataset):
            return None
        f = self.dataset[self._i]
        self._i += 1
        return f

    def reset(self) -> None:
        self._i = 0


class SyntheticSensor(Sensor):
    """Renders frames of an analytic scene along a trajectory."""

    def __init__(self, scene, trajectory, intrinsics: Intrinsics,
                 depth_scale: float = 0.001):
        self.scene = scene
        self.trajectory = list(trajectory)
        self.intrinsics = Intrinsics(
            **{**intrinsics.__dict__, "depth_scale": depth_scale}
        )
        self._i = 0

    def get_frame(self):
        if self._i >= len(self.trajectory):
            return None
        depth_raw, color = self.scene.render_frame(
            self.trajectory[self._i], self.intrinsics,
            depth_scale=self.intrinsics.depth_scale,
        )
        self._i += 1
        return color, depth_raw


def open_sensor(source: str, **kw) -> Sensor:
    """Open a sensor by name or dataset path (runtime equivalent of the
    reference's compile-time backend switch, depth_sensor.h:4)."""
    if source in ("kinect2", "realsense"):
        raise RuntimeError(
            f"live '{source}' capture needs its vendor SDK on the host "
            "(depth_sensor.cpp:48-131); record the stream to the bundled "
            "folder format (color/*.png, depth/*.png, intr.txt) and replay "
            "it with a dataset path instead"
        )
    return DatasetSensor(source, kind=kw.get("kind", "auto"))
