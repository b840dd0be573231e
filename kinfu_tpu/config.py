"""Runtime configuration for the KinectFusion pipeline.

Unlike the reference (which hardcodes every hyperparameter in
kinectfusion.cpp:167-190 `default_params()` and chooses the sensor backend
with a compile-time #define, depth_sensor.h:4), every knob here is a real
runtime flag on a frozen dataclass, overridable from the CLI.

Defaults reproduce the reference's `default_params()` exactly, except where a
reference bug is deliberately fixed (each such divergence is listed in
DIVERGENCES.md).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class KinFuParams:
    """All pipeline hyperparameters (static at trace time).

    Parity: kinectfusion.h:9-30 `kinectfuison_params` [sic] and
    kinectfusion.cpp:167-190 `default_params()`.
    """

    # ---- surface measurement (kinectfusion.cpp:171-175) ----
    pyramid_height: int = 3
    bfilter_kernel_size: int = 5
    bfilter_spatial_sigma: float = 10.0
    bfilter_color_sigma: float = 10.0
    #: far clip in metres applied after mm->m scaling (kinectfusion.cpp:175)
    dfilter_dist: float = 5.0
    #: mm -> m. The reference hardcodes 0.001 (image_process.cu:14) even
    #: though the dataset's intr.txt carries a depth scale; here it is a flag.
    depth_scale: float = 0.001
    #: relative depth-discontinuity threshold for normal invalidation
    #: (DIVERGENCES.md — the reference computes garbage silhouette normals)
    normal_disc_threshold: float = 0.1

    # ---- ICP (kinectfusion.cpp:177-179) ----
    icp_dist_threshold: float = 0.015
    #: degrees; compared via sin(angle) like icp_registration.cpp:3-6
    icp_angle_threshold: float = 30.0
    #: iterations per pyramid level, index = level (0 = finest). The
    #: reference runs iters[2]=10 at the coarsest level first
    #: (icp_registration.cpp:21-27).
    icp_iters: Tuple[int, ...] = (4, 5, 10)

    # ---- TSDF volume (kinectfusion.cpp:181-186) ----
    #: voxels per axis as (X, Y, Z)
    volume_dims: Tuple[int, int, int] = (512, 512, 512)
    #: metres per axis as (X, Y, Z)
    volume_range: Tuple[float, float, float] = (3.0, 3.0, 3.0)
    #: TSDF truncation distance in metres; None -> 2.1 * range_x / dims_x
    trunc_dist: float | None = None
    #: world-frame position of the volume's (0,0,0) corner
    #: (kinectfusion.cpp:184: translate(-range/2, -range/2, +0.5))
    volume_origin: Tuple[float, float, float] | None = None
    tsdf_max_weight: int = 64

    # ---- raycast ----
    #: ray-march step in voxels (reference: 1 voxel, tsdf_volume.cu:174)
    raycast_step_voxels: float = 1.0
    #: marcher: "step" = plain lockstep march on the global sample grid
    #: (reference semantics, tsdf_volume.cu:228-241), "hier" = coarse-cell
    #: empty-space skipping (same events, sample phase differs by O(step)),
    #: "auto" = hier when every volume dim is a multiple of 8, else step.
    #: The sharded pipeline marches directly (step grid); parity tests pin
    #: "step" on both sides.
    raycast_mode: str = "auto"

    # ---- extraction ----
    #: fixed-size output buffer for extracted surface points
    #: (reference MAXPOINTNUM 2e6, device_types.hpp:12)
    max_extracted_points: int = 2_000_000

    _MODE_CHOICES = {
        "raycast_mode": ("auto", "hier", "step"),
    }

    def __post_init__(self):
        for field, choices in self._MODE_CHOICES.items():
            val = getattr(self, field)
            if val not in choices:
                raise ValueError(f"{field}={val!r}; must be one of {choices}")
        if self.trunc_dist is None:
            object.__setattr__(
                self,
                "trunc_dist",
                2.1 * self.volume_range[0] / self.volume_dims[0],
            )
        if self.volume_origin is None:
            rx, ry, _ = self.volume_range
            object.__setattr__(self, "volume_origin", (-rx / 2.0, -ry / 2.0, 0.5))

    # -- derived, static --
    @property
    def voxel_size(self) -> Tuple[float, float, float]:
        """Metres per voxel, per axis (tsdf_volume.cpp:16)."""
        return tuple(r / d for r, d in zip(self.volume_range, self.volume_dims))

    @property
    def volume_pose(self) -> np.ndarray:
        """4x4 world-from-volume transform (pure translation by default)."""
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = np.asarray(self.volume_origin, dtype=np.float32)
        return T

    def level_iters_coarse_to_fine(self) -> Tuple[Tuple[int, int], ...]:
        """(level, iters) pairs in the execution order of the reference:
        coarsest level first (icp_registration.cpp:21)."""
        n = len(self.icp_iters)
        return tuple((lvl, self.icp_iters[lvl]) for lvl in range(n - 1, -1, -1))

    def replace(self, **kw) -> "KinFuParams":
        return dataclasses.replace(self, **kw)


def tiny_params(dim: int = 64, levels: int = 1) -> KinFuParams:
    """Small configuration for tests / CPU runs."""
    return KinFuParams(
        pyramid_height=levels,
        icp_iters=tuple([4, 5, 10][:levels]),
        volume_dims=(dim, dim, dim),
        volume_range=(3.0, 3.0, 3.0),
        max_extracted_points=200_000,
    )
