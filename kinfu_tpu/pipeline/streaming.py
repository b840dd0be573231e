"""Streaming-volume pipeline: kinfu_step with a camera-following grid.

Extends pipeline/kinfu.py (fixed 3 m cube, kinectfusion.cpp:181-184
semantics) with the moving volume of volume/stream.py: the volume's world
origin becomes dynamic state (whole-voxel offset from the configured base
origin), and each tracked frame may shift the grid before fusing. One
jitted step, state donated; no host round-trips.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from kinfu_tpu.config import KinFuParams
from kinfu_tpu.frontend.maps import build_measurement_pyramid
from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.geometry.se3 import (
    Pose,
    compose,
    identity_pose,
    inverse,
    pose_matrix,
)
from kinfu_tpu.pipeline.kinfu import _model_pyramid
from kinfu_tpu.pipeline.state import KinFuState, StepOutput
from kinfu_tpu.tracking.icp import rigid_icp
from kinfu_tpu.volume.integrate import integrate
from kinfu_tpu.volume.raycast import raycast
from kinfu_tpu.volume.stream import camera_centering_shift, shift_volume
from kinfu_tpu.volume.tsdf import reset_volume


class StreamingState(NamedTuple):
    kinfu: KinFuState
    #: whole-voxel offset of the volume origin from params.volume_origin
    origin_vox: jnp.ndarray  # int32 [3] (x, y, z)


def init_streaming_state(params: KinFuParams, intr: Intrinsics) -> StreamingState:
    from kinfu_tpu.pipeline.kinfu import init_state

    return StreamingState(
        kinfu=init_state(params, intr),
        origin_vox=jnp.zeros((3,), jnp.int32),
    )


def _vol_pose_dyn(params: KinFuParams, origin_vox: jnp.ndarray) -> Pose:
    """World-from-volume pose for the current grid placement."""
    base = jnp.asarray(params.volume_origin, jnp.float32)
    vs = jnp.asarray(params.voxel_size, jnp.float32)
    return Pose(jnp.eye(3, dtype=jnp.float32), base + origin_vox.astype(jnp.float32) * vs)


def streaming_step(
    state: StreamingState,
    depth_mm: jnp.ndarray,
    color_rgb: jnp.ndarray,
    params: KinFuParams,
    intr: Intrinsics,
    margin_frac: float = 0.25,
) -> Tuple[StreamingState, StepOutput]:
    ks = state.kinfu
    dmaps, vmaps, nmaps = build_measurement_pyramid(
        depth_mm,
        intr,
        pyramid_height=params.pyramid_height,
        bfilter_kernel_size=params.bfilter_kernel_size,
        bfilter_color_sigma=params.bfilter_color_sigma,
        bfilter_spatial_sigma=params.bfilter_spatial_sigma,
        depth_scale=params.depth_scale,
        max_dist=params.dfilter_dist,
        normal_disc_threshold=params.normal_disc_threshold,
    )

    # Single-conditional structure (see pipeline.kinfu.kinfu_step's
    # structure note): the volume passes through exactly ONE lax.cond.
    is_first = ks.frame_count == 1
    icp = rigid_icp(vmaps, nmaps, ks.model_vmaps, ks.model_nmaps, intr, params)
    good = (icp.ok & ~is_first) | is_first

    tracked_pose = compose(ks.pose, icp.pose)
    new_pose = jax.tree.map(
        lambda a, b: jnp.where(is_first, a, b), ks.pose, tracked_pose
    )

    # recenter the grid around the *view anchor* — a point half the volume
    # depth in front of the camera. Centering the camera itself would
    # scroll the observed scene out of the grid (a forward-looking sensor
    # needs the volume ahead of it; the reference statically places the
    # camera 0.5 m behind the volume face, kinectfusion.cpp:184).
    vol_pose0 = _vol_pose_dyn(params, state.origin_vox)
    anchor_cam = jnp.asarray(
        [0.0, 0.0, 0.5 * params.volume_range[2]], jnp.float32
    )
    anchor_w = new_pose.R @ anchor_cam + new_pose.t
    inv_vp = inverse(vol_pose0)
    anchor_vol = inv_vp.R @ anchor_w + inv_vp.t
    shift = camera_centering_shift(
        anchor_vol, params.volume_dims, params.voxel_size, margin_frac
    )
    shift = jnp.where(is_first, jnp.zeros((3,), jnp.int32), shift)
    origin_vox = state.origin_vox + shift
    vol_pose = _vol_pose_dyn(params, origin_vox)

    vol2cam = compose(inverse(new_pose), vol_pose)
    cam2vol = compose(inverse(vol_pose), new_pose)

    def fuse(vol):
        vol = shift_volume(vol, shift)
        vol = integrate(vol, dmaps[0], color_rgb, vol2cam, intr, params)
        rv, rn = raycast(vol, cam2vol, intr, params)
        mv, mn = _model_pyramid(rv, rn, params.pyramid_height)
        mv = tuple(jnp.where(is_first, a, b) for a, b in zip(vmaps, mv))
        mn = tuple(jnp.where(is_first, a, b) for a, b in zip(nmaps, mn))
        return vol, mv, mn

    def fail(vol):
        return (
            reset_volume(vol),
            tuple(jnp.zeros_like(v) for v in ks.model_vmaps),
            tuple(jnp.zeros_like(n) for n in ks.model_nmaps),
        )

    vol_n, mv, mn = jax.lax.cond(good, fuse, fail, ks.vol)

    pose_n = jax.tree.map(
        lambda a, b: jnp.where(good, a, b), new_pose, identity_pose()
    )
    fc_n = jnp.where(
        good,
        jnp.where(is_first, 2, ks.frame_count + 1),
        jnp.asarray(1, jnp.int32),
    )
    origin_n = jnp.where(good, origin_vox, jnp.zeros((3,), jnp.int32))
    new_ks = KinFuState(
        vol=vol_n,
        pose=pose_n,
        model_vmaps=mv,
        model_nmaps=mn,
        frame_count=fc_n,
    )
    out = StepOutput(
        pose_matrix=pose_matrix(pose_n),
        tracking_ok=good,
        icp_inliers=jnp.where(is_first, 0, icp.num_inliers),
    )
    return StreamingState(new_ks, origin_n), out


def make_streaming_step_fn(
    params: KinFuParams, intr: Intrinsics, donate: bool = True, margin_frac: float = 0.25
) -> Callable:
    fn = functools.partial(
        streaming_step, params=params, intr=intr, margin_frac=margin_frac
    )
    return jax.jit(fn, donate_argnums=(0,) if donate else ())
