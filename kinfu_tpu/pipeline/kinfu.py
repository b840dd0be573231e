"""The per-frame pipeline step: one jitted, donated, functional update.

Mirrors kinectfusion::pipeline (kinectfusion.cpp:78-131) but as a single
traced computation:

  measurement pyramid -> [bootstrap | ICP -> integrate -> raycast] -> state'

Control flow uses `lax.cond` so exactly one branch executes on device per
frame; tracking failure takes the reset branch (wipe volume + identity pose,
kinectfusion.cpp:97-102,:133-141) entirely in-graph.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from kinfu_tpu.config import KinFuParams
from kinfu_tpu.frontend.maps import build_measurement_pyramid, resize_points_normals
from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.geometry.se3 import (
    Pose,
    compose,
    identity_pose,
    inverse,
    pose_from_matrix,
    pose_matrix,
)
from kinfu_tpu.pipeline.state import KinFuState, StepOutput
from kinfu_tpu.tracking.icp import rigid_icp
from kinfu_tpu.volume.integrate import integrate
from kinfu_tpu.volume.raycast import raycast
from kinfu_tpu.volume.tsdf import create_volume, reset_volume


def init_state(params: KinFuParams, intr: Intrinsics) -> KinFuState:
    """Fresh session state (kinectfusion ctor + reset, kinectfusion.cpp:9-27)."""
    vol = create_volume(params.volume_dims)
    vmaps, nmaps = [], []
    for level in range(params.pyramid_height):
        li = intr.level(level)
        vmaps.append(jnp.zeros((li.height, li.width, 3), jnp.float32))
        nmaps.append(jnp.zeros((li.height, li.width, 3), jnp.float32))
    return KinFuState(
        vol=vol,
        pose=identity_pose(),
        model_vmaps=tuple(vmaps),
        model_nmaps=tuple(nmaps),
        frame_count=jnp.asarray(1, dtype=jnp.int32),
    )


def _volume_pose(params: KinFuParams) -> Pose:
    return pose_from_matrix(jnp.asarray(params.volume_pose))


def _model_pyramid(vmap0, nmap0, levels: int):
    vmaps, nmaps = [vmap0], [nmap0]
    for _ in range(1, levels):
        v, n = resize_points_normals(vmaps[-1], nmaps[-1])
        vmaps.append(v)
        nmaps.append(n)
    return tuple(vmaps), tuple(nmaps)


def kinfu_step(
    state: KinFuState,
    depth_mm: jnp.ndarray,
    color_rgb: jnp.ndarray,
    params: KinFuParams,
    intr: Intrinsics,
    auto_reset: bool = True,
) -> Tuple[KinFuState, StepOutput]:
    """Process one frame. depth_mm: [H, W] float32 raw depth (mm-scale);
    color_rgb: [H, W, 3] uint8.

    auto_reset=True reproduces the reference's recovery (tracking failure
    wipes map + pose, kinectfusion.cpp:97-102). auto_reset=False keeps the
    state untouched on failure so a relocalizer (mapping/relocalize.py +
    relocalize_step) can try to re-acquire the existing map instead.

    Structure note: the TSDF volume passes through exactly ONE lax.cond.
    XLA may stage conditional operands and results through fresh buffers,
    so every conditional layer wrapping the volume risks full-volume
    copies. Bootstrap therefore merges into the main path: ICP runs every
    frame (on frame 1 the model maps are zero, which the correspondence
    mask rejects — its result is discarded), and the small per-frame
    selects (pose, maps) use jnp.where."""
    vol_pose = _volume_pose(params)

    with jax.named_scope("measure"):
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

    is_first = state.frame_count == 1
    with jax.named_scope("icp"):
        icp = rigid_icp(
            vmaps, nmaps, state.model_vmaps, state.model_nmaps, intr, params
        )
    good = icp.ok & ~is_first | is_first

    # frame 1 fuses at the held pose (kinectfusion.cpp:84-93); tracked
    # frames right-multiply the ICP increment (kinectfusion.cpp:104)
    tracked_pose = compose(state.pose, icp.pose)
    new_pose = jax.tree.map(
        lambda a, b: jnp.where(is_first, a, b), state.pose, tracked_pose
    )

    vol2cam = compose(inverse(new_pose), vol_pose)
    cam2vol = compose(inverse(vol_pose), new_pose)

    def fuse(vol):
        with jax.named_scope("integrate"):
            vol = integrate(vol, dmaps[0], color_rgb, vol2cam, intr, params)
        with jax.named_scope("raycast"):
            rv, rn = raycast(vol, cam2vol, intr, params)
        with jax.named_scope("model_pyramid"):
            mv, mn = _model_pyramid(rv, rn, params.pyramid_height)
        # frame 1 seeds the model with the measurement — no raycast
        # output is used (the raycast above is wasted work on that one
        # frame; branching on it would re-wrap the volume in another
        # conditional)
        mv = tuple(jnp.where(is_first, a, b) for a, b in zip(vmaps, mv))
        mn = tuple(jnp.where(is_first, a, b) for a, b in zip(nmaps, mn))
        return vol, mv, mn

    def fail(vol):
        if auto_reset:
            return (
                reset_volume(vol),
                tuple(jnp.zeros_like(v) for v in state.model_vmaps),
                tuple(jnp.zeros_like(n) for n in state.model_nmaps),
            )
        return vol, state.model_vmaps, state.model_nmaps

    vol_n, mv, mn = jax.lax.cond(good, fuse, fail, state.vol)

    if auto_reset:
        fail_pose = identity_pose()
        fail_fc = jnp.asarray(1, jnp.int32)
    else:
        fail_pose = state.pose
        fail_fc = state.frame_count
    pose_n = jax.tree.map(
        lambda a, b: jnp.where(good, a, b), new_pose, fail_pose
    )
    fc_n = jnp.where(
        good,
        jnp.where(is_first, 2, state.frame_count + 1),
        fail_fc,
    )
    new_state = KinFuState(
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
    return new_state, out


def make_step_fn(
    params: KinFuParams, intr: Intrinsics, donate: bool = True, auto_reset: bool = True
) -> Callable[[KinFuState, jnp.ndarray, jnp.ndarray], Tuple[KinFuState, StepOutput]]:
    """Jitted step with the state donated (in-place volume update)."""
    fn = functools.partial(
        kinfu_step, params=params, intr=intr, auto_reset=auto_reset
    )
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def relocalize_step(
    state: KinFuState,
    depth_mm: jnp.ndarray,
    color_rgb: jnp.ndarray,
    seed_pose: jnp.ndarray,
    params: KinFuParams,
    intr: Intrinsics,
) -> Tuple[KinFuState, StepOutput]:
    """One relocalization attempt against the kept map.

    Raycasts the volume from `seed_pose` (a 4x4 world-from-camera guess,
    typically the nearest keyframe — mapping/keyframes.py), runs ICP of the
    current measurement against that prediction, and on success re-enters
    normal tracking (integrate + fresh model maps). On failure the state is
    returned untouched. No reference equivalent (the reference can only
    wipe the map, kinectfusion.cpp:97-102)."""
    vol_pose = _volume_pose(params)
    seed = pose_from_matrix(jnp.asarray(seed_pose, jnp.float32))

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

    # model prediction from the seed pose
    cam2vol_seed = compose(inverse(vol_pose), seed)
    rv, rn = raycast(state.vol, cam2vol_seed, intr, params)
    mv, mn = _model_pyramid(rv, rn, params.pyramid_height)

    icp = rigid_icp(vmaps, nmaps, mv, mn, intr, params)

    def on_ok(_):
        new_pose = compose(seed, icp.pose)
        vol2cam = compose(inverse(new_pose), vol_pose)
        vol = integrate(state.vol, dmaps[0], color_rgb, vol2cam, intr, params)
        cam2vol = compose(inverse(vol_pose), new_pose)
        rv2, rn2 = raycast(vol, cam2vol, intr, params)
        mv2, mn2 = _model_pyramid(rv2, rn2, params.pyramid_height)
        new_state = KinFuState(
            vol=vol,
            pose=new_pose,
            model_vmaps=mv2,
            model_nmaps=mn2,
            frame_count=state.frame_count + 1,
        )
        out = StepOutput(
            pose_matrix=pose_matrix(new_pose),
            tracking_ok=jnp.asarray(True),
            icp_inliers=icp.num_inliers,
        )
        return new_state, out

    def on_fail(_):
        out = StepOutput(
            pose_matrix=pose_matrix(state.pose),
            tracking_ok=jnp.asarray(False),
            icp_inliers=icp.num_inliers,
        )
        return state, out

    return jax.lax.cond(icp.ok, on_ok, on_fail, None)
