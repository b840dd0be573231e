"""Mesh-sharded pipeline: Z-sharded volume, psum ICP, halo-exchange raycast.

Decomposition (no reference equivalent — the reference is single-GPU;
SURVEY.md section 2 parallelism call-out):

  - **integrate**: embarrassingly parallel — each shard fuses its own
    Z-slab of voxels against the (replicated, ~1 MB) depth/color images,
    offsetting voxel positions by its slab origin. Zero communication.
  - **raycast**: each shard marches only the t-interval where the ray's z
    lies inside its slab (on the *global* sample grid, so crossings are
    bit-identical to single-chip), using a 2-voxel halo obtained via two
    `ppermute`s so crossings/trilinear gradients straddling the boundary
    resolve locally. Hits composite with a `pmin` over the mesh (first hit
    along the ray wins; a closer backface cancels, preserving the
    reference's early-break semantics, tsdf_volume.cu:242-244); the winning
    shard shades, a masked `psum` broadcasts the result.
  - **ICP**: image rows shard across the mesh, each shard reduces its
    partial 6x6 normal equations, one `psum` finishes the reduction
    (the collective equivalent of rigid_icp.cu:115-132), and every device
    solves the same 6x6 system — the pose stays replicated by construction.

All collectives ride the 1-D mesh axis "z"; the host never sees a voxel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

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
from kinfu_tpu.parallel.mesh import VOLUME_AXIS, volume_sharding
from kinfu_tpu.pipeline.kinfu import _model_pyramid, _volume_pose
from kinfu_tpu.pipeline.state import KinFuState, StepOutput
from kinfu_tpu.tracking.icp import rigid_icp
from kinfu_tpu.volume.integrate import integrate
from kinfu_tpu.volume.raycast import camera_rays, march, ray_aabb, shade, _INF
from kinfu_tpu.volume.tsdf import TSDFVolume, reset_volume

HALO = 3  # voxel rows: march samples reach +-2.5 rows past the owned slab
# (one step each side of a boundary crossing + rint), trilinear gradient
# +-1.5 — 3 covers the worst case at |dir_z| = 1.


def halo_exchange_z(
    x: jnp.ndarray,
    axis_name: str = VOLUME_AXIS,
    halo: int = HALO,
):
    """Pad a local Z-slab with `halo` rows from each mesh neighbour.

    Boundary shards receive zero rows (outside the global volume these are
    never sampled — the 1-voxel global border rule masks them)."""
    n = jax.lax.axis_size(axis_name)
    L = x.shape[0]
    last = jax.lax.slice_in_dim(x, L - halo, L, axis=0)
    first = jax.lax.slice_in_dim(x, 0, halo, axis=0)
    below = jax.lax.ppermute(  # my last rows -> next shard's leading halo
        last, axis_name, perm=[(i, i + 1) for i in range(n - 1)]
    )
    above = jax.lax.ppermute(  # my first rows -> previous shard's trailing halo
        first, axis_name, perm=[(i + 1, i) for i in range(n - 1)]
    )
    return jnp.concatenate([below, x, above], axis=0)


def _local_t_interval(org_z, dir_z, z_lo, z_hi, t_start, t_end, step):
    """Restrict the global march interval to where the ray's z coordinate is
    inside [z_lo, z_hi), *snapped to the global sample grid* so the sharded
    march visits exactly the same sample points as the single-chip one."""
    dz_safe = jnp.where(jnp.abs(dir_z) < 1e-12, 1e-12, dir_z)
    ta = (z_lo - org_z) / dz_safe
    tb = (z_hi - org_z) / dz_safe
    t_in = jnp.minimum(ta, tb)
    t_out = jnp.maximum(ta, tb)
    # near-horizontal rays: entirely inside or outside the slab
    horiz = jnp.abs(dir_z) < 1e-12
    inside = (org_z >= z_lo) & (org_z < z_hi)
    t_in = jnp.where(horiz, jnp.where(inside, t_start, _INF), t_in)
    t_out = jnp.where(horiz, jnp.where(inside, t_end, -_INF), t_out)

    # one-step overlap each side; duplicates resolve identically via pmin
    lo = jnp.maximum(t_start, t_in - 2 * step)
    hi = jnp.minimum(t_end, t_out + 2 * step)
    # snap to the global grid t_start + k*step: return the integer offset so
    # the marcher computes t = t_start + k*step with the SAME fp rounding as
    # the single-device march (bit-identical sample positions)
    k = jnp.ceil(jnp.maximum(lo - t_start, 0.0) / step).astype(jnp.int32)
    return k, hi


def sharded_raycast(
    tsdf_local: jnp.ndarray,
    cam2vol: Pose,
    intr: Intrinsics,
    params: KinFuParams,
    axis_name: str = VOLUME_AXIS,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Raycast over a Z-sharded volume; returns replicated camera-frame
    vertex/normal maps. Call inside shard_map."""
    Zl, Y, X = tsdf_local.shape
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    Zg = Zl * n
    vsx, vsy, vsz = params.voxel_size
    step = params.raycast_step_voxels * vsx
    inv_vs = jnp.array([1.0 / vsx, 1.0 / vsy, 1.0 / vsz], dtype=jnp.float32)

    padded = halo_exchange_z(tsdf_local, axis_name)
    z0 = idx * Zl
    z0h = z0 - HALO

    org, dirs = camera_rays(cam2vol, intr)
    box_max = jnp.array(params.volume_range, dtype=jnp.float32)
    tnear, tfar = ray_aabb(org, dirs, box_max)
    t_start = jnp.maximum(tnear, 0.0) + step

    z_lo = z0.astype(jnp.float32) * vsz
    z_hi = (z0 + Zl).astype(jnp.float32) * vsz
    k_lo, t_hi = _local_t_interval(org[2], dirs[..., 2], z_lo, z_hi, t_start, tfar, step)

    res = march(
        padded, (Zg, Y, X), z0h, org, dirs, t_start, t_hi, step, inv_vs, k_start=k_lo
    )

    # composite: earliest hit / earliest backface across shards
    hit_t = jax.lax.pmin(res.hit_t, axis_name)
    back_t = jax.lax.pmin(res.back_t, axis_name)
    hit = (hit_t < back_t) & (hit_t < _INF)

    # unique winner: the shard whose slab contains the hit's z coordinate
    # (intervals overlap by 2 steps, so neighbours may detect the same
    # crossing at the identical grid t — ownership dedupes the psum)
    hit_z = org[2] + dirs[..., 2] * hit_t
    owned = (hit_z >= z_lo) & (hit_z < z_hi)
    # global-boundary hits (z outside every half-open slab) fall to shard 0/n-1
    owned = owned | ((idx == 0) & (hit_z < 0.0)) | (
        (idx == n - 1) & (hit_z >= vsz * Zg)
    )
    mine = hit & (res.hit_t <= hit_t) & owned
    winner = jax.lax.pmin(jnp.where(mine, idx, n), axis_name)
    i_shade = mine & (winner == idx)

    vertex, nrm, valid = shade(
        padded, (Zg, Y, X), z0h, org, dirs, hit_t, i_shade, params.voxel_size
    )
    R, _ = cam2vol
    Rinv = R.T
    vcam = jnp.einsum("ij,hwj->hwi", Rinv, vertex - org[None, None, :])
    ncam = jnp.einsum("ij,hwj->hwi", Rinv, nrm)
    mask = (valid & i_shade).astype(jnp.float32)[..., None]
    vout = jax.lax.psum(vcam * mask, axis_name)
    nout = jax.lax.psum(ncam * mask, axis_name)
    return vout, nout


def _row_shard(img: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Slice this device's block of image rows (for the ICP psum reduce).

    Rows are zero-padded up to a multiple of the axis size first — zero
    rows have zero normals, which the ICP correspondence mask rejects, so
    padding never contributes to the reduction. (Without the pad, `h // n`
    would silently DROP the remainder rows from the sharded reduction and
    the sharded pose would diverge from single-device.)"""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    rows = -(-img.shape[0] // n)
    pad = rows * n - img.shape[0]
    if pad:
        img = jnp.pad(img, ((0, pad),) + ((0, 0),) * (img.ndim - 1))
    return jax.lax.dynamic_slice_in_dim(img, idx * rows, rows, axis=0)


def kinfu_step_local(
    state: KinFuState,
    depth_mm: jnp.ndarray,
    color_rgb: jnp.ndarray,
    params: KinFuParams,
    intr: Intrinsics,
    axis_name: str = VOLUME_AXIS,
) -> Tuple[KinFuState, StepOutput]:
    """Per-device body of the sharded per-frame step (mirrors
    pipeline.kinfu.kinfu_step; runs inside shard_map). The volume is
    sharded along Z."""
    vol_pose = _volume_pose(params)
    z_offset = jax.lax.axis_index(axis_name) * state.vol.tsdf.shape[0]

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

    # Same single-conditional structure as pipeline.kinfu.kinfu_step (see
    # its structure note): the volume shard passes through exactly ONE
    # lax.cond; ICP runs every frame (zero model maps on frame 1 are
    # rejected by the correspondence mask) and small selects handle the
    # bootstrap special cases.
    is_first = state.frame_count == 1
    cur_v = [_row_shard(v, axis_name) for v in vmaps]
    cur_n = [_row_shard(n, axis_name) for n in nmaps]
    icp = rigid_icp(
        cur_v,
        cur_n,
        state.model_vmaps,
        state.model_nmaps,
        intr,
        params,
        axis_name=axis_name,
    )
    good = (icp.ok & ~is_first) | is_first

    tracked_pose = compose(state.pose, icp.pose)
    new_pose = jax.tree.map(
        lambda a, b: jnp.where(is_first, a, b), state.pose, tracked_pose
    )

    vol2cam = compose(inverse(new_pose), vol_pose)
    cam2vol = compose(inverse(vol_pose), new_pose)

    def fuse(vol):
        vol = integrate(
            vol, dmaps[0], color_rgb, vol2cam, intr, params, z_offset=z_offset
        )
        rv, rn = sharded_raycast(vol.tsdf, cam2vol, intr, params, axis_name)
        mv, mn = _model_pyramid(rv, rn, params.pyramid_height)
        mv = tuple(jnp.where(is_first, a, b) for a, b in zip(vmaps, mv))
        mn = tuple(jnp.where(is_first, a, b) for a, b in zip(nmaps, mn))
        return vol, mv, mn

    def fail(vol):
        return (
            reset_volume(vol),
            tuple(jnp.zeros_like(v) for v in state.model_vmaps),
            tuple(jnp.zeros_like(n) for n in state.model_nmaps),
        )

    vol_n, mv, mn = jax.lax.cond(good, fuse, fail, state.vol)

    pose_n = jax.tree.map(
        lambda a, b: jnp.where(good, a, b), new_pose, identity_pose()
    )
    fc_n = jnp.where(
        good,
        jnp.where(is_first, 2, state.frame_count + 1),
        jnp.asarray(1, jnp.int32),
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


def _state_specs(params: KinFuParams) -> KinFuState:
    vol_p = P(VOLUME_AXIS, None, None)
    vol_spec = TSDFVolume(tsdf=vol_p, weight=vol_p, color=vol_p)
    return KinFuState(
        vol=vol_spec,
        pose=Pose(P(), P()),
        model_vmaps=tuple(P() for _ in range(params.pyramid_height)),
        model_nmaps=tuple(P() for _ in range(params.pyramid_height)),
        frame_count=P(),
    )


def make_sharded_step_fn(params: KinFuParams, intr: Intrinsics, mesh: Mesh):
    """Jitted mesh-sharded per-frame step with donated volume state."""
    state_spec = _state_specs(params)
    out_spec = StepOutput(pose_matrix=P(), tracking_ok=P(), icp_inliers=P())

    body = functools.partial(kinfu_step_local, params=params, intr=intr)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(state_spec, P(), P()),
        out_specs=(state_spec, out_spec),
        check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(0,))


def shard_state(state: KinFuState, mesh: Mesh) -> KinFuState:
    """Place a host-built state onto the mesh (volume sharded along Z,
    rest replicated)."""
    vs = volume_sharding(mesh)
    rep = NamedSharding(mesh, P())
    vol = jax.tree.map(lambda x: jax.device_put(x, vs), state.vol)
    rest = jax.tree.map(
        lambda x: jax.device_put(x, rep), state._replace(vol=None)
    )
    return rest._replace(vol=vol)
