"""The compiled stages against independent float64 numpy references.

kinfu_tpu/eval/reference.py implements integrate, raycast and the ICP
normal equations straight from the CUDA reference's semantics
(tsdf_volume.cu:41-110, :217-258; rigid_icp.cu:46-112). These tests hold
the jnp pipeline to them across view directions: the six axis-aligned
views, a tilted view, a near-camera view, a cube-corner view, a
non-cubic volume and a shard slab with a nonzero z offset.

Tolerances follow from float32 against float64: a value that lands
within the last float32 bit of a rounding boundary (nearest pixel,
fixed-point truncation, nearest voxel) may round the other way.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kinfu_tpu.config import KinFuParams
from kinfu_tpu.data.synthetic import SyntheticScene, default_test_scene, plane, sphere
from kinfu_tpu.eval.reference import (
    gram_error,
    icp_normal_equations_ref,
    integrate_ref,
    raycast_ref,
)
from kinfu_tpu.frontend.maps import build_measurement_pyramid
from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.geometry.se3 import Pose
from kinfu_tpu.tracking.icp import _normal_equations
from kinfu_tpu.volume.integrate import integrate
from kinfu_tpu.volume.raycast import raycast
from kinfu_tpu.volume.tsdf import TSDFVolume, create_volume, tsdf_to_fixed


def _look(direction, roll_deg=0.0):
    """Rotation whose camera z axis points along `direction`."""
    z = np.asarray(direction, np.float64)
    z /= np.linalg.norm(z)
    up = np.array([0.0, 1.0, 0.0]) if abs(z[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    a = math.radians(roll_deg)
    Rz = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
    return R @ Rz


def _pose(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def _jpose(T):
    T = np.asarray(T, np.float32)
    return Pose(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]))


AXES = {
    "+x": (1, 0, 0), "-x": (-1, 0, 0),
    "+y": (0, 1, 0), "-y": (0, -1, 0),
    "+z": (0, 0, 1), "-z": (0, 0, -1),
}

# ------------------------------------------------------------- integrate
VOXEL = 0.05
INTR_I = Intrinsics(width=48, height=40, fx=40.0, fy=40.0, cx=23.5, cy=19.5)


def _integrate_params(dims):
    rng = tuple(d * VOXEL for d in dims)
    return KinFuParams(volume_dims=dims, volume_range=rng, volume_origin=(0.0, 0.0, 0.0))


@functools.lru_cache(maxsize=None)
def _integrate_fn(dims):
    p = _integrate_params(dims)
    return jax.jit(functools.partial(integrate, intr=INTR_I, params=p))


def _integrate_case(dims, direction, back, slab=None, z_offset=0):
    """Two frames of a sphere + wall scene fused from `back` metres behind
    the volume centre along `direction`; the second frame is nudged."""
    p = _integrate_params(dims)
    centre = np.asarray(p.volume_range) / 2
    d = np.asarray(direction, np.float64) / np.linalg.norm(direction)
    scene = SyntheticScene(
        [sphere(centre, 0.3), plane(centre + 0.45 * d, -d + np.array([0.05, 0.02, 0.0]))]
    )
    R = _look(d, roll_deg=7.0)
    poses = [_pose(R, centre - back * d), _pose(R, centre - back * d + [0.01, -0.008, 0.005])]
    X, Y, Z = dims
    shape_xyz = (X, Y, slab if slab else Z)
    vol = create_volume(shape_xyz)
    ref = tuple(np.asarray(a) for a in vol)
    for T in poses:
        depth_raw, color = scene.render_frame(T, INTR_I)
        depth_m = (depth_raw * np.float32(p.depth_scale)).astype(np.float32)
        vol2cam = np.linalg.inv(T)  # volume frame == world frame here
        vol = _integrate_fn(dims)(
            vol, jnp.asarray(depth_m), jnp.asarray(color), _jpose(vol2cam),
            z_offset=jnp.int32(z_offset),
        )
        ref = integrate_ref(*ref, depth_m, color, vol2cam, INTR_I, p.voxel_size,
                            p.trunc_dist, p.tsdf_max_weight, z_offset=z_offset)
    got = tuple(np.asarray(a) for a in vol)
    n = got[0].size
    observed = (ref[1] > 0).sum()
    assert observed > 100, f"too few fused voxels: {observed}"
    assert (np.abs(got[0].astype(int) - ref[0]) > 1).mean() <= 1e-3
    assert (got[1] != ref[1]).mean() <= 1e-3
    both = (got[1] > 0) & (ref[1] > 0)
    assert (got[2][both] != ref[2][both]).mean() <= 1e-3
    return observed


@pytest.mark.parametrize("face", list(AXES))
def test_integrate_matches_reference_axis_views(face):
    _integrate_case((32, 32, 32), AXES[face], back=1.0)


def test_integrate_matches_reference_tilted_view():
    _integrate_case((32, 32, 32), (0.6, -0.4, 0.7), back=1.0)


def test_integrate_matches_reference_near_camera():
    """Camera inside the volume, 0.3 m from the sphere: part of the
    volume is behind the camera (z <= 0 voxels never update)."""
    _integrate_case((32, 32, 32), (0.2, 0.1, 1.0), back=0.6)


def test_integrate_matches_reference_non_cubic():
    _integrate_case((24, 32, 40), (0.1, 0.2, 1.0), back=1.2)


def test_integrate_matches_reference_shard_slab_offset():
    """A 16-slice slab at global z 8 of a 32^3 volume fuses exactly the
    voxels the full volume would (kinfu_tpu/parallel/)."""
    _integrate_case((32, 32, 32), (0.0, 0.3, 1.0), back=1.0, slab=16, z_offset=8)


# --------------------------------------------------------------- raycast
DIM_R = 48
VOXEL_R = 0.03
INTR_R = Intrinsics(width=40, height=32, fx=36.0, fy=36.0, cx=19.5, cy=15.5)
PARAMS_R = KinFuParams(
    volume_dims=(DIM_R,) * 3, volume_range=(DIM_R * VOXEL_R,) * 3,
    volume_origin=(0.0, 0.0, 0.0),
)


@functools.lru_cache(maxsize=None)
def _sphere_volume():
    """Fixed-point TSDF of a sphere at the volume centre, truncated like
    the fusion (distance / trunc clipped to [-1, 1])."""
    g = (np.arange(DIM_R) * VOXEL_R).astype(np.float64)
    Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
    c = DIM_R * VOXEL_R / 2
    d = np.sqrt((X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2) - 0.4
    return np.asarray(tsdf_to_fixed(jnp.asarray(np.clip(d / PARAMS_R.trunc_dist, -1, 1),
                                                jnp.float32)))


@functools.lru_cache(maxsize=None)
def _raycast_fn(mode):
    p = PARAMS_R.replace(raycast_mode=mode)
    return jax.jit(lambda t, pose: raycast(TSDFVolume(t, None, None), pose, INTR_R, p))


RAY_VIEWS = {**{f"face{k}": (v, 0.0) for k, v in AXES.items()},
             "tilted": ((0.5, -0.3, 0.8), 20.0),
             "corner": ((1.0, 1.0, 1.0), 0.0)}


@pytest.mark.parametrize("mode", ["step", "hier"])
@pytest.mark.parametrize("view", list(RAY_VIEWS))
def test_raycast_matches_reference(view, mode):
    direction, roll = RAY_VIEWS[view]
    d = np.asarray(direction, np.float64) / np.linalg.norm(direction)
    c = DIM_R * VOXEL_R / 2
    cam2vol = _pose(_look(d, roll), c - 1.1 * d)
    tsdf = _sphere_volume()
    vg, ng = (np.asarray(a) for a in _raycast_fn(mode)(jnp.asarray(tsdf), _jpose(cam2vol)))
    vr, nr = raycast_ref(tsdf, cam2vol, INTR_R, PARAMS_R.voxel_size)
    hit_g, hit_r = vg[..., 2] > 0, vr[..., 2] > 0
    assert hit_r.mean() > 0.2
    both = hit_g & hit_r
    err = np.linalg.norm(vg - vr, axis=-1)[both] / VOXEL_R
    nerr = np.linalg.norm(ng - nr, axis=-1)[both]
    if mode == "step":
        # same sample grid: identical events, float32 rounding only
        assert (hit_g == hit_r).mean() >= 0.995
        assert np.percentile(err, 99) <= 0.01 and err.max() <= 1.0
        assert np.percentile(nerr, 99) <= 0.05
    else:
        # shifted sample phase: hit_t differs by O(step) on a fully
        # observed surface (march_hier docstring), most at grazing rays
        assert (hit_g == hit_r).mean() >= 0.99
        assert np.median(err) <= 1.0 and err.max() <= 4.0
        assert np.median(nerr) <= 0.05


# ------------------------------------------------------------------- ICP
INTR_C = Intrinsics(width=160, height=128, fx=140.0, fy=140.0, cx=79.5, cy=63.5)
# a 10 cm association gate: at the coarsest level a pixel spans ~5 cm, so
# the default 15 mm gate would leave almost no pair to check
PARAMS_C = KinFuParams(
    pyramid_height=3, icp_iters=(1, 1, 1), volume_dims=(64,) * 3,
    icp_dist_threshold=0.1,
)


@functools.lru_cache(maxsize=None)
def _icp_maps():
    scene = default_test_scene()
    T1 = _pose(_look((0.02, 0.0, 1.0)), [0.01, -0.005, 0.004])
    p = PARAMS_C
    pyr = jax.jit(functools.partial(
        build_measurement_pyramid, intr=INTR_C, pyramid_height=3,
        bfilter_kernel_size=p.bfilter_kernel_size,
        bfilter_color_sigma=p.bfilter_color_sigma,
        bfilter_spatial_sigma=p.bfilter_spatial_sigma,
        depth_scale=p.depth_scale, max_dist=p.dfilter_dist,
        normal_disc_threshold=p.normal_disc_threshold,
    ))
    maps = []
    for T in (np.eye(4), T1):
        _, vm, nm = pyr(jnp.asarray(scene.render_frame(T, INTR_C)[0]))
        maps.append([(np.asarray(v), np.asarray(n)) for v, n in zip(vm, nm)])
    # cur = frame at T1, pre (model) = frame at identity; the true
    # increment maps cur-camera points into the pre camera
    return maps[1], maps[0], T1


@functools.lru_cache(maxsize=None)
def _icp_fn(level):
    return jax.jit(functools.partial(
        _normal_equations, intr=INTR_C.level(level),
        dist_thres=PARAMS_C.icp_dist_threshold,
        sin_angle_thres=math.sin(math.radians(PARAMS_C.icp_angle_threshold)),
    ))


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("inc_kind", ["identity", "true"])
def test_icp_normal_equations_match_reference(level, inc_kind):
    cur, pre, T1 = _icp_maps()
    inc = np.eye(4) if inc_kind == "identity" else T1
    A, b, n = _icp_fn(level)(_jpose(inc), *cur[level], *pre[level])
    G, count = icp_normal_equations_ref(
        inc, *cur[level], *pre[level], INTR_C.level(level),
        PARAMS_C.icp_dist_threshold, PARAMS_C.icp_angle_threshold,
    )
    assert count > 100
    assert abs(int(n) - count) <= 2
    assert gram_error(A, b, G) <= 1e-4
