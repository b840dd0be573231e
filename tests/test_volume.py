import numpy as np
import jax.numpy as jnp

from kinfu_tpu.config import KinFuParams, tiny_params
from kinfu_tpu.data.synthetic import default_test_scene
from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.geometry.se3 import Pose, compose, identity_pose, inverse, pose_from_matrix
from kinfu_tpu.volume.extract import extract_points
from kinfu_tpu.volume.integrate import integrate
from kinfu_tpu.volume.raycast import raycast
from kinfu_tpu.volume.tsdf import (
    create_volume,
    pack_rgb,
    tsdf_to_fixed,
    tsdf_to_float,
    unpack_rgb,
)

import functools

import jax

INTR = Intrinsics(width=160, height=120, fx=140.0, fy=140.0, cx=79.5, cy=59.5)
PARAMS = tiny_params(dim=64).replace(
    volume_range=(2.0, 2.0, 2.0), volume_origin=(-1.0, -1.0, 0.5)
)


@functools.cache
def _jitted(fn, params):
    return jax.jit(functools.partial(fn, intr=INTR, params=params))


def j_integrate(vol, depth, color, pose, params=PARAMS):
    return _jitted(integrate, params)(vol, depth, color, pose)


def j_raycast(vol, pose, params=PARAMS):
    return _jitted(raycast, params)(vol, pose)


def _vol2cam(cam_pose: Pose, params) -> Pose:
    return compose(inverse(cam_pose), pose_from_matrix(jnp.asarray(params.volume_pose)))


def _cam2vol(cam_pose: Pose, params) -> Pose:
    return compose(inverse(pose_from_matrix(jnp.asarray(params.volume_pose))), cam_pose)


def _render_plane_depth(z_plane: float) -> np.ndarray:
    return np.full((INTR.height, INTR.width), z_plane, np.float32)


def test_pack_unpack_rgb():
    rgb = jnp.asarray(np.array([[10, 20, 30], [255, 0, 128]], np.uint8))
    packed = pack_rgb(rgb)
    un = np.asarray(unpack_rgb(packed))
    np.testing.assert_allclose(un, [[10, 20, 30], [255, 0, 128]])


def test_tsdf_fixed_point_roundtrip():
    vals = jnp.asarray([-1.0, -0.5, 0.0, 0.25, 1.0])
    f = tsdf_to_float(tsdf_to_fixed(vals))
    np.testing.assert_allclose(np.asarray(f), np.asarray(vals), atol=1e-4)


def test_integrate_plane_tsdf_values():
    """Fronto-parallel plane: voxels in front positive, behind negative,
    truncated band ~2.1 voxels (tsdf_volume.cu:65-79 math)."""
    params = PARAMS
    vol = create_volume(params.volume_dims)
    depth = jnp.asarray(_render_plane_depth(1.5))
    color = jnp.zeros((INTR.height, INTR.width, 3), jnp.uint8)
    cam = identity_pose()
    vol = j_integrate(vol, depth, color, _vol2cam(cam, params), params)

    F = np.asarray(tsdf_to_float(vol.tsdf))
    W = np.asarray(vol.weight)
    vsz = params.voxel_size[2]
    # voxel index at volume z for world z=1.5: world z = origin_z + k*vs
    k_surface = (1.5 - 0.5) / vsz  # = 32 at dim=64, range 2
    # centre column of the image maps near x=y=0 world -> volume index 32
    i, j = 32, 32
    col = F[:, j, i]
    w = W[:, j, i]
    assert w[int(k_surface) - 1] > 0 and w[int(k_surface) + 1] > 0
    assert col[int(k_surface) - 1] > 0  # in front of surface (towards camera)
    assert col[int(k_surface) + 1] < 0  # behind surface
    # far behind: untouched (sdf < -trunc)
    assert w[int(k_surface) + 6] == 0
    # well in front: saturated at +1
    np.testing.assert_allclose(col[5:20], 1.0, atol=2e-4)


def test_integrate_weight_accumulates_and_clamps():
    params = PARAMS.replace(tsdf_max_weight=3)
    vol = create_volume(params.volume_dims)
    depth = jnp.asarray(_render_plane_depth(1.5))
    color = jnp.zeros((INTR.height, INTR.width, 3), jnp.uint8)
    cam = identity_pose()
    for _ in range(5):
        vol = j_integrate(vol, depth, color, _vol2cam(cam, params), params)
    W = np.asarray(vol.weight)
    assert W.max() == 3  # clamped (tsdf_volume.cu:76, MAX_WEIGHT semantics)


def test_integrate_color_written_near_surface():
    params = PARAMS
    vol = create_volume(params.volume_dims)
    depth = jnp.asarray(_render_plane_depth(1.5))
    color = jnp.full((INTR.height, INTR.width, 3), 200, jnp.uint8)
    vol = j_integrate(vol, depth, color, _vol2cam(identity_pose(), params), params)
    rgb = np.asarray(unpack_rgb(vol.color))
    k = 32
    assert rgb[k, 32, 32].max() > 50  # colored near surface
    assert rgb[5, 32, 32].max() == 0  # far in front: no color


def test_raycast_recovers_plane():
    params = PARAMS
    vol = create_volume(params.volume_dims)
    depth = jnp.asarray(_render_plane_depth(1.5))
    color = jnp.zeros((INTR.height, INTR.width, 3), jnp.uint8)
    cam = identity_pose()
    vol = j_integrate(vol, depth, color, _vol2cam(cam, params), params)
    vmap, nmap = j_raycast(vol, _cam2vol(cam, params), params)
    vmap, nmap = np.asarray(vmap), np.asarray(nmap)

    hits = vmap[..., 2] > 0
    # central region must hit
    assert hits[40:80, 50:110].mean() > 0.95
    err = np.abs(vmap[..., 2][hits] - 1.5)
    assert np.percentile(err, 90) < 1.5 * params.voxel_size[2]
    # normals point back at the camera
    nz = nmap[..., 2][hits]
    assert np.percentile(nz, 95) < -0.9


def test_raycast_sphere_geometry():
    """Sphere fused from exact depth: raycast vertices must lie on the
    sphere within ~a voxel."""
    params = PARAMS
    scene = default_test_scene()
    vol = create_volume(params.volume_dims)
    cam = identity_pose()
    depth_m = scene.render_depth(np.eye(4), INTR)
    color = jnp.zeros((INTR.height, INTR.width, 3), jnp.uint8)
    vol = j_integrate(vol, jnp.asarray(depth_m), color, _vol2cam(cam, params), params)
    vmap, _ = j_raycast(vol, _cam2vol(cam, params), params)
    vmap = np.asarray(vmap)
    hits = vmap[..., 2] > 0
    assert hits.mean() > 0.12
    pts = vmap[hits]  # camera frame == world frame here
    d = np.abs(scene.sdf(pts))
    assert np.percentile(d, 80) < 2.0 * params.voxel_size[0]


def test_extract_points_plane():
    params = PARAMS.replace(max_extracted_points=100_000)
    vol = create_volume(params.volume_dims)
    depth = jnp.asarray(_render_plane_depth(1.5))
    color = jnp.zeros((INTR.height, INTR.width, 3), jnp.uint8)
    vol = j_integrate(vol, depth, color, _vol2cam(identity_pose(), params), params)
    pts, count = extract_points(
        vol, pose_from_matrix(jnp.asarray(params.volume_pose)), params
    )
    n = int(count)
    assert n > 500
    p = np.asarray(pts[:n])
    # all crossing points lie on the z=1.5 world plane within half a voxel
    err = np.abs(p[:, 2] - 1.5)
    assert np.percentile(err, 90) < 0.75 * params.voxel_size[2]


def test_march_chunked_matches_march():
    """The chunked march must produce identical hits to the
    step-by-step reference march on the same sample grid."""
    from kinfu_tpu.volume.raycast import (
        camera_rays,
        march,
        march_chunked,
        ray_aabb,
    )
    from kinfu_tpu.geometry.se3 import identity_pose

    params = PARAMS
    scene = default_test_scene()
    vol = create_volume(params.volume_dims)
    depth_m = scene.render_depth(np.eye(4), INTR)
    color = jnp.zeros((INTR.height, INTR.width, 3), jnp.uint8)
    vol = j_integrate(
        vol, jnp.asarray(depth_m), color, _vol2cam(identity_pose(), params), params
    )

    Z, Y, X = vol.tsdf.shape
    vsx, vsy, vsz = params.voxel_size
    step = params.raycast_step_voxels * vsx
    inv_vs = jnp.array([1 / vsx, 1 / vsy, 1 / vsz], jnp.float32)
    org, dirs = camera_rays(_cam2vol(identity_pose(), params), INTR)
    box_max = jnp.array(params.volume_range, jnp.float32)
    tnear, tfar = ray_aabb(org, dirs, box_max)
    t_start = jnp.maximum(tnear, 0.0) + step

    a = march(vol.tsdf, (Z, Y, X), 0, org, dirs, t_start, tfar, step, inv_vs)
    diag = float(np.linalg.norm(params.volume_range))
    max_steps = int(np.ceil(diag / step)) + 2
    for chunk in (7, 64):
        b = jax.jit(
            lambda: march_chunked(
                vol.tsdf, (Z, Y, X), 0, org, dirs, t_start, tfar, step, inv_vs,
                max_steps, chunk=chunk,
            )
        )()
        np.testing.assert_allclose(
            np.asarray(a.hit_t), np.asarray(b.hit_t), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(a.back_t), np.asarray(b.back_t), rtol=1e-6
        )


def test_march_hier_matches_march():
    """The hierarchical (empty-space-skipping) march must find the same
    surface as the stepwise march: same hit classification for ~all rays,
    hit parameters within one step (its fine sample grid is phase-shifted
    by the cell-entry backup, so refined t differs sub-step)."""
    from kinfu_tpu.volume.raycast import (
        build_occupancy,
        camera_rays,
        march,
        march_hier,
        ray_aabb,
    )
    from kinfu_tpu.geometry.se3 import identity_pose

    params = PARAMS
    scene = default_test_scene()
    vol = create_volume(params.volume_dims)
    color = jnp.zeros((INTR.height, INTR.width, 3), jnp.uint8)
    # fuse from two poses so the volume has free space, surface band, AND
    # unobserved regions (all three occupancy classes)
    from kinfu_tpu.data.synthetic import make_orbit_trajectory

    for pose_m in (np.eye(4), np.asarray(make_orbit_trajectory(8)[1])):
        depth_m = scene.render_depth(pose_m, INTR)
        vol = j_integrate(
            vol, jnp.asarray(depth_m), color,
            _vol2cam(pose_from_matrix(jnp.asarray(pose_m, jnp.float32)), params),
            params,
        )

    Z, Y, X = vol.tsdf.shape
    vsx, vsy, vsz = params.voxel_size
    step = params.raycast_step_voxels * vsx
    inv_vs = jnp.array([1 / vsx, 1 / vsy, 1 / vsz], jnp.float32)
    org, dirs = camera_rays(_cam2vol(identity_pose(), params), INTR)
    box_max = jnp.array(params.volume_range, jnp.float32)
    tnear, tfar = ray_aabb(org, dirs, box_max)
    t_start = jnp.maximum(tnear, 0.0) + step

    a = march(vol.tsdf, (Z, Y, X), 0, org, dirs, t_start, tfar, step, inv_vs)
    occ = build_occupancy(vol.tsdf, 8)
    b = jax.jit(
        lambda: march_hier(vol.tsdf, occ, org, dirs, t_start, tfar, step, inv_vs, 8)
    )()

    INF = 1e29
    a_hit = (np.asarray(a.hit_t) < np.asarray(a.back_t)) & (np.asarray(a.hit_t) < INF)
    b_hit = (np.asarray(b.hit_t) < np.asarray(b.back_t)) & (np.asarray(b.hit_t) < INF)
    # classification agreement on ~all rays. The residual disagreements are
    # sampling-phase artifacts on grazing rays: a negative sliver thinner
    # than one step is seen by one sample grid and straddled by the other
    # (march's grid starts at t_start, march_hier's at the occupied-cell
    # backup point). march itself is equally sensitive to a shifted t_start.
    assert np.mean(a_hit == b_hit) > 0.97
    both = a_hit & b_hit
    assert both.sum() > 0.2 * a_hit.size
    dt = np.abs(np.asarray(a.hit_t)[both] - np.asarray(b.hit_t)[both])
    assert np.percentile(dt, 99) < 2.5 * step
    assert dt.max() < 8 * step
