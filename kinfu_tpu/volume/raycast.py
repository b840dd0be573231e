"""Raycast surface prediction — jnp reference implementation.

All rays march in lockstep inside one `lax.while_loop` (XLA-friendly: fixed
shapes, global early-exit when every ray is done), sampling the TSDF with
nearest-voxel gathers. Hit refinement and normals run as a separate
vectorised pass over the recorded hit parameters, so the expensive trilinear
gradient (6 interpolations * 8 corners) happens once per ray instead of once
per march step.

The marcher and shader are factored to operate on a *local Z-slab* of the
global volume (``z0h`` = global z index of local row 0, ``dims_g`` = global
dims): the single-chip path passes the full volume, while the sharded path
(kinfu_tpu/parallel/) passes each shard's slab (plus halo) and a restricted
t-interval, then min-composites hits across the mesh.

Math parity with device::raycast (tsdf_volume.cu:113-279):
  - ray = cam2vol.R @ K^-1 [u,v,1], normalised, origin cam2vol.t (:217-220)
  - AABB clip to [0, volume_range], start at max(tnear,0)+step, step = one
    voxel (:225-232)
  - nearest-voxel TSDF sampling, invalid outside [1, dims-2] (:166-177);
    an invalid sample never triggers a crossing test (NaN semantics, :237)
  - -,+ crossing (backface) terminates the ray without a hit (:242-243)
  - +,- crossing: linear refinement, vertex = org + dir*Ts, normal = central
    difference of trilinear TSDF at +-voxel/2, outputs rotated to the camera
    frame: vmap = Rinv (vertex - t), nmap = Rinv n (:246-254)

Two deliberate fixes vs the reference, recorded in DIVERGENCES.md (items 2
and 10): the refinement interpolates forward (the reference subtracts the
fractional step), and an invalid normal terminates the ray.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from kinfu_tpu.config import KinFuParams
from kinfu_tpu.geometry.se3 import Pose
from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.volume.tsdf import SHORTMAX, TSDFVolume, tsdf_to_float

_INF = 1e30


class MarchResult(NamedTuple):
    #: ray parameter of the first +,- crossing, +inf when none
    hit_t: jnp.ndarray
    #: ray parameter of the first -,+ (backface) event, +inf when none
    back_t: jnp.ndarray


def _sample_nearest(tsdf_flat, dims_g, z0h, local_z, p_vox):
    """Nearest-voxel TSDF at float *global* voxel coords ([..., 3] x,y,z).

    The backing array covers global z rows [z0h, z0h + local_z). Validity is
    the reference's 1-voxel global border (tsdf_volume.cu:166-177) AND local
    availability.
    """
    Zg, Y, X = dims_g
    xi = jnp.rint(p_vox[..., 0]).astype(jnp.int32)
    yi = jnp.rint(p_vox[..., 1]).astype(jnp.int32)
    zi = jnp.rint(p_vox[..., 2]).astype(jnp.int32)
    valid = (
        (xi >= 1) & (xi < X - 1) & (yi >= 1) & (yi < Y - 1) & (zi >= 1) & (zi < Zg - 1)
    )
    zl = zi - z0h
    valid = valid & (zl >= 0) & (zl < local_z)
    lin = jnp.clip((zl * Y + yi) * X + xi, 0, local_z * Y * X - 1)
    val = tsdf_to_float(jnp.take(tsdf_flat, lin))
    return val, valid


def trilinear(tsdf_flat, dims_g, z0h, local_z, p_vox):
    """Trilinear TSDF interpolation at float global voxel coords (corner
    convention). Parity: device::interpolate (tsdf_volume.cu:139-161): floor
    anchor, invalid outside [0, dims-2]. Returns (value, valid)."""
    Zg, Y, X = dims_g
    g = jnp.floor(p_vox)
    gx = g[..., 0].astype(jnp.int32)
    gy = g[..., 1].astype(jnp.int32)
    gz = g[..., 2].astype(jnp.int32)
    valid = (
        (gx >= 0) & (gx < X - 1) & (gy >= 0) & (gy < Y - 1) & (gz >= 0) & (gz < Zg - 1)
    )
    gzl = gz - z0h
    valid = valid & (gzl >= 0) & (gzl < local_z - 1)

    a = p_vox[..., 0] - g[..., 0]
    b = p_vox[..., 1] - g[..., 1]
    c = p_vox[..., 2] - g[..., 2]

    gxc = jnp.clip(gx, 0, X - 2)
    gyc = jnp.clip(gy, 0, Y - 2)
    gzc = jnp.clip(gzl, 0, local_z - 2)

    acc = jnp.zeros(p_vox.shape[:-1], dtype=jnp.float32)
    for dx in (0, 1):
        wx = a if dx else (1.0 - a)
        for dy in (0, 1):
            wy = b if dy else (1.0 - b)
            for dz in (0, 1):
                wz = c if dz else (1.0 - c)
                lin = ((gzc + dz) * Y + (gyc + dy)) * X + (gxc + dx)
                acc = acc + tsdf_to_float(jnp.take(tsdf_flat, lin)) * wx * wy * wz
    return acc, valid


def ray_aabb(org, dirs, box_max):
    """Per-ray entry/exit parameters for the [0, box_max] AABB
    (device::intersect, tsdf_volume.cu:120-136)."""
    safe_dirs = jnp.where(jnp.abs(dirs) < 1e-12, 1e-12, dirs)
    tbot = (0.0 - org) / safe_dirs
    ttop = (box_max - org) / safe_dirs
    tnear = jnp.max(jnp.minimum(tbot, ttop), axis=-1)
    tfar = jnp.min(jnp.maximum(tbot, ttop), axis=-1)
    return tnear, tfar


def march(
    tsdf_local: jnp.ndarray,
    dims_g: Tuple[int, int, int],
    z0h: jnp.ndarray | int,
    org: jnp.ndarray,
    dirs: jnp.ndarray,
    t_start: jnp.ndarray,
    t_end: jnp.ndarray,
    step: float,
    inv_vs: jnp.ndarray,
    k_start: jnp.ndarray | None = None,
) -> MarchResult:
    """Lockstep ray march over sample grid t_k = t_start + k*step, starting
    at k = k_start (default 0) while t_k < t_end.

    Sample positions are computed as t_start + k*step from an integer
    counter — never accumulated — so a sharded caller that restricts each
    shard to its own k-interval of the SAME global grid (passing the global
    t_start and a per-ray integer `k_start`) samples bit-identical positions
    to the single-device march, and events match exactly.

    tsdf_local: [local_Z, Y, X] int16 slab covering global z rows
    [z0h, z0h + local_Z). Samples outside the slab are invalid (the crossing
    tests skip them), so a sharded caller must provide halo rows for
    crossings that straddle its boundary.
    """
    local_z = tsdf_local.shape[0]
    tsdf_flat = tsdf_local.reshape(-1)

    if k_start is None:
        k_start = jnp.zeros(t_start.shape, jnp.int32)

    def t_of(k):
        return t_start + k.astype(jnp.float32) * step

    t0 = t_of(k_start)
    p0 = org[None, None, :] + dirs * t0[..., None]
    f0, v0 = _sample_nearest(tsdf_flat, dims_g, z0h, local_z, p0 * inv_vs)
    alive0 = t0 < t_end

    hit_t = jnp.full(t0.shape, _INF, dtype=jnp.float32)
    back_t = jnp.full(t0.shape, _INF, dtype=jnp.float32)

    def cond(state):
        _, _, _, alive, _, _ = state
        return jnp.any(alive)

    def body(state):
        k, f_prev, v_prev, alive, hit_t, back_t = state
        knext = k + 1
        tcur = t_of(k)
        tnext = t_of(knext)
        p = org[None, None, :] + dirs * tnext[..., None]
        f_next, v_next = _sample_nearest(tsdf_flat, dims_g, z0h, local_z, p * inv_vs)

        both = v_prev & v_next & alive
        front = both & (f_prev > 0.0) & (f_next < 0.0)
        back = both & (f_prev < 0.0) & (f_next > 0.0)

        frac = f_prev / jnp.maximum(f_prev - f_next, 1e-30)
        hit_t = jnp.where(front, jnp.minimum(hit_t, tcur + step * frac), hit_t)
        back_t = jnp.where(back, jnp.minimum(back_t, tnext), back_t)

        alive = alive & ~front & ~back & (tnext < t_end)
        return (knext, f_next, v_next, alive, hit_t, back_t)

    state = (k_start, f0, v0, alive0, hit_t, back_t)
    _, _, _, _, hit_t, back_t = jax.lax.while_loop(cond, body, state)
    return MarchResult(hit_t=hit_t, back_t=back_t)


def march_chunked(
    tsdf_local: jnp.ndarray,
    dims_g: Tuple[int, int, int],
    z0h: jnp.ndarray | int,
    org: jnp.ndarray,
    dirs: jnp.ndarray,
    t_start: jnp.ndarray,
    t_end: jnp.ndarray,
    step: float,
    inv_vs: jnp.ndarray,
    max_steps: int,
    chunk: int = 64,
) -> MarchResult:
    """Chunked lockstep march — identical events to `march`, restructured
    into fewer, larger loop iterations.

    `march` issues one [H, W] gather per step (~hundreds of tiny gathers
    per frame, each a separate loop iteration). Here each while_loop
    iteration samples `chunk`+1 positions for every ray in ONE [H, W, C+1]
    gather, detects all +/- crossings in the chunk vectorised, and keeps
    only each ray's earliest event — ~`max_steps`/`chunk` big iterations
    with a global early exit once every ray has resolved. Crossing t values
    land on the same global grid as `march`, so results are identical.
    """
    local_z = tsdf_local.shape[0]
    tsdf_flat = tsdf_local.reshape(-1)
    n_chunks = max(1, -(-max_steps // chunk))

    offs = jnp.arange(chunk + 1, dtype=jnp.float32) * step
    hit0 = jnp.full(t_start.shape, _INF, dtype=jnp.float32)
    back0 = jnp.full(t_start.shape, _INF, dtype=jnp.float32)
    active0 = t_start < t_end

    def cond(state):
        k, active, _, _ = state
        return (k < n_chunks) & jnp.any(active)

    def body(state):
        k, active, hit_t, back_t = state
        base = t_start + (k * chunk) * step
        t = base[..., None] + offs  # [H, W, C+1]
        p = org[None, None, None, :] + dirs[..., None, :] * t[..., None]
        f, v = _sample_nearest(tsdf_flat, dims_g, z0h, local_z, p * inv_vs)

        fp, fn = f[..., :-1], f[..., 1:]
        vp, vn = v[..., :-1], v[..., 1:]
        # pair i is (sample i, sample i+1); test while the leading sample is
        # still inside the interval (one-step overshoot parity with `march`)
        in_rng = t[..., :-1] < t_end[..., None]
        both = vp & vn & in_rng
        front = both & (fp > 0.0) & (fn < 0.0)
        back = both & (fp < 0.0) & (fn > 0.0)

        any_evt = front | back
        has_evt = jnp.any(any_evt, axis=-1)
        first = jnp.argmax(any_evt, axis=-1)  # first True along the chunk

        t_prev = jnp.take_along_axis(t[..., :-1], first[..., None], axis=-1)[..., 0]
        f_prev = jnp.take_along_axis(fp, first[..., None], axis=-1)[..., 0]
        f_next = jnp.take_along_axis(fn, first[..., None], axis=-1)[..., 0]
        is_front = jnp.take_along_axis(front, first[..., None], axis=-1)[..., 0]

        frac = f_prev / jnp.maximum(f_prev - f_next, 1e-30)
        t_hit = t_prev + step * frac

        ev = active & has_evt
        hit_t = jnp.where(ev & is_front, t_hit, hit_t)
        back_t = jnp.where(ev & ~is_front, t_prev + step, back_t)

        # a ray stays active until it has an event or leaves the interval
        exhausted = base + chunk * step >= t_end
        active = active & ~has_evt & ~exhausted
        return (k + 1, active, hit_t, back_t)

    _, _, hit_t, back_t = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), active0, hit0, back0)
    )
    return MarchResult(hit_t=hit_t, back_t=back_t)


def build_occupancy(tsdf: jnp.ndarray, block: int = 8) -> jnp.ndarray:
    """Coarse occupancy grid for empty-space skipping.

    A `block`^3 cell is *occupied* iff it contains any voxel with TSDF < 0.
    Cells with all samples >= 0 can produce no march event: a front (+,-)
    crossing needs a negative `f_next` and a backface (-,+) crossing a
    negative `f_prev` (tsdf_volume.cu:242-246 semantics), so such cells —
    observed free space, the front truncation band, AND unobserved space
    (stored as 0) — are all safely skippable at cell granularity. Crossings
    that straddle a cell boundary are caught by `march_hier`'s two-step
    backup into the preceding cell.

    Works directly on the int16 fixed-point array (sign is preserved by the
    encoding). Requires all dims divisible by `block`.
    """
    Z, Y, X = tsdf.shape
    b = block
    # staged axis-by-axis pooling, minor dim first
    m = tsdf.reshape(Z, Y, X // b, b).min(axis=3)
    m = m.reshape(Z, Y // b, b, X // b).min(axis=2)
    min_f = m.reshape(Z // b, b, Y // b, X // b).min(axis=1)
    return min_f < 0


def march_hier(
    tsdf_local: jnp.ndarray,
    occ: jnp.ndarray,
    org: jnp.ndarray,
    dirs: jnp.ndarray,
    t_start: jnp.ndarray,
    t_end: jnp.ndarray,
    step: float,
    inv_vs: jnp.ndarray,
    block: int = 8,
    max_iters: int | None = None,
) -> MarchResult:
    """Two-level lockstep march: DDA over coarse cells, fine steps only
    inside cells that can hold a crossing.

    Fine sampling inside an occupied cell starts two steps before the cell
    entry (so the `f_prev` sample for a boundary-straddling crossing lands
    in the already skipped cell), which shifts the sample grid by a
    fraction of a step relative to `march`'s global grid. On observed
    surfaces the refined `hit_t` then differs from `march` by O(step).
    Where unobserved voxels (stored as 0) interleave with observed ones,
    the shifted samples read other voxels and the hit/no-hit decision can
    differ: about 3 % of pixels at 64^3-256^3 after five frames of the
    synthetic orbit, against `march` and the float64 reference alike.

    Every iteration issues exactly ONE gather from a combined fine+coarse
    table: coarse-mode rays read their cell's occupancy word, fine-mode
    rays read their voxel. Skipping cuts the
    lockstep iteration count from O(diagonal/step) to
    O(diagonal/(block*voxel)) + O(occupied cells crossed).
    """
    Zl, Y, X = tsdf_local.shape
    Zc, Yc, Xc = occ.shape
    assert (Zc, Yc, Xc) == (Zl // block, Y // block, X // block)
    n_fine = Zl * Y * X

    # Coarse cells encoded with the same sign convention as the TSDF:
    # negative == occupied, so one comparison serves both modes.
    comb = jnp.concatenate(
        [
            tsdf_local.reshape(-1),
            jnp.where(occ.reshape(-1), jnp.int16(-1), jnp.int16(1)),
        ]
    )

    if max_iters is None:
        # worst case: every cell on the diagonal fine-marched end to end,
        # with progress >= step/4 per iteration in degenerate corners.
        max_iters = int(8 * (Zl + Y + X))

    safe_dirs = jnp.where(jnp.abs(dirs) < 1e-12, 1e-12, dirs)
    pos_dir = dirs > 0
    vs = 1.0 / inv_vs  # [3] metres per voxel

    def sample_indices(t):
        """(fine linear index, fine validity, coarse linear index, cell
        exit t) at ray parameter t."""
        p = (org[None, None, :] + dirs * t[..., None]) * inv_vs  # voxel coords
        # fine (nearest voxel, reference validity: 1-voxel border)
        xi = jnp.rint(p[..., 0]).astype(jnp.int32)
        yi = jnp.rint(p[..., 1]).astype(jnp.int32)
        zi = jnp.rint(p[..., 2]).astype(jnp.int32)
        v = (
            (xi >= 1)
            & (xi < X - 1)
            & (yi >= 1)
            & (yi < Y - 1)
            & (zi >= 1)
            & (zi < Zl - 1)
        )
        fine_lin = jnp.clip((zi * Y + yi) * X + xi, 0, n_fine - 1)
        # coarse cell + DDA exit parameter
        cell = jnp.floor(p / block).astype(jnp.int32)
        cc = jnp.clip(cell, 0, jnp.array([Xc - 1, Yc - 1, Zc - 1], jnp.int32))
        coarse_lin = n_fine + (cc[..., 2] * Yc + cc[..., 1]) * Xc + cc[..., 0]
        bound_vox = (cell + pos_dir.astype(jnp.int32)).astype(jnp.float32) * block
        t_ax = (bound_vox * vs - org[None, None, :]) / safe_dirs
        t_exit = jnp.min(t_ax, axis=-1)
        return fine_lin, v, coarse_lin, t_exit

    t0 = t_start
    shape = t0.shape
    hit0 = jnp.full(shape, _INF, dtype=jnp.float32)
    back0 = jnp.full(shape, _INF, dtype=jnp.float32)
    alive0 = t0 < t_end
    state0 = (
        jnp.asarray(0, jnp.int32),  # k
        t0,
        jnp.zeros(shape, jnp.float32),  # f_prev
        jnp.zeros(shape, jnp.bool_),  # v_prev
        jnp.ones(shape, jnp.bool_),  # coarse mode
        jnp.full(shape, -_INF, jnp.float32),  # fine_until
        alive0,
        hit0,
        back0,
    )

    def cond(state):
        k, _, _, _, _, _, alive, _, _ = state
        return jnp.any(alive) & (k < max_iters)

    def body(state):
        k, t, f_prev, v_prev, coarse, fine_until, alive, hit_t, back_t = state
        tnext = t + step
        fine_lin, v_next, _, _ = sample_indices(tnext)
        _, _, coarse_lin, t_exit = sample_indices(t)

        raw = jnp.take(comb, jnp.where(coarse, coarse_lin, fine_lin))
        neg = raw < 0

        # ---- fine branch: crossing tests on consecutive samples ----
        f_next = raw.astype(jnp.float32) * (1.0 / SHORTMAX)
        both = ~coarse & alive & v_prev & v_next
        front = both & (f_prev > 0.0) & (f_next < 0.0)
        back = both & (f_prev < 0.0) & (f_next > 0.0)
        frac = f_prev / jnp.maximum(f_prev - f_next, 1e-30)
        hit_t = jnp.where(front, jnp.minimum(hit_t, t + step * frac), hit_t)
        back_t = jnp.where(back, jnp.minimum(back_t, tnext), back_t)

        # ---- coarse branch: skip empty cell / drop to fine ----
        occupied = coarse & neg
        # guaranteed-progress DDA skip past the cell boundary
        t_skip = jnp.maximum(t_exit + 0.05 * step, t + 0.25 * step)
        # enter fine mode two steps early so f_prev lands in the skipped cell
        t_enter = jnp.maximum(t - 2.0 * step, t_start - step)

        t_new = jnp.where(
            coarse, jnp.where(occupied, t_enter, t_skip), tnext
        )
        coarse_new = jnp.where(
            coarse, ~occupied, tnext >= fine_until
        )
        fine_until_new = jnp.where(occupied, t_exit, fine_until)
        f_prev_new = jnp.where(coarse, 0.0, f_next)
        v_prev_new = jnp.where(coarse, False, v_next)

        alive_new = alive & ~front & ~back & (t_new < t_end)
        return (
            k + 1,
            jnp.where(alive, t_new, t),
            f_prev_new,
            v_prev_new,
            coarse_new,
            fine_until_new,
            alive_new,
            hit_t,
            back_t,
        )

    out = jax.lax.while_loop(cond, body, state0)
    return MarchResult(hit_t=out[7], back_t=out[8])


def shade(
    tsdf_local: jnp.ndarray,
    dims_g: Tuple[int, int, int],
    z0h: jnp.ndarray | int,
    org: jnp.ndarray,
    dirs: jnp.ndarray,
    hit_t: jnp.ndarray,
    hit_mask: jnp.ndarray,
    voxel_size: Tuple[float, float, float],
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Vertex (volume frame) + trilinear-gradient normal at the hits.

    Returns (vertex [H,W,3], normal [H,W,3], valid [H,W]).
    """
    local_z = tsdf_local.shape[0]
    tsdf_flat = tsdf_local.reshape(-1)
    vsx, vsy, vsz = voxel_size
    inv_vs = jnp.array([1.0 / vsx, 1.0 / vsy, 1.0 / vsz], dtype=jnp.float32)
    delta = jnp.array([vsx, vsy, vsz], dtype=jnp.float32) * 0.5

    t_safe = jnp.where(hit_mask, hit_t, 0.0)
    vertex = org[None, None, :] + dirs * t_safe[..., None]

    def axis_grad(axis):
        e = jnp.zeros((3,), jnp.float32).at[axis].set(delta[axis])
        f1, v1 = trilinear(tsdf_flat, dims_g, z0h, local_z, (vertex + e) * inv_vs)
        f2, v2 = trilinear(tsdf_flat, dims_g, z0h, local_z, (vertex - e) * inv_vs)
        return (f1 - f2) / (2.0 * delta[axis]), v1 & v2

    gx, vx = axis_grad(0)
    gy, vy = axis_grad(1)
    gz, vz = axis_grad(2)
    n = jnp.stack([gx, gy, gz], axis=-1)
    nrm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    valid = hit_mask & vx & vy & vz & (nrm[..., 0] > 1e-20)
    n = n / jnp.maximum(nrm, 1e-30)
    return vertex, n, valid


def camera_rays(cam2vol: Pose, intr: Intrinsics):
    """(origin [3], unit direction [H,W,3]) of all pixel rays in the volume
    frame (tsdf_volume.cu:217-220)."""
    R, t = cam2vol
    dirs = jnp.einsum("ij,hwj->hwi", R, intr.pixel_rays())
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    return t, dirs


def raycast(
    vol: TSDFVolume,
    cam2vol: Pose,
    intr: Intrinsics,
    params: KinFuParams,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-device raycast: camera-frame vertex/normal maps [H, W, 3]."""
    Z, Y, X = vol.tsdf.shape
    vsx, vsy, vsz = params.voxel_size
    step = params.raycast_step_voxels * vsx
    inv_vs = jnp.array([1.0 / vsx, 1.0 / vsy, 1.0 / vsz], dtype=jnp.float32)

    org, dirs = camera_rays(cam2vol, intr)
    box_max = jnp.array(params.volume_range, dtype=jnp.float32)
    tnear, tfar = ray_aabb(org, dirs, box_max)
    t_start = jnp.maximum(tnear, 0.0) + step

    # march_hier skips coarse cells that cannot hold a crossing (one DDA
    # iteration per empty 8^3 cell instead of `block` fine steps); `step`
    # is the reference-semantics march on the global sample grid.
    block = 8
    mode = params.raycast_mode
    if mode == "auto":
        divisible = Z % block == 0 and Y % block == 0 and X % block == 0
        mode = "hier" if divisible else "step"
    if mode == "hier":
        occ = build_occupancy(vol.tsdf, block)
        res = march_hier(
            vol.tsdf, occ, org, dirs, t_start, tfar, step, inv_vs, block
        )
    elif mode == "step":
        res = march(vol.tsdf, (Z, Y, X), 0, org, dirs, t_start, tfar, step, inv_vs)
    else:
        raise ValueError(f"unknown raycast_mode: {params.raycast_mode!r}")
    hit = (res.hit_t < res.back_t) & (res.hit_t < _INF)

    vertex, n, valid = shade(
        vol.tsdf, (Z, Y, X), 0, org, dirs, res.hit_t, hit, params.voxel_size
    )

    R, t = cam2vol
    Rinv = R.T
    vcam = jnp.einsum("ij,hwj->hwi", Rinv, vertex - org[None, None, :])
    ncam = jnp.einsum("ij,hwj->hwi", Rinv, n)
    mask = valid.astype(jnp.float32)[..., None]
    return vcam * mask, ncam * mask
