"""Plain float64 numpy references for the three volume/tracking stages.

Written independently of the jnp pipeline, straight from the CUDA
reference's semantics, so tests and the on-card smoke check can hold the
compiled stages to them:

  - `integrate_ref`: device::integrate (tsdf_volume.cu:41-110), with the
    documented divergence that every z slab integrates (DIVERGENCES.md);
  - `raycast_ref`: device::raycast (tsdf_volume.cu:217-258) — a per-ray
    one-voxel march with the refinement and invalid-normal fixes of
    DIVERGENCES.md items 2 and 10;
  - `icp_normal_equations_ref`: device::ICP::findCoresp + kernel_rigidICP
    (rigid_icp.cu:46-112): association, gates, and the 6x6 system.

Volumes are int16/int16/int32 [Z, Y, X] arrays as in volume/tsdf.py. Poses
are 4x4 float matrices. Everything is computed in float64; outputs are
rounded to the stored types with the reference's own conversions.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

SHORTMAX = 32767.0


def _split(T) -> Tuple[np.ndarray, np.ndarray]:
    T = np.asarray(T, dtype=np.float64)
    return T[:3, :3], T[:3, 3]


def _unpack_rgb(packed: np.ndarray) -> np.ndarray:
    p = packed.astype(np.int64)
    return np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], -1).astype(
        np.float64
    )


def _pack_rgb(rgb: np.ndarray) -> np.ndarray:
    r = rgb.astype(np.int64)
    return ((r[..., 0] << 16) | (r[..., 1] << 8) | r[..., 2]).astype(np.int32)


def integrate_ref(
    tsdf: np.ndarray,
    weight: np.ndarray,
    color: np.ndarray,
    depth_m: np.ndarray,
    color_rgb: np.ndarray,
    vol2cam,
    intr,
    voxel_size: Tuple[float, float, float],
    trunc: float,
    max_weight: int,
    z_offset: int = 0,
):
    """One fusion pass. Returns (tsdf, weight, color) in stored types.

    Voxel (x, y, z) sits at index * voxel_size (corner convention, :49);
    `z_offset` is the global index of the first z slab."""
    Z, Y, X = tsdf.shape
    h, w = depth_m.shape
    R, t = _split(vol2cam)
    zz, yy, xx = np.meshgrid(
        (np.arange(Z) + z_offset) * voxel_size[2],
        np.arange(Y) * voxel_size[1],
        np.arange(X) * voxel_size[0],
        indexing="ij",
    )
    p = np.stack([xx, yy, zz], axis=-1)
    vc = p @ R.T + t
    zc = vc[..., 2]
    front = zc > 0
    zs = np.where(front, zc, 1.0)
    # Intrs::proj rounds to nearest (device_utils.cuh:15-21)
    u = np.rint(vc[..., 0] / zs * intr.fx + intr.cx).astype(np.int64)
    v = np.rint(vc[..., 1] / zs * intr.fy + intr.cy).astype(np.int64)
    inb = front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    uc, vcl = np.clip(u, 0, w - 1), np.clip(v, 0, h - 1)
    depth = np.where(inb, depth_m.astype(np.float64)[vcl, uc], 0.0)
    valid = inb & (depth > 0)

    lam = np.sqrt(((u - intr.cx) / intr.fx) ** 2 + ((v - intr.cy) / intr.fy) ** 2 + 1)
    sdf = -(np.linalg.norm(vc, axis=-1) / lam - depth)
    upd = valid & (sdf >= -trunc)

    w_old = weight.astype(np.float64)
    t_old = tsdf.astype(np.float64) / SHORTMAX
    w_new = np.minimum(w_old + 1.0, float(max_weight))
    t_new = (t_old * w_old + np.minimum(1.0, sdf / trunc)) / (w_old + 1.0)
    fixed = np.trunc(np.clip(t_new * SHORTMAX, -SHORTMAX, SHORTMAX))
    tsdf_out = np.where(upd, fixed, tsdf).astype(np.int16)
    weight_out = np.where(upd, w_new, weight).astype(np.int16)

    # colour only inside the half-truncation band, averaged with the
    # already-incremented weight (:82-96)
    cupd = upd & (np.abs(sdf) <= trunc * 0.5)
    pix = color_rgb.astype(np.float64)[vcl, uc]
    mixed = (w_new[..., None] * _unpack_rgb(color) + pix) / (w_new[..., None] + 1)
    mixed = np.trunc(np.clip(mixed, 0.0, 255.0))
    color_out = np.where(cupd, _pack_rgb(mixed), color).astype(np.int32)
    return tsdf_out, weight_out, color_out


def _nearest(tsdf: np.ndarray, p_vox: np.ndarray):
    """Nearest-voxel TSDF, invalid outside [1, dims-2] (:166-177)."""
    Z, Y, X = tsdf.shape
    i = np.rint(p_vox).astype(np.int64)
    valid = (
        (i[..., 0] >= 1) & (i[..., 0] < X - 1)
        & (i[..., 1] >= 1) & (i[..., 1] < Y - 1)
        & (i[..., 2] >= 1) & (i[..., 2] < Z - 1)
    )
    ic = [np.clip(i[..., k], 0, d - 1) for k, d in enumerate((X, Y, Z))]
    return tsdf[ic[2], ic[1], ic[0]].astype(np.float64) / SHORTMAX, valid


def _trilinear(tsdf: np.ndarray, p_vox: np.ndarray):
    """Trilinear TSDF at voxel coords; floor anchor, invalid outside
    [0, dims-2] (device::interpolate, :139-161)."""
    Z, Y, X = tsdf.shape
    g = np.floor(p_vox)
    gi = g.astype(np.int64)
    valid = (
        (gi[..., 0] >= 0) & (gi[..., 0] < X - 1)
        & (gi[..., 1] >= 0) & (gi[..., 1] < Y - 1)
        & (gi[..., 2] >= 0) & (gi[..., 2] < Z - 1)
    )
    f = p_vox - g
    gc = [np.clip(gi[..., k], 0, d - 2) for k, d in enumerate((X, Y, Z))]
    acc = np.zeros(p_vox.shape[:-1])
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wgt = (
                    (f[..., 0] if dx else 1 - f[..., 0])
                    * (f[..., 1] if dy else 1 - f[..., 1])
                    * (f[..., 2] if dz else 1 - f[..., 2])
                )
                val = tsdf[gc[2] + dz, gc[1] + dy, gc[0] + dx] / SHORTMAX
                acc += wgt * val
    return acc, valid


def raycast_ref(
    tsdf: np.ndarray,
    cam2vol,
    intr,
    voxel_size: Tuple[float, float, float],
    step_voxels: float = 1.0,
):
    """Camera-frame (vertex, normal) maps [H, W, 3]; zeros where no hit.

    Rays march t_k = t_start + k * step from the AABB entry, sampling the
    nearest voxel; a +,- crossing of consecutive valid samples is a hit
    refined linearly forward, a -,+ crossing ends the ray without one."""
    Z, Y, X = tsdf.shape
    R, org = _split(cam2vol)
    vs = np.asarray(voxel_size, np.float64)
    step = step_voxels * vs[0]
    v, u = np.mgrid[0 : intr.height, 0 : intr.width].astype(np.float64)
    rays = np.stack(
        [(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, np.ones_like(u)], -1
    )
    dirs = rays @ R.T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    box = vs * np.array([X, Y, Z], np.float64)
    safe = np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
    t0, t1 = (0.0 - org) / safe, (box - org) / safe
    tnear = np.max(np.minimum(t0, t1), -1)
    tfar = np.min(np.maximum(t0, t1), -1)
    t_start = np.maximum(tnear, 0.0) + step

    def sample(t):
        return _nearest(tsdf, (org + dirs * t[..., None]) / vs)

    hit_t = np.full(t_start.shape, np.inf)
    k = 0
    alive = t_start < tfar
    f_prev, v_prev = sample(t_start)
    while alive.any():
        t_cur = t_start + k * step
        t_next = t_start + (k + 1) * step
        f_next, v_next = sample(t_next)
        both = alive & v_prev & v_next
        front = both & (f_prev > 0) & (f_next < 0)
        back = both & (f_prev < 0) & (f_next > 0)
        frac = f_prev / np.maximum(f_prev - f_next, 1e-30)
        hit_t = np.where(front, t_cur + step * frac, hit_t)
        alive = alive & ~front & ~back & (t_next < tfar)
        f_prev, v_prev = f_next, v_next
        k += 1

    hit = np.isfinite(hit_t)
    vertex = org + dirs * np.where(hit, hit_t, 0.0)[..., None]
    grads, ok = [], hit
    for ax in range(3):
        e = np.zeros(3)
        e[ax] = vs[ax] * 0.5
        f1, v1 = _trilinear(tsdf, (vertex + e) / vs)
        f2, v2 = _trilinear(tsdf, (vertex - e) / vs)
        grads.append((f1 - f2) / vs[ax])
        ok = ok & v1 & v2
    n = np.stack(grads, -1)
    nrm = np.linalg.norm(n, axis=-1, keepdims=True)
    ok = ok & (nrm[..., 0] > 1e-20)
    n = n / np.maximum(nrm, 1e-30)
    vcam = (vertex - org) @ R
    ncam = n @ R
    m = ok[..., None]
    return np.where(m, vcam, 0.0), np.where(m, ncam, 0.0)


def icp_normal_equations_ref(
    inc,
    cur_vmap: np.ndarray,
    cur_nmap: np.ndarray,
    pre_vmap: np.ndarray,
    pre_nmap: np.ndarray,
    intr,
    dist_thres: float,
    angle_thres_deg: float,
):
    """(G [7,7], inlier count) of one Gauss-Newton iteration, where
    A = G[:6, :6] and b = G[:6, 6].

    The current vertex s = inc * v is projected into the previous frame,
    the model vertex d and normal n there are gated by distance and by
    ||n_cur x n|| <= sin(angle), and each inlier adds the row
    r = [s x n, n | n . (d - s)] to G = sum r^T r."""
    R, t = _split(inc)
    h, w, _ = pre_vmap.shape
    cv = cur_vmap.astype(np.float64)
    cn = cur_nmap.astype(np.float64)
    pv = pre_vmap.astype(np.float64)
    pn = pre_nmap.astype(np.float64)

    s = cv @ R.T + t
    z = s[..., 2]
    zs = np.where(z > 0, z, 1.0)
    u = np.rint(s[..., 0] / zs * intr.fx + intr.cx).astype(np.int64)
    v = np.rint(s[..., 1] / zs * intr.fy + intr.cy).astype(np.int64)
    inb = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    uc, vc = np.clip(u, 0, w - 1), np.clip(v, 0, h - 1)
    d, n = pv[vc, uc], pn[vc, uc]

    sine = np.linalg.norm(np.cross(cn @ R.T, n), axis=-1)
    mask = (
        inb
        & np.any(cn != 0, -1)
        & np.any(n != 0, -1)
        & (np.linalg.norm(s - d, axis=-1) <= dist_thres)
        & (sine <= math.sin(math.radians(angle_thres_deg)))
    )
    rows = np.concatenate(
        [np.cross(s, n), n, np.sum(n * (d - s), -1, keepdims=True)], -1
    )[mask]
    return rows.T @ rows, int(mask.sum())


def gram_error(A, b, G_ref) -> float:
    """Largest entry error of (A, b) against G_ref, each entry scaled by
    sqrt(G_ii G_jj) — the Cauchy-Schwarz bound of that entry, so entries
    that cancel to near zero are not judged by their own size."""
    d = np.sqrt(np.maximum(np.diag(G_ref), 1e-300))
    ea = np.abs(np.asarray(A, np.float64) - G_ref[:6, :6]) / np.outer(d[:6], d[:6])
    eb = np.abs(np.asarray(b, np.float64) - G_ref[:6, 6]) / (d[:6] * d[6])
    return float(max(ea.max(), eb.max()))
