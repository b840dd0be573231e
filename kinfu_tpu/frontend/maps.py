"""Vertex/normal map generation and model-pyramid downsampling.

Invalid entries are exact zeros (vertex z == 0 / zero normal). The reference
instead lets ``normalize((0,0,0))`` produce NaNs that downstream code tests
with isnan (image_process.cu:57-94); zeros keep every map finite, and every
consumer here gates on them explicitly.
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp

from kinfu_tpu.geometry.intrinsics import Intrinsics


def vertex_map(depth: jnp.ndarray, intr: Intrinsics) -> jnp.ndarray:
    """Back-project a depth map to camera-frame points [H, W, 3].

    Parity: kernel_getVertexmap (image_process.cu:29-55); depth 0 yields the
    zero vertex.
    """
    h, w = depth.shape
    v = jnp.arange(h, dtype=jnp.float32)[:, None]
    u = jnp.arange(w, dtype=jnp.float32)[None, :]
    x = depth * (u - intr.cx) / intr.fx
    y = depth * (v - intr.cy) / intr.fy
    return jnp.stack([x, y, depth], axis=-1)


def normal_map(vmap: jnp.ndarray, disc_threshold: float = 0.1) -> jnp.ndarray:
    """Normals from central differences of the vertex map.

    n = normalize(cross(v[x-1]-v[x+1], v[y-1]-v[y+1])), flipped so n.z <= 0.
    Zero where any 4-neighbour is invalid or at the image border
    (image_process.cu:57-94).

    Divergence (DIVERGENCES.md): pixels whose 4-neighbourhood spans a depth
    discontinuity (|z_nb - z| > disc_threshold * z, e.g. object silhouettes)
    are invalidated. The reference computes garbage normals there; those
    correspondences systematically bias the ICP normal equations.
    """
    h, w, _ = vmap.shape
    # roll-based neighbour access (a workaround for an earlier backend's
    # compiler, kept until a chip run shows the padded form is neutral —
    # ROADMAP C3). The wrapped border rows/cols produce garbage
    # differences there, but the border mask below already invalidates
    # them.
    left = jnp.roll(vmap, 1, axis=1)
    right = jnp.roll(vmap, -1, axis=1)
    up = jnp.roll(vmap, 1, axis=0)
    down = jnp.roll(vmap, -1, axis=0)

    ax = left - right
    ay = up - down
    n = jnp.cross(ax, ay)
    n = jnp.where(n[..., 2:3] > 0, -n, n)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)

    z = vmap[..., 2]
    tau = disc_threshold * z
    smooth = (
        (jnp.abs(left[..., 2] - z) < tau)
        & (jnp.abs(right[..., 2] - z) < tau)
        & (jnp.abs(up[..., 2] - z) < tau)
        & (jnp.abs(down[..., 2] - z) < tau)
    )
    valid = (
        smooth
        & (left[..., 2] != 0)
        & (right[..., 2] != 0)
        & (up[..., 2] != 0)
        & (down[..., 2] != 0)
        & (norm[..., 0] > 0)
    )
    # border rows/cols invalid (reference never writes them)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    valid = valid & (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1)

    n = n / jnp.maximum(norm, 1e-30)
    return jnp.where(valid[..., None], n, 0.0)


def resize_points_normals(
    vmap: jnp.ndarray, nmap: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """2x2 downsample of the raycast model maps for coarser ICP levels.

    Parity: kernel_resizePointsNormals (image_process.cu:95-135), except for
    a deliberate divergence (DIVERGENCES.md): the reference's plain 2x2 mean
    folds invalid (zero) entries into the average and never renormalises the
    averaged normal, which pollutes coarse-level vertices near holes and
    silhouettes (at 40x30 this destabilises the coarse ICP level entirely).
    Here the mean runs over *valid* entries only and normals renormalise;
    blocks with no valid entry stay zero (invalid).
    """

    def block(m: jnp.ndarray) -> jnp.ndarray:
        h, w, c = m.shape
        return m.reshape(h // 2, 2, w // 2, 2, c)

    vblk = block(vmap)
    nblk = block(nmap)
    nvalid = jnp.any(nblk != 0, axis=-1, keepdims=True)
    # a vertex is valid where its normal is (holes have both zero)
    vvalid = vblk[..., 2:3] != 0

    def masked_mean(blk, valid):
        cnt = valid.sum(axis=(1, 3))
        s = (blk * valid).sum(axis=(1, 3))
        return s / jnp.maximum(cnt, 1) * (cnt > 0)

    v = masked_mean(vblk, vvalid)
    n = masked_mean(nblk, nvalid)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-30) * (norm > 1e-20)
    return v, n


def build_measurement_pyramid(
    depth_mm: jnp.ndarray,
    intr: Intrinsics,
    *,
    pyramid_height: int,
    bfilter_kernel_size: int,
    bfilter_color_sigma: float,
    bfilter_spatial_sigma: float,
    depth_scale: float,
    max_dist: float,
    normal_disc_threshold: float = 0.1,
) -> tuple[List[jnp.ndarray], List[jnp.ndarray], List[jnp.ndarray]]:
    """Full surface-measurement stage: depth/vertex/normal pyramids.

    Order of operations matches kinectfusion.cpp:48-76: pyrDown on raw-mm
    depth, then bilateral per level, then scale+clip, then vertex/normal.
    Returns (dmaps, vmaps, nmaps), level 0 finest; dmaps are in metres.
    """
    from kinfu_tpu.frontend.depth import bilateral_filter, pyr_down, scale_and_truncate

    raw = [depth_mm]
    for _ in range(1, pyramid_height):
        raw.append(pyr_down(raw[-1]))

    dmaps, vmaps, nmaps = [], [], []
    for level in range(pyramid_height):
        d = bilateral_filter(
            raw[level],
            kernel_size=bfilter_kernel_size,
            sigma_color=bfilter_color_sigma,
            sigma_spatial=bfilter_spatial_sigma,
        )
        d = scale_and_truncate(d, depth_scale, max_dist)
        vm = vertex_map(d, intr.level(level))
        # the central-difference baseline doubles per level, so an oblique
        # surface's legitimate per-pixel depth step doubles too — scale the
        # discontinuity threshold to keep masking silhouettes, not obliques
        nm = normal_map(vm, disc_threshold=normal_disc_threshold * (2.0**level))
        dmaps.append(d)
        vmaps.append(vm)
        nmaps.append(nm)
    return dmaps, vmaps, nmaps
