"""Surface point extraction from the TSDF volume.

The reference uses warp-ballot/prefix-scan compaction with global atomics
(FullScan6, tsdf_volume.cu:307-479, modeled on PCL). The equivalent here
is a dense sign-change mask over the whole volume followed by a
`jnp.nonzero(size=N)` prefix-sum compaction into a fixed-size buffer — the
same dataflow (scan + compact) with XLA-friendly static shapes.

Parity of the crossing rule (tsdf_volume.cu:330-421):
  - voxel centre positions (index + 0.5) * voxel_size  [note: extraction uses
    the +0.5 centre convention while integrate/raycast use corners — a
    reference inconsistency faithfully preserved]
  - a crossing exists along +x/+y/+z when both voxels have weight != 0,
    tsdf != 1, and opposite TSDF signs; the point interpolates by
    |F_neighbour| / (|F| + |F_n|) and transforms by the volume pose.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


from kinfu_tpu.config import KinFuParams
from kinfu_tpu.geometry.se3 import Pose, transform_points
from kinfu_tpu.volume.tsdf import TSDFVolume, tsdf_to_float


def _extract(vol, volume_pose, params, max_points, with_colors):
    Z, Y, X = vol.tsdf.shape
    vs = jnp.array(params.voxel_size, dtype=jnp.float32)

    F = tsdf_to_float(vol.tsdf)
    W = vol.weight
    ok = (W != 0) & (F != 1.0)
    if with_colors:
        col_i32 = vol.color  # int32 packed RGB (volume/tsdf.py)

    pts_all = []
    mask_all = []
    col_all = []
    for axis, (dz, dy, dx) in (("x", (0, 0, 1)), ("y", (0, 1, 0)), ("z", (1, 0, 0))):
        sl_a = (slice(0, Z - dz), slice(0, Y - dy), slice(0, X - dx))
        sl_b = (slice(dz, Z), slice(dy, Y), slice(dx, X))
        Fa, Fb = F[sl_a], F[sl_b]
        crossing = (
            ok[sl_a]
            & ok[sl_b]
            & (((Fa > 0) & (Fb < 0)) | ((Fa < 0) & (Fb > 0)))
        )
        denom = jnp.abs(Fa) + jnp.abs(Fb)
        frac = jnp.abs(Fa) / jnp.maximum(denom, 1e-30)

        zz = jnp.arange(Z - dz, dtype=jnp.float32)[:, None, None]
        yy = jnp.arange(Y - dy, dtype=jnp.float32)[None, :, None]
        xx = jnp.arange(X - dx, dtype=jnp.float32)[None, None, :]
        base = jnp.stack(
            [
                jnp.broadcast_to(xx, Fa.shape) + 0.5,
                jnp.broadcast_to(yy, Fa.shape) + 0.5,
                jnp.broadcast_to(zz, Fa.shape) + 0.5,
            ],
            axis=-1,
        )
        offset = jnp.zeros((3,), jnp.float32).at[{"x": 0, "y": 1, "z": 2}[axis]].set(1.0)
        p = (base + frac[..., None] * offset) * vs
        pts_all.append(p.reshape(-1, 3))
        mask_all.append(crossing.reshape(-1))
        if with_colors:
            # colour of the voxel the crossing point is nearer to (the
            # reference extracts xyz only, tsdf_volume.cu:307-421; colour
            # export is an extension feeding the 3D view / coloured PLY)
            c = jnp.where(frac < 0.5, col_i32[sl_a], col_i32[sl_b])
            col_all.append(c.reshape(-1))

    pts = jnp.concatenate(pts_all, axis=0)
    mask = jnp.concatenate(mask_all, axis=0)

    idx = jnp.nonzero(mask, size=max_points, fill_value=0)[0]
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), max_points)
    sel = jnp.take(pts, idx, axis=0)
    valid = jnp.arange(max_points) < count
    sel = jnp.where(valid[:, None], transform_points(volume_pose, sel), 0.0)
    if not with_colors:
        return sel, count
    packed = jnp.take(jnp.concatenate(col_all, axis=0), idx)
    packed = jnp.where(valid, packed, 0)
    rgb = jnp.stack(
        [
            jnp.right_shift(packed, 16) & 0xFF,
            jnp.right_shift(packed, 8) & 0xFF,
            packed & 0xFF,
        ],
        axis=-1,
    ).astype(jnp.uint8)
    return sel, rgb, count


def extract_points(
    vol: TSDFVolume,
    volume_pose: Pose,
    params: KinFuParams,
    max_points: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Return (points [N, 3] world-frame, count). Padded entries are zero."""
    if max_points is None:
        max_points = params.max_extracted_points
    return _extract(vol, volume_pose, params, max_points, with_colors=False)


def extract_points_colored(
    vol: TSDFVolume,
    volume_pose: Pose,
    params: KinFuParams,
    max_points: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Like extract_points but also returns per-point RGB u8 [N, 3] sampled
    from the colour volume at the nearer crossing voxel."""
    if max_points is None:
        max_points = params.max_extracted_points
    return _extract(vol, volume_pose, params, max_points, with_colors=True)
