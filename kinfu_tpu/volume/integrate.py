"""TSDF fusion (integrate) — jnp reference implementation.

One functional pass over the volume per frame: every voxel projects into the
depth map (a ~1.2 MB image, small enough to stay cache-resident), reads its
depth, and folds the new truncated SDF observation into the running weighted
average. Processing is a `lax.scan` over Z-chunks so XLA keeps intermediates
at chunk size instead of materialising 512^3 float temporaries, and can fuse
each chunk's projection, gather and update into one loop — the reference's
own per-voxel design.

Math parity with device::integrate (tsdf_volume.cu:41-110):
  - voxel world position = index * voxel_size  (corner convention, :49)
  - sdf = -(||vc|| / ||K^-1 [u,v,1]|| - depth) with nearest-pixel lookup (:59-68)
  - update iff sdf >= -trunc: tsdf = min(1, sdf/trunc),
    w' = min(w+1, max_weight), t' = (t*w + tsdf)/(w + 1)   (:69-79)
  - color averaged only within |sdf| <= trunc/2, with the reference's own
    (already-incremented) weight convention (:82-96)
Divergence: the reference never touches the z=0 slab (its z loop starts at 1,
:52-56); here all slabs integrate. Recorded in DIVERGENCES.md.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kinfu_tpu.config import KinFuParams
from kinfu_tpu.geometry.se3 import Pose
from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.volume.tsdf import (
    TSDFVolume,
    pack_rgb,
    tsdf_to_fixed,
    tsdf_to_float,
    unpack_rgb,
)


def _pick_z_chunk(z: int) -> int:
    """Largest power-of-two chunk <= 16 that divides Z."""
    for c in (16, 8, 4, 2, 1):
        if z % c == 0:
            return c
    return 1


def integrate(
    vol: TSDFVolume,
    depth_m: jnp.ndarray,
    color_rgb: jnp.ndarray,
    vol2cam: Pose,
    intr: Intrinsics,
    params: KinFuParams,
    z_offset: jnp.ndarray | int = 0,
) -> TSDFVolume:
    """Fuse one (depth [H,W] metres, color [H,W,3] u8) observation.

    `vol2cam` maps volume coordinates to the camera frame
    (camera_pose^-1 * volume_pose, tsdf_volume.cpp:50). `z_offset` is the
    global Z index of vol's first slab — nonzero when `vol` is one shard
    of a mesh-distributed volume (kinfu_tpu/parallel/): integration is
    embarrassingly parallel across shards.
    """
    Z, Y, X = vol.tsdf.shape
    h, w = depth_m.shape
    vsx, vsy, vsz = params.voxel_size
    trunc = params.trunc_dist
    max_weight = params.tsdf_max_weight

    depth_flat = depth_m.reshape(-1)
    color_flat = pack_rgb(color_rgb).reshape(-1)

    R, t = vol2cam
    cz = _pick_z_chunk(Z)
    n_chunks = Z // cz

    # Per-chunk constant index grids.
    yy = jax.lax.broadcasted_iota(jnp.float32, (cz, Y, X), 1) * vsy
    xx = jax.lax.broadcasted_iota(jnp.float32, (cz, Y, X), 2) * vsx
    zz_local = jax.lax.broadcasted_iota(jnp.float32, (cz, Y, X), 0) * vsz

    z_offset = jnp.asarray(z_offset, dtype=jnp.int32)

    def chunk_update(args):
        tsdf_c, weight_c, color_c, z0 = args
        pz = zz_local + (z0 + z_offset).astype(jnp.float32) * vsz
        # camera-frame voxel position
        vcx = R[0, 0] * xx + R[0, 1] * yy + R[0, 2] * pz + t[0]
        vcy = R[1, 0] * xx + R[1, 1] * yy + R[1, 2] * pz + t[1]
        vcz = R[2, 0] * xx + R[2, 1] * yy + R[2, 2] * pz + t[2]

        in_front = vcz > 0
        zsafe = jnp.where(in_front, vcz, 1.0)
        u = jnp.rint(vcx / zsafe * intr.fx + intr.cx).astype(jnp.int32)
        v = jnp.rint(vcy / zsafe * intr.fy + intr.cy).astype(jnp.int32)
        inb = in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)

        lin = jnp.clip(v * w + u, 0, h * w - 1)
        depth = jnp.take(depth_flat, lin)
        valid = inb & (depth > 0)

        # sdf = -(||vc|| / lambda - depth), lambda = ||K^-1 [u,v,1]||
        lx = (u.astype(jnp.float32) - intr.cx) / intr.fx
        ly = (v.astype(jnp.float32) - intr.cy) / intr.fy
        lam = jnp.sqrt(lx * lx + ly * ly + 1.0)
        vc_norm = jnp.sqrt(vcx * vcx + vcy * vcy + vcz * vcz)
        sdf = -(vc_norm / lam - depth)

        upd = valid & (sdf >= -trunc)
        tsdf_obs = jnp.minimum(1.0, sdf / trunc)

        w_old = weight_c.astype(jnp.float32)
        t_old = tsdf_to_float(tsdf_c)
        w_new = jnp.minimum(w_old + 1.0, float(max_weight))
        t_new = (t_old * w_old + tsdf_obs) / (w_old + 1.0)

        tsdf_out = jnp.where(upd, tsdf_to_fixed(t_new), tsdf_c)
        weight_out = jnp.where(upd, w_new.astype(jnp.int16), weight_c)

        # color: only within the half-truncation band (tsdf_volume.cu:82-96)
        cupd = upd & (sdf <= trunc * 0.5) & (sdf >= -trunc * 0.5)
        pix = unpack_rgb(jnp.take(color_flat, lin))
        old_rgb = unpack_rgb(color_c)
        mixed = (w_new[..., None] * old_rgb + pix) / (w_new[..., None] + 1.0)
        mixed_u8 = jnp.clip(mixed, 0.0, 255.0).astype(jnp.uint8)
        color_out = jnp.where(cupd, pack_rgb(mixed_u8), color_c)

        return tsdf_out, weight_out, color_out

    def scan_body(_, xs):
        return None, chunk_update(xs)

    z0s = jnp.arange(n_chunks, dtype=jnp.int32) * cz
    xs = (
        vol.tsdf.reshape(n_chunks, cz, Y, X),
        vol.weight.reshape(n_chunks, cz, Y, X),
        vol.color.reshape(n_chunks, cz, Y, X),
        z0s,
    )
    _, (tsdf_n, weight_n, color_n) = jax.lax.scan(scan_body, None, xs)
    return TSDFVolume(
        tsdf=tsdf_n.reshape(Z, Y, X),
        weight=weight_n.reshape(Z, Y, X),
        color=color_n.reshape(Z, Y, X),
    )
