"""TSDF volume state: a pure pytree of dense arrays.

Layout is [Z, Y, X] with X innermost (contiguous rows of X voxels) and Z
outermost so the volume shards/streams along Z.

Voxel storage parity with the reference's 8-byte `Voxel{short tsdf; short
weight; uchar3 rgb}` (device_types.hpp:51-56): TSDF is int16 fixed-point
scaled by 32767 (device_utils.cuh:6-7,:57-64), weight int16 clamped to
max_weight, color packed as 0x00RRGGBB in int32 (values <=
0x00FFFFFF, so the sign bit is never set; int32 keeps the volume free of
u32<->s32 bitcast_convert ops).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

SHORTMAX = 32767.0


class TSDFVolume(NamedTuple):
    """Dense TSDF state. All arrays are [Z, Y, X]."""

    tsdf: jnp.ndarray  # int16, fixed-point distance / trunc in [-1, 1]
    weight: jnp.ndarray  # int16
    color: jnp.ndarray  # int32, packed 0x00RRGGBB (always >= 0)


def create_volume(dims_xyz: Tuple[int, int, int]) -> TSDFVolume:
    """Allocate a zeroed volume; dims given as (X, Y, Z) like the config."""
    x, y, z = dims_xyz
    shape = (z, y, x)
    return TSDFVolume(
        tsdf=jnp.zeros(shape, dtype=jnp.int16),
        weight=jnp.zeros(shape, dtype=jnp.int16),
        color=jnp.zeros(shape, dtype=jnp.int32),
    )


def reset_volume(vol: TSDFVolume) -> TSDFVolume:
    """Zero all fields (device::resetVolume, tsdf_volume.cu:11-32)."""
    return TSDFVolume(
        tsdf=jnp.zeros_like(vol.tsdf),
        weight=jnp.zeros_like(vol.weight),
        color=jnp.zeros_like(vol.color),
    )


def tsdf_to_float(fixed: jnp.ndarray) -> jnp.ndarray:
    """int16 fixed-point -> float32 in [-1, 1] (device_utils.cuh:62)."""
    return fixed.astype(jnp.float32) * (1.0 / SHORTMAX)


def tsdf_to_fixed(value: jnp.ndarray) -> jnp.ndarray:
    """float32 -> int16 fixed-point, truncating toward zero like the
    reference's static_cast<int> (device_utils.cuh:57)."""
    scaled = jnp.clip(value * SHORTMAX, -SHORTMAX, SHORTMAX)
    return jnp.trunc(scaled).astype(jnp.int16)


def pack_rgb(rgb: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] uint8 -> [...] int32 packed 0x00RRGGBB."""
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    return (r << 16) | (g << 8) | b


def unpack_rgb(packed: jnp.ndarray) -> jnp.ndarray:
    """[...] packed int -> [..., 3] float32 channels in [0, 255]."""
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return jnp.stack([r, g, b], axis=-1).astype(jnp.float32)
