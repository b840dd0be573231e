"""Device mesh setup and sharding specs.

The reference is strictly single-GPU (SURVEY.md section 2, parallelism
inventory); this module is the scaling layer: the TSDF volume block-shards
along Z across a 1-D mesh axis ``"z"`` and all cross-device communication is
XLA collectives (psum / ppermute / pmin), never host transfers. The cards of
one host reach each other all to all, so the mesh follows the algorithm and
stays 1-D.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

VOLUME_AXIS = "z"


def make_mesh(n_shards: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the volume-sharding axis."""
    if devices is None:
        devices = jax.devices()
    if n_shards is None:
        n_shards = len(devices)
    if n_shards > len(devices):
        raise ValueError(f"need {n_shards} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n_shards]), (VOLUME_AXIS,))


def volume_sharding(mesh: Mesh) -> NamedSharding:
    """[Z, Y, X] volume arrays shard along Z."""
    return NamedSharding(mesh, P(VOLUME_AXIS, None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
