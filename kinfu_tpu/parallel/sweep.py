"""Replica-parallel evaluation sweeps: N sequences fanned across a device
mesh, each device tracking its own full pipeline end to end.

SURVEY.md section 2's parallelism call-out, row 5 ("multi-host data/replica
parallelism for eval sweeps") — no reference equivalent (the reference is a
single interactive binary, main.cpp:64-101). One jitted program runs
`kinfu_step` as a `lax.scan` over frames inside a `shard_map` over the
"replica" mesh axis, so an 8-device host evaluates 8 sequences in the wall
time of one. Configs change
static shapes, so a sweep over configs is a serial loop of (cached) jitted
programs; sequences within one config share a single compile.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from kinfu_tpu.config import KinFuParams
from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.pipeline.kinfu import init_state, kinfu_step

REPLICA_AXIS = "replica"


def replica_mesh(n_devices: int | None = None) -> Mesh:
    """1-D replica mesh over the first `n_devices` local devices."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else min(n_devices, len(devs))
    return Mesh(np.asarray(devs[:n]), (REPLICA_AXIS,))


def _track_one(depths, colors, params: KinFuParams, intr: Intrinsics):
    """Scan the per-frame step over one [F, H, W] sequence; returns
    (poses [F,4,4], oks [F])."""
    state = init_state(params, intr)

    def body(st, frame):
        d, c = frame
        st, out = kinfu_step(st, d, c, params=params, intr=intr)
        return st, (out.pose_matrix, out.tracking_ok)

    _, (poses, oks) = jax.lax.scan(body, state, (depths, colors))
    return poses, oks


def track_replicated(
    depths: jnp.ndarray,  # [N, F, H, W] float32 (raw depth units)
    colors: jnp.ndarray,  # [N, F, H, W, 3] uint8
    params: KinFuParams,
    intr: Intrinsics,
    mesh: Mesh | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Track N sequences in parallel, one replica per mesh device.

    N must be a multiple of the mesh size (pad with repeated sequences if
    needed — see `sweep_sequences`). Returns (poses [N,F,4,4], oks [N,F])."""
    if mesh is None:
        mesh = replica_mesh()
    n = mesh.devices.size
    assert depths.shape[0] % n == 0, (depths.shape, n)

    def local(d, c):
        # [N/n, F, ...] local batch: scan sequences serially per device
        return jax.lax.map(
            lambda dc: _track_one(dc[0], dc[1], params, intr), (d, c)
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(REPLICA_AXIS), P(REPLICA_AXIS)),
        out_specs=(P(REPLICA_AXIS), P(REPLICA_AXIS)),
        check_vma=False,
    )
    poses, oks = jax.jit(fn)(depths, colors)
    return np.asarray(poses), np.asarray(oks)


def sweep_sequences(
    sequences: Sequence[Tuple[np.ndarray, np.ndarray]],
    params: KinFuParams,
    intr: Intrinsics,
    mesh: Mesh | None = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Convenience wrapper: pad the sequence list to the mesh size, run one
    replicated tracking program, drop the padding.

    `sequences`: list of (depths [F,H,W] float32, colors [F,H,W,3] u8),
    all the same F/H/W. Returns per-sequence (poses [F,4,4], oks [F])."""
    if mesh is None:
        mesh = replica_mesh()
    n = mesh.devices.size
    m = len(sequences)
    pad = (-m) % n
    padded = list(sequences) + [sequences[-1]] * pad
    depths = jnp.asarray(np.stack([d for d, _ in padded]))
    colors = jnp.asarray(np.stack([c for _, c in padded]))
    poses, oks = track_replicated(depths, colors, params, intr, mesh)
    return [(poses[i], oks[i]) for i in range(m)]
