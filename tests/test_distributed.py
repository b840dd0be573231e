"""Mesh-sharded pipeline tests on the 8-device CPU-emulated mesh.

Validates that the Z-sharded volume + halo-exchange raycast + psum-ICP step
produces the same results as the single-device pipeline (the reference has
no distributed mode at all; SURVEY.md section 2)."""

import numpy as np
import jax.numpy as jnp
import pytest

from kinfu_tpu.config import KinFuParams
from kinfu_tpu.data.synthetic import default_test_scene, make_translation_trajectory
from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.parallel.mesh import make_mesh
from kinfu_tpu.parallel.sharded import make_sharded_step_fn, shard_state
from kinfu_tpu.pipeline.kinfu import init_state, make_step_fn
from kinfu_tpu.volume.tsdf import tsdf_to_float

INTR = Intrinsics(width=160, height=120, fx=140.0, fy=140.0, cx=79.5, cy=59.5)
# raycast_mode is pinned to "step" so both pipelines march the identical
# global sample grid: the sharded marcher is grid-snapped plain `march`
# (parallel/sharded.py), while single-device "auto" would pick `march_hier`,
# whose sample phase legitimately differs by O(step) — a like-for-like
# comparison needs the same marcher on both sides.
PARAMS = KinFuParams(
    pyramid_height=2,
    icp_iters=(4, 8),
    volume_dims=(64, 64, 64),
    volume_range=(3.0, 3.0, 3.0),
    raycast_mode="step",
)

def _run(step_fn, state, frames):
    outs = []
    for depth_raw, color in frames:
        state, out = step_fn(state, jnp.asarray(depth_raw), jnp.asarray(color))
        outs.append(out)
    return state, outs


def test_sharded_matches_single_device(devices8):
    scene = default_test_scene()
    traj = make_translation_trajectory(4, step=(0.004, 0.0, 0.006))
    frames = [scene.render_frame(T, INTR) for T in traj]

    # single-device reference
    s_state, s_outs = _run(
        make_step_fn(PARAMS, INTR, donate=False), init_state(PARAMS, INTR), frames
    )

    # 8-way sharded
    mesh = make_mesh(8)
    d_state0 = shard_state(init_state(PARAMS, INTR), mesh)
    step = make_sharded_step_fn(PARAMS, INTR, mesh)
    d_state, d_outs = _run(step, d_state0, frames)

    for s, d in zip(s_outs, d_outs):
        assert bool(s.tracking_ok) and bool(d.tracking_ok)
        np.testing.assert_allclose(
            np.asarray(s.pose_matrix), np.asarray(d.pose_matrix), atol=1e-4
        )

    # fused volumes agree (integration is deterministic given the pose)
    sf = np.asarray(tsdf_to_float(s_state.vol.tsdf))
    df = np.asarray(tsdf_to_float(d_state.vol.tsdf))
    mismatch = np.abs(sf - df) > 2e-2
    assert mismatch.mean() < 2e-3

    sw = np.asarray(s_state.vol.weight)
    dw = np.asarray(d_state.vol.weight)
    assert (sw != dw).mean() < 2e-3

    # model maps (raycast output) agree. The psum'd ICP reduction sums in a
    # different order than the single-device matmul, so the tracked poses
    # differ at fp32 rounding level (~1e-4); grazing/silhouette rays amplify
    # that into occasional larger vertex differences — compare with an
    # outlier-tolerant criterion rather than elementwise atol.
    sv = np.asarray(s_state.model_vmaps[0])
    dv = np.asarray(d_state.model_vmaps[0])
    both = (np.abs(sv[..., 2]) > 0) & (np.abs(dv[..., 2]) > 0)
    diff = np.abs(sv - dv).max(axis=-1)[both]
    assert np.percentile(diff, 99) < 2e-3
    assert (diff > 2e-3).mean() < 5e-3
    # hit masks agree except a tiny boundary fraction
    assert ((np.abs(sv[..., 2]) > 0) != (np.abs(dv[..., 2]) > 0)).mean() < 5e-3


def test_sharded_tracking_failure_resets(devices8):
    scene = default_test_scene()
    mesh = make_mesh(8)
    state = shard_state(init_state(PARAMS, INTR), mesh)
    step = make_sharded_step_fn(PARAMS, INTR, mesh)
    depth_raw, color = scene.render_frame(np.eye(4), INTR)
    state, out = step(state, jnp.asarray(depth_raw), jnp.asarray(color))
    assert bool(out.tracking_ok)
    state, out = step(state, jnp.zeros_like(jnp.asarray(depth_raw)), jnp.asarray(color))
    assert not bool(out.tracking_ok)
    assert int(state.frame_count) == 1
    assert int(np.asarray(jnp.sum(state.vol.weight.astype(jnp.int32)))) == 0


def test_replica_sweep_matches_serial(devices8):
    """parallel/sweep.py: N sequences fanned across the replica mesh must
    produce the same trajectories as running each serially."""
    from kinfu_tpu.data.synthetic import make_orbit_trajectory
    from kinfu_tpu.parallel.sweep import replica_mesh, sweep_sequences
    from kinfu_tpu.pipeline.kinfu import make_step_fn

    scene = default_test_scene()
    params = PARAMS.replace(raycast_mode="auto")
    seqs, steps = [], (0.2, 0.5, 0.8)
    for s in steps:
        traj = make_orbit_trajectory(3, angle_step_deg=s)
        frames = [scene.render_frame(T, INTR) for T in traj]
        seqs.append(
            (
                np.stack([d for d, _ in frames]),
                np.stack([c for _, c in frames]),
            )
        )

    mesh = replica_mesh(4)
    results = sweep_sequences(seqs, params, INTR, mesh)
    assert len(results) == 3

    step_fn = make_step_fn(params, INTR, donate=False)
    for (depths, colors), (poses, oks) in zip(seqs, results):
        assert oks.astype(bool).all()
        st = init_state(params, INTR)
        for f in range(depths.shape[0]):
            st, out = step_fn(st, jnp.asarray(depths[f]), jnp.asarray(colors[f]))
        np.testing.assert_allclose(
            poses[-1], np.asarray(out.pose_matrix), atol=1e-5
        )


@pytest.mark.parametrize("n_devices", [2, 4])
def test_sharded_step_matches_single_device_on_n_devices(n_devices, devices8):
    """chip_smoke.py's four-card phase, rehearsed on virtual devices: the
    Z-sharded plain step over an n-device mesh tracks the same poses as the
    single-device step, and each device holds its own volume shard."""
    import chip_smoke

    scene = default_test_scene()
    traj = make_translation_trajectory(3, step=(0.004, -0.003, 0.006))
    frames = [scene.render_frame(T, INTR) for T in traj]
    errs = chip_smoke.four_card_sharded(
        PARAMS, INTR, frames, devices8[:n_devices], card="virtual CPU mesh"
    )
    assert len(errs) == 3
