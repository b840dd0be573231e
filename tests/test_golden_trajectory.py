"""Golden-trajectory regression (doc/poses.txt analogue, main.cpp:95-98).

The reference ships a 50-pose golden trajectory of its bundled sequence as
its only machine-checkable expected output (doc/poses.txt, SURVEY.md
section 4). This repo's equivalents:
  - tests/golden/poses_cpu_orbit12_128.txt — CPU-runnable golden at
    128^3 / 2-level / 160x120 over an exact-GT synthetic orbit (this test)
  - the production 512^3 / 3-level / 640x480 run on the card, scored by
    chip_smoke.py (phase 4) and recorded in ACCURACY.md

A behavioural change to tracking or fusion shows up here as ATE drift
against the recorded golden.
"""

import os

import numpy as np
import jax.numpy as jnp

from kinfu_tpu.config import KinFuParams
from kinfu_tpu.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu.eval.ate import ate_rmse
from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.io.poses import read_poses_reference_format
from kinfu_tpu.pipeline.kinfu import init_state, make_step_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "poses_cpu_orbit12_128.txt")


def test_trajectory_matches_golden():
    intr = Intrinsics(width=160, height=120, fx=140.0, fy=140.0, cx=79.5, cy=59.5)
    params = KinFuParams(
        pyramid_height=2,
        icp_iters=(4, 5),
        volume_dims=(128,) * 3,
        volume_range=(3.0,) * 3,
    )
    scene = default_test_scene()
    traj = make_orbit_trajectory(12, angle_step_deg=0.3)
    frames = [scene.render_frame(T, intr) for T in traj]
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]

    step = make_step_fn(params, intr)
    st = init_state(params, intr)
    est = []
    for d, c in frames:
        st, out = step(st, jnp.asarray(d), jnp.asarray(c))
        assert bool(out.tracking_ok)
        est.append(np.asarray(out.pose_matrix))

    golden = read_poses_reference_format(GOLDEN)
    assert len(golden) == len(est)
    # regression vs the recorded golden (tight: same code path, same data)
    ate_gold = ate_rmse(est, golden)
    assert ate_gold < 1e-3, f"drifted from golden: ATE {ate_gold:.5f} m"
    # absolute accuracy vs exact synthetic GT (12 mm voxels -> ~1 mm ATE)
    ate_gt = ate_rmse(est, gt)
    assert ate_gt < 2e-3, f"ATE vs GT {ate_gt:.5f} m"
