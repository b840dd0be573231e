"""Production-scale accuracy run: the full 512^3 / 3-level / 640x480
pipeline over a >=50-frame synthetic trajectory with exact ground truth, on
a GPU (it exits non-zero on any other backend, naming what it found).

Outputs:
  - the card's name and power limit, then ATE/RPE as one JSON line
  - with --golden PATH, the estimated trajectory in the reference's
    poses.txt format (doc/poses.txt analogue, main.cpp:95-98)

Usage: python tools/accuracy_run.py [--dim 512] [--frames 50] [--golden PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--angle-step", type=float, default=0.3)
    ap.add_argument("--golden", default=None, help="write the trajectory here")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from kinfu_tpu.utils.device import card_label, require_gpu

    devs = require_gpu()
    card = card_label().splitlines()[0]
    print(f"device: {devs[0].device_kind} x{len(devs)} | nvidia-smi: {card}")

    import jax
    import jax.numpy as jnp

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.data.synthetic import default_test_scene, make_orbit_trajectory
    from kinfu_tpu.eval.ate import ate_rmse, rpe_rmse
    from kinfu_tpu.geometry.intrinsics import Intrinsics
    from kinfu_tpu.io.poses import write_poses_reference_format
    from kinfu_tpu.pipeline.kinfu import init_state, kinfu_step
    from kinfu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    params = KinFuParams(
        pyramid_height=args.levels,
        icp_iters=(4, 5, 10)[: args.levels],
        volume_dims=(args.dim,) * 3,
    )
    intr = Intrinsics(
        width=args.width,
        height=args.height,
        fx=525.0 * args.width / 640,
        fy=525.0 * args.width / 640,
        cx=args.width / 2 - 0.5,
        cy=args.height / 2 - 0.5,
    )
    traj = make_orbit_trajectory(args.frames, angle_step_deg=args.angle_step)
    scene = default_test_scene()
    rendered = [scene.render_frame(T, intr) for T in traj]
    depths = jnp.asarray(np.stack([d for d, _ in rendered]))
    colors = jnp.asarray(np.stack([c for _, c in rendered]))
    gt = [np.linalg.inv(traj[0]) @ T for T in traj]

    def scan_pipeline(state, ds, cs):
        def body(st, frame):
            d, c = frame
            st, out = kinfu_step(st, d, c, params=params, intr=intr)
            return st, (out.pose_matrix, out.tracking_ok)

        return jax.lax.scan(body, state, (ds, cs))

    scan = jax.jit(scan_pipeline, donate_argnums=(0,))
    state = init_state(params, intr)
    print("compiling + running...", flush=True)
    t0 = time.perf_counter()
    state, (poses, oks) = jax.block_until_ready(scan(state, depths, colors))
    poses = np.asarray(poses)
    oks = np.asarray(oks)
    wall = time.perf_counter() - t0
    print(f"done in {wall:.0f} s", flush=True)
    assert oks.all(), f"tracking failed at frames {np.where(~oks)[0]}"

    est = [poses[i] for i in range(poses.shape[0])]
    ate = ate_rmse(est, gt)
    ate_noalign = ate_rmse(est, gt, align=False)
    rpe_t, rpe_r = rpe_rmse(est, gt, delta=1)

    if args.golden:
        write_poses_reference_format(args.golden, est)

    print(
        json.dumps(
            {
                "config": f"{args.width}x{args.height}/{args.dim}^3/"
                f"{args.levels}lvl",
                "frames": int(poses.shape[0]),
                "ate_rmse_m": round(float(ate), 6),
                "ate_rmse_noalign_m": round(float(ate_noalign), 6),
                "rpe_trans_rmse_m": round(float(rpe_t), 6),
                "rpe_rot_rmse_deg": round(float(np.degrees(rpe_r)), 6),
                "card": card,
            }
        )
    )


if __name__ == "__main__":
    main()
