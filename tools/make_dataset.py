"""Write a synthetic RGB-D sequence to disk in the reference's bundled
dataset layout (color/*.png + depth/*.png + intr.txt, depth_sensor.cpp:13-46)
so the FULL disk -> PNG decode -> track pipeline can run end-to-end:

    python tools/make_dataset.py --out seq --frames 50
    python -m kinfu_tpu run --data seq --save-poses poses.txt ...

Also writes gt_poses.txt (world-from-camera 4x4 per frame, the reference's
doc/poses.txt format) for ATE evaluation of the run.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--angle-step", type=float, default=0.3, help="deg/frame")
    ap.add_argument(
        "--traj", default="orbit", choices=["orbit", "translate"],
    )
    args = ap.parse_args()

    from kinfu_tpu.data.bundled import write_bundled
    from kinfu_tpu.data.synthetic import (
        default_test_scene,
        make_orbit_trajectory,
        make_translation_trajectory,
    )
    from kinfu_tpu.geometry.intrinsics import Intrinsics

    intr = Intrinsics(
        width=args.width,
        height=args.height,
        fx=525.0 * args.width / 640,
        fy=525.0 * args.width / 640,
        cx=args.width / 2 - 0.5,
        cy=args.height / 2 - 0.5,
    )
    scene = default_test_scene()
    if args.traj == "orbit":
        traj = make_orbit_trajectory(args.frames, angle_step_deg=args.angle_step)
    else:
        traj = make_translation_trajectory(args.frames, step=(0.004, 0.0, 0.006))
    write_bundled(args.out, [scene.render_frame(T, intr) for T in traj], intr, traj)
    print(f"wrote {len(traj)} frames to {args.out}")


if __name__ == "__main__":
    main()
