"""End-to-end benchmark: ms/frame of the full per-frame pipeline step.

Workload parity with the reference's published number (BASELINE.md):
640x480 RGB-D frames, 512^3 TSDF volume over a 3 m cube, 3-level pyramid,
{4,5,10} ICP iterations — the reference runs ~18 ms/frame on a GTX 1650 Ti
(README.md:9-10). Prints the card on one line, then one JSON line;
vs_baseline > 1 means faster than the reference's published figure.

Needs a GPU: on any other backend it exits non-zero, naming what it found.

Measurement method: the per-frame step runs as a `lax.scan` over a stacked
frame batch entirely on device, and the reported time is the *difference*
between a long scan and a short scan divided by the frame-count difference,
which cancels the fixed per-dispatch overhead. Each scan ends in
`jax.block_until_ready`.

Both scan lengths start from a FRESH init_state and replay the same orbit
from frame 0, so every measured frame is a genuinely tracking frame. On
tracking failure the per-frame ok/inlier trace is printed before exiting
non-zero.

Usage: python bench.py [--dim 512] [--frames 20] [--raycast auto|hier|step]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _run_scan(scan_fn, init_fn, depths, colors):
    """Run the scanned pipeline from fresh state. Returns (poses, oks,
    inliers, seconds)."""
    import jax

    state = init_fn()
    t0 = time.perf_counter()
    state, outs = jax.block_until_ready(scan_fn(state, depths, colors))
    dt = time.perf_counter() - t0
    poses, oks, inl = (np.asarray(x) for x in outs)
    return poses, oks, inl, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--raycast", default="auto", choices=["auto", "hier", "step"])
    args = ap.parse_args(argv)

    from kinfu_tpu.utils.device import card_label, require_gpu

    devs = require_gpu()
    label = card_label()
    print(f"device: {devs[0].device_kind} x{len(devs)} | nvidia-smi: {label}")

    import jax
    import jax.numpy as jnp

    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.data.synthetic import default_test_scene, make_orbit_trajectory
    from kinfu_tpu.geometry.intrinsics import Intrinsics
    from kinfu_tpu.pipeline.kinfu import init_state, kinfu_step
    from kinfu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    params = KinFuParams(
        pyramid_height=args.levels,
        icp_iters=(4, 5, 10)[: args.levels],
        volume_dims=(args.dim, args.dim, args.dim),
        raycast_mode=args.raycast,
    )
    intr = Intrinsics(
        width=args.width,
        height=args.height,
        fx=525.0 * args.width / 640,
        fy=525.0 * args.width / 640,
        cx=args.width / 2 - 0.5,
        cy=args.height / 2 - 0.5,
    )

    n_small, n_big = args.warmup, args.warmup + args.frames
    traj = make_orbit_trajectory(n_big, angle_step_deg=0.3)
    scene = default_test_scene()
    rendered = [scene.render_frame(T, intr) for T in traj]
    depths = jnp.asarray(np.stack([d for d, _ in rendered]))
    colors = jnp.asarray(np.stack([c for _, c in rendered]))

    def scan_pipeline(state, ds, cs):
        def body(st, frame):
            d, c = frame
            st, out = kinfu_step(st, d, c, params=params, intr=intr)
            return st, (out.pose_matrix, out.tracking_ok, out.icp_inliers)

        return jax.lax.scan(body, state, (ds, cs))

    scan = jax.jit(scan_pipeline, donate_argnums=(0,))
    init = lambda: init_state(params, intr)  # noqa: E731

    sm_d, sm_c = depths[:n_small], colors[:n_small]
    # compile both scan lengths
    _run_scan(scan, init, sm_d, sm_c)
    _run_scan(scan, init, depths, colors)

    # timed: both lengths from fresh state, difference out fixed overhead
    t_small, t_big = [], []
    for _ in range(3):
        _, _, _, dt = _run_scan(scan, init, sm_d, sm_c)
        t_small.append(dt)
        poses, oks, inl, dt = _run_scan(scan, init, depths, colors)
        t_big.append(dt)
    if not oks[1:].all():  # frame 0 bootstraps; all others must track
        for i in range(n_big):
            print(
                f"frame {i:3d}  ok={bool(oks[i])}  inliers={int(inl[i])}",
                file=sys.stderr,
            )
        raise AssertionError("tracking failed during benchmark")

    ms = (min(t_big) - min(t_small)) / (n_big - n_small) * 1e3
    baseline_ms = 18.0
    print(
        json.dumps(
            {
                "metric": f"ms_per_frame_{args.width}x{args.height}_{args.dim}^3",
                "value": ms,
                "unit": "ms",
                "vs_baseline": baseline_ms / ms,
                "device": {
                    "platform": devs[0].platform,
                    "kind": devs[0].device_kind,
                    "count": len(devs),
                    "nvidia_smi": label,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
