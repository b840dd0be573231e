"""Command-line interface: `python -m kinfu_tpu <cmd>`.

The reference is a fixed demo binary with hardcoded paths and compile-time
configuration (main.cpp:115, depth_sensor.h:4); this CLI exposes the same
workflows — and the ones the reference lacks (evaluation, checkpointing,
benchmarking) — as real runtime flags.

Commands:
  run    fuse an RGB-D sequence: tracking + TSDF fusion + exports
  eval   ATE/RPE of an estimated trajectory against ground truth
  bench  end-to-end per-frame latency benchmark (see bench.py)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _add_params_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dim", type=int, default=512, help="voxels per axis")
    p.add_argument("--volume-size", type=float, default=3.0, help="metres per axis")
    p.add_argument("--levels", type=int, default=3, help="pyramid height")
    p.add_argument("--icp-iters", type=str, default="4,5,10")
    p.add_argument("--dist-threshold", type=float, default=0.015)
    p.add_argument("--angle-threshold", type=float, default=30.0)
    p.add_argument("--depth-scale", type=float, default=None,
                   help="metres per depth unit (default: dataset-provided)")
    p.add_argument("--max-weight", type=int, default=64)


def _params_from_args(args, dataset_depth_scale: float):
    from kinfu_tpu.config import KinFuParams

    iters = tuple(int(x) for x in args.icp_iters.split(","))[: args.levels]
    return KinFuParams(
        pyramid_height=args.levels,
        icp_iters=iters,
        icp_dist_threshold=args.dist_threshold,
        icp_angle_threshold=args.angle_threshold,
        volume_dims=(args.dim,) * 3,
        volume_range=(args.volume_size,) * 3,
        depth_scale=(
            args.depth_scale if args.depth_scale is not None else dataset_depth_scale
        ),
        tsdf_max_weight=args.max_weight,
    )


def _open_dataset(path: str, kind: str):
    if kind == "auto":
        kind = "tum" if os.path.exists(os.path.join(path, "rgb.txt")) else "bundled"
    if kind == "icl":
        from kinfu_tpu.data.icl_nuim import ICLNuimDataset

        return ICLNuimDataset(path), "icl"
    if kind == "tum":
        from kinfu_tpu.data.tum import TUMDataset

        return TUMDataset(path), "tum"
    from kinfu_tpu.data.bundled import BundledDataset

    return BundledDataset(path), "bundled"


def cmd_run(args) -> int:
    from kinfu_tpu.pipeline.session import KinFuSession
    from kinfu_tpu.utils.metrics import MetricsRecorder

    ds, kind = _open_dataset(args.data, args.dataset)
    intr = ds.intrinsics
    scale = intr.depth_scale if intr.depth_scale != 1.0 else 0.001
    params = _params_from_args(args, scale)

    if args.resume:
        from kinfu_tpu.io.checkpoint import load_checkpoint

        sess = load_checkpoint(args.resume)
        start = sess.frame_count - 1
        print(f"resumed from {args.resume} at frame {start}")
    else:
        sess = KinFuSession(
            intr,
            params,
            relocalize=args.relocalize,
            streaming=args.streaming,
            pose_graph=args.pose_graph,
        )
        start = 0

    if args.dump_renders:
        os.makedirs(args.dump_renders, exist_ok=True)
    if args.dump_3d:
        os.makedirs(args.dump_3d, exist_ok=True)

    rec = MetricsRecorder(jsonl_path=args.metrics, echo=not args.quiet)
    n = len(ds) if args.frames is None else min(args.frames, len(ds))
    from kinfu_tpu.utils.metrics import FrameMetrics
    import time

    for i in range(start, n):
        color, depth = ds[i]
        t0 = time.perf_counter()
        ok = sess.pipeline(color, depth)
        rec.record(
            FrameMetrics(
                frame=i,
                tracking_ok=ok,
                total_ms=(time.perf_counter() - t0) * 1e3,
                icp_inliers=getattr(sess, "last_icp_inliers", 0),
            )
        )
        if args.dump_renders and i % max(1, args.dump_every) == 0:
            # the reference shows Scene (Phong of the fused model), Depth,
            # Color every frame (main.cpp:77-86); golden analogues:
            # doc/raycast-map.png / raycast-normal.png / color-map.png
            from kinfu_tpu.io.images import write_color_png, write_depth_png

            d = args.dump_renders
            write_color_png(
                os.path.join(d, f"{i:06d}_phong.png"),
                sess.get_render_map(sess.PHONG),
            )
            write_color_png(
                os.path.join(d, f"{i:06d}_normal.png"),
                sess.get_render_map(sess.NORMAL),
            )
            write_color_png(os.path.join(d, f"{i:06d}_color.png"), color)
            write_depth_png(
                os.path.join(d, f"{i:06d}_depth.png"),
                np.asarray(depth).astype(np.uint16),
            )
        if (
            args.dump_3d
            and args.dump_3d_every
            and (i + 1) % args.dump_3d_every == 0
        ):
            sess.save_3d(os.path.join(args.dump_3d, f"{i:06d}_3d.png"))
        if args.checkpoint and args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            from kinfu_tpu.io.checkpoint import save_checkpoint

            save_checkpoint(args.checkpoint, sess)

    if args.pose_graph:
        print(
            f"pose graph: {len(sess.pg_keyframes)} keyframes, "
            f"{len(sess.loop_closures)} loop closures"
        )
    s = rec.summary()
    if s:
        print(
            f"done: {s['frames']} frames, {s['tracking_failures']} tracking "
            f"failures, median {s['median_ms']:.1f} ms/frame"
        )
    else:
        print(f"nothing to do (resumed at frame {start}, sequence has {n})")
    if args.save_poses:
        if args.poses_format == "tum":
            from kinfu_tpu.io.poses import write_poses_tum

            stamps = [
                ds.timestamp(i) if hasattr(ds, "timestamp") else float(i)
                for i in range(len(sess.pose_record))
            ]
            write_poses_tum(args.save_poses, sess.pose_record, stamps)
        else:
            sess.save_poses(args.save_poses)
        print(f"poses -> {args.save_poses}")
    if args.save_ply:
        sess.save_pointcloud(args.save_ply)
        print(f"pointcloud -> {args.save_ply}")
    if args.dump_3d:
        out3d = os.path.join(args.dump_3d, "3d_final.png")
        sess.save_3d(out3d)
        print(f"3d view -> {out3d}")
    if args.checkpoint:
        from kinfu_tpu.io.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, sess)
        print(f"checkpoint -> {args.checkpoint}")
    rec.close()
    return 0


def cmd_eval(args) -> int:
    from kinfu_tpu.eval.ate import ate_rmse, rpe_rmse
    from kinfu_tpu.io.poses import (
        read_poses_reference_format,
        read_poses_tum,
    )

    def load(path, fmt):
        if fmt == "auto":
            with open(path) as f:
                first = f.readline()
            fmt = "ref" if first.lstrip().startswith("[") else "tum"
        if fmt == "tum":
            _, poses = read_poses_tum(path)
            return poses
        return read_poses_reference_format(path)

    est = load(args.est, args.est_format)
    gt = load(args.gt, args.gt_format)
    ate = ate_rmse(est, gt, align=not args.no_align)
    rpe_t, rpe_r = rpe_rmse(est, gt, delta=args.rpe_delta)
    import json

    print(
        json.dumps(
            {
                "ate_rmse_m": round(ate, 6),
                "rpe_trans_rmse_m": round(rpe_t, 6),
                "rpe_rot_rmse_deg": round(np.degrees(rpe_r), 6),
                "n_est": len(est),
                "n_gt": len(gt),
            }
        )
    )
    return 0


def cmd_sweep(args) -> int:
    """Replica-parallel eval sweep: sequences x configs across the mesh
    (parallel/sweep.py). Emits one JSON line per (sequence, config) with
    ATE and per-frame latency, then a summary table."""
    import json
    import time

    from kinfu_tpu.data.synthetic import default_test_scene, make_orbit_trajectory
    from kinfu_tpu.eval.ate import ate_rmse
    from kinfu_tpu.geometry.intrinsics import Intrinsics
    from kinfu_tpu.parallel.sweep import replica_mesh, sweep_sequences

    intr = Intrinsics(
        width=args.width,
        height=args.height,
        fx=525.0 * args.width / 640,
        fy=525.0 * args.width / 640,
        cx=args.width / 2 - 0.5,
        cy=args.height / 2 - 0.5,
    )
    scene = default_test_scene()
    sequences, gts, names = [], [], []
    for k in range(args.synthetic):
        step = 0.2 + 0.15 * k  # distinct trajectories per replica
        traj = make_orbit_trajectory(args.frames, angle_step_deg=step)
        frames = [scene.render_frame(T, intr) for T in traj]
        depths = np.stack([d for d, _ in frames])
        colors = np.stack([c for _, c in frames])
        sequences.append((depths, colors))
        gts.append([np.linalg.inv(traj[0]) @ T for T in traj])
        names.append(f"orbit_{step:.2f}deg")
    for root in args.data or []:
        ds, kind = _open_dataset(root, "auto")
        n = min(args.frames, len(ds))
        frames = [ds[i] for i in range(n)]
        depths = np.stack([np.asarray(d, np.float32) for _, d in frames])
        colors = np.stack([c for c, _ in frames])
        # pad/crop datasets to the synthetic frame count for one compile
        sequences.append((depths, colors))
        gts.append(None)
        names.append(os.path.basename(os.path.normpath(root)))

    mesh = replica_mesh(args.devices)
    dims = [int(d) for d in args.dims.split(",")]
    rows = []
    for dim in dims:
        params = _params_from_args(args, 0.001).replace(volume_dims=(dim,) * 3)
        t0 = time.perf_counter()
        results = sweep_sequences(sequences, params, intr, mesh)
        wall = time.perf_counter() - t0
        n_waves = -(-len(sequences) // mesh.devices.size)
        ms_frame = wall / (n_waves * args.frames) * 1e3
        for name, gt, (poses, oks) in zip(names, gts, results):
            row = {
                "sequence": name,
                "dim": dim,
                "frames": int(oks.shape[0]),
                "tracking_failures": int((~oks.astype(bool)).sum()),
                "ms_per_frame_wall": round(ms_frame, 2),
            }
            if gt is not None:
                row["ate_rmse_m"] = round(
                    float(ate_rmse(list(poses), gt[: len(poses)])), 6
                )
            rows.append(row)
            print(json.dumps(row))
    print(f"# sweep: {len(sequences)} sequences x {len(dims)} configs on "
          f"{mesh.devices.size} devices")
    return 0


def cmd_bench(args) -> int:
    sys.argv = ["bench.py"] + args.rest
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import bench

    bench.main()
    return 0


def main(argv=None) -> int:
    from kinfu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="kinfu_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="fuse an RGB-D sequence")
    rp.add_argument("--data", required=True, help="dataset root")
    rp.add_argument(
        "--dataset", choices=("auto", "bundled", "tum", "icl"), default="auto"
    )
    rp.add_argument("--frames", type=int, default=None)
    rp.add_argument(
        "--streaming",
        action="store_true",
        help="camera-following moving volume (corridor-scale sequences)",
    )
    rp.add_argument(
        "--relocalize",
        action="store_true",
        help="keep the map on tracking loss and try keyframe relocalization",
    )
    rp.add_argument(
        "--pose-graph",
        action="store_true",
        help="keyframe pose graph with loop-closure drift correction",
    )
    rp.add_argument(
        "--dump-renders",
        default=None,
        metavar="DIR",
        help="write phong/normal/color/depth PNGs per frame (main.cpp:77-86)",
    )
    rp.add_argument("--dump-every", type=int, default=5, metavar="N",
                    help="dump renders every N frames (default 5)")
    rp.add_argument(
        "--dump-3d",
        default=None,
        metavar="DIR",
        help="write an offline 3D overview PNG (cloud + cube + trajectory "
        "+ frustum — the headless analogue of the reference's cv::viz "
        "window, main.cpp:82-86 / doc/3D.png)",
    )
    rp.add_argument("--dump-3d-every", type=int, default=0, metavar="N",
                    help="also dump the 3D view every N frames (0 = final only)")
    rp.add_argument("--save-poses", default=None)
    rp.add_argument("--poses-format", choices=("ref", "tum"), default="ref")
    rp.add_argument("--save-ply", default=None)
    rp.add_argument("--checkpoint", default=None, help="checkpoint file (.npz)")
    rp.add_argument("--checkpoint-every", type=int, default=0)
    rp.add_argument("--resume", default=None, help="resume from checkpoint")
    rp.add_argument("--metrics", default=None, help="per-frame metrics JSONL")
    rp.add_argument("--quiet", action="store_true")
    _add_params_flags(rp)
    rp.set_defaults(fn=cmd_run)

    ep = sub.add_parser("eval", help="trajectory accuracy (ATE / RPE)")
    ep.add_argument("--est", required=True)
    ep.add_argument("--gt", required=True)
    ep.add_argument("--est-format", choices=("auto", "ref", "tum"), default="auto")
    ep.add_argument("--gt-format", choices=("auto", "ref", "tum"), default="auto")
    ep.add_argument("--rpe-delta", type=int, default=1)
    ep.add_argument("--no-align", action="store_true")
    ep.set_defaults(fn=cmd_eval)

    sp = sub.add_parser(
        "sweep", help="replica-parallel eval sweep (sequences x configs)"
    )
    sp.add_argument("--synthetic", type=int, default=8,
                    help="number of synthetic orbit sequences")
    sp.add_argument("--data", action="append", default=None,
                    help="dataset root (repeatable)")
    sp.add_argument("--frames", type=int, default=12)
    sp.add_argument("--width", type=int, default=160)
    sp.add_argument("--height", type=int, default=120)
    sp.add_argument("--dims", type=str, default="128",
                    help="comma-separated volume dims (one config each)")
    sp.add_argument("--devices", type=int, default=None,
                    help="mesh size (default: all local devices)")
    _add_params_flags(sp)
    sp.set_defaults(fn=cmd_sweep)

    bp = sub.add_parser("bench", help="per-frame latency benchmark")
    bp.add_argument("rest", nargs=argparse.REMAINDER)
    bp.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
