"""On-card smoke test: the per-frame pipeline on one NVIDIA GPU.

    python chip_smoke.py               # one card, phases 1-6
    python chip_smoke.py --four-cards  # four cards: the Z-sharded 1024^3
                                       # step and the replica sweep only

Default phases, at the reference workload (640x480 frames, 512^3 voxels over
3 m, 3 pyramid levels, {4,5,10} ICP iterations):

  1. device: platform, kind and count as JAX reports them, and the card's
     name and power limit from nvidia-smi; anything but a GPU fails;
  2. compile the per-frame step and print `memory_analysis()`;
  3. parity on the card against plain references computed off it:
     integrate and raycast against the same jnp code on the host CPU
     backend, the ICP normal equations against float64 numpy;
  4. end to end through `python -m kinfu_tpu run` on a 50-frame synthetic
     sequence with exact ground truth: tracking, ATE, PLY, Phong render;
  5. the streaming and relocalizing session modes, 10 frames each;
  6. steady-state device ms/frame of the scanned step (information only).

The last line of standard output is one JSON object naming the device; it
is printed only when every phase passed. Each phase is a function that the
CPU tests rehearse at tiny shapes (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, ".chip_smoke")

#: reference workload (BASELINE.md): frame size, voxels per axis, levels
WIDTH, HEIGHT, DIM, LEVELS = 640, 480, 512, 3
#: 0.3 degrees of orbit per frame, as bench.py
ORBIT_STEP_DEG = 0.3


def log(msg: str) -> None:
    print(msg, flush=True)


def workload(dim: int = DIM, width: int = WIDTH, height: int = HEIGHT,
             levels: int = LEVELS, **overrides):
    """(params, intrinsics) of the reference workload, resized."""
    from kinfu_tpu.config import KinFuParams
    from kinfu_tpu.geometry.intrinsics import Intrinsics

    params = KinFuParams(
        pyramid_height=levels,
        icp_iters=(4, 5, 10)[:levels],
        volume_dims=(dim, dim, dim),
        **overrides,
    )
    intr = Intrinsics(
        width=width,
        height=height,
        fx=525.0 * width / 640,
        fy=525.0 * width / 640,
        cx=width / 2 - 0.5,
        cy=height / 2 - 0.5,
    )
    return params, intr


def orbit(n: int, intr, step_deg: float = ORBIT_STEP_DEG):
    """(frames [(depth_raw, color)], world-from-camera poses) of the default
    synthetic scene along the orbit; frame 0 is at identity."""
    from kinfu_tpu.data.synthetic import default_test_scene, make_orbit_trajectory

    scene = default_test_scene()
    traj = make_orbit_trajectory(n, angle_step_deg=step_deg)
    return [scene.render_frame(T, intr) for T in traj], traj


# ---------------------------------------------------------------- phase 1
def phase_device(expect: int | None = None):
    """Require GPUs, print what JAX and nvidia-smi report."""
    from kinfu_tpu.utils.device import card_label, require_gpu

    devs = require_gpu()
    if expect is not None and len(devs) < expect:
        raise SystemExit(f"needs {expect} GPUs, JAX found {len(devs)}")
    label = card_label()
    log(
        f"[1 device] platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}"
    )
    for line in label.splitlines():
        log(f"[1 device] nvidia-smi: {line}")
    return devs, label.splitlines()[0]


# ---------------------------------------------------------------- phase 2
def phase_compile(params, intr, frame, card: str):
    """Compile the donated per-frame step; report its memory analysis.

    Returns (compiled step, report dict). `temp_holds_volume` says whether
    XLA's temporaries are at least one volume in size — a second volume
    buffer around the step's lax.cond."""
    import jax.numpy as jnp

    from kinfu_tpu.pipeline.kinfu import init_state, make_step_fn

    step = make_step_fn(params, intr)
    depth, color = (jnp.asarray(a) for a in frame)
    t0 = time.perf_counter()
    compiled = step.lower(init_state(params, intr), depth, color).compile()
    secs = time.perf_counter() - t0
    X, Y, Z = params.volume_dims
    vol_bytes = 8 * X * Y * Z  # int16 tsdf + int16 weight + int32 colour
    ma = compiled.memory_analysis()
    report = {"compile_s": secs, "volume_bytes": vol_bytes}
    if ma is not None:
        for k in ("argument", "output", "temp", "alias"):
            report[f"{k}_bytes"] = int(getattr(ma, f"{k}_size_in_bytes"))
        report["temp_holds_volume"] = report["temp_bytes"] >= vol_bytes
    log(f"[2 compile] step compiled in {secs:.1f} s on {card}; "
        "memory_analysis: " + json.dumps(report))
    if ma is not None:
        log(
            "[2 compile] temp "
            + ("HOLDS" if report["temp_holds_volume"] else "does not hold")
            + f" a volume-sized buffer ({report['temp_bytes']} B temp vs "
            f"{vol_bytes} B volume)"
        )
    return compiled, report


# ---------------------------------------------------------------- phase 3
def _vol2cam(params, cam_pose):
    """4x4 volume->camera transform for a world-from-camera pose."""
    return np.linalg.inv(np.asarray(cam_pose, np.float64)) @ params.volume_pose


def _pose(T, device):
    import jax

    from kinfu_tpu.geometry.se3 import Pose

    T = np.asarray(T, np.float32)
    return jax.device_put(Pose(T[:3, :3], T[:3, 3]), device)


def check_integrate(params, intr, frames, poses, slab_z, z_offset, device, host):
    """Integrate the frames into a [slab_z, Y, X] slab starting at global z
    `z_offset`, on `device` and with the same jnp code on `host`.

    Tolerance: TSDF and weight within +-1 LSB (the fixed-point truncation
    of float32 values that may differ in the last bit), colour exact where
    both weights are positive. A voxel whose projection lies within the
    last bit of a pixel boundary may read the neighbouring pixel on one
    side only; up to 1e-5 of the voxels may differ for that reason, and the
    count is printed."""
    import jax

    from kinfu_tpu.volume.integrate import integrate
    from kinfu_tpu.volume.tsdf import create_volume

    X, Y, _ = params.volume_dims
    fn = jax.jit(functools.partial(integrate, intr=intr, params=params))
    out = {}
    for name, dev in (("device", device), ("host", host)):
        vol = jax.device_put(create_volume((X, Y, slab_z)), dev)
        for (depth_raw, color), T in zip(frames, poses):
            d = jax.device_put(np.float32(params.depth_scale) * depth_raw, dev)
            c = jax.device_put(color, dev)
            vol = fn(vol, d, c, _pose(_vol2cam(params, T), dev),
                     z_offset=jax.device_put(np.int32(z_offset), dev))
        out[name] = jax.tree.map(np.asarray, vol)
    a, b = out["device"], out["host"]
    n = a.tsdf.size
    bad_t = int((np.abs(a.tsdf.astype(np.int32) - b.tsdf) > 1).sum())
    bad_w = int((np.abs(a.weight.astype(np.int32) - b.weight) > 1).sum())
    both = (a.weight > 0) & (b.weight > 0)
    bad_c = int((both & (a.color != b.color)).sum())
    observed = int(both.sum())
    stats = {"voxels": n, "observed": observed, "tsdf_gt_1lsb": bad_t,
             "weight_gt_1lsb": bad_w, "colour_mismatch": bad_c}
    log("[3 parity] integrate slab vs host CPU backend: " + json.dumps(stats))
    assert observed > 0, "integrate parity: nothing was fused"
    limit = max(1, int(1e-5 * n))
    assert bad_t <= limit and bad_w <= limit and bad_c <= limit, (
        f"integrate parity beyond tolerance: {stats} (limit {limit})"
    )
    return stats


def _compare_maps(vd, vh, voxel):
    hit_d, hit_h = vd[..., 2] > 0, vh[..., 2] > 0
    common = hit_d & hit_h
    dist = np.linalg.norm(vd - vh, axis=-1)[common] / voxel
    return {
        "hit_frac": float(hit_h.mean()),
        "mask_agree": float((hit_d == hit_h).mean()),
        "vertex_within_1_voxel": float((dist <= 1).mean()) if dist.size else 0.0,
        "vertex_max_err_voxels": float(dist.max()) if dist.size else 0.0,
    }


def check_raycast(params, intr, tsdf, cam2vol, device, host):
    """Raycast the same volume on `device` and with the same jnp code on
    `host`, for both marchers, and `hier` on `device` against `step`.

    Tolerance for the same marcher on both sides: hit masks agree on
    >= 99.9 % of pixels and vertices of pixels hit on both sides lie
    within one voxel on >= 99.9 % of them. `hier` against `step` is held
    to 95 %: `hier` samples at another phase of the grid, which changes
    the hit/no-hit decision where unobserved voxels interleave with
    observed ones — about 3 % of pixels in CPU runs at 64^3-256^3
    (march_hier docstring)."""
    import jax

    from kinfu_tpu.volume.raycast import raycast
    from kinfu_tpu.volume.tsdf import TSDFVolume

    def run(mode, dev):
        p = params.replace(raycast_mode=mode)
        fn = jax.jit(lambda t, pose: raycast(TSDFVolume(t, None, None), pose, intr, p))
        v, _ = fn(jax.device_put(tsdf, dev), _pose(cam2vol, dev))
        return np.asarray(v)

    maps = {(m, side): run(m, dev) for m in ("hier", "step")
            for side, dev in (("device", device), ("host", host))}
    voxel = params.voxel_size[0]
    stats = {}
    for a, b, bound in (("hier", "hier", 0.999), ("step", "step", 0.999),
                        ("hier", "step", 0.95)):
        st = _compare_maps(maps[(a, "device")], maps[(b, "host")], voxel)
        stats[f"{a}_device_vs_{b}_host"] = st
        log(f"[3 parity] raycast {a} (device) vs {b} (host), bound "
            f"{bound}: " + json.dumps(st))
        assert st["hit_frac"] > 0.3, "raycast parity: the host raycast hit nothing"
        assert st["mask_agree"] >= bound and st["vertex_within_1_voxel"] >= bound, (
            f"raycast parity {a} vs {b} beyond tolerance: {st}"
        )
    return stats


def check_icp(params, intr, cur, pre, inc, device, tol: float = 1e-5):
    """ICP normal equations at every pyramid level on `device` against
    float64 numpy (kinfu_tpu/eval/reference.py).

    Tolerance: each entry of A and b within `tol` of the float64 Gram,
    relative to sqrt(G_ii G_jj) — float32 summation order. A TF32 product
    (about three decimal digits) misses it. The same product with TF32
    allowed is printed beside it as a control."""
    import math

    import jax

    from kinfu_tpu.eval.reference import gram_error, icp_normal_equations_ref
    from kinfu_tpu.tracking.icp import _normal_equations

    sin_t = math.sin(math.radians(params.icp_angle_threshold))
    errs, control = [], []
    for level in range(params.pyramid_height):
        lintr = intr.level(level)
        args = [jax.device_put(a, device) for a in (*cur[level], *pre[level])]
        fn = jax.jit(functools.partial(
            _normal_equations, intr=lintr, dist_thres=params.icp_dist_threshold,
            sin_angle_thres=sin_t,
        ))
        A, b, ninl = fn(_pose(inc, device), *args)
        with jax.default_matmul_precision("tensorfloat32"):
            A32, b32, _ = jax.jit(functools.partial(
                _normal_equations, intr=lintr,
                dist_thres=params.icp_dist_threshold, sin_angle_thres=sin_t,
            ))(_pose(inc, device), *args)
        G, count = icp_normal_equations_ref(
            inc, *cur[level], *pre[level], lintr,
            params.icp_dist_threshold, params.icp_angle_threshold,
        )
        errs.append(gram_error(A, b, G))
        control.append(gram_error(A32, b32, G))
        log(
            f"[3 parity] ICP level {level}: inliers device={int(ninl)} "
            f"ref={count}, Gram error {errs[-1]:.3g} (tol {tol:g}); "
            f"TF32 control {control[-1]:.3g}"
        )
        assert count > 100, f"ICP parity: only {count} inliers at level {level}"
        assert abs(int(ninl) - count) <= max(2, count // 1000), (
            f"ICP parity: inliers {int(ninl)} vs {count} at level {level}"
        )
    assert max(errs) <= tol, f"ICP parity: Gram error {max(errs):.3g} > {tol:g}"
    return errs, control


def phase_parity(params, intr, compiled, frames, poses, device, host,
                 slab_z: int = 64, z_offset: int = 192):
    """Phase 3: fuse 5 frames with the compiled step, then hold integrate,
    raycast and ICP to their references."""
    import jax
    import jax.numpy as jnp

    from kinfu_tpu.frontend.maps import build_measurement_pyramid
    from kinfu_tpu.pipeline.kinfu import init_state

    check_integrate(params, intr, [frames[0], frames[3]], [poses[0], poses[3]],
                    slab_z, z_offset, device, host)

    state = init_state(params, intr)
    for depth_raw, color in frames[:5]:
        state, out = compiled(state, jnp.asarray(depth_raw), jnp.asarray(color))
        assert bool(out.tracking_ok), "parity setup: tracking failed"
    pose_m = np.asarray(out.pose_matrix, np.float64)
    cam2vol = np.linalg.inv(params.volume_pose.astype(np.float64)) @ pose_m
    check_raycast(params, intr, state.vol.tsdf, cam2vol, device, host)

    p = params
    _, vm, nm = jax.jit(functools.partial(
        build_measurement_pyramid, intr=intr, pyramid_height=p.pyramid_height,
        bfilter_kernel_size=p.bfilter_kernel_size,
        bfilter_color_sigma=p.bfilter_color_sigma,
        bfilter_spatial_sigma=p.bfilter_spatial_sigma,
        depth_scale=p.depth_scale, max_dist=p.dfilter_dist,
        normal_disc_threshold=p.normal_disc_threshold,
    ))(jnp.asarray(frames[5][0]))
    cur = [(np.asarray(v), np.asarray(n)) for v, n in zip(vm, nm)]
    pre = [(np.asarray(v), np.asarray(n))
           for v, n in zip(state.model_vmaps, state.model_nmaps)]
    check_icp(params, intr, cur, pre, np.eye(4), device)


# ---------------------------------------------------------------- phase 4
def _cli(args):
    from kinfu_tpu import cli

    rc = cli.main(args)
    assert rc == 0, f"kinfu_tpu {' '.join(args)} returned {rc}"


def _read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_end_to_end(params, intr, frames, poses, out_dir, card: str,
                     ate_bound: float = 0.002):
    """`run --data` over a bundled dataset written with the library's own
    writers. Returns (ATE metres, median ms/frame of steady frames)."""
    from kinfu_tpu.data.bundled import write_bundled
    from kinfu_tpu.eval.ate import ate_rmse
    from kinfu_tpu.io.images import read_color_png
    from kinfu_tpu.io.ply import read_ply
    from kinfu_tpu.io.poses import read_poses_reference_format

    data = os.path.join(out_dir, "orbit")
    write_bundled(data, frames, intr, poses)
    est_p = os.path.join(out_dir, "poses.txt")
    ply = os.path.join(out_dir, "cloud.ply")
    renders = os.path.join(out_dir, "renders")
    metrics = os.path.join(out_dir, "metrics.jsonl")
    n = len(frames)
    _cli(["run", "--data", data, "--save-poses", est_p, "--save-ply", ply,
          "--dump-renders", renders, "--dump-every", str(n - 1),
          "--metrics", metrics, "--quiet", *_param_flags(params)])

    m = _read_metrics(metrics)
    assert len(m) == n, f"end to end: {len(m)} frames recorded of {n}"
    lost = [r["frame"] for r in m[1:] if not r["tracking_ok"]]
    assert not lost, f"end to end: tracking lost at frames {lost}"
    est = read_poses_reference_format(est_p)
    gt = read_poses_reference_format(os.path.join(data, "gt_poses.txt"))
    ate = ate_rmse(est, gt)
    assert ate <= ate_bound, f"end to end: ATE {ate:.6f} m > {ate_bound} m"
    n_pts = read_ply(ply).shape[0]
    assert n_pts > 0, "end to end: empty PLY"
    phong = read_color_png(os.path.join(renders, f"{n - 1:06d}_phong.png"))
    nz = float((phong.sum(-1) > 0).mean())
    assert nz >= 0.8, f"end to end: Phong render {nz:.3f} nonzero < 0.8"
    steady = sorted(r["total_ms"] for r in m[2:])
    ms = steady[len(steady) // 2] if steady else float("nan")
    log(
        f"[4 end-to-end] {n} frames tracked, ATE {ate * 1e3:.4f} mm "
        f"(bound {ate_bound * 1e3:g} mm, unaligned "
        f"{ate_rmse(est, gt, align=False) * 1e3:.4f} mm), PLY {n_pts} points, "
        f"Phong {nz:.3f} nonzero; session median {ms:.3f} ms/frame over "
        f"{len(steady)} steady frames (host clock, each frame waits for its "
        f"pose) on {card}"
    )
    return ate, ms


def _param_flags(params):
    return ["--dim", str(params.volume_dims[0]),
            "--levels", str(params.pyramid_height),
            "--icp-iters", ",".join(str(i) for i in params.icp_iters)]


# ---------------------------------------------------------------- phase 5
def phase_sessions(params, intr, frames, poses, out_dir, n: int = 10):
    """`run --streaming` and `run --relocalize` over n frames. The
    relocalize sequence blanks the depth of frame n // 2: that frame must
    fail, the relocalizer must keep the map, and the next frame must track
    against it (a reset map would bootstrap with 0 ICP inliers)."""
    from kinfu_tpu.data.bundled import write_bundled

    data = os.path.join(out_dir, "orbit")
    if not os.path.isdir(data):
        write_bundled(data, frames[:n], intr, poses[:n])
    metrics = os.path.join(out_dir, "streaming.jsonl")
    _cli(["run", "--data", data, "--frames", str(n), "--streaming",
          "--metrics", metrics, "--quiet", *_param_flags(params)])
    m = _read_metrics(metrics)
    assert all(r["tracking_ok"] for r in m[1:]), f"streaming lost tracking: {m}"
    log(f"[5 sessions] streaming: {len(m)} frames tracked")

    blank = n // 2
    reloc_frames = list(frames[:n])
    reloc_frames[blank] = (np.zeros_like(frames[blank][0]), frames[blank][1])
    reloc_data = os.path.join(out_dir, "orbit_blank")
    write_bundled(reloc_data, reloc_frames, intr, poses[:n])
    metrics = os.path.join(out_dir, "relocalize.jsonl")
    _cli(["run", "--data", reloc_data, "--relocalize", "--metrics", metrics,
          "--quiet", *_param_flags(params)])
    m = _read_metrics(metrics)
    lost = [r["frame"] for r in m[1:] if not r["tracking_ok"]]
    assert lost == [blank], f"relocalize: lost frames {lost}, expected [{blank}]"
    after = m[blank + 1]
    assert after["icp_inliers"] > 0, "relocalize: the map was not kept"
    log(
        f"[5 sessions] relocalize: blank frame {blank} failed, frame "
        f"{blank + 1} tracked the kept map with {after['icp_inliers']} inliers"
    )


# ---------------------------------------------------------------- phase 6
def phase_steady(params, intr, frames, card: str, reps: int = 3):
    """Device ms/frame of the scanned step over the frames, from a fresh
    state, best of `reps` (information only, not a benchmark metric)."""
    import jax
    import jax.numpy as jnp

    from kinfu_tpu.pipeline.kinfu import init_state, kinfu_step

    depths = jnp.asarray(np.stack([d for d, _ in frames]))
    colors = jnp.asarray(np.stack([c for _, c in frames]))

    def scan(state, ds, cs):
        def body(st, f):
            st, out = kinfu_step(st, f[0], f[1], params=params, intr=intr)
            return st, out.tracking_ok

        return jax.lax.scan(body, state, (ds, cs))

    fn = jax.jit(scan, donate_argnums=(0,))
    _, oks = jax.block_until_ready(fn(init_state(params, intr), depths, colors))
    assert np.asarray(oks)[1:].all(), "steady state: tracking lost"
    best = float("inf")
    for _ in range(reps):
        state = jax.block_until_ready(init_state(params, intr))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(state, depths, colors))
        best = min(best, time.perf_counter() - t0)
    ms = best / len(frames) * 1e3
    log(f"[6 steady] scanned step {ms:.3f} ms/frame over {len(frames)} frames "
        f"(best of {reps}) on {card}")
    return ms


# ---------------------------------------------------------------- 4 cards
def four_card_sharded(params, intr, frames, mesh_devices, card: str,
                      tol: float = 1e-4):
    """Z-sharded step over the mesh against the single-device step, both
    with raycast_mode="step"; poses must match to `tol`."""
    import jax
    import jax.numpy as jnp

    from kinfu_tpu.parallel.mesh import make_mesh
    from kinfu_tpu.parallel.sharded import make_sharded_step_fn, shard_state
    from kinfu_tpu.pipeline.kinfu import init_state, make_step_fn

    params = params.replace(raycast_mode="step")
    mesh = make_mesh(len(mesh_devices), mesh_devices)
    state = shard_state(init_state(params, intr), mesh)
    shard_devs = {s.device for s in state.vol.tsdf.addressable_shards}
    assert len(shard_devs) == len(mesh_devices), (
        f"volume shards on {shard_devs}, expected {len(mesh_devices)} devices"
    )
    step = make_sharded_step_fn(params, intr, mesh)
    t0 = time.perf_counter()
    sharded = []
    for depth_raw, color in frames:
        state, out = step(state, jnp.asarray(depth_raw), jnp.asarray(color))
        sharded.append((np.asarray(out.pose_matrix), bool(out.tracking_ok)))
    secs = time.perf_counter() - t0
    per_dev = state.vol.tsdf.addressable_shards[0].data.nbytes
    del state

    single_step = make_step_fn(params, intr)
    s_state = jax.device_put(init_state(params, intr), mesh_devices[0])
    errs = []
    for (pose_d, ok_d), (depth_raw, color) in zip(sharded, frames):
        s_state, s_out = single_step(
            s_state, jnp.asarray(depth_raw), jnp.asarray(color)
        )
        assert ok_d and bool(s_out.tracking_ok), "sharded parity: tracking lost"
        errs.append(float(np.abs(pose_d - np.asarray(s_out.pose_matrix)).max()))
    log(
        f"[4-card sharded] {params.volume_dims[0]}^3 Z-sharded over "
        f"{len(mesh_devices)} devices ({per_dev} B of tsdf per device): "
        f"{len(frames)} frames in {secs:.1f} s incl. compile; max pose "
        f"error vs single device {max(errs):.3g} (tol {tol:g}) on {card}"
    )
    assert max(errs) <= tol, f"sharded pose error {max(errs):.3g} > {tol:g}"
    return errs


def four_card_sweep(params, intr, n_seq: int, n_frames: int, mesh_devices,
                    tol: float = 1e-4):
    """track_replicated: one sequence per device against the serial run."""
    import jax
    import jax.numpy as jnp

    from kinfu_tpu.parallel.sweep import replica_mesh, sweep_sequences
    from kinfu_tpu.pipeline.kinfu import init_state, make_step_fn

    seqs = []
    for k in range(n_seq):
        fr, _ = orbit(n_frames, intr, step_deg=0.2 + 0.15 * k)
        seqs.append((np.stack([d for d, _ in fr]), np.stack([c for _, c in fr])))
    mesh = replica_mesh(len(mesh_devices))
    results = sweep_sequences(seqs, params, intr, mesh)
    step = make_step_fn(params, intr, donate=False)
    errs = []
    for (depths, colors), (poses, oks) in zip(seqs, results):
        assert oks.astype(bool).all(), "replica sweep: tracking lost"
        st = jax.device_put(init_state(params, intr), mesh_devices[0])
        for f in range(depths.shape[0]):
            st, out = step(st, jnp.asarray(depths[f]), jnp.asarray(colors[f]))
        errs.append(float(np.abs(poses[-1] - np.asarray(out.pose_matrix)).max()))
    log(
        f"[4-card sweep] {n_seq} sequences x {n_frames} frames on "
        f"{mesh.devices.size} devices; max final-pose error vs serial "
        f"{max(errs):.3g} (tol {tol:g})"
    )
    assert max(errs) <= tol, f"replica sweep pose error {max(errs):.3g}"
    return errs


# ------------------------------------------------------------------ main
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phases")
    ap.add_argument("--out", default=OUT_DIR,
                    help="scratch directory for the synthetic dataset")
    args = ap.parse_args(argv)

    devs, card = phase_device(expect=4 if args.four_cards else None)

    import jax

    from kinfu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    if args.four_cards:
        params, intr = workload(dim=1024)
        frames, _ = orbit(5, intr)
        four_card_sharded(params, intr, frames, devs[:4], card)
        params, intr = workload()
        four_card_sweep(params, intr, 4, 5, devs[:4])
        count = 4
    else:
        params, intr = workload()
        frames, poses = orbit(50, intr)
        compiled, _ = phase_compile(params, intr, frames[0], card)
        phase_parity(params, intr, compiled, frames, poses, devs[0],
                     jax.devices("cpu")[0])
        del compiled
        phase_end_to_end(params, intr, frames, poses, args.out, card)
        phase_sessions(params, intr, frames, poses, args.out)
        phase_steady(params, intr, frames[:20], card)
        count = len(devs)
    result = {"ok": True, "device": {"platform": devs[0].platform,
                                     "kind": devs[0].device_kind,
                                     "count": count}}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
