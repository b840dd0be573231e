"""Per-stage and per-op device time of the per-frame step on a GPU.

Runs a short scan of kinfu_step at the reference workload under
jax.profiler, reads the trace's GPU device planes, and prints the device
time per pipeline stage (the `jax.named_scope` spans of
pipeline/kinfu.py: measure, icp, integrate, raycast, model_pyramid), the
device idle share over the traced window, and the top kernels by total
duration. The card's name and power limit are printed beside the numbers.
Needs a GPU: on any other backend it exits non-zero, naming what it found.

Usage: python tools/trace_step.py [--dim 512] [--frames 6] [--top 25]
       [--json trace_step.json]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("measure", "icp", "integrate", "raycast", "model_pyramid")


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> pipeline stage, from the op_name metadata
    that jax.named_scope writes into the compiled module."""
    out = {}
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = _stage_of(m.group(2))
    return out


def _stage_of(text: str) -> str | None:
    for s in STAGES:
        if f"/{s}/" in text or text.endswith(f"/{s}") or f"{s}/" in text:
            return s
    return None


def event_stage(name: str, stats: dict, scopes: dict) -> str | None:
    """Stage of one device event: through its `hlo_op` stat, else through
    its kernel name (XLA names kernel `fusion_7` after instruction
    `fusion.7`; events inside a CUDA graph carry hlo_op=command_buffer)."""
    hlo = str(stats.get("hlo_op", ""))
    for key in (hlo, re.sub(r"_(\d+)$", r".\1", name), name):
        if scopes.get(key):
            return scopes[key]
    return _stage_of(" ".join(str(v) for v in stats.values()))


def reduce_trace(path: str, scopes: dict, n_frames: int) -> dict:
    """Device busy time, idle share and per-stage/per-op totals from one
    .xplane.pb: every kernel event on a `/device:GPU` plane's stream lines
    counts as device work; busy time is the union of their intervals."""
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    ops = collections.defaultdict(lambda: [0.0, 0])
    stages = collections.defaultdict(float)
    intervals = []
    sample, line_names = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        line_names.update(f"{plane.name}|{ln.name}" for ln in lines)
        # module- and step-level lines span whole programs; kernels sit on
        # the stream lines
        lines = [ln for ln in lines if ln.name.startswith("Stream")] or lines
        for line in lines:
            for ev in line.events:
                dur = ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + dur))
                stats = dict(ev.stats or {})
                if len(sample) < 5:
                    sample.append({"plane": plane.name, "line": line.name,
                                   "name": ev.name,
                                   "stats": {k: str(v)[:200] for k, v in stats.items()}})
                stage = event_stage(ev.name, stats, scopes)
                ops[ev.name][0] += dur
                ops[ev.name][1] += 1
                stages[stage or "other"] += dur
    if not intervals:
        raise RuntimeError(f"no /device:GPU events in {path}")
    intervals.sort()
    busy, cur_s, cur_e = 0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    return {
        "frames": n_frames,
        "device_busy_ms_per_frame": busy / 1e6 / n_frames,
        "window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window,
        "stage_ms_per_frame": {k: v / 1e6 / n_frames for k, v in stages.items()},
        "ops": {k: (v[0] / 1e6 / n_frames, v[1]) for k, v in ops.items()},
        "sample_events": sample,
        "lines": sorted(line_names),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, ".trace"))
    ap.add_argument("--json", default=None, help="write the reduction here")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from kinfu_tpu.utils.device import card_label, require_gpu

    devs = require_gpu()
    card = card_label().splitlines()[0]
    print(f"device: {devs[0].device_kind} x{len(devs)} | nvidia-smi: {card}")

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from kinfu_tpu.pipeline.kinfu import init_state, kinfu_step
    from kinfu_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    params, intr = chip_smoke.workload(dim=args.dim)
    frames, _ = chip_smoke.orbit(args.frames, intr)
    depths = jnp.asarray(np.stack([d for d, _ in frames]))
    colors = jnp.asarray(np.stack([c for _, c in frames]))

    def scan_pipeline(state, ds, cs):
        def body(st, frame):
            st, out = kinfu_step(st, frame[0], frame[1], params=params, intr=intr)
            return st, out.tracking_ok

        return jax.lax.scan(body, state, (ds, cs))

    scan = jax.jit(scan_pipeline, donate_argnums=(0,))
    compiled = scan.lower(init_state(params, intr), depths, colors).compile()
    scopes = hlo_scopes(compiled.as_text())
    # warm up outside the trace
    _, oks = jax.block_until_ready(compiled(init_state(params, intr), depths, colors))
    assert np.asarray(oks)[1:].all(), "tracking lost"

    os.makedirs(args.trace_dir, exist_ok=True)
    state = jax.block_until_ready(init_state(params, intr))
    with jax.profiler.trace(args.trace_dir):
        jax.block_until_ready(compiled(state, depths, colors))
    path = max(
        glob.glob(os.path.join(args.trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    red = reduce_trace(path, scopes, args.frames)
    red["card"] = card
    red["workload"] = f"{intr.width}x{intr.height} {args.dim}^3 {params.pyramid_height} levels"

    print(
        f"device busy {red['device_busy_ms_per_frame']:.3f} ms/frame, idle share "
        f"{red['idle_share']:.3f} of a {red['window_ms']:.1f} ms window "
        f"({args.frames} frames, {red['workload']}) on {card}"
    )
    for stage, ms in sorted(red["stage_ms_per_frame"].items(), key=lambda kv: -kv[1]):
        print(f"  stage {stage:<14} {ms:9.3f} ms/frame")
    print(f"{'ms/frame':>10} {'count':>7}  kernel")
    for name, (ms, cnt) in sorted(red["ops"].items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"{ms:>10.3f} {cnt:>7}  {name[:120]}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        top = dict(sorted(red["ops"].items(), key=lambda kv: -kv[1][0])[:200])
        with open(args.json, "w") as f:
            json.dump({**red, "ops": top}, f, indent=1)


if __name__ == "__main__":
    main()
