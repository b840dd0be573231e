"""Automated sanitizer passes (SURVEY.md §5 "race detection / sanitizers").

The reference compiles with `-G;-g` and nothing else (CMakeLists.txt:18).
In a functional JAX framework the analogous bug class is indexing /
numeric faults inside the traced step: `jax.experimental.checkify`
instruments one full pipeline step with out-of-bounds index and division
checks on every suite run.
"""

import functools

import jax
import jax.numpy as jnp

from kinfu_tpu.config import tiny_params
from kinfu_tpu.data.synthetic import default_test_scene, make_orbit_trajectory
from kinfu_tpu.geometry.intrinsics import Intrinsics

INTR = Intrinsics(width=80, height=64, fx=70.0, fy=70.0, cx=39.5, cy=31.5)


def test_step_passes_checkify_index_and_div_checks():
    from jax.experimental import checkify

    from kinfu_tpu.pipeline.kinfu import init_state, kinfu_step

    params = tiny_params(dim=32, levels=2).replace(
        icp_iters=(2, 2),
        raycast_mode="step",
    )
    scene = default_test_scene()
    frames = [
        scene.render_frame(T, INTR)
        for T in make_orbit_trajectory(2, angle_step_deg=0.3)
    ]
    step = functools.partial(kinfu_step, params=params, intr=INTR)
    checked = jax.jit(
        checkify.checkify(
            step, errors=checkify.index_checks | checkify.div_checks
        )
    )
    state = init_state(params, INTR)
    for depth, color in frames:
        err, (state, out) = checked(
            state, jnp.asarray(depth), jnp.asarray(color)
        )
        err.throw()  # raises on any OOB index / div fault
    assert bool(out.tracking_ok)
