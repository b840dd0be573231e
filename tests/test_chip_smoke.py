"""chip_smoke.py, bench.py and the helpers they share.

On the CPU: the device checks refuse to run, the compile cache lands where
it should, and every phase of chip_smoke.py runs at tiny shapes (64^3,
160x120, 2 levels) with the host CPU backend standing in for the card.
The `gpu` tests run the same phases at the reference workload when a GPU
is present (see tests/conftest.py for the command).
"""

import os

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from kinfu_tpu.utils import compile_cache


@pytest.mark.parametrize(
    "entry",
    [chip_smoke.main, bench.main],
    ids=["chip_smoke", "bench"],
)
def test_device_check_refuses_cpu(entry):
    with pytest.raises(SystemExit) as exc:
        entry([])
    msg = str(exc.value)
    assert "needs a GPU" in msg and "platform='cpu'" in msg


def test_trace_step_refuses_cpu():
    from tools import trace_step

    with pytest.raises(SystemExit, match="platform='cpu'"):
        trace_step.main([])


def test_compile_cache_uses_env_dir_and_sets_none(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ------------------------------------------------- rehearsal at tiny shapes
@pytest.fixture(scope="module")
def tiny():
    params, intr = chip_smoke.workload(dim=64, width=160, height=120, levels=2)
    frames, poses = chip_smoke.orbit(8, intr)
    compiled, report = chip_smoke.phase_compile(
        params, intr, frames[0], "CPU rehearsal"
    )
    return params, intr, frames, poses, compiled, report


def test_phase_compile_reports_memory(tiny):
    params, *_, report = tiny
    assert report["volume_bytes"] == 8 * 64**3
    assert report["alias_bytes"] > 0  # the donated state is aliased
    assert isinstance(report["temp_holds_volume"], bool)


def test_phase_parity_integrate(tiny):
    params, intr, frames, poses, *_ = tiny
    cpu = jax.devices("cpu")[0]
    stats = chip_smoke.check_integrate(
        params, intr, [frames[0], frames[3]], [poses[0], poses[3]], 16, 24, cpu, cpu
    )
    assert stats["tsdf_gt_1lsb"] == 0 and stats["observed"] > 0


def test_phase_parity_raycast_and_icp(tiny):
    """The whole of phase 3: fuse 5 frames, then integrate, raycast and
    ICP against their references."""
    params, intr, frames, poses, compiled, _ = tiny
    cpu = jax.devices("cpu")[0]
    chip_smoke.phase_parity(params, intr, compiled, frames, poses, cpu, cpu,
                            slab_z=16, z_offset=24)


def test_check_icp_rejects_a_wrong_gram(tiny):
    """The ICP check fails when the product is off by more than the
    tolerance (a zero tolerance stands in for a TF32 product here)."""
    params, intr, frames, *_ = tiny
    cpu = jax.devices("cpu")[0]
    from kinfu_tpu.frontend.maps import build_measurement_pyramid

    p = params
    maps = []
    for d, _ in (frames[0], frames[1]):
        _, vm, nm = build_measurement_pyramid(
            jax.numpy.asarray(d), intr, pyramid_height=p.pyramid_height,
            bfilter_kernel_size=p.bfilter_kernel_size,
            bfilter_color_sigma=p.bfilter_color_sigma,
            bfilter_spatial_sigma=p.bfilter_spatial_sigma,
            depth_scale=p.depth_scale, max_dist=p.dfilter_dist,
            normal_disc_threshold=p.normal_disc_threshold,
        )
        maps.append([(np.asarray(v), np.asarray(n)) for v, n in zip(vm, nm)])
    errs, _ = chip_smoke.check_icp(params, intr, maps[1], maps[0], np.eye(4), cpu)
    assert max(errs) < 1e-5
    with pytest.raises(AssertionError, match="Gram error"):
        chip_smoke.check_icp(params, intr, maps[1], maps[0], np.eye(4), cpu, tol=0.0)


def test_phase_end_to_end_and_sessions(tiny, tmp_path):
    """Phases 4 and 5 through `python -m kinfu_tpu run`, with a bound
    that suits 47 mm voxels."""
    params, intr, frames, poses, *_ = tiny
    ate, _ = chip_smoke.phase_end_to_end(
        params, intr, frames, poses, str(tmp_path), "CPU rehearsal", ate_bound=0.05
    )
    assert 0 <= ate <= 0.05
    chip_smoke.phase_sessions(params, intr, frames, poses, str(tmp_path), n=6)


def test_four_card_sweep_matches_serial(tiny, devices8):
    params, intr, *_ = tiny
    errs = chip_smoke.four_card_sweep(params, intr, 4, 3, devices8[:4])
    assert len(errs) == 4


# ----------------------------------------------------------- on the card
@pytest.mark.gpu
def test_gpu_parity_at_reference_workload(gpu_device):
    params, intr = chip_smoke.workload()
    frames, poses = chip_smoke.orbit(6, intr)
    compiled, _ = chip_smoke.phase_compile(
        params, intr, frames[0], gpu_device.device_kind
    )
    chip_smoke.phase_parity(params, intr, compiled, frames, poses, gpu_device,
                            jax.devices("cpu")[0])


@pytest.mark.gpu
def test_gpu_end_to_end_at_reference_workload(gpu_device, tmp_path):
    params, intr = chip_smoke.workload()
    frames, poses = chip_smoke.orbit(50, intr)
    chip_smoke.phase_end_to_end(params, intr, frames, poses, str(tmp_path),
                                gpu_device.device_kind)
    chip_smoke.phase_sessions(params, intr, frames, poses, str(tmp_path))


def test_trace_step_maps_kernels_to_stages():
    """tools/trace_step.py attributes a kernel to the named_scope of the
    HLO instruction it runs, by its hlo_op stat or by its kernel name."""
    from tools import trace_step

    @jax.jit
    def f(x):
        with jax.named_scope("icp"):
            y = jax.numpy.sin(x) @ x
        with jax.named_scope("raycast"):
            return jax.numpy.cos(y).sum()

    scopes = trace_step.hlo_scopes(f.lower(np.ones((8, 8), np.float32)).compile().as_text())
    assert {"icp", "raycast"} <= set(scopes.values())
    name = next(k for k, v in scopes.items() if v == "raycast")
    assert trace_step.event_stage("x", {"hlo_op": name}, scopes) == "raycast"
    kernel = name.replace(".", "_") if "." in name else name
    assert trace_step.event_stage(kernel, {"hlo_op": "command_buffer"}, scopes) == "raycast"
    assert trace_step.event_stage("memcpy", {}, scopes) is None
