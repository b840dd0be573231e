"""Test configuration: the CPU backend with 8 virtual devices, so the
mesh/shard_map/distributed tests run without an accelerator.

`JAX_PLATFORMS` defaults to `cpu` here, set through jax.config as well so
it holds even if JAX was imported before this file. Tests marked `gpu` run
the on-card checks of chip_smoke.py at real widths; on the machine with
the card run them as
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu -n 0 tests/`. Elsewhere
the `gpu_device` fixture skips them."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kinfu_tpu.geometry.intrinsics import Intrinsics  # noqa: E402


@pytest.fixture
def small_intr() -> Intrinsics:
    """Small image for fast tests; principal point off-centre on purpose."""
    return Intrinsics(width=80, height=64, fx=70.0, fy=72.0, cx=39.2, cy=31.7)


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(0)


def _devices_or_skip(n: int):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices, have {len(devs)}")
    return devs[:n]


@pytest.fixture
def devices8():
    """Eight devices (the virtual CPU mesh), decided at test time."""
    return _devices_or_skip(8)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX has {devs[0].platform}")
    return devs[0]
