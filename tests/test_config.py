"""KinFuParams validation and derived-value tests."""

import numpy as np
import pytest

from kinfu_tpu.config import KinFuParams


def test_mode_validation_rejects_typos():
    for bad in ("On", "true", "Hier"):
        with pytest.raises(ValueError, match="raycast_mode"):
            KinFuParams(raycast_mode=bad)


def test_mode_validation_accepts_choices():
    for mode in ("auto", "hier", "step"):
        assert KinFuParams(raycast_mode=mode).raycast_mode == mode


@pytest.mark.parametrize(
    "removed",
    [
        {"icp_mode": "gather"},
        {"integrate_mode": "gather"},
        {"fused_mode": "off"},
        {"raycast_face": (640, 261.0)},
    ],
)
def test_removed_options_are_rejected(removed):
    """Options of the removed accelerator-specific kernels fail loudly,
    both at construction and through replace()."""
    with pytest.raises(TypeError):
        KinFuParams(**removed)
    with pytest.raises(TypeError):
        KinFuParams().replace(**removed)


def test_removed_warped_raycast_is_rejected():
    with pytest.raises(ValueError, match="raycast_mode"):
        KinFuParams(raycast_mode="warped")


def test_derived_defaults_match_reference():
    """kinectfusion.cpp:181-186: trunc = 2.1 * voxel size, origin at
    (-range/2, -range/2, +0.5)."""
    p = KinFuParams()
    assert np.isclose(p.trunc_dist, 2.1 * 3.0 / 512)
    assert p.volume_origin == (-1.5, -1.5, 0.5)
    assert np.allclose(p.voxel_size, 3.0 / 512)
    T = p.volume_pose
    assert np.allclose(T[:3, :3], np.eye(3))
    assert np.allclose(T[:3, 3], (-1.5, -1.5, 0.5))
