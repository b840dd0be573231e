"""Depth-image preprocessing: pyramid downsample, bilateral filter, clip.

Both filters are small fixed stencils, expressed as sums of 25 statically
shifted images — element-wise work that XLA fuses into a handful of passes
over a ~1.2 MB image. No custom kernel needed at this size.

Parity: cv::cuda::pyrDown + cv::cuda::bilateralFilter(k=5, sigma_color=10,
sigma_spatial=10) applied to raw millimetre depth (kinectfusion.cpp:54-64),
then the mm->m scale + far clip of device::depthTruncation
(image_process.cu:8-27). The reference kernel reads one row/col out of
bounds (image_process.cu:13-16); that bug is not reproduced.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

# OpenCV pyrDown 5-tap Gaussian: outer product of [1, 4, 6, 4, 1] / 16.
_PYR_TAPS = (1.0, 4.0, 6.0, 4.0, 1.0)


def _shifted(padded: jnp.ndarray, dy: int, dx: int, h: int, w: int) -> jnp.ndarray:
    return padded[dy : dy + h, dx : dx + w]


def pyr_down(depth: jnp.ndarray) -> jnp.ndarray:
    """Gaussian blur (reflect-101 border) + 2x decimation, like cv::pyrDown."""
    h, w = depth.shape
    padded = jnp.pad(depth, 2, mode="reflect")
    acc = jnp.zeros_like(depth)
    for dy, wy in enumerate(_PYR_TAPS):
        for dx, wx in enumerate(_PYR_TAPS):
            acc = acc + (wy * wx) * _shifted(padded, dy, dx, h, w)
    blurred = acc / 256.0
    return blurred[::2, ::2]


def bilateral_filter(
    depth: jnp.ndarray,
    kernel_size: int = 5,
    sigma_color: float = 10.0,
    sigma_spatial: float = 10.0,
) -> jnp.ndarray:
    """Edge-preserving smoothing on raw depth (OpenCV weight convention).

    w(dy,dx) = exp(-(dy^2+dx^2)/(2*sigma_s^2)) * exp(-(I_n - I_c)^2/(2*sigma_c^2))
    """
    h, w = depth.shape
    r = kernel_size // 2
    padded = jnp.pad(depth, r, mode="reflect")
    inv2sc = -0.5 / (sigma_color * sigma_color)
    num = jnp.zeros_like(depth)
    den = jnp.zeros_like(depth)
    for dy in range(kernel_size):
        for dx in range(kernel_size):
            sw = math.exp(((dy - r) ** 2 + (dx - r) ** 2) * -0.5 / (sigma_spatial**2))
            nb = _shifted(padded, dy, dx, h, w)
            wgt = sw * jnp.exp((nb - depth) * (nb - depth) * inv2sc)
            num = num + wgt * nb
            den = den + wgt
    return num / jnp.maximum(den, 1e-20)


def scale_and_truncate(depth: jnp.ndarray, scale: float, max_dist: float) -> jnp.ndarray:
    """mm -> m and zero out beyond the far clip (image_process.cu:8-27)."""
    d = depth * scale
    return jnp.where(d <= max_dist, d, 0.0)
