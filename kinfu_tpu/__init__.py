"""kinfu_tpu — a dense RGB-D SLAM (KinectFusion) engine in JAX.

Built from scratch in JAX/XLA. Capability reference:
baiyuntao00/SLAM-KinectFusion (single-GPU C++/CUDA); see SURVEY.md for the
structural map. This is not a port: the per-frame pipeline is a single
jit-compiled functional step with donated volume state, every stage is plain
jax.numpy/lax that XLA compiles for the accelerator, and the volume shards
across a device mesh.
"""

__version__ = "0.1.0"

import jax as _jax

# Pose math and the ICP normal equations are tiny 3x3/6x6 products and one
# [P,7]^T[P,7] Gram. On a GPU, XLA may run float32 products in TF32 (about
# three decimal digits), which is ~1e-3 relative error — catastrophic for
# trajectory accuracy. Full-precision f32 matmul costs nothing at this scale.
_jax.config.update("jax_default_matmul_precision", "highest")

from kinfu_tpu.config import KinFuParams  # noqa: F401
