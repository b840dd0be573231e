"""Frame-to-model projective point-to-plane ICP, fully in-graph.

The reference ping-pongs host<->device 19 times per frame: every iteration
launches two CUDA reduction kernels, copies 27 floats to the host, and solves
the 6x6 system on the CPU with OpenCV (rigid_icp.cu:135-169,
icp_registration.cpp:28-42). Here the entire coarse-to-fine optimisation is
one traced computation: correspondence search + residual rows are vectorised
over pixels, the 27-term reduction is a single [6+1, P] x [P, 6+1] matmul,
and the 6x6 solve runs in-graph — zero transfers per frame. On a
device mesh the same reduction finishes with a `psum` over the pixel-sharded
axis (see kinfu_tpu/parallel/).

Math parity with device::ICP::findCoresp + kernel_rigidICP
(rigid_icp.cu:46-112) and ICPRegistration::rigidTransform
(icp_registration.cpp:16-44):
  - transform the current vertex by the running increment, project into the
    previous (raycast) frame with nearest-pixel rounding; gate by z > 0,
    bounds, ||v_cur - v_pre|| <= dist_thres, ||n_cur x n_pre|| <= sin(angle)
  - row = [s x n, n | n . (d - s)] with s = transformed current vertex,
    n,d = model normal/vertex
  - solve A x = b, fail when |det A| < 1e-15 or NaN; increment =
    (Rodrigues(x[:3]), x[3:6]) right-multiplied onto the running pose
  - levels run coarsest-first with iters[level] iterations each
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from kinfu_tpu.config import KinFuParams
from kinfu_tpu.geometry.intrinsics import Intrinsics
from kinfu_tpu.geometry.se3 import Pose, compose, se3_increment


class ICPResult(NamedTuple):
    #: previous-camera-from-current-camera increment
    pose: Pose
    #: False when any 6x6 system was singular (tracking failure)
    ok: jnp.ndarray
    #: diagnostics: inlier correspondence count at the finest level
    num_inliers: jnp.ndarray


def _normal_equations(
    inc: Pose,
    cur_vmap: jnp.ndarray,
    cur_nmap: jnp.ndarray,
    pre_vmap: jnp.ndarray,
    pre_nmap: jnp.ndarray,
    intr: Intrinsics,
    dist_thres: float,
    sin_angle_thres: float,
    axis_name: str | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Build (A [6,6], b [6], inlier_count) for one Gauss-Newton iteration.

    With `axis_name`, cur_vmap/cur_nmap are row-shards of the image and the
    27-term reduction finishes with a psum over the mesh — the distributed
    equivalent of the reference's two-kernel global reduction
    (rigid_icp.cu:115-132). The model maps must be replicated (projective
    association gathers arbitrary pixels)."""
    # bounds come from the *model* image (cur maps may be a row-shard)
    h, w, _ = pre_vmap.shape
    R, t = inc

    ncur_valid = jnp.any(cur_nmap != 0, axis=-1)

    s = jnp.einsum("ij,hwj->hwi", R, cur_vmap) + t
    z = s[..., 2]
    zsafe = jnp.where(z > 0, z, 1.0)
    u = jnp.rint(s[..., 0] / zsafe * intr.fx + intr.cx).astype(jnp.int32)
    v = jnp.rint(s[..., 1] / zsafe * intr.fy + intr.cy).astype(jnp.int32)
    inb = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)

    lin = jnp.clip(v * w + u, 0, h * w - 1)
    d = jnp.take(pre_vmap.reshape(-1, 3), lin, axis=0)
    n = jnp.take(pre_nmap.reshape(-1, 3), lin, axis=0)

    dist = jnp.linalg.norm(s - d, axis=-1)
    ncur_t = jnp.einsum("ij,hwj->hwi", R, cur_nmap)
    sine = jnp.linalg.norm(jnp.cross(ncur_t, n), axis=-1)
    npre_valid = jnp.any(n != 0, axis=-1)

    mask = (
        ncur_valid
        & inb
        & npre_valid
        & (dist <= dist_thres)
        & (sine <= sin_angle_thres)
    )

    # rows [P, 7]: [s x n, n, n.(d - s)]
    c = jnp.cross(s, n)
    r = jnp.sum(n * (d - s), axis=-1)
    rows = jnp.concatenate([c, n, r[..., None]], axis=-1)
    rows = jnp.where(mask[..., None], rows, 0.0).reshape(-1, 7)

    # 27 independent sums == upper triangle of rows^T rows; one matmul
    G = jax.lax.dot_general(
        rows,
        rows,
        (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    ninl = jnp.sum(mask.astype(jnp.int32))
    if axis_name is not None:
        G = jax.lax.psum(G, axis_name)
        ninl = jax.lax.psum(ninl, axis_name)
    A = G[:6, :6]
    b = G[:6, 6]
    return A, b, ninl


def rigid_icp(
    cur_vmaps: Sequence[jnp.ndarray],
    cur_nmaps: Sequence[jnp.ndarray],
    pre_vmaps: Sequence[jnp.ndarray],
    pre_nmaps: Sequence[jnp.ndarray],
    intr: Intrinsics,
    params: KinFuParams,
    axis_name: str | None = None,
) -> ICPResult:
    """Coarse-to-fine ICP. Returns the prev<-cur camera increment.

    With `axis_name`, cur maps are row-shards and the reduction is a psum
    (see _normal_equations); pose updates then happen replicated on every
    device."""
    sin_thres = math.sin(math.radians(params.icp_angle_threshold))
    pose0 = Pose(jnp.eye(3, dtype=jnp.float32), jnp.zeros((3,), jnp.float32))
    ok0 = jnp.asarray(True)
    inliers = jnp.asarray(0, dtype=jnp.int32)

    pose, ok = pose0, ok0
    for level, iters in params.level_iters_coarse_to_fine():
        lintr = intr.level(level)
        cv, cn = cur_vmaps[level], cur_nmaps[level]
        pv, pn = pre_vmaps[level], pre_nmaps[level]

        def body(_, carry, cv=cv, cn=cn, pv=pv, pn=pn, lintr=lintr):
            pose, ok, _ = carry
            A, b, ninl = _normal_equations(
                pose,
                cv,
                cn,
                pv,
                pn,
                lintr,
                params.icp_dist_threshold,
                sin_thres,
                axis_name=axis_name,
            )
            det = jnp.linalg.det(A.astype(jnp.float32))
            good = (jnp.abs(det) >= 1e-15) & ~jnp.isnan(det)
            x = jnp.linalg.solve(
                jnp.where(good, A, jnp.eye(6, dtype=A.dtype)), b
            )
            x = jnp.where(good, x, 0.0)
            new_pose = compose(pose, se3_increment(x))
            keep = ok & good
            pose = jax.tree.map(
                lambda new, old: jnp.where(keep, new, old), new_pose, pose
            )
            return pose, keep, ninl

        pose, ok, inliers = jax.lax.fori_loop(0, iters, body, (pose, ok, inliers))

    return ICPResult(pose=pose, ok=ok, num_inliers=inliers)


def icp_step(*args, **kwargs) -> ICPResult:  # convenience alias
    return rigid_icp(*args, **kwargs)
