"""Structure-of-arrays bundle-adjustment problem state.

Array-first replacement for the reference's object graph (SURVEY §2 "Bundle /
measurement model": ``Camera``, ``Track``, ``Bundle`` with per-measurement
Python loops).  Here the entire problem is a pytree of statically-shaped
arrays:

- cameras:      ``R [C,3,3]``, ``t [C,3]``, ``intr [C,I]``
- points:       ``X [P,3]``
- observations: ``obs_cam [M]``, ``obs_pt [M]``, ``obs_uv [M,2]``,
                ``obs_w [M]`` (confidence weight; 0 marks padding)
- visibility as a padded per-point table ``pt_obs [P,K]`` (+ mask) used by
  the Schur elimination to gather each point's observations with static
  shapes (SURVEY §7 "Irregular visibility graph on a dense-math machine").

Residual/Jacobian evaluation is one ``vmap``-free batched expression over
the observation axis — XLA fuses it into a few elementwise kernels feeding
gathers (SURVEY §3.1, the reference's hot loops).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from pysfm_tpu.geometry import projection
from pysfm_tpu.problem import robust
from pysfm_tpu.utils import struct


@struct.dataclass
class BundleProblem:
    """The full BA problem state, a jax pytree with static metadata."""

    # Camera states (world-to-camera: x_cam = R @ X + t).
    R: jnp.ndarray            # [C, 3, 3]
    t: jnp.ndarray            # [C, 3]
    intr: jnp.ndarray         # [C, I]   I = projection.INTR_DIM[camera_model]
    # Points.
    X: jnp.ndarray            # [P, 3]
    # Observations (sorted by point id by the builder).
    obs_cam: jnp.ndarray      # [M] int32
    obs_pt: jnp.ndarray       # [M] int32
    obs_uv: jnp.ndarray       # [M, 2]
    obs_w: jnp.ndarray        # [M] float; 0 => padding / disabled
    # Per-point padded observation table for Schur elimination.
    pt_obs: jnp.ndarray       # [P, K] int32 indices into obs arrays
    pt_obs_mask: jnp.ndarray  # [P, K] bool
    # Per-camera padded observation table: turns the camera-side
    # normal-equation accumulation into gathers + contractions instead of
    # scatter-adds.
    cam_obs: jnp.ndarray       # [C, Kc] int32 indices into obs arrays
    cam_obs_mask: jnp.ndarray  # [C, Kc] bool
    # Gauge fixing: cameras whose tangent update is frozen (SURVEY §7).
    cam_fixed: jnp.ndarray    # [C] bool
    # Robust cost (SURVEY §2 "Robust sensor models").
    robust_scale: jnp.ndarray  # scalar
    camera_model: str = struct.field(pytree_node=False, default="pose")
    robust: str = struct.field(pytree_node=False, default="gaussian")

    @property
    def n_cameras(self) -> int:
        return self.R.shape[0]

    @property
    def n_points(self) -> int:
        return self.X.shape[0]

    @property
    def n_obs(self) -> int:
        return self.obs_cam.shape[0]

    @property
    def cam_dof(self) -> int:
        return projection.CAM_DOF[self.camera_model]

    @property
    def dtype(self):
        return self.X.dtype


def build_point_obs_table(
    obs_pt: np.ndarray,
    n_points: int,
    max_track: Optional[int] = None,
    select: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: padded [P, K] table of observation indices per point.

    K defaults to the longest track.  Padding entries index 0 and are
    masked out; every consumer multiplies gathered values by the mask.
    ``select`` (bool [M]) restricts the table to a subset of observations
    (table entries still index the FULL obs arrays) — used to keep
    zero-weight padding rows from inflating K.
    """
    obs_pt = np.asarray(obs_pt)
    ids = (
        np.arange(obs_pt.shape[0])
        if select is None
        else np.flatnonzero(select)
    )
    sub = obs_pt[ids]
    counts = np.bincount(sub, minlength=n_points)
    k = int(counts.max(initial=1)) if max_track is None else int(max_track)
    order = np.argsort(sub, kind="stable")
    sorted_pt = sub[order]
    # Rank of each observation within its point group (vectorized).
    group_start = np.zeros(n_points + 1, dtype=np.int64)
    np.cumsum(counts, out=group_start[1:])
    pos = np.arange(sub.shape[0]) - group_start[sorted_pt]
    valid = pos < k
    table = np.zeros((n_points, k), dtype=np.int32)
    mask = np.zeros((n_points, k), dtype=bool)
    table[sorted_pt[valid], pos[valid]] = ids[order[valid]]
    mask[sorted_pt[valid], pos[valid]] = True
    return table, mask


def prepare_problem_arrays(
    R,
    t,
    intr,
    X,
    obs_cam,
    obs_pt,
    obs_uv,
    *,
    camera_model: str = "pose",
    robust: str = "gaussian",
    robust_scale: float = 1.0,
    obs_w=None,
    cam_fixed=None,
    max_track: Optional[int] = None,
    max_cam_obs: Optional[int] = None,
    dtype=None,
):
    """Host-side prep shared by the layout-specific builders: validates,
    sorts observations by point id, and builds the padded visibility
    tables.  Returns a dict of NumPy arrays (+ ``dtype``) that
    :func:`make_problem` (standard layout) and
    :func:`pysfm_tpu.problem.cm.make_cm_problem` (component-major BAL-scale
    layout) assemble into their device pytrees."""
    projection._check_model(camera_model)
    if robust not in ("gaussian", "huber", "cauchy"):
        raise ValueError(f"unknown robust kernel {robust!r}")
    R = np.asarray(R)
    t = np.asarray(t)
    intr = np.asarray(intr)
    X = np.asarray(X)
    obs_cam = np.asarray(obs_cam, dtype=np.int32)
    obs_pt = np.asarray(obs_pt, dtype=np.int32)
    obs_uv = np.asarray(obs_uv)
    if dtype is None:
        dtype = obs_uv.dtype if obs_uv.dtype in (np.float32, np.float64) else np.float64
    C, P = R.shape[0], X.shape[0]
    expected_intr = projection.INTR_DIM[camera_model]
    if intr.shape != (C, expected_intr):
        raise ValueError(
            f"intr must be [{C}, {expected_intr}] for model {camera_model!r}, "
            f"got {intr.shape}"
        )
    if obs_w is None:
        obs_w = np.ones(obs_cam.shape[0])
    obs_w = np.asarray(obs_w)
    if cam_fixed is None:
        cam_fixed = np.zeros(C, dtype=bool)
        cam_fixed[0] = True  # gauge: freeze the first camera (SURVEY §7)
    cam_fixed = np.asarray(cam_fixed, dtype=bool)

    # Sort by point id for segment locality; stable to keep camera order.
    order = np.argsort(obs_pt, kind="stable")
    obs_cam, obs_pt, obs_uv, obs_w = (
        obs_cam[order],
        obs_pt[order],
        obs_uv[order],
        obs_w[order],
    )
    # Zero-weight observations (padding / deactivated) contribute zero to
    # every w-scaled payload, so they are excluded from the gather tables —
    # otherwise bucketed padding rows (all indexing obs 0) inflate K.
    live = obs_w > 0
    # max_track / max_cam_obs only bucket the table shapes upward (static
    # -shape reuse across incremental-BA calls); a value below the actual
    # maximum would silently drop observations from the Schur gather.
    if max_track is not None and obs_pt.size:
        actual = int(np.bincount(obs_pt[live], minlength=P).max(initial=0))
        if max_track < actual:
            raise ValueError(
                f"max_track={max_track} < longest track {actual}"
            )
    if max_cam_obs is not None and obs_cam.size:
        actual = int(np.bincount(obs_cam[live], minlength=C).max(initial=0))
        if max_cam_obs < actual:
            raise ValueError(
                f"max_cam_obs={max_cam_obs} < busiest camera {actual}"
            )
    table, mask = build_point_obs_table(obs_pt, P, max_track, select=live)
    cam_table, cam_mask = build_point_obs_table(obs_cam, C, max_cam_obs,
                                                select=live)
    return dict(
        R=R, t=t, intr=intr, X=X,
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv, obs_w=obs_w,
        pt_obs=table, pt_obs_mask=mask,
        cam_obs=cam_table, cam_obs_mask=cam_mask,
        cam_fixed=cam_fixed, robust_scale=robust_scale,
        camera_model=camera_model, robust=robust, dtype=dtype,
    )


def make_problem(*args, **kwargs) -> BundleProblem:
    """Host-side builder: sorts observations by point, builds the padded
    visibility table, and assembles the device pytree."""
    a = prepare_problem_arrays(*args, **kwargs)
    (R, t, intr, X, obs_cam, obs_pt, obs_uv, obs_w, table, mask, cam_table,
     cam_mask, cam_fixed, robust_scale, camera_model, robust, dtype) = (
        a["R"], a["t"], a["intr"], a["X"], a["obs_cam"], a["obs_pt"],
        a["obs_uv"], a["obs_w"], a["pt_obs"], a["pt_obs_mask"], a["cam_obs"],
        a["cam_obs_mask"], a["cam_fixed"], a["robust_scale"],
        a["camera_model"], a["robust"], a["dtype"],
    )
    return BundleProblem(
        R=jnp.asarray(R, dtype=dtype),
        t=jnp.asarray(t, dtype=dtype),
        intr=jnp.asarray(intr, dtype=dtype),
        X=jnp.asarray(X, dtype=dtype),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(obs_uv, dtype=dtype),
        obs_w=jnp.asarray(obs_w, dtype=dtype),
        pt_obs=jnp.asarray(table),
        pt_obs_mask=jnp.asarray(mask),
        cam_obs=jnp.asarray(cam_table),
        cam_obs_mask=jnp.asarray(cam_mask),
        cam_fixed=jnp.asarray(cam_fixed),
        robust_scale=jnp.asarray(robust_scale, dtype=dtype),
        camera_model=camera_model,
        robust=robust,
    )


# --------------------------------------------------------------------------
# Batched evaluation (the reference's hot loops, SURVEY §3.1).
# --------------------------------------------------------------------------


def residuals(p: BundleProblem) -> jnp.ndarray:
    """Reprojection residuals r = project(cam, X) - uv, [M, 2] (unweighted)."""
    Rg = p.R[p.obs_cam]
    tg = p.t[p.obs_cam]
    ig = p.intr[p.obs_cam]
    Xg = p.X[p.obs_pt]
    uv = projection.project(p.camera_model, Rg, tg, ig, Xg)
    return uv - p.obs_uv


def cost(p: BundleProblem, r: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Robustified total cost 0.5 * sum_m w_m rho(||r_m||^2)."""
    if r is None:
        r = residuals(p)
    s = jnp.sum(r * r, axis=-1)
    return 0.5 * jnp.sum(p.obs_w * robust.rho(p.robust, s, p.robust_scale))


def residuals_and_jacobians(
    p: BundleProblem,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched residual + block-Jacobian build (SURVEY §2 "analytic Jacobians").

    Returns ``(r [M,2], J_cam [M,2,CP], J_pt [M,2,3], w_irls [M])`` where
    ``w_irls = obs_w * rho'(||r||^2)`` is the combined confidence+robust IRLS
    weight and J_cam is zeroed for gauge-fixed cameras.
    """
    Rg = p.R[p.obs_cam]
    tg = p.t[p.obs_cam]
    ig = p.intr[p.obs_cam]
    Xg = p.X[p.obs_pt]
    uv, J_cam, J_pt = projection.project_with_jac(p.camera_model, Rg, tg, ig, Xg)
    r = uv - p.obs_uv
    s = jnp.sum(r * r, axis=-1)
    w = p.obs_w * robust.weight(p.robust, s, p.robust_scale)
    free = jnp.logical_not(p.cam_fixed)[p.obs_cam]
    J_cam = J_cam * free[:, None, None].astype(J_cam.dtype)
    return r, J_cam, J_pt, w


def apply_update(
    p: BundleProblem, d_cam: jnp.ndarray, d_pt: jnp.ndarray
) -> BundleProblem:
    """Retract a tangent step: R <- exp(dw) R, t += dt, intr += di, X += dX.

    ``d_cam [C, CP]`` (already zero for fixed cameras by construction),
    ``d_pt [P, 3]``.  Reference analog: ``apply_update`` (SURVEY §3.1).
    """
    from pysfm_tpu.geometry import so3

    dw = d_cam[:, 0:3]
    dt = d_cam[:, 3:6]
    from pysfm_tpu.utils import precision as xp

    new_R = xp.matmul(so3.exp(dw), p.R)
    new_t = p.t + dt
    if d_cam.shape[1] > 6:
        new_intr = p.intr + d_cam[:, 6:]
    else:
        new_intr = p.intr
    return p.replace(R=new_R, t=new_t, intr=new_intr, X=p.X + d_pt)
