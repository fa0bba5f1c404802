"""Component-major (CM) problem layout — the BAL/Venice-scale fast path.

Why this exists (see solver/scale.py's layout rule): an array whose
trailing axis is small (``X [P, 3]``, ``obs_uv [M, 2]``, a gathered
``R[obs_cam] [m, 3, 3]``) interleaves its few components with the
observation or point axis, so every elementwise pass over one component
reads strided memory.

:class:`CMProblem` stores every observation/point-sized quantity with the
big axis MINOR (component-major): points as ``X3 [3, P]``, measurements as
flat ``u [M]`` / ``v [M]`` vectors, the per-point visibility table
transposed to ``[K, P]``.  Camera-sized arrays (C ~ 1e3) keep the standard
layout — they are small.  The companion projection/Jacobian math in this
module is scalar-unrolled over component rows (elementwise work on [m]
vectors), so the per-chunk working set of the normal-equation build is a
couple of [D, m] row blocks instead of [m, 3, 3] gathers.

Reference analog: none — the reference (pure NumPy, SURVEY §0/§2) has no
layout tier; this is the design SURVEY §7 step 6 calls for
("BAL-scale config with obs-chunking").
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from pysfm_tpu.geometry import projection
from pysfm_tpu.problem import problem as problem_mod
from pysfm_tpu.utils import struct


@struct.dataclass
class CMProblem:
    """Bundle-adjustment state in component-major layout.

    Same information as :class:`~pysfm_tpu.problem.BundleProblem`, laid out
    with the big axes minor for BAL scale.  Consumed by the ``pcg`` solver
    path (solver/scale.py + solver/pcg.py).
    """

    # Camera states (C is small — standard layout).
    R: jnp.ndarray            # [C, 3, 3]
    t: jnp.ndarray            # [C, 3]
    intr: jnp.ndarray         # [C, I]
    cam_fixed: jnp.ndarray    # [C] bool
    # Points, component-major.
    X3: jnp.ndarray           # [3, P]
    # Observations (sorted by point id), flat vectors.
    obs_cam: jnp.ndarray      # [M] int32
    obs_pt: jnp.ndarray       # [M] int32
    u: jnp.ndarray            # [M] measured pixel u
    v: jnp.ndarray            # [M] measured pixel v
    obs_w: jnp.ndarray        # [M]; 0 => padding / disabled
    # Visibility tables: point-side pre-transposed (P minor), camera-side
    # standard ([C, Kc] — both dims sizeable, tiles fine).
    pt_obsT: jnp.ndarray       # [K, P] int32 indices into obs arrays
    pt_obs_maskT: jnp.ndarray  # [K, P] bool
    cam_obs: jnp.ndarray       # [C, Kc] int32
    cam_obs_mask: jnp.ndarray  # [C, Kc] bool
    robust_scale: jnp.ndarray  # scalar
    camera_model: str = struct.field(pytree_node=False, default="pose")
    robust: str = struct.field(pytree_node=False, default="gaussian")

    @property
    def n_cameras(self) -> int:
        return self.R.shape[0]

    @property
    def n_points(self) -> int:
        return self.X3.shape[1]

    @property
    def n_obs(self) -> int:
        return self.obs_cam.shape[0]

    @property
    def cam_dof(self) -> int:
        return projection.CAM_DOF[self.camera_model]

    @property
    def dtype(self):
        return self.X3.dtype


def make_cm_problem(*args, **kwargs) -> CMProblem:
    """Host-side builder, mirror of :func:`pysfm_tpu.problem.make_problem`
    but emitting the component-major layout directly — at Venice scale this
    also avoids shipping the (logically identical) standard-layout arrays
    to the device at all."""
    a = problem_mod.prepare_problem_arrays(*args, **kwargs)
    dtype = a["dtype"]
    uv = np.asarray(a["obs_uv"], dtype=dtype)
    return CMProblem(
        R=jnp.asarray(a["R"], dtype=dtype),
        t=jnp.asarray(a["t"], dtype=dtype),
        intr=jnp.asarray(a["intr"], dtype=dtype),
        cam_fixed=jnp.asarray(a["cam_fixed"]),
        X3=jnp.asarray(np.ascontiguousarray(a["X"].T), dtype=dtype),
        obs_cam=jnp.asarray(a["obs_cam"]),
        obs_pt=jnp.asarray(a["obs_pt"]),
        u=jnp.asarray(np.ascontiguousarray(uv[:, 0])),
        v=jnp.asarray(np.ascontiguousarray(uv[:, 1])),
        obs_w=jnp.asarray(a["obs_w"], dtype=dtype),
        pt_obsT=jnp.asarray(np.ascontiguousarray(a["pt_obs"].T)),
        pt_obs_maskT=jnp.asarray(np.ascontiguousarray(a["pt_obs_mask"].T)),
        cam_obs=jnp.asarray(a["cam_obs"]),
        cam_obs_mask=jnp.asarray(a["cam_obs_mask"]),
        robust_scale=jnp.asarray(a["robust_scale"], dtype=dtype),
        camera_model=a["camera_model"],
        robust=a["robust"],
    )


def from_problem(p: problem_mod.BundleProblem) -> CMProblem:
    """Device-side conversion from the standard layout (one-time transpose
    cost; used when a caller hands the pcg solver a BundleProblem)."""
    return CMProblem(
        R=p.R, t=p.t, intr=p.intr, cam_fixed=p.cam_fixed,
        X3=p.X.T,
        obs_cam=p.obs_cam, obs_pt=p.obs_pt,
        u=p.obs_uv[:, 0], v=p.obs_uv[:, 1], obs_w=p.obs_w,
        pt_obsT=p.pt_obs.T, pt_obs_maskT=p.pt_obs_mask.T,
        cam_obs=p.cam_obs, cam_obs_mask=p.cam_obs_mask,
        robust_scale=p.robust_scale,
        camera_model=p.camera_model, robust=p.robust,
    )


def merge_params(
    p: problem_mod.BundleProblem, cmp: CMProblem
) -> problem_mod.BundleProblem:
    """Write a solved CMProblem's parameters back into a standard-layout
    problem (the measurement arrays are identical by construction)."""
    return p.replace(R=cmp.R, t=cmp.t, intr=cmp.intr, X=cmp.X3.T)


# --------------------------------------------------------------------------
# Camera parameter table + component-major projection math.
#
# The per-iteration camera table packs everything an observation needs from
# its camera into one [Dc, C] array so the chunked payload does a single
# [Dc, m] gather: rows 0..8 = R row-major, 9..11 = t, 12..12+I-1 = intr,
# last row = free flag (0 for gauge-fixed cameras; multiplies J_cam).
# --------------------------------------------------------------------------


def cam_table(cmp) -> jnp.ndarray:
    """[Dc, C] packed camera parameters (see the comment above) of a
    CMProblem or a BundleProblem (both carry R, t, intr, cam_fixed)."""
    C = cmp.n_cameras
    dt = cmp.dtype
    free = jnp.logical_not(cmp.cam_fixed).astype(dt)[None, :]     # [1, C]
    return jnp.concatenate(
        [
            cmp.R.reshape(C, 9).T.astype(dt),                     # [9, C]
            cmp.t.T.astype(dt),                                   # [3, C]
            cmp.intr.T.astype(dt),                                # [I, C]
            free,
        ],
        axis=0,
    )


def _cam_point_cm(cols: jnp.ndarray, Xg: jnp.ndarray):
    """p = R X + t from gathered camera columns; returns (x, y, z, rx, ry,
    rz) with r = R X (needed for the -hat(RX) pose block)."""
    X0, X1, X2 = Xg[0], Xg[1], Xg[2]
    rx = cols[0] * X0 + cols[1] * X1 + cols[2] * X2
    ry = cols[3] * X0 + cols[4] * X1 + cols[5] * X2
    rz = cols[6] * X0 + cols[7] * X1 + cols[8] * X2
    return rx + cols[9], ry + cols[10], rz + cols[11], rx, ry, rz


def project_cm(
    model: str, cols: jnp.ndarray, Xg: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Projection on component rows: cols [Dc, m], Xg [3, m] -> (u, v) [m].

    Same math as :func:`pysfm_tpu.geometry.projection.project`, unrolled so
    every intermediate is an [m] vector (no [m, k] minor-axis padding).
    """
    projection._check_model(model)
    x, y, z, _, _, _ = _cam_point_cm(cols, Xg)
    inv_z = 1.0 / z
    if model == "bal":
        f, k1, k2 = cols[12], cols[13], cols[14]
        pn0 = -x * inv_z
        pn1 = -y * inv_z
        r2 = pn0 * pn0 + pn1 * pn1
        rho = 1.0 + r2 * (k1 + r2 * k2)
        return f * rho * pn0, f * rho * pn1
    # Same operation order as project_jac_cm (fx * (x * inv_z) + cx) so the
    # two paths agree bitwise, not just to roundoff.
    fx, fy, cx, cy = cols[12], cols[13], cols[14], cols[15]
    return fx * (x * inv_z) + cx, fy * (y * inv_z) + cy


def project_jac_cm(
    model: str, cols: jnp.ndarray, Xg: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, List[List[jnp.ndarray]], List[List[jnp.ndarray]]]:
    """Projection + analytic Jacobians on component rows.

    Returns ``(u, v, Jc, Jp)`` where ``Jc[i][d]`` (i in {0,1} residual
    component, d < CAM_DOF[model]) and ``Jp[i][s]`` (s < 3) are [m] vectors.
    Identical math to :func:`projection.project_with_jac` (left-perturbation
    pose tangent [dw, dt, dintr]); equality asserted by tests/test_cm.py.
    The gauge free-flag row of ``cols`` multiplies every Jc entry.
    """
    projection._check_model(model)
    x, y, z, rx, ry, rz = _cam_point_cm(cols, Xg)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    free = cols[-1]

    if model == "bal":
        f, k1, k2 = cols[12], cols[13], cols[14]
        pn0 = -x * inv_z
        pn1 = -y * inv_z
        r2 = pn0 * pn0 + pn1 * pn1
        rho = 1.0 + r2 * (k1 + r2 * k2)
        u = f * rho * pn0
        v = f * rho * pn1
        # duv_dpn = f (rho I + pn drho^T), drho = (2 k1 + 4 k2 r2) pn.
        g = 2.0 * k1 + 4.0 * k2 * r2
        dr0 = g * pn0
        dr1 = g * pn1
        a00 = f * (rho + pn0 * dr0)
        a01 = f * (pn0 * dr1)
        a10 = f * (pn1 * dr0)
        a11 = f * (rho + pn1 * dr1)
        # dpn_dp = [[-iz, 0, x iz^2], [0, -iz, y iz^2]]; d = duv_dpn @ dpn_dp
        d = [
            [-a00 * inv_z, -a01 * inv_z, (a00 * x + a01 * y) * inv_z2],
            [-a10 * inv_z, -a11 * inv_z, (a10 * x + a11 * y) * inv_z2],
        ]
        J_intr = [
            [rho * pn0, f * r2 * pn0, f * r2 * r2 * pn0],
            [rho * pn1, f * r2 * pn1, f * r2 * r2 * pn1],
        ]
    else:
        fx, fy = cols[12], cols[13]
        pn0 = x * inv_z
        pn1 = y * inv_z
        u = fx * pn0 + cols[14]
        v = fy * pn1 + cols[15]
        zero = jnp.zeros_like(x)
        d = [
            [fx * inv_z, zero, -fx * x * inv_z2],
            [zero, fy * inv_z, -fy * y * inv_z2],
        ]
        if model == "pose_k":
            one = jnp.ones_like(x)
            J_intr = [
                [pn0, zero, one, zero],
                [zero, pn1, zero, one],
            ]
        else:
            J_intr = None

    # Pose blocks: dp/ddw = -hat(R X) with rows [[0, rz, -ry], [-rz, 0, rx],
    # [ry, -rx, 0]]; dp/ddt = I; dp/dX = R.
    Jc: List[List[jnp.ndarray]] = [[], []]
    Jp: List[List[jnp.ndarray]] = [[], []]
    for i in range(2):
        d0, d1, d2 = d[i]
        Jw = [
            -d1 * rz + d2 * ry,
            d0 * rz - d2 * rx,
            -d0 * ry + d1 * rx,
        ]
        Jt = [d0, d1, d2]
        block = Jw + Jt + (J_intr[i] if J_intr is not None else [])
        Jc[i] = [free * e for e in block]
        Jp[i] = [
            d0 * cols[0] + d1 * cols[3] + d2 * cols[6],
            d0 * cols[1] + d1 * cols[4] + d2 * cols[7],
            d0 * cols[2] + d1 * cols[5] + d2 * cols[8],
        ]
    return u, v, Jc, Jp


def residuals_and_jacobians_rows(p: problem_mod.BundleProblem):
    """:func:`pysfm_tpu.problem.problem.residuals_and_jacobians` emitted
    directly in component-major rows, for the dense solver's cm layout
    (solver/schur_cm.py): ``(rt [2, M], Jct [2*CP, M], Jpt [6, M],
    wt [M])`` with Jct row ``i*CP + d`` and Jpt row ``i*3 + s``.  One
    camera-table column gather and one point gather feed the unrolled
    :func:`project_jac_cm`, so no ``[M, 2, CP]`` array is formed."""
    from pysfm_tpu.problem import robust as robust_mod

    cols = cam_table(p)[:, p.obs_cam]                        # [Dc, M]
    Xg = p.X.T[:, p.obs_pt]                                  # [3, M]
    u, v, Jc, Jp = project_jac_cm(p.camera_model, cols, Xg)
    r0 = u - p.obs_uv[:, 0]
    r1 = v - p.obs_uv[:, 1]
    w = p.obs_w * robust_mod.weight(
        p.robust, r0 * r0 + r1 * r1, p.robust_scale
    )
    return (
        jnp.stack([r0, r1]), jnp.stack(Jc[0] + Jc[1]),
        jnp.stack(Jp[0] + Jp[1]), w,
    )


def apply_update_cm(
    cmp: CMProblem, d_cam: jnp.ndarray, d_pt3: jnp.ndarray
) -> CMProblem:
    """Retraction in the CM domain: ``d_cam [C, CP]`` (standard layout — the
    camera axis is small), ``d_pt3 [3, P]`` component-major."""
    from pysfm_tpu.geometry import so3
    from pysfm_tpu.utils import precision as xp

    new_R = xp.matmul(so3.exp(d_cam[:, 0:3]), cmp.R)
    new_t = cmp.t + d_cam[:, 3:6]
    new_intr = (
        cmp.intr + d_cam[:, 6:] if d_cam.shape[1] > 6 else cmp.intr
    )
    return cmp.replace(
        R=new_R, t=new_t, intr=new_intr, X3=cmp.X3 + d_pt3
    )
