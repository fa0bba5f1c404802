"""Projection models with closed-form (analytic) Jacobians, batched.

Reference analog (SURVEY §2 "Bundle / measurement model"): projection
``x = pr(K (R X + t))`` with analytic Jacobians wrt the camera tangent
(dw, dt[, intrinsics]) and the point.  The reference evaluates these in a
per-measurement Python loop; here every function is written point-wise and
meant to be ``vmap``-ed / broadcast over the observation axis so XLA lowers
it to a handful of fused elementwise kernels (SURVEY §3.1).

Camera models (static choice per problem, SURVEY §7):

- ``"pose"``      — 6-DoF pose only, fixed K folded into normalized coords
                    (intr = [fx, fy, cx, cy], not optimized).
- ``"pose_k"``    — 6-DoF pose + [fx, fy, cx, cy] optimized (CP = 10).
- ``"bal"``       — BAL convention: 6-DoF pose + [f, k1, k2] with the
                    -p/z flip and radial distortion (CP = 9).

Tangent layout is always ``[dw(3), dt(3), dintr(0|3|4)]``.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from pysfm_tpu.utils import precision as xp

CAMERA_MODELS = ("pose", "pose_k", "bal")

# Number of intrinsic parameters *stored* per model.
INTR_DIM = {"pose": 4, "pose_k": 4, "bal": 3}
# Tangent (optimized) dim per camera.
CAM_DOF = {"pose": 6, "pose_k": 10, "bal": 9}


def pr(x: jnp.ndarray) -> jnp.ndarray:
    """Dehomogenize: [..., n] -> [..., n-1] (reference ``pr()``, SURVEY §2)."""
    return x[..., :-1] / x[..., -1:]


def unpr(x: jnp.ndarray) -> jnp.ndarray:
    """Homogenize: [..., n] -> [..., n+1] (reference ``unpr()``)."""
    return jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)


def _cam_point(R, t, X):
    return xp.matvec(R, X) + t


def _check_model(model: str) -> None:
    if model not in CAMERA_MODELS:
        raise ValueError(
            f"unknown camera model {model!r}; expected one of {CAMERA_MODELS}"
        )


def project(model: str, R, t, intr, X) -> jnp.ndarray:
    """Project world point(s) X to pixel coordinates. Broadcasts."""
    _check_model(model)
    p = _cam_point(R, t, X)
    if model == "bal":
        # BAL: p' = -p/z ; radial rho = 1 + k1 r^2 + k2 r^4 ; uv = f * rho * p'
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        pn = -p[..., :2] / p[..., 2:3]
        r2 = jnp.sum(pn * pn, axis=-1)
        rho = 1.0 + r2 * (k1 + r2 * k2)
        return (f * rho)[..., None] * pn
    else:
        fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
        pn = p[..., :2] / p[..., 2:3]
        u = fx * pn[..., 0] + cx
        v = fy * pn[..., 1] + cy
        return jnp.stack([u, v], axis=-1)


def project_with_jac(
    model: str, R, t, intr, X
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Projection + analytic Jacobians.

    Returns ``(uv, J_cam, J_pt)`` with ``uv [..., 2]``,
    ``J_cam [..., 2, CAM_DOF[model]]`` (wrt tangent [dw, dt, dintr]) and
    ``J_pt [..., 2, 3]`` (wrt the world point).

    Derivation: p = R X + t; left perturbation gives
    d p / d dw = -hat(R X) = -hat(p - t); d p / d dt = I; d p / d X = R.
    The pixel map then chain-rules through the normalized coordinates.
    Validated against ``jax.jacfwd`` and central finite differences in
    ``tests/test_jacobians.py`` (SURVEY §3.4 three-way check).
    """
    _check_model(model)
    p = _cam_point(R, t, X)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    inv_z = 1.0 / z

    if model == "bal":
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        pn = -p[..., :2] * inv_z[..., None]                       # [..., 2]
        r2 = jnp.sum(pn * pn, axis=-1)
        rho = 1.0 + r2 * (k1 + r2 * k2)
        uv = (f * rho)[..., None] * pn

        # d pn / d p : [-1/z, 0, x/z^2; 0, -1/z, y/z^2]
        zero = jnp.zeros_like(inv_z)
        dpn_dp = jnp.stack(
            [
                jnp.stack([-inv_z, zero, x * inv_z * inv_z], axis=-1),
                jnp.stack([zero, -inv_z, y * inv_z * inv_z], axis=-1),
            ],
            axis=-2,
        )                                                          # [..., 2, 3]
        # d uv / d pn = f * (rho I + pn * (drho/dpn)^T),
        # drho/dpn = (2 k1 + 4 k2 r2) * pn
        drho = (2.0 * k1 + 4.0 * k2 * r2)[..., None] * pn          # [..., 2]
        eye2 = jnp.eye(2, dtype=p.dtype)
        duv_dpn = f[..., None, None] * (
            rho[..., None, None] * eye2
            + pn[..., :, None] * drho[..., None, :]
        )                                                          # [..., 2, 2]
        duv_dp = xp.matmul(duv_dpn, dpn_dp)                        # [..., 2, 3]

        # Intrinsics block: d uv / d [f, k1, k2]
        duv_df = rho[..., None] * pn                               # [..., 2]
        duv_dk1 = (f * r2)[..., None] * pn
        duv_dk2 = (f * r2 * r2)[..., None] * pn
        J_intr = jnp.stack([duv_df, duv_dk1, duv_dk2], axis=-1)    # [..., 2, 3]
    else:
        fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
        pn = p[..., :2] * inv_z[..., None]
        uv = jnp.stack(
            [fx * pn[..., 0] + cx, fy * pn[..., 1] + cy], axis=-1
        )
        zero = jnp.zeros_like(inv_z)
        # d uv / d p directly: row0 = fx * [1/z, 0, -x/z^2], row1 = fy * [0, 1/z, -y/z^2]
        duv_dp = jnp.stack(
            [
                fx[..., None]
                * jnp.stack([inv_z, zero, -x * inv_z * inv_z], axis=-1),
                fy[..., None]
                * jnp.stack([zero, inv_z, -y * inv_z * inv_z], axis=-1),
            ],
            axis=-2,
        )                                                          # [..., 2, 3]
        if model == "pose_k":
            one = jnp.ones_like(inv_z)
            J_intr = jnp.stack(
                [
                    jnp.stack([pn[..., 0], zero], axis=-1),        # d/dfx
                    jnp.stack([zero, pn[..., 1]], axis=-1),        # d/dfy
                    jnp.stack([one, zero], axis=-1),               # d/dcx
                    jnp.stack([zero, one], axis=-1),               # d/dcy
                ],
                axis=-1,
            )                                                      # [..., 2, 4]
        else:
            J_intr = None

    # Pose blocks via the chain rule through p.
    p_minus_t = p - t
    px, py, pz = p_minus_t[..., 0], p_minus_t[..., 1], p_minus_t[..., 2]
    zero = jnp.zeros_like(px)
    # -hat(R X): [..., 3, 3]
    neg_hat_RX = jnp.stack(
        [
            jnp.stack([zero, pz, -py], axis=-1),
            jnp.stack([-pz, zero, px], axis=-1),
            jnp.stack([py, -px, zero], axis=-1),
        ],
        axis=-2,
    )
    J_w = xp.matmul(duv_dp, neg_hat_RX)                            # [..., 2, 3]
    J_t = duv_dp                                                   # dp/dt = I
    J_pt = xp.matmul(duv_dp, R)                                    # [..., 2, 3]

    if J_intr is None:
        J_cam = jnp.concatenate([J_w, J_t], axis=-1)
    else:
        J_cam = jnp.concatenate([J_w, J_t, J_intr], axis=-1)
    return uv, J_cam, J_pt
