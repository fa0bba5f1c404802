"""Triangulation — batched linear (DLT) + nonlinear refinement.

Reference analog (SURVEY §2 "Triangulation"): initialize 3-D points from
>= 2 posed views via linear least squares on the cross-product constraints.
Design: instead of per-point SVDs of stacked [2V,4] systems, we solve
the inhomogeneous 3x3 normal equations with the closed-form batched inverse
(points at infinity are not a target of the reference either), vmapped over
points with a visibility mask — static shapes, no data-dependent loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pysfm_tpu.utils import precision as xp

from pysfm_tpu.geometry import projection
from pysfm_tpu.solver.schur import inv3x3


def pixel_to_normalized(model: str, intr: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Pixel -> normalized image coordinates (undistorting where the model
    has distortion).  Broadcasts over leading dims.

    For ``bal`` the radial distortion is inverted by fixed-point iteration
    (5 steps — exact to f32 for the mild k1/k2 of the BAL datasets), and the
    returned coordinates follow the *pinhole* convention ``pn = p/z`` with
    the BAL -z flip folded in, so downstream geometry is convention-free.
    """
    projection._check_model(model)
    if model == "bal":
        f, k1, k2 = intr[..., 0], intr[..., 1], intr[..., 2]
        d = uv / f[..., None]          # = rho * pn_bal
        pn = d
        for _ in range(5):
            r2 = jnp.sum(pn * pn, axis=-1)
            rho = 1.0 + r2 * (k1 + r2 * k2)
            pn = d / rho[..., None]
        # BAL: pn_bal = -p/z; convert to pinhole p/z convention.
        return -pn
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    return jnp.stack(
        [(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1
    )


def forward_sign(model: str) -> float:
    """Camera-frame depth sign for points in front: +1 pinhole, -1 BAL."""
    return -1.0 if model == "bal" else 1.0


def triangulate_linear(
    R: jnp.ndarray,       # [V, 3, 3]
    t: jnp.ndarray,       # [V, 3]
    pn: jnp.ndarray,      # [V, 2] normalized coords (pinhole convention)
    mask: jnp.ndarray,    # [V] weights (0/1 or confidences)
) -> jnp.ndarray:
    """Linear triangulation of one point from masked views.

    Constraints per view (p = R X + t, pn = p_xy / p_z):
    ``(R0 - xn R2) X = -(t0 - xn t2)`` and same for y.  Solves the 3x3
    normal equations.  vmap over a leading point axis for batches.
    """
    xn, yn = pn[..., 0:1], pn[..., 1:2]
    a1 = R[:, 0, :] - xn * R[:, 2, :]                 # [V, 3]
    a2 = R[:, 1, :] - yn * R[:, 2, :]
    b1 = -(t[:, 0] - pn[:, 0] * t[:, 2])              # [V]
    b2 = -(t[:, 1] - pn[:, 1] * t[:, 2])
    A = jnp.concatenate([a1, a2], axis=0)             # [2V, 3]
    b = jnp.concatenate([b1, b2], axis=0)
    w = jnp.concatenate([mask, mask], axis=0).astype(A.dtype)
    AtA = jnp.einsum("vi,vj->ij", A * w[:, None], A, precision=xp.HIGHEST)
    Atb = jnp.einsum("vi,v->i", A * w[:, None], b, precision=xp.HIGHEST)
    # Identity fill keeps unobserved/degenerate systems finite.
    d = jnp.diagonal(AtA)
    AtA = AtA + jnp.diag(jnp.where(jnp.max(jnp.abs(d)) == 0, 1.0, 0.0) * jnp.ones_like(d))
    return xp.matvec(inv3x3(AtA), Atb)


def triangulate_points(
    model: str,
    R: jnp.ndarray,      # [V, 3, 3] camera poses
    t: jnp.ndarray,      # [V, 3]
    intr: jnp.ndarray,   # [V, I]
    uv: jnp.ndarray,     # [P, V, 2] pixel measurements per point/view
    mask: jnp.ndarray,   # [P, V]
) -> jnp.ndarray:
    """Batched multi-view triangulation: [P, 3] world points."""
    pn = pixel_to_normalized(model, intr, uv)         # [P, V, 2]
    return jax.vmap(lambda pnp_, m: triangulate_linear(R, t, pnp_, m))(
        pn, mask
    )


def depths(R: jnp.ndarray, t: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame z of points. Broadcasts: [..., 3, 3], [..., 3], [..., 3]."""
    return jnp.einsum("...j,...j->...", R[..., 2, :], X) + t[..., 2]


def refine_points(
    model: str,
    R: jnp.ndarray, t: jnp.ndarray, intr: jnp.ndarray,   # [V, ...]
    uv: jnp.ndarray, mask: jnp.ndarray,                   # [P, V, 2], [P, V]
    X0: jnp.ndarray,                                      # [P, 3]
    iters: int = 5,
) -> jnp.ndarray:
    """Gauss-Newton polish of triangulated points (point-only BA), batched.

    Uses the analytic point Jacobians from L0; each iteration is a masked
    3x3 solve per point.  Fixed iteration count -> static control flow.
    """

    def step(X, _):
        Xb = X[:, None, :]                                # [P, 1, 3] -> bcast V
        uv_hat, _, J_pt = projection.project_with_jac(
            model, R[None], t[None], intr[None], Xb
        )
        r = (uv_hat - uv) * mask[..., None]               # [P, V, 2]
        H = jnp.einsum("pvis,pvit->pst", J_pt * mask[..., None, None], J_pt, precision=xp.HIGHEST)
        g = jnp.einsum("pvis,pvi->ps", J_pt * mask[..., None, None], r, precision=xp.HIGHEST)
        d = jnp.diagonal(H, axis1=-2, axis2=-1)
        H = H + 1e-8 * jnp.eye(3, dtype=X.dtype) + jnp.eye(3, dtype=X.dtype) * (
            jnp.max(jnp.abs(d), axis=-1, keepdims=True)[..., None] == 0
        )
        dX = -jnp.einsum("pst,pt->ps", inv3x3(H), g, precision=xp.HIGHEST)
        return X + dX, None

    X, _ = jax.lax.scan(step, X0, None, length=iters)
    return X
