"""Two-view epipolar geometry: normalized 8-point F/E, pose from E.

Reference analog (SURVEY §2 "Epipolar geometry / two-view init"):
fundamental/essential via normalized 8-point (SVD, rank-2 projection),
decompose E into 4 (R, t) candidates, select by cheirality.  All functions
are batched/vmap-friendly (the RANSAC loop evaluates thousands of
hypotheses in parallel — SURVEY §3.2).

Convention: pinhole, x2^T E x1 = 0 with x = (xn, yn, 1) normalized coords;
(R, t) maps camera-1 coordinates to camera-2: p2 = R p1 + t.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from pysfm_tpu.utils import precision as xp

from pysfm_tpu.frontend import triangulate as tri
from pysfm_tpu.geometry import so3


def normalize_points(x: jnp.ndarray, w: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hartley normalization: translate centroid to origin, scale mean
    distance to sqrt(2).  ``x [N,2]``, ``w [N]`` weights; returns (xh [N,3]
    normalized homogeneous, T [3,3]) with xh = T @ [x;1]."""
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    mean = jnp.sum(x * w[:, None], axis=0) / wsum
    d = jnp.sqrt(jnp.sum((x - mean) ** 2, axis=-1))
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d * w) / wsum, 1e-12)
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=x.dtype
    )
    T = T.at[0, 0].set(scale).at[1, 1].set(scale)
    T = T.at[0, 2].set(-scale * mean[0]).at[1, 2].set(-scale * mean[1])
    ones = jnp.ones_like(x[:, :1])
    xh = xp.matmul(jnp.concatenate([x, ones], axis=-1), T.T)
    return xh, T


def eight_point(
    x1: jnp.ndarray, x2: jnp.ndarray, w: jnp.ndarray | None = None,
    essential: bool = False,
) -> jnp.ndarray:
    """(Weighted) normalized 8-point algorithm.

    ``x1, x2 [N, 2]`` correspondences (N >= 8; pass weights to use a
    subset), returns F (or E with the (1,1,0) singular-value projection)
    such that ``x2h^T F x1h = 0``.
    """
    if w is None:
        w = jnp.ones(x1.shape[0], x1.dtype)
    x1h, T1 = normalize_points(x1, w)
    x2h, T2 = normalize_points(x2, w)
    # A_i = kron(x1h_i, x2h_i): rows of the homogeneous system A f = 0.
    A = jnp.einsum("ni,nj->nij", x1h, x2h).reshape(-1, 9)
    A = A * w[:, None]
    # Smallest right singular vector of A. SVD of the [N, 9] system keeps
    # the error ~eps*cond(A); eigh of A^T A squares the condition number
    # (measured 2e-7 vs <1e-10 here) and batched [*,N,9] SVD vmaps fine.
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    f = Vt[-1, :]
    F = f.reshape(3, 3).T          # note: einsum layout gives F^T in f
    # Undo normalization FIRST (T is not orthogonal, so singular-value
    # projections only make sense in the original frame):
    # x2^T F x1 with xh = T x -> F_orig = T2^T F T1.
    F = xp.matmul(xp.matmul(T2.T, F), T1)
    U, s, Vt = jnp.linalg.svd(F)
    if essential:
        s_proj = jnp.array([1.0, 1.0, 0.0], dtype=F.dtype) * (s[0] + s[1]) / 2.0
    else:
        s_proj = s.at[2].set(0.0)
    return xp.matmul(U * s_proj[None, :], Vt)


def sampson_distance(F: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) distance squared, [N]."""
    ones = jnp.ones_like(x1[:, :1])
    x1h = jnp.concatenate([x1, ones], axis=-1)
    x2h = jnp.concatenate([x2, ones], axis=-1)
    Fx1 = xp.matmul(x1h, F.T)          # [N, 3]
    Ftx2 = xp.matmul(x2h, F)           # [N, 3]
    e = jnp.sum(x2h * Fx1, axis=-1)
    denom = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    return e * e / jnp.maximum(denom, 1e-12)


def decompose_essential(E: jnp.ndarray):
    """E -> 4 candidate (R, t): [4,3,3], [4,3] (|t| = 1)."""
    U, _, Vt = jnp.linalg.svd(E)
    # Keep rotations proper.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    Ra = xp.matmul(xp.matmul(U, W), Vt)
    Rb = xp.matmul(xp.matmul(U, W.T), Vt)
    tu = U[:, 2]
    Rs = jnp.stack([Ra, Ra, Rb, Rb])
    ts = jnp.stack([tu, -tu, tu, -tu])
    return Rs, ts


def select_pose(
    E: jnp.ndarray, pn1: jnp.ndarray, pn2: jnp.ndarray,
    w: jnp.ndarray | None = None,
):
    """Resolve the 4-fold ambiguity by cheirality (SURVEY §3.2): triangulate
    under each candidate, pick the one with the most points in front of both
    cameras.  Returns (R, t, n_good, X [N,3] under the winner)."""
    if w is None:
        w = jnp.ones(pn1.shape[0], pn1.dtype)
    Rs, ts = decompose_essential(E)
    eye = jnp.eye(3, dtype=E.dtype)
    zero = jnp.zeros(3, dtype=E.dtype)

    def tri_count(R2, t2):
        Rpair = jnp.stack([eye, R2])
        tpair = jnp.stack([zero, t2])
        X = jax.vmap(
            lambda a, b: tri.triangulate_linear(
                Rpair, tpair, jnp.stack([a, b]), jnp.ones(2, dtype=E.dtype)
            )
        )(pn1, pn2)
        z1 = tri.depths(eye, zero, X)
        z2 = tri.depths(R2, t2, X)
        good = jnp.logical_and(z1 > 0, z2 > 0)
        return jnp.sum(good * w), X

    counts, Xs = jax.vmap(tri_count)(Rs, ts)
    k = jnp.argmax(counts)
    return Rs[k], ts[k], counts[k], Xs[k]


def essential_from_pose(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Ground-truth E = [t]x R for tests; p2 = R p1 + t convention."""
    return xp.matmul(so3.hat(t), R)
