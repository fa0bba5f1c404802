"""P3P — minimal 3-point absolute pose (Grunert's formulation).

The minimal resection solver for PnP-RANSAC: a 3-point sample keeps the
all-inlier probability high at low inlier ratios where the 6-point DLT
sample collapses (SURVEY §3.3 "RANSAC'd PnP").

Design: the Grunert system is reduced to a single quartic whose
coefficients are built by static polynomial arithmetic, and the quartic is
solved in closed form (Ferrari) with REAL elementwise ops only — no
``eigvals`` and no complex transcendentals, branch-free, fully
``vmap``-able across RANSAC hypotheses.  Each
sample yields up to 4 candidate poses; invalid candidates come back as NaN
and are discarded by scoring.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from pysfm_tpu.utils import precision as xp


def solve_quartic(coeffs: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form (Ferrari) REAL roots of c4 x^4 + ... + c1 x + c0.

    ``coeffs = [c4, c3, c2, c1, c0]`` real; returns ``(roots[4], valid[4])``
    where invalid slots mark complex-conjugate pairs (their values are
    meaningless).  Entirely real arithmetic — no complex transcendentals —
    with the resolvent cubic split into the real-Cardano
    (disc >= 0) and trigonometric (disc < 0, three real roots) branches,
    both evaluated and selected branch-free.  Roots are polished with three
    Newton steps on the original quartic, which also stabilizes f32.
    """
    c4, c3, c2, c1, c0 = [coeffs[i] for i in range(5)]
    dtype = coeffs.dtype
    one = jnp.asarray(1.0, dtype)
    tiny = jnp.asarray(1e-30 if dtype == jnp.float64 else 1e-18, dtype)
    a = c3 / c4
    b = c2 / c4
    c = c1 / c4
    d = c0 / c4

    # Depressed quartic y^4 + p y^2 + q y + r with x = y - a/4.
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a * a * a / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0

    # Resolvent cubic z^3 - p z^2 - 4 r z + (4 p r - q^2) = 0; any real root
    # works (one always exists).  Depress: t^3 + P t + Q with z = t - A/3.
    A = -p
    P = -4.0 * r - A * A / 3.0
    Q = (4.0 * p * r - q * q) - A * (-4.0 * r) / 3.0 + 2.0 * A ** 3 / 27.0
    disc = (Q / 2.0) ** 2 + (P / 3.0) ** 3

    def _cbrt(w):
        return jnp.sign(w) * jnp.abs(w) ** (one / 3.0)

    # disc >= 0: one real root via real Cardano.
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_card = _cbrt(-Q / 2.0 + sq) + _cbrt(-Q / 2.0 - sq)
    # disc < 0 (requires P < 0): three real roots; take the largest, which
    # maximizes m^2 = z - p below and keeps the quadratic split stable.
    Pn = jnp.minimum(P, -tiny)
    sP = jnp.sqrt(-Pn / 3.0)
    cosarg = jnp.clip(3.0 * Q / (2.0 * Pn) * jnp.sqrt(-3.0 / Pn), -1.0, 1.0)
    t_trig = 2.0 * sP * jnp.cos(jnp.arccos(cosarg) / 3.0)
    t1 = jnp.where(disc >= 0, t_card, t_trig)
    z = t1 - A / 3.0

    # Factor into two quadratics: y^2 -+ m y + (z/2 -+ q/(2m)).
    m2 = z - p
    biquad = m2 < tiny
    m = jnp.sqrt(jnp.maximum(m2, 0.0))
    m_safe = jnp.where(biquad, one, m)
    alpha = z / 2.0 - q / (2.0 * m_safe)
    beta = z / 2.0 + q / (2.0 * m_safe)
    d1s = m * m - 4.0 * alpha
    d2s = m * m - 4.0 * beta
    d1 = jnp.sqrt(jnp.maximum(d1s, 0.0))
    d2 = jnp.sqrt(jnp.maximum(d2s, 0.0))
    roots_gen = jnp.stack(
        [
            (-m + d1) / 2.0,
            (-m - d1) / 2.0,
            (m + d2) / 2.0,
            (m - d2) / 2.0,
        ]
    )
    # Permissive validity: a repeated real root's discriminant can round
    # slightly negative; admitting a borderline complex pair is harmless
    # (callers score candidates), dropping a real double root is not.
    eps = jnp.asarray(1e-9 if dtype == jnp.float64 else 1e-4, dtype)
    tol1 = -eps * (m * m + 4.0 * jnp.abs(alpha) + one)
    tol2 = -eps * (m * m + 4.0 * jnp.abs(beta) + one)
    valid_gen = jnp.stack([d1s >= tol1, d1s >= tol1, d2s >= tol2,
                           d2s >= tol2])

    # If m ~ 0 the quartic is biquadratic: y^2 = (-p +- sqrt(p^2 - 4 r))/2.
    s_bi2 = p * p - 4.0 * r
    s_bi = jnp.sqrt(jnp.maximum(s_bi2, 0.0))
    alpha_bi = (-p + s_bi) / 2.0
    beta_bi = (-p - s_bi) / 2.0
    rt_a = jnp.sqrt(jnp.maximum(alpha_bi, 0.0))
    rt_b = jnp.sqrt(jnp.maximum(beta_bi, 0.0))
    roots_bi = jnp.stack([rt_a, -rt_a, rt_b, -rt_b])
    valid_bi = jnp.stack(
        [
            (s_bi2 >= 0) & (alpha_bi >= 0),
            (s_bi2 >= 0) & (alpha_bi >= 0),
            (s_bi2 >= 0) & (beta_bi >= 0),
            (s_bi2 >= 0) & (beta_bi >= 0),
        ]
    )
    y = jnp.where(biquad, roots_bi, roots_gen)
    valid = jnp.where(biquad, valid_bi, valid_gen)
    x = y - (a / 4.0)

    # Safeguarded Newton polish on the undepressed quartic tightens the
    # closed-form roots (Ferrari in f32 is fragile).  Near a double root
    # f and f' are both noise-dominated and the raw step f/f' can be a
    # huge jump away from an already-correct root, so a step is accepted
    # only if it reduces |f|.
    def _poly(t):
        return (((c4 * t + c3) * t + c2) * t + c1) * t + c0

    f = _poly(x)
    for _ in range(3):
        fp = ((4.0 * c4 * x + 3.0 * c3) * x + 2.0 * c2) * x + c1
        fp = jnp.where(jnp.abs(fp) < tiny, tiny, fp)
        x_new = x - f / fp
        f_new = _poly(x_new)
        better = jnp.abs(f_new) < jnp.abs(f)
        x = jnp.where(better, x_new, x)
        f = jnp.where(better, f_new, f)
    return x, valid


def _poly_mul(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Multiply polynomials given low-to-high coefficient vectors."""
    return jnp.convolve(p1, p2)


def p3p(
    X: jnp.ndarray,    # [3, 3] world points
    pn: jnp.ndarray,   # [3, 2] normalized image coords (pinhole)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Grunert P3P: up to 4 poses.  Returns (R [4,3,3], t [4,3]); invalid
    slots are NaN.

    Derivation (SURVEY §2 epipolar/resection capability): with unit
    bearings f_i and side lengths a=|P2P3|, b=|P1P3|, c=|P1P2|, the depth
    ratios u=s2/s1, v=s3/s1 satisfy two quadrics; eliminating u yields a
    quartic in v built here with exact polynomial arithmetic.
    """
    dtype = X.dtype
    ones = jnp.ones((3, 1), dtype)
    f = jnp.concatenate([pn, ones], axis=-1)
    f = f / jnp.linalg.norm(f, axis=-1, keepdims=True)     # [3, 3] bearings

    a2 = jnp.sum((X[1] - X[2]) ** 2)
    b2 = jnp.sum((X[0] - X[2]) ** 2)
    c2 = jnp.sum((X[0] - X[1]) ** 2)
    ca = jnp.dot(f[1], f[2])   # cos(alpha), opposite side a
    cb = jnp.dot(f[0], f[2])
    cg = jnp.dot(f[0], f[1])

    A = a2 / b2
    Bc = c2 / b2
    # S(v) = 1 - 2 cb v + v^2 ; N(v) = (1 + (A - Bc)) + (-(A - Bc) 2 cb) v
    # + ((A - Bc) - 1) v^2 ; D(v) = 2 cg - 2 ca v ; substituting u = N/D
    # into 1 + u^2 - 2 u cg = Bc S gives the quartic
    # N^2 - 2 cg N D + D^2 - Bc S D^2 = 0.
    S = jnp.stack([jnp.ones_like(cb), -2.0 * cb, jnp.ones_like(cb)])
    AB = A - Bc
    N = jnp.stack([1.0 + AB, -2.0 * cb * AB, AB - 1.0])
    D = jnp.stack([2.0 * cg, -2.0 * ca])
    NN = _poly_mul(N, N)                       # degree 4 (5 coeffs)
    ND = _poly_mul(N, D)                       # degree 3
    DD = _poly_mul(D, D)                       # degree 2
    SDD = _poly_mul(S, DD)                     # degree 4
    quartic = NN - Bc * SDD
    quartic = quartic.at[:4].add(-2.0 * cg * ND)
    quartic = quartic.at[:3].add(DD)
    # solve_quartic expects high-to-low.
    roots, real = solve_quartic(quartic[::-1])

    v = roots.astype(dtype)
    valid = jnp.logical_and(real, v > 1e-6)

    def pose_from_v(vk, ok):
        Nv = N[0] + N[1] * vk + N[2] * vk * vk
        Dv = D[0] + D[1] * vk
        u = Nv / jnp.where(jnp.abs(Dv) < 1e-12, 1e-12, Dv)
        s1sq = b2 / jnp.maximum(1.0 - 2.0 * cb * vk + vk * vk, 1e-12)
        s1 = jnp.sqrt(s1sq)
        s2 = u * s1
        s3 = vk * s1
        ok = jnp.logical_and(ok, jnp.logical_and(s2 > 0, s3 > 0))
        Q = jnp.stack([s1, s2, s3])[:, None] * f                # camera pts
        # Absolute orientation from 3 correspondences (Horn / Procrustes).
        mx = jnp.mean(X, axis=0)
        mq = jnp.mean(Q, axis=0)
        H = xp.matmul((Q - mq).T, (X - mx))
        U, _, Vt = jnp.linalg.svd(H)
        dets = jnp.linalg.det(xp.matmul(U, Vt))
        fix = jnp.ones(3, dtype).at[2].set(dets)
        R = xp.matmul(U * fix[None, :], Vt)
        t = mq - xp.matvec(R, mx)
        nan = jnp.asarray(jnp.nan, dtype)
        return (
            jnp.where(ok, R, nan),
            jnp.where(ok, t, nan),
        )

    Rs, ts = jax.vmap(pose_from_v)(v, valid)
    return Rs, ts


def p3p_ransac(
    key: jax.Array,
    X: jnp.ndarray,     # [N, 3]
    pn: jnp.ndarray,    # [N, 2]
    *,
    n_hypotheses: int = 256,
    threshold: float = 1e-4,
    data_weights: jnp.ndarray | None = None,
    refine_iters: int = 8,
):
    """RANSAC resection with the P3P minimal solver (4 models/sample scored
    in parallel), followed by GN refinement on the inliers.

    Returns (R, t, inliers).
    """
    from pysfm_tpu.frontend.pnp import refine_pose

    n = X.shape[0]
    if data_weights is None:
        data_weights = jnp.ones((n,), X.dtype)
    keys = jax.random.split(key, n_hypotheses)

    def one(kh):
        idx = jax.random.choice(
            kh, n, shape=(3,), replace=False,
            p=data_weights / jnp.sum(data_weights),
        )
        Rs, ts = p3p(X[idx], pn[idx])           # [4, 3, 3], [4, 3]

        def score(R, t):
            p = jnp.einsum("ij,nj->ni", R, X, precision=xp.HIGHEST) + t
            pn_hat = p[:, :2] / p[:, 2:3]
            d = jnp.sum((pn_hat - pn) ** 2, axis=-1)
            d = jnp.where(p[:, 2] <= 0, jnp.asarray(1e10, d.dtype), d)
            finite = jnp.all(jnp.isfinite(R))
            inl = jnp.logical_and(d < threshold, data_weights > 0)
            return jnp.where(finite, jnp.sum(inl), -1), inl

        counts, inls = jax.vmap(score)(Rs, ts)
        k = jnp.argmax(counts)
        return Rs[k], ts[k], counts[k], inls[k]

    Rs, ts, counts, inls = jax.vmap(one)(keys)
    best = jnp.argmax(counts)
    R0 = jnp.nan_to_num(Rs[best], nan=0.0)
    t0 = jnp.nan_to_num(ts[best], nan=0.0)
    inliers = inls[best]
    w_in = inliers.astype(X.dtype) * data_weights
    R, t = refine_pose(R0, t0, X, pn, w_in, iters=refine_iters)
    # Re-evaluate inliers under the refined pose.
    p = jnp.einsum("ij,nj->ni", R, X, precision=xp.HIGHEST) + t
    d = jnp.sum((p[:, :2] / p[:, 2:3] - pn) ** 2, axis=-1)
    d = jnp.where(p[:, 2] <= 0, jnp.asarray(1e10, d.dtype), d)
    inliers = jnp.logical_and(d < threshold, data_weights > 0)
    return R, t, inliers
