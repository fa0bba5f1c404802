"""SO(3) — rotation group operations, batched and differentiable.

Batched replacement for the reference's Rodrigues/axis-angle helpers
(SURVEY §2 "Rotation / Lie algebra": SO(3) exp/log, small-angle safe, used
for minimal 3-param rotation updates ``R <- exp([w]x) @ R``).

All functions broadcast over leading batch dimensions and are safe to
differentiate at the small-angle limit (the usual ``where``-inside-``where``
guard so no NaN flows through the unused branch).
"""

from __future__ import annotations

import jax.numpy as jnp

from pysfm_tpu.utils import precision as xp

# Below this squared angle we switch to Taylor expansions of the Rodrigues
# coefficients.  Generous threshold: the 4th-order Taylor terms are < 1e-12
# relative error at theta^2 = 1e-6 in f64 and below f32 resolution anyway.
_SMALL_SQ = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric (cross-product) matrix of w: hat(w) @ v == cross(w, v).

    w: [..., 3] -> [..., 3, 3].  (Reference analog: ``skew()``, SURVEY §2.)
    """
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    rows = [
        jnp.stack([zero, -wz, wy], axis=-1),
        jnp.stack([wz, zero, -wx], axis=-1),
        jnp.stack([-wy, wx, zero], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`hat`: [..., 3, 3] -> [..., 3]."""
    return jnp.stack(
        [W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1
    )


def _exp_coefs(theta_sq: jnp.ndarray):
    """Rodrigues coefficients A = sin(t)/t, B = (1-cos(t))/t^2, small-angle safe."""
    small = theta_sq < _SMALL_SQ
    # Guarded theta so sqrt/ division never see 0 in the branch we discard.
    safe_sq = jnp.where(small, jnp.ones_like(theta_sq), theta_sq)
    theta = jnp.sqrt(safe_sq)
    a_exact = jnp.sin(theta) / theta
    b_exact = (1.0 - jnp.cos(theta)) / safe_sq
    a_taylor = 1.0 - theta_sq / 6.0 * (1.0 - theta_sq / 20.0)
    b_taylor = 0.5 - theta_sq / 24.0 * (1.0 - theta_sq / 30.0)
    return jnp.where(small, a_taylor, a_exact), jnp.where(small, b_taylor, b_exact)


def exp(w: jnp.ndarray) -> jnp.ndarray:
    """SO(3) exponential map (Rodrigues): [..., 3] -> [..., 3, 3]."""
    theta_sq = jnp.sum(w * w, axis=-1)
    a, b = _exp_coefs(theta_sq)
    W = hat(w)
    WW = xp.matmul(W, W)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a[..., None, None] * W + b[..., None, None] * WW


def to_quaternion(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion [w, x, y, z], Shepperd's method.

    Branch-free (computes all four candidates and selects the best-
    conditioned one), numerically stable at every angle including pi.
    [..., 3, 3] -> [..., 4].
    """
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    t0 = 1.0 + r00 + r11 + r22
    t1 = 1.0 + r00 - r11 - r22
    t2 = 1.0 - r00 + r11 - r22
    t3 = 1.0 - r00 - r11 + r22
    q0 = jnp.stack([t0, r21 - r12, r02 - r20, r10 - r01], axis=-1)
    q1 = jnp.stack([r21 - r12, t1, r01 + r10, r02 + r20], axis=-1)
    q2 = jnp.stack([r02 - r20, r01 + r10, t2, r12 + r21], axis=-1)
    q3 = jnp.stack([r10 - r01, r02 + r20, r12 + r21, t3], axis=-1)

    ts = jnp.stack([t0, t1, t2, t3], axis=-1)
    k = jnp.argmax(ts, axis=-1)
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)          # [..., 4 cases, 4]
    q = jnp.take_along_axis(qs, k[..., None, None], axis=-2)[..., 0, :]
    tk = jnp.take_along_axis(ts, k[..., None], axis=-1)
    q = q / (2.0 * jnp.sqrt(jnp.maximum(tk, 1e-30)))
    # Canonical hemisphere: w >= 0 so theta = 2*atan2(|v|, w) lies in [0, pi].
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def from_quaternion(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion [w, x, y, z] -> rotation matrix. [..., 4] -> [..., 3, 3]."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        jnp.stack(
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            axis=-1,
        ),
        jnp.stack(
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            axis=-1,
        ),
        jnp.stack(
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            axis=-1,
        ),
    ]
    return jnp.stack(rows, axis=-2)


def log(R: jnp.ndarray) -> jnp.ndarray:
    """SO(3) logarithm: [..., 3, 3] -> [..., 3] axis-angle vector.

    Goes through the quaternion (:func:`to_quaternion`) so the result is
    accurate at every angle — the naive arccos/antisymmetric-part formula
    degrades near both 0 and pi.
    """
    q = to_quaternion(R)
    w, v = q[..., 0], q[..., 1:]
    n = jnp.linalg.norm(v, axis=-1)
    theta = 2.0 * jnp.arctan2(n, w)
    small = n < 1e-9
    safe_n = jnp.where(small, jnp.ones_like(n), n)
    # theta/n -> 2/w as n -> 0 (w -> 1 on the canonical hemisphere).
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-12), theta / safe_n)
    return scale[..., None] * v


def normalize(R: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize a near-rotation matrix via symmetric polar projection.

    Used to fight f32 drift after many multiplicative updates
    ``R <- exp(dw) @ R`` inside the LM loop.
    """
    u, _, vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(xp.matmul(u, vt))
    # Flip the last singular direction if the product would be a reflection.
    fix = jnp.concatenate(
        [jnp.ones_like(R[..., :2, 0]), det[..., None]], axis=-1
    )
    return xp.matmul(u * fix[..., None, :], vt)
