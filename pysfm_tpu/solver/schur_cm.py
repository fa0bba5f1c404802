"""Component-major normal equations + Schur reduction (the dense solver's
default layout).

The standard path's per-observation block arrays (``J_cam [M,2,CP]``,
``B [M,CP,3]``, ``W/V [P,C*CP,3]``) interleave tiny component dimensions
with the observation axis.  Here every per-observation quantity is a
**component-major row** — a ``[D, M]`` array with observations on the
minor axis — so all elementwise math reads and writes contiguous rows, and
the only big contractions are clean 2-D matmuls:

- camera-side reduction: ``[D, M] @ [M, C]`` one-hot matmul,
- point-side reduction: per-component 1-D gathers via the padded ``pt_obs``
  table + a K-axis sum,
- Schur outer product: ``S = Vr^T Vr`` with ``Vr [3P, C*CP]``.

The math is identical to :mod:`pysfm_tpu.solver.schur` (whitened
elimination: damped ``Hpp = L L^T``, ``M = L^{-1}``, ``V = W M^T``,
``S = blockdiag(Hcc_aug) - V V^T``); equality is tested in f64 against the
standard path and the explicit full-H solve.

Layout conventions:

- ``Jct [2*CP, M]``: row ``i*CP + d`` is d(residual_i)/d(cam tangent d).
- ``Jpt [6, M]``: row ``i*3 + s``.
- ``B rows [3*CP, M]`` (s-major): row ``s*CP + d`` = coupling block (d, s).
- ``hpp6 / m6 [6, P]``: lower-triangular components (00, 10, 11, 20, 21, 22).
- ``Vr [(p*3+s), (d*C+c)]``: note the **(d, c) column permutation** — it is
  the natural output order of the batched assembly einsum; the reduced
  system is permuted back to the standard (c, d) order just before the
  (tiny) dense solve.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pysfm_tpu.utils import precision as xp

# Lower-triangular 3x3 component order used throughout.
_TRI = ((0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2))


class NormalEqsCM(NamedTuple):
    Hcc: jnp.ndarray    # [C, CP, CP] (dense, symmetric)
    g_c: jnp.ndarray    # [C, CP]
    hpp6: jnp.ndarray   # [6, P] lower-tri point blocks
    g_p: jnp.ndarray    # [3, P]
    Bg: jnp.ndarray     # [P, K, 3*CP] s-major coupling blocks, point grid


def build_normal_equations_cm(
    rt: jnp.ndarray,      # [2, M]
    Jct: jnp.ndarray,     # [2*CP, M]
    Jpt: jnp.ndarray,     # [6, M]
    wt: jnp.ndarray,      # [M]
    obs_cam: jnp.ndarray,
    pt_obs: jnp.ndarray,      # [P, K]
    pt_obs_mask: jnp.ndarray,  # [P, K]
    n_cameras: int,
) -> NormalEqsCM:
    """J^T W J and J^T W r blockwise, all in component-major layout."""
    cp = Jct.shape[0] // 2
    C = n_cameras
    w = wt[None, :]
    wr0 = rt[0:1] * w
    wr1 = rt[1:2] * w

    # Camera-side rows -> one [rows, M] @ [M, C] matmul.
    # rows: g_c (CP), Hcc lower triangle (CP*(CP+1)/2).
    rows = []
    for d in range(cp):
        rows.append(Jct[d : d + 1] * wr0 + Jct[cp + d : cp + d + 1] * wr1)
    tri_c = [(d, e) for d in range(cp) for e in range(d + 1)]
    for d, e in tri_c:
        rows.append(
            (Jct[d : d + 1] * Jct[e : e + 1]
             + Jct[cp + d : cp + d + 1] * Jct[cp + e : cp + e + 1]) * w
        )
    cam_rows = jnp.concatenate(rows, axis=0)                   # [R, M]
    onehot = (
        obs_cam[:, None] == jnp.arange(C, dtype=obs_cam.dtype)
    ).astype(Jct.dtype)                                        # [M, C]
    red = xp.einsum("rm,mc->rc", cam_rows, onehot)             # [R, C]
    g_c = red[:cp].T                                           # [C, CP]
    Hcc = jnp.zeros((C, cp, cp), Jct.dtype)
    for i, (d, e) in enumerate(tri_c):
        blk = red[cp + i]                                      # [C]
        Hcc = Hcc.at[:, d, e].set(blk)
        if d != e:
            Hcc = Hcc.at[:, e, d].set(blk)

    # Point-side rows + coupling blocks -> ONE batched grid gather through
    # the pt_obs table instead of one per row; it leaves the coupling
    # blocks resident in the point grid where the Schur assembly needs
    # them.
    maskf = pt_obs_mask.astype(Jct.dtype)                      # [P, K]
    prows = [
        (Jpt[a : a + 1] * Jpt[b : b + 1]
         + Jpt[3 + a : 4 + a] * Jpt[3 + b : 4 + b]) * w
        for a, b in _TRI
    ] + [
        Jpt[s : s + 1] * wr0 + Jpt[3 + s : 4 + s] * wr1
        for s in range(3)
    ] + [
        # Coupling rows, s-major: B[s*CP+d] = sum_i Jc[i,d] w Jp[i,s].
        Jct[:cp] * (Jpt[s : s + 1] * w) + Jct[cp:] * (Jpt[3 + s : 4 + s] * w)
        for s in range(3)
    ]
    stacked = jnp.concatenate(prows, axis=0).T                 # [M, 9+3CP]
    grid = stacked[pt_obs] * maskf[..., None]                  # [P, K, 9+3CP]
    red_p = jnp.sum(grid[..., :9], axis=1).T                   # [9, P]
    hpp6 = red_p[:6]
    g_p = red_p[6:]
    Bg = grid[..., 9:]                                         # [P, K, 3CP]
    return NormalEqsCM(Hcc=Hcc, g_c=g_c, hpp6=hpp6, g_p=g_p, Bg=Bg)


def _augment6(hpp6: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """LM damping of the lower-tri point blocks, with unit fill on zero
    diagonals (padding / unobserved points) — matches
    schur.augment_block_diag."""
    d00, d11, d22 = hpp6[0], hpp6[2], hpp6[5]

    def aug(d):
        return d + lam * d + jnp.where(d == 0, jnp.ones_like(d), 0.0)

    return jnp.stack([aug(d00), hpp6[1], aug(d11), hpp6[3], hpp6[4], aug(d22)])


def _chol6(h6: jnp.ndarray) -> jnp.ndarray:
    """Closed-form Cholesky of SPD 3x3 blocks in 6-component form."""
    a00, a10, a11, a20, a21, a22 = h6
    l00 = jnp.sqrt(a00)
    l10 = a10 / l00
    l20 = a20 / l00
    l11 = jnp.sqrt(a11 - l10 * l10)
    l21 = (a21 - l20 * l10) / l11
    l22 = jnp.sqrt(a22 - l20 * l20 - l21 * l21)
    return jnp.stack([l00, l10, l11, l20, l21, l22])


def _inv_lower6(l6: jnp.ndarray) -> jnp.ndarray:
    l00, l10, l11, l20, l21, l22 = l6
    m00 = 1.0 / l00
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m10 = -l10 * m00 * m11
    m21 = -l21 * m11 * m22
    m20 = -(l20 * m00 + l21 * m10) * m22
    return jnp.stack([m00, m10, m11, m20, m21, m22])


class SchurSystemCM(NamedTuple):
    S: jnp.ndarray     # [A, A] standard (c*CP+d) order, damped
    rhs: jnp.ndarray   # [A]
    m6: jnp.ndarray    # [6, P]
    Vr: jnp.ndarray    # [3P, CP*C]  rows (p*3+s), cols (d*C+c)
    u: jnp.ndarray     # [3, P] whitened point gradient


def reduce_cm(
    eqs: NormalEqsCM,
    lam: jnp.ndarray,
    obs_pt: jnp.ndarray,
    pt_obs: jnp.ndarray,
    pt_obs_mask: jnp.ndarray,
    obs_cam: jnp.ndarray,
    axis_name: str | None = None,
) -> SchurSystemCM:
    """Whitened Schur reduction in component-major layout.

    Under ``axis_name`` (inside shard_map) the camera-sized Hcc/g_c/S/rhs
    partials are psum'd; point rows stay chip-local (SURVEY §2
    "Point-sharded Schur elimination").
    """
    from pysfm_tpu.solver import schur

    C, cp, _ = eqs.Hcc.shape
    P = eqs.hpp6.shape[1]
    Hcc, g_c = eqs.Hcc, eqs.g_c
    if axis_name is not None:
        Hcc = jax.lax.psum(Hcc, axis_name)
        g_c = jax.lax.psum(g_c, axis_name)
    Hcc_aug = schur.augment_block_diag(Hcc, lam)

    m6 = _inv_lower6(_chol6(_augment6(eqs.hpp6, lam)))          # [6, P]
    # Whiten the grid-resident coupling blocks: E_s = sum_{s'} B_{s'} M[s,s'],
    # with the per-point M components broadcast over the K track slots.
    B0 = eqs.Bg[..., :cp]                                       # [P, K, CP]
    B1 = eqs.Bg[..., cp : 2 * cp]
    B2 = eqs.Bg[..., 2 * cp :]

    def mrow(i):
        return m6[i][:, None, None]

    Eg = jnp.concatenate(
        [
            B0 * mrow(0),
            B0 * mrow(1) + B1 * mrow(2),
            B0 * mrow(3) + B1 * mrow(4) + B2 * mrow(5),
        ],
        axis=-1,
    )                                                           # [P, K, 3CP]
    camg = obs_cam[pt_obs]
    # No mask on the one-hot: padded slots carry Eg == 0 (Bg was masked in
    # the build), so whatever camera they one-hot into contributes zero.
    OH = (
        camg[..., None] == jnp.arange(C, dtype=camg.dtype)
    ).astype(m6.dtype)                                          # [P, K, C]
    # One batched contraction over the track axis; the s-major e index
    # makes [P, 3CP, C] -> [(p*3+s), (d*C+c)] a pure reshape (no transpose).
    Vr = xp.einsum("pke,pkc->pec", Eg, OH).reshape(3 * P, cp * C)

    # Whitened point gradient u = M g_p.
    g0, g1, g2 = eqs.g_p[0], eqs.g_p[1], eqs.g_p[2]
    u = jnp.stack([
        m6[0] * g0,
        m6[1] * g0 + m6[2] * g1,
        m6[3] * g0 + m6[4] * g1 + m6[5] * g2,
    ])                                                          # [3, P]
    ur = u.T.reshape(3 * P)                                     # rows (p*3+s)

    S_perm = -xp.einsum("na,nb->ab", Vr, Vr)                    # [(d,c),(d',c')]
    rhs_perm = xp.einsum("na,n->a", Vr, ur)
    if axis_name is not None:
        S_perm = jax.lax.psum(S_perm, axis_name)
        rhs_perm = jax.lax.psum(rhs_perm, axis_name)
    # Permute (d, c) -> (c, d) standard order.
    S = (
        S_perm.reshape(cp, C, cp, C)
        .transpose(1, 0, 3, 2)
        .reshape(C * cp, C * cp)
    )
    rhs_red = rhs_perm.reshape(cp, C).T.reshape(-1)
    eye_c = jnp.eye(C, dtype=S.dtype)
    S = (
        S.reshape(C, cp, C, cp)
        + Hcc_aug[:, :, None, :] * eye_c[:, None, :, None]
    ).reshape(C * cp, C * cp)
    rhs = -g_c.reshape(-1) + rhs_red
    return SchurSystemCM(S=S, rhs=rhs, m6=m6, Vr=Vr, u=u)


def back_substitute_cm(system: SchurSystemCM, dc: jnp.ndarray) -> jnp.ndarray:
    """dp = -M^T (u + V^T dc); returns [3, P] component-major."""
    # dc arrives [C, CP] standard; permute to the Vr column order (d, c).
    dc_perm = dc.T.reshape(-1)                                  # [(d,c)]
    Vt = xp.matmul(system.Vr, dc_perm).reshape(-1, 3).T        # [3, P]
    x0 = system.u[0] + Vt[0]
    x1 = system.u[1] + Vt[1]
    x2 = system.u[2] + Vt[2]
    m = system.m6
    return -jnp.stack([
        m[0] * x0 + m[1] * x1 + m[3] * x2,
        m[2] * x1 + m[4] * x2,
        m[5] * x2,
    ])


def solve_step_cm(
    eqs: NormalEqsCM,
    lam: jnp.ndarray,
    obs_cam: jnp.ndarray,
    obs_pt: jnp.ndarray,
    pt_obs: jnp.ndarray,
    pt_obs_mask: jnp.ndarray,
    axis_name: str | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One damped GN step: returns (dc [C, CP], dp [P, 3])."""
    from pysfm_tpu.solver import schur

    C, cp, _ = eqs.Hcc.shape
    system = reduce_cm(
        eqs, lam, obs_pt, pt_obs, pt_obs_mask, obs_cam, axis_name
    )
    Ssym = 0.5 * (system.S + system.S.T)
    L, lower = jax.scipy.linalg.cho_factor(Ssym, lower=True)
    dc = jax.scipy.linalg.cho_solve((L, lower), system.rhs).reshape(C, cp)
    dp = back_substitute_cm(system, dc)
    return dc, dp.T


def predicted_reduction_cm(
    eqs: NormalEqsCM,
    lam: jnp.ndarray,
    dc: jnp.ndarray,
    dp: jnp.ndarray,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """Same LM model-reduction formula as schur.predicted_reduction."""
    Hcc, g_c = eqs.Hcc, eqs.g_c
    if axis_name is not None:
        Hcc = jax.lax.psum(Hcc, axis_name)
        g_c = jax.lax.psum(g_c, axis_name)
    d_cc = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
    d_pp = jnp.stack([eqs.hpp6[0], eqs.hpp6[2], eqs.hpp6[5]], axis=-1)  # [P,3]
    fill_c = jnp.where(d_cc == 0, 1.0, 0.0)
    fill_p = jnp.where(d_pp == 0, 1.0, 0.0)
    g_pT = eqs.g_p.T
    cam_term = jnp.sum((lam * d_cc + fill_c) * dc * dc) - jnp.sum(dc * g_c)
    pt_term = jnp.sum((lam * d_pp + fill_p) * dp * dp) - jnp.sum(dp * g_pT)
    if axis_name is not None:
        pt_term = jax.lax.psum(pt_term, axis_name)
    return 0.5 * (cam_term + pt_term)


def grad_inf_cm(eqs: NormalEqsCM, axis_name: str | None = None) -> jnp.ndarray:
    g_c = eqs.g_c
    if axis_name is not None:
        g_c = jax.lax.psum(g_c, axis_name)
    gi = jnp.maximum(jnp.max(jnp.abs(g_c)), jnp.max(jnp.abs(eqs.g_p)))
    if axis_name is not None:
        gi = jax.lax.pmax(gi, axis_name)
    return gi
