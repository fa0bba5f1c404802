"""Block normal equations + Schur-complement reduction, batched.

Reference analog (SURVEY §2 "Bundle adjuster (LM + Schur)", §3.1): build
block-sparse normal equations (per-camera blocks Hcc, per-point 3x3 blocks
Hpp, coupling blocks Hcp over the visibility graph), damp the block
diagonals, eliminate points via the Schur complement
``S = Hcc - Hcp Hpp^-1 Hcp^T``, solve the reduced camera system, and
back-substitute the point updates.

Design (SURVEY §3.1, §7):

- Per-observation blocks are built in one batched expression and reduced
  with ``segment_sum`` — no Python loops over measurements.
- Hpp inversion is a closed-form batched 3x3 adjugate (no LAPACK calls).
- The reduced camera matrix S is assembled with a single dense matmul over
  a scattered ``[P, C*CP, 3]`` operand ("dense-W" regime) for
  small/medium camera counts, or matrix-free via PCG for large ones
  (:mod:`pysfm_tpu.solver.pcg`).
- Zero diagonal blocks (gauge-fixed cameras, padding points) are filled
  with identity so every factorization exists; their gradients are zero so
  the corresponding steps are exactly zero.

Sign conventions: ``g = J^T W r`` and the Newton system is
``[Hcc Hcp; Hcp^T Hpp] [dc; dp] = -[gc; gp]``, so the returned
``(dc, dp)`` are the steps to *add* to the parameters.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pysfm_tpu.utils import precision as xp


class NormalEqs(NamedTuple):
    """Undamped block normal equations + per-observation coupling blocks."""

    Hcc: jnp.ndarray   # [C, CP, CP]
    Hpp: jnp.ndarray   # [P, 3, 3]
    g_c: jnp.ndarray   # [C, CP]
    g_p: jnp.ndarray   # [P, 3]
    B: jnp.ndarray     # [M, CP, 3]  per-obs Jc^T W Jp (Hcp blocks)


def build_normal_equations(
    r: jnp.ndarray,
    J_cam: jnp.ndarray,
    J_pt: jnp.ndarray,
    w: jnp.ndarray,
    obs_cam: jnp.ndarray,
    obs_pt: jnp.ndarray,
    n_cameras: int,
    n_points: int,
    pt_obs: jnp.ndarray | None = None,
    pt_obs_mask: jnp.ndarray | None = None,
) -> NormalEqs:
    """Accumulate J^T W J and J^T W r blockwise (SURVEY §3.1 HOT loop 3).

    Two regimes:

    - With the padded per-point/per-camera observation tables: each block
      sum is a gather of the relevant J rows followed by one batched
      contraction — no scatter, no materialized per-observation [CP, CP]
      blocks.
    - Without tables (e.g. chip-local shards that don't carry them):
      ``segment_sum`` fallback, identical results.
    """
    wJc = J_cam * w[:, None, None]
    wJp = J_pt * w[:, None, None]
    wr = r * w[:, None]
    b_m = xp.einsum("mic,mip->mcp", J_cam, wJp)

    if pt_obs is not None:
        # Camera side: C is small, so the segmented reduction is ONE dense
        # [C, M] x [M, D] matmul against a one-hot selector — no scatter
        # (segment_sum) and no tiny-row gather.
        M = J_cam.shape[0]
        onehot = (
            obs_cam[:, None] == jnp.arange(n_cameras, dtype=obs_cam.dtype)
        ).astype(J_cam.dtype)                       # [M, C]
        hcc_m = xp.einsum("mic,mid->mcd", J_cam, wJc).reshape(M, -1)
        gc_m = xp.einsum("mic,mi->mc", J_cam, wr)
        Hcc = xp.einsum("mc,md->cd", onehot, hcc_m).reshape(
            n_cameras, J_cam.shape[2], J_cam.shape[2]
        )
        g_c = xp.einsum("mc,md->cd", onehot, gc_m)

        # Point side: P is large but tracks are short — gather the point's
        # K observations via the padded table and contract.
        pmask = pt_obs_mask.astype(J_pt.dtype)
        Jp_g = J_pt[pt_obs]                         # [P, K, 2, 3]
        wJp_g = wJp[pt_obs] * pmask[..., None, None]
        wr_pg = wr[pt_obs] * pmask[..., None]
        Hpp = xp.einsum("fkia,fkib->fab", Jp_g, wJp_g)
        g_p = xp.einsum("fkia,fki->fa", Jp_g, wr_pg)
    else:
        hcc_m = xp.einsum("mic,mid->mcd", J_cam, wJc)
        hpp_m = xp.einsum("mip,miq->mpq", J_pt, wJp)
        gc_m = xp.einsum("mic,mi->mc", J_cam, wr)
        gp_m = xp.einsum("mip,mi->mp", J_pt, wr)
        Hcc = jax.ops.segment_sum(hcc_m, obs_cam, num_segments=n_cameras)
        Hpp = jax.ops.segment_sum(hpp_m, obs_pt, num_segments=n_points)
        g_c = jax.ops.segment_sum(gc_m, obs_cam, num_segments=n_cameras)
        g_p = jax.ops.segment_sum(gp_m, obs_pt, num_segments=n_points)
    return NormalEqs(Hcc=Hcc, Hpp=Hpp, g_c=g_c, g_p=g_p, B=b_m)


def augment_block_diag(H: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """LM damping: H + lam * diag(H), with unit fill on exactly-zero diagonal
    entries (gauge-fixed cameras / unobserved or padding points) so the block
    stays invertible; those blocks have zero gradient, hence zero step."""
    d = jnp.diagonal(H, axis1=-2, axis2=-1)
    fill = jnp.where(d == 0, jnp.ones_like(d), jnp.zeros_like(d))
    aug = lam * d + fill
    # Diagonal embed via an eye mask (no scatter).
    eye = jnp.eye(H.shape[-1], dtype=H.dtype)
    return H + aug[..., :, None] * eye


def inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse via the adjugate (no LAPACK)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / det
    adj = jnp.stack(
        [
            jnp.stack([A00, A01, A02], axis=-1),
            jnp.stack([A10, A11, A12], axis=-1),
            jnp.stack([A20, A21, A22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def chol3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form Cholesky of SPD 3x3 blocks: A = L L^T, L lower.

    Elementwise — no LAPACK call, no tiny batched matmuls."""
    a00, a10, a20 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a11, a21, a22 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l00 = jnp.sqrt(a00)
    l10 = a10 / l00
    l20 = a20 / l00
    l11 = jnp.sqrt(a11 - l10 * l10)
    l21 = (a21 - l20 * l10) / l11
    l22 = jnp.sqrt(a22 - l20 * l20 - l21 * l21)
    zero = jnp.zeros_like(l00)
    return jnp.stack(
        [
            jnp.stack([l00, zero, zero], axis=-1),
            jnp.stack([l10, l11, zero], axis=-1),
            jnp.stack([l20, l21, l22], axis=-1),
        ],
        axis=-2,
    )


def inv_lower3x3(L: jnp.ndarray) -> jnp.ndarray:
    """Batched inverse of lower-triangular 3x3 blocks (elementwise)."""
    l00, l10, l20 = L[..., 0, 0], L[..., 1, 0], L[..., 2, 0]
    l11, l21, l22 = L[..., 1, 1], L[..., 2, 1], L[..., 2, 2]
    m00 = 1.0 / l00
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m10 = -l10 * m00 * m11
    m21 = -l21 * m11 * m22
    m20 = -(l20 * m00 + l21 * m10) * m22
    zero = jnp.zeros_like(m00)
    return jnp.stack(
        [
            jnp.stack([m00, zero, zero], axis=-1),
            jnp.stack([m10, m11, zero], axis=-1),
            jnp.stack([m20, m21, m22], axis=-1),
        ],
        axis=-2,
    )


def scatter_coupling_dense(
    B: jnp.ndarray, obs_cam: jnp.ndarray, obs_pt: jnp.ndarray,
    n_cameras: int, n_points: int,
    pt_obs: jnp.ndarray | None = None,
    pt_obs_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Assemble the dense per-point coupling operand W [P, C*CP, 3].

    W[p] is the p-th block-column of Hcp.  Memory is P*C*CP*3 — the
    "dense-W" regime is for small/medium C (the two-view / windowed /
    50-camera configs); large problems use the matrix-free path.

    With the padded per-point table (``pt_obs``/``pt_obs_mask``) the
    assembly is a batched one-hot matmul instead of a scatter-add.  The
    scatter fallback remains for callers without the table.
    """
    M, CP, _ = B.shape
    if pt_obs is None:
        W = jnp.zeros((n_points, n_cameras, CP, 3), dtype=B.dtype)
        W = W.at[obs_pt, obs_cam].add(B)
        return W.reshape(n_points, n_cameras * CP, 3)
    maskf = pt_obs_mask.astype(B.dtype)
    Bg = B[pt_obs] * maskf[..., None, None]              # [P, K, CP, 3]
    camg = obs_cam[pt_obs]                               # [P, K]
    onehot = (
        camg[..., None] == jnp.arange(n_cameras, dtype=camg.dtype)
    ).astype(B.dtype) * maskf[..., None]                 # [P, K, C]
    # Contract over the track axis k: per point a [C, K] x [K, CP*3] matmul.
    W = xp.einsum("pkc,pkds->pcds", onehot, Bg)         # [P, C, CP, 3]
    return W.reshape(n_points, n_cameras * CP, 3)


class SchurSystem(NamedTuple):
    S: jnp.ndarray      # [C*CP, C*CP] reduced camera matrix (damped)
    rhs: jnp.ndarray    # [C*CP]
    M: jnp.ndarray      # [P, 3, 3] inverse point-Cholesky: Hpp_inv = M^T M
    V: jnp.ndarray      # [P, C*CP, 3] whitened coupling V_p = W_p M_p^T
    u: jnp.ndarray      # [P, 3] whitened point gradient u_p = M_p g_p


def reduce_dense(
    eqs: NormalEqs,
    lam: jnp.ndarray,
    obs_cam: jnp.ndarray,
    obs_pt: jnp.ndarray,
    axis_name: str | None = None,
    pt_obs: jnp.ndarray | None = None,
    pt_obs_mask: jnp.ndarray | None = None,
) -> SchurSystem:
    """Schur reduction, dense-W regime (SURVEY §3.1 HOT loop: per-point
    3x3 inverse + outer products -> here one big matmul).

    With ``axis_name`` set (inside ``shard_map``), points and their
    observations are chip-local shards while cameras are replicated: the
    camera-sized quantities (Hcc, g_c, the partial reduced system S and its
    rhs) are ``psum``'d across the mesh while point-sized state never moves —
    SURVEY §2 "Point-sharded Schur elimination" / §5 long-context analog.
    """
    C, CP, _ = eqs.Hcc.shape
    P = eqs.Hpp.shape[0]
    Hcc = eqs.Hcc
    g_c = eqs.g_c
    if axis_name is not None:
        Hcc = jax.lax.psum(Hcc, axis_name)
        g_c = jax.lax.psum(g_c, axis_name)
    Hcc_aug = augment_block_diag(Hcc, lam)
    Hpp_aug = augment_block_diag(eqs.Hpp, lam)

    # Whitened formulation: factor Hpp_aug = L L^T (closed form), M = L^-1,
    # so Hpp_inv = M^T M.  Whiten per-observation coupling blocks
    # E_m = B_m M_{p(m)}^T *before* the scatter; then
    #   S_outer = sum_p W_p Hpp_inv W_p^T = sum_p V_p V_p^T,  V = scatter(E).
    # This removes the [P, C*CP, 3] x [P, 3, 3] "Y" batched matmul (inner
    # dimension 3) entirely and halves the dense-operand memory traffic.
    M3 = inv_lower3x3(chol3x3(Hpp_aug))                          # [P, 3, 3]
    # E = B @ M^T elementwise over observations (M gathered per obs as its
    # 6 lower-tri components — no [M, 3, 3] gather).
    m00 = M3[..., 0, 0][obs_pt][:, None]
    m10 = M3[..., 1, 0][obs_pt][:, None]
    m11 = M3[..., 1, 1][obs_pt][:, None]
    m20 = M3[..., 2, 0][obs_pt][:, None]
    m21 = M3[..., 2, 1][obs_pt][:, None]
    m22 = M3[..., 2, 2][obs_pt][:, None]
    B0, B1, B2 = eqs.B[..., 0], eqs.B[..., 1], eqs.B[..., 2]    # [M, CP]
    # E[., t] = sum_s B[., s] * M[t, s]  (M lower-triangular).
    E = jnp.stack(
        [
            B0 * m00,
            B0 * m10 + B1 * m11,
            B0 * m20 + B1 * m21 + B2 * m22,
        ],
        axis=-1,
    )                                                            # [M, CP, 3]
    V = scatter_coupling_dense(
        E, obs_cam, obs_pt, C, P, pt_obs, pt_obs_mask
    )                                                            # [P, CCP, 3]
    u = xp.matvec(M3, eqs.g_p)                                   # [P, 3]
    # S = blockdiag(Hcc_aug) - sum_p V_p V_p^T : one [CCP, 3P] x [3P, CCP]
    # contraction.  The -VV^T part is a per-device partial; one psum of
    # the camera-sized S combines devices (the single collective per Schur
    # reduction, SURVEY §2 "Camera-replicated reduced solve").
    S = -xp.einsum("pas,pbs->ab", V, V)
    rhs_red = xp.einsum("pas,ps->a", V, u)
    if axis_name is not None:
        S = jax.lax.psum(S, axis_name)
        rhs_red = jax.lax.psum(rhs_red, axis_name)
    # Add the block-diagonal Hcc without a scatter: view S as [C, CP, C, CP]
    # and mask with a camera-identity.
    eye_c = jnp.eye(C, dtype=S.dtype)
    S = (
        S.reshape(C, CP, C, CP)
        + Hcc_aug[:, :, None, :] * eye_c[:, None, :, None]
    ).reshape(C * CP, C * CP)
    rhs = -g_c.reshape(-1) + rhs_red
    return SchurSystem(S=S, rhs=rhs, M=M3, V=V, u=u)


def solve_reduced(system: SchurSystem) -> jnp.ndarray:
    """Solve S dc = rhs. S is symmetric positive definite after damping +
    identity fill; Cholesky on device (SURVEY §3.1 'dense solve, O(C^3)')."""
    S = 0.5 * (system.S + system.S.T)
    L, lower = jax.scipy.linalg.cho_factor(S, lower=True)
    return jax.scipy.linalg.cho_solve((L, lower), system.rhs)


def back_substitute(system: SchurSystem, dc: jnp.ndarray) -> jnp.ndarray:
    """dp = -Hpp^-1 (g_p + Hcp^T dc), per point (SURVEY §3.1).

    In the whitened form: dp = -M^T (u + V^T dc)."""
    Vt_dc = xp.einsum("pas,a->ps", system.V, dc)           # [P, 3]
    return -xp.einsum("pts,pt->ps", system.M, system.u + Vt_dc)


def solve_step_dense(
    eqs: NormalEqs,
    lam: jnp.ndarray,
    obs_cam: jnp.ndarray,
    obs_pt: jnp.ndarray,
    axis_name: str | None = None,
    pt_obs: jnp.ndarray | None = None,
    pt_obs_mask: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One damped Gauss-Newton step via dense Schur: returns (dc [C,CP], dp [P,3]).

    Under ``axis_name``, dc is replicated across chips (S and rhs are
    psum'd so every chip solves the identical reduced system) and dp is the
    chip-local point shard's update.
    """
    system = reduce_dense(
        eqs, lam, obs_cam, obs_pt, axis_name, pt_obs, pt_obs_mask
    )
    dc = solve_reduced(system)
    dp = back_substitute(system, dc)
    C, CP, _ = eqs.Hcc.shape
    return dc.reshape(C, CP), dp


def predicted_reduction(
    eqs: NormalEqs,
    lam: jnp.ndarray,
    dc: jnp.ndarray,
    dp: jnp.ndarray,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """LM model reduction L(0) - L(d) = 0.5 * d^T (lam*D d - g) for the step
    solving (H + lam D) d = -g with Marquardt scaling D = diag(H) (+ fill).

    Identical formula in the NumPy oracle so gain ratios match bitwise-ish.
    Under ``axis_name``: camera terms use the psum'd Hcc/g_c; point terms
    are summed locally then psum'd.
    """
    Hcc, g_c = eqs.Hcc, eqs.g_c
    if axis_name is not None:
        Hcc = jax.lax.psum(Hcc, axis_name)
        g_c = jax.lax.psum(g_c, axis_name)
    d_cc = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
    d_pp = jnp.diagonal(eqs.Hpp, axis1=-2, axis2=-1)
    fill_c = jnp.where(d_cc == 0, 1.0, 0.0)
    fill_p = jnp.where(d_pp == 0, 1.0, 0.0)
    cam_term = jnp.sum((lam * d_cc + fill_c) * dc * dc) - jnp.sum(dc * g_c)
    pt_term = jnp.sum((lam * d_pp + fill_p) * dp * dp) - jnp.sum(dp * eqs.g_p)
    if axis_name is not None:
        pt_term = jax.lax.psum(pt_term, axis_name)
    return 0.5 * (cam_term + pt_term)
