"""Matrix-free Schur solve: preconditioned CG on the reduced camera system.

Reference analog: the reference materializes S and calls a dense solve
(SURVEY §3.1 "dc = solve(S, rhs)"), which caps it at small camera counts.
For BASELINE config 4 (1.7k cams, 1M points) the dense-W operand
``[P, C*CP, 3]`` used by :func:`pysfm_tpu.solver.schur.reduce_dense` would
be tens of TB, so S can never be formed.  This module solves
``S dc = rhs`` *implicitly*:

    S x = Hcc_aug x - Hcp (Hpp_aug^-1 (Hcp^T x))

Layout — **component-major gathered tables**.  Two facts shape the
design:

- a scatter-add (``segment_sum``) over 5M observations is the most
  expensive way to reduce them, and a one-hot ``[M, C]`` reduction
  matmul costs M*C*D*2 flops;
- big axes are kept minor: the payload as ``[3*CP, K, P]`` rows is
  dense and coalesced, while a ``[P, K, CP, 3]`` block table has tiny
  minor dimensions.

So the per-observation coupling rows ``B_cm [3*CP, M]`` are gathered ONCE
per LM iteration into both padded visibility tables, keeping the big axis
minor:

- ``Bp [3*CP, K, P]``  — point-major (rows of Hcp^T), via ``pt_obs.T``;
- ``Bg [3*CP, C, Kc]`` — camera-major (rows of Hcp), via ``cam_obs``;

after which every reduction in the CG loop is a small gather of a
camera/point *vector* plus masked multiply-reduce contractions over the
leading (component/track) axes — pure memory-bound VPU work with static
shapes, no scatters, no layout padding.  Point blocks live in 6-component
lower-tri form ``[6, P]`` (a ``[P, 3, 3]`` array would tile 10x).
Padding slots hold zero rows, so gathered garbage never contributes.

Preconditioner: **exact** block-Jacobi of S.  In BA each (camera, point)
pair has (at most) one observation, so the diagonal block of the outer
product term is ``sum_k Bg[:,c,k] Hpp_inv[ptg[c,k]] Bg[:,c,k]^T`` — one
more masked contraction.  Block inverses are batched Cholesky solves of
[CP, CP] tiles.

Distributed (SURVEY §2 "Point-sharded Schur elimination"): with
``axis_name`` set, points/observations (and both tables, built per shard)
are chip-local; every S-matvec psums the camera-sized [CP, C] vector
across the mesh (one small collective per CG iteration), the preconditioner is psum'd
once per LM iteration, and the CG scalars (alpha/beta) are computed from
replicated quantities so all chips stay in lockstep.

A ``segment_sum`` fallback over :class:`schur.NormalEqs` remains for
callers without tables (used by the equality tests as an independent
formulation of the same operator).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from pysfm_tpu.utils import precision as xp

from pysfm_tpu.solver import scale as scale_mod
from pysfm_tpu.solver import schur


class PCGSystem(NamedTuple):
    """Component-major (table) or segment_sum (fallback) PCG operator."""

    Hcc_aug: jnp.ndarray    # [C, CP, CP] damped camera blocks (psum'd)
    hinv6: jnp.ndarray      # [6, P] damped point-block inverses (local)
    rhs: jnp.ndarray        # [CP, C] reduced rhs (psum'd), component-major
    g_p: jnp.ndarray        # [3, P] point gradient (local)
    M_inv: jnp.ndarray      # [C, CP, CP] block-Jacobi preconditioner inverse
    # Gathered-domain operands (None on the segment_sum fallback path).
    Bp: Optional[jnp.ndarray]    # [3*CP, K, P] masked point-major rows
    camg: Optional[jnp.ndarray]  # [K, P] camera id per slot
    Bg: Optional[jnp.ndarray]    # [3*CP, C, Kc] masked camera-major rows
    ptg: Optional[jnp.ndarray]   # [C, Kc] point id per slot
    # Fallback per-observation operands (None on the table path).
    B_cm: Optional[jnp.ndarray]    # [3*CP, M]
    obs_cam: Optional[jnp.ndarray]
    obs_pt: Optional[jnp.ndarray]
    # The (damped) block diagonal of S itself — kept only when the power-
    # series preconditioner needs to apply O = D - S (see _precond_power).
    D_blk: Optional[jnp.ndarray] = None  # [C, CP, CP]


class CamShard(NamedTuple):
    """Static descriptor of the camera-axis partition ("keyframes ...
    partitioned", SURVEY §2).

    On an ``n_shards``-chip mesh, chip ``k`` owns camera rows
    ``[k*n_local, (k+1)*n_local)`` of the padded range ``n_shards *
    n_local >= n_cams``.  All O(C) *solver* state — the damped camera
    blocks, the reduced rhs, the exact block-Jacobi preconditioner (its
    batched Cholesky), and the CG iteration vectors — lives only on its
    owner chip; the per-observation partials each chip computes for every
    camera are routed to owners with ONE ``psum_scatter`` (which performs
    the point-parallel reduction AND the camera partition in a single
    collective, the same bytes a plain psum moved before).  The matvec
    all-gathers the [CP, C] iterate (41 KB at Venice scale) — camera-sized
    state on the wire, never point-sized (SURVEY §5 long-context analog).
    """

    axis_name: str
    n_cams: int     # global C (unpadded)
    n_local: int    # padded per-chip camera rows (ceil(C / n_shards))
    n_shards: int

    @property
    def n_pad(self) -> int:
        return self.n_local * self.n_shards


def make_cam_shard(axis_name: str, n_cams: int, n_shards: int) -> CamShard:
    return CamShard(
        axis_name=axis_name, n_cams=n_cams,
        n_local=-(-n_cams // n_shards), n_shards=n_shards,
    )


def _scatter_cols(x: jnp.ndarray, cam: CamShard) -> jnp.ndarray:
    """[cp, C] per-chip partial -> [cp, n_local] owner rows (summed)."""
    pad = cam.n_pad - x.shape[1]
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad)))
    return jax.lax.psum_scatter(
        x, cam.axis_name, scatter_dimension=1, tiled=True
    )


def _scatter_rows(x: jnp.ndarray, cam: CamShard) -> jnp.ndarray:
    """[C, ...] per-chip partial -> [n_local, ...] owner rows (summed)."""
    pad = cam.n_pad - x.shape[0]
    if pad:
        x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
    return jax.lax.psum_scatter(
        x, cam.axis_name, scatter_dimension=0, tiled=True
    )


def _gather_x(x_local: jnp.ndarray, cam: CamShard) -> jnp.ndarray:
    """[cp, n_local] shard -> full [cp, C] (unpadded) on every chip."""
    xf = jax.lax.all_gather(
        x_local, cam.axis_name, axis=1, tiled=True
    )
    return xf[:, : cam.n_cams]


def _eqs_to_cm(eqs: schur.NormalEqs) -> scale_mod.ScaleEqs:
    """View a standard NormalEqs as component-major (test/fallback entry)."""
    cp = eqs.Hcc.shape[-1]
    hpp6 = jnp.stack([eqs.Hpp[:, d, e] for d, e in scale_mod.TRI3])
    B_cm = jnp.transpose(eqs.B, (2, 1, 0)).reshape(3 * cp, -1)
    return scale_mod.ScaleEqs(
        Hcc=eqs.Hcc, g_c=eqs.g_c, hpp6=hpp6, g_p=eqs.g_p.T, B_cm=B_cm
    )


def build_pcg_system(
    eqs,
    lam: jnp.ndarray,
    obs_cam: jnp.ndarray,
    obs_pt: jnp.ndarray,
    axis_name: str | None = None,
    pt_obsT: jnp.ndarray | None = None,
    pt_obs_maskT: jnp.ndarray | None = None,
    cam_obs: jnp.ndarray | None = None,
    cam_obs_mask: jnp.ndarray | None = None,
    keep_D: bool = False,
    cam: CamShard | None = None,
) -> PCGSystem:
    """Damp, invert point blocks, build rhs and the block-Jacobi
    preconditioner — everything except S itself.

    ``eqs`` is a :class:`scale.ScaleEqs` (the native layout) or a
    :class:`schur.NormalEqs` (converted; small problems / tests only).

    ``cam`` (with ``axis_name`` set) partitions the camera axis: the
    returned system's Hcc_aug / rhs / M_inv (and D_blk) hold only this
    chip's ``cam.n_local`` camera rows — per-chip partials are reduced
    AND routed to owners by psum_scatter instead of psum (same bytes).
    Padding rows (beyond C) are all-zero; ``augment_block_diag``'s unit
    diagonal fill makes their blocks the identity, and their rhs is
    zero, so CG keeps them exactly zero.
    """
    if isinstance(eqs, schur.NormalEqs):
        eqs = _eqs_to_cm(eqs)
    C, cp, _ = eqs.Hcc.shape
    Hcc = eqs.Hcc
    g_c = eqs.g_c
    if cam is not None:
        Hcc = _scatter_rows(Hcc, cam)
        g_c = _scatter_rows(g_c, cam)
    elif axis_name is not None:
        Hcc = jax.lax.psum(Hcc, axis_name)
        g_c = jax.lax.psum(g_c, axis_name)
    Hcc_aug = schur.augment_block_diag(Hcc, lam)
    hinv6 = scale_mod.sym6_inv(scale_mod.augment6(eqs.hpp6, lam))

    use_tables = pt_obsT is not None and cam_obs is not None
    u0 = scale_mod.sym6_mv(hinv6, eqs.g_p)                     # [3, P]
    if use_tables:
        pmask_t = pt_obs_maskT.astype(eqs.B_cm.dtype)          # [K, P]
        cmask = cam_obs_mask.astype(eqs.B_cm.dtype)            # [C, Kc]
        # Fence the table gathers: the materialized tables are the CG-loop
        # operands, so they are built once here and not re-fused into the
        # rhs/preconditioner reduces below.
        Bp = jax.lax.optimization_barrier(
            eqs.B_cm[:, pt_obsT]
        ) * pmask_t                                            # [3CP, K, P]
        camg = obs_cam[pt_obsT]                                # [K, P]
        Bg = jax.lax.optimization_barrier(
            eqs.B_cm[:, cam_obs]
        ) * cmask                                              # [3CP, C, Kc]
        ptg = obs_pt[cam_obs]                                  # [C, Kc]
        Bg4 = Bg.reshape(3, cp, C, -1)
        # rhs_red[d,c] = sum_{s,k} Bg(d,s)[c,k] * u0[s, ptg[c,k]].
        u0g = jax.lax.optimization_barrier(u0[:, ptg])         # [3, C, Kc]
        rhs_red = jnp.sum(Bg4 * u0g[:, None], axis=(0, 3))     # [cp, C]
        # Exact block-Jacobi diag: D_c = Hcc_aug[c] - sum_k Bg Hinv Bg^T.
        a, b, c_, d_, e, f = jax.lax.optimization_barrier(
            hinv6[:, ptg]
        )                                                      # each [C, Kc]
        B0, B1, B2 = Bg4[0], Bg4[1], Bg4[2]                    # [cp, C, Kc]
        BH0 = a * B0 + b * B1 + d_ * B2
        BH1 = b * B0 + c_ * B1 + e * B2
        BH2 = d_ * B0 + e * B1 + f * B2
        D = (
            xp.einsum("dck,eck->cde", BH0, B0)
            + xp.einsum("dck,eck->cde", BH1, B1)
            + xp.einsum("dck,eck->cde", BH2, B2)
        )
        B_keep = oc_keep = op_keep = None
    else:
        B4 = eqs.B_cm.reshape(3, cp, -1)                       # [3, cp, M]
        u0g = u0[:, obs_pt]                                    # [3, M]
        z = xp.einsum("scm,sm->cm", B4, u0g)                   # [cp, M]
        rhs_red = jax.ops.segment_sum(
            z.T, obs_cam, num_segments=C
        ).T                                                    # [cp, C]
        a, b, c_, d_, e, f = hinv6[:, obs_pt]                  # each [M]
        B0, B1, B2 = B4[0], B4[1], B4[2]                       # [cp, M]
        BH0 = a * B0 + b * B1 + d_ * B2
        BH1 = b * B0 + c_ * B1 + e * B2
        BH2 = d_ * B0 + e * B1 + f * B2
        D_m = (
            xp.einsum("dm,em->mde", BH0, B0)
            + xp.einsum("dm,em->mde", BH1, B1)
            + xp.einsum("dm,em->mde", BH2, B2)
        )
        D = jax.ops.segment_sum(D_m, obs_cam, num_segments=C)
        Bp = camg = Bg = ptg = None
        B_keep, oc_keep, op_keep = eqs.B_cm, obs_cam, obs_pt
    if cam is not None:
        rhs_red = _scatter_cols(rhs_red, cam)
        D = _scatter_rows(D, cam)
    elif axis_name is not None:
        rhs_red = jax.lax.psum(rhs_red, axis_name)
        D = jax.lax.psum(D, axis_name)
    rhs = -g_c.T + rhs_red                      # [cp, C] (or [cp, n_local])
    D = Hcc_aug - D
    # Batched Cholesky inverse of the [CP, CP] diagonal blocks; symmetrize
    # first (summation order effects) and fall back to the damped Hcc
    # block if a block is not SPD (can happen transiently at huge lam).
    D = 0.5 * (D + jnp.swapaxes(D, -1, -2))
    eye = jnp.eye(cp, dtype=D.dtype)
    L = jnp.linalg.cholesky(D)
    ok = jnp.all(jnp.isfinite(L), axis=(-2, -1), keepdims=True)
    L_safe = jnp.where(ok, L, jnp.linalg.cholesky(Hcc_aug))
    M_inv = jax.scipy.linalg.cho_solve(
        (L_safe, True), jnp.broadcast_to(eye, D.shape)
    )
    return PCGSystem(
        Hcc_aug=Hcc_aug, hinv6=hinv6, rhs=rhs, g_p=eqs.g_p, M_inv=M_inv,
        Bp=Bp, camg=camg, Bg=Bg, ptg=ptg,
        B_cm=B_keep, obs_cam=oc_keep, obs_pt=op_keep,
        D_blk=D if keep_D else None,
    )


def _hcpT_x(sys: PCGSystem, x: jnp.ndarray) -> jnp.ndarray:
    """u = Hcp^T x with x [CP, C] component-major; returns [3, P].

    The camera-vector gather is fenced with an optimization_barrier, so it
    is materialized once instead of being fused into the reduce over the
    table (the same pattern throughout this module)."""
    cp = x.shape[0]
    if sys.Bp is not None:
        Bp4 = sys.Bp.reshape(3, cp, *sys.Bp.shape[1:])         # [3,cp,K,P]
        xg = jax.lax.optimization_barrier(x[:, sys.camg])      # [cp,K,P]
        return jnp.sum(Bp4 * xg[None], axis=(1, 2))
    B4 = sys.B_cm.reshape(3, cp, -1)
    u_m = xp.einsum("sdm,dm->sm", B4, x[:, sys.obs_cam])       # [3, M]
    return jax.ops.segment_sum(
        u_m.T, sys.obs_pt, num_segments=sys.hinv6.shape[1]
    ).T


def _hcp_w(sys: PCGSystem, w: jnp.ndarray, C: int) -> jnp.ndarray:
    """z = Hcp w with w [3, P]; returns [CP, C] (chip-local partial)."""
    if sys.Bg is not None:
        cp = sys.Bg.shape[0] // 3
        Bg4 = sys.Bg.reshape(3, cp, *sys.Bg.shape[1:])         # [3,cp,C,Kc]
        wg = jax.lax.optimization_barrier(w[:, sys.ptg])       # [3,C,Kc]
        return jnp.sum(Bg4 * wg[:, None], axis=(0, 3))
    cp = sys.B_cm.shape[0] // 3
    B4 = sys.B_cm.reshape(3, cp, -1)
    z_m = xp.einsum("sdm,sm->dm", B4, w[:, sys.obs_pt])        # [cp, M]
    return jax.ops.segment_sum(z_m.T, sys.obs_cam, num_segments=C).T


def schur_matvec(
    sys: PCGSystem,
    x: jnp.ndarray,
    axis_name: str | None = None,
    cam: CamShard | None = None,
) -> jnp.ndarray:
    """y = S x with x, y [CP, C] component-major; S never formed.

    With ``cam`` set, x and y are this chip's [CP, n_local] camera shard:
    the iterate is all-gathered for the coupling term (camera-sized
    traffic), each chip computes its point shard's contribution to every
    camera, and one psum_scatter both sums the point-parallel partials
    and routes camera rows to their owners."""
    if cam is not None:
        x_full = _gather_x(x, cam)
        u = _hcpT_x(sys, x_full)
        w = scale_mod.sym6_mv(sys.hinv6, u)                    # [3, P]
        z = _scatter_cols(_hcp_w(sys, w, cam.n_cams), cam)
        y = xp.einsum("cde,ec->dc", sys.Hcc_aug, x)
        return y - z
    C = sys.Hcc_aug.shape[0]
    u = _hcpT_x(sys, x)
    w = scale_mod.sym6_mv(sys.hinv6, u)                        # [3, P]
    z = _hcp_w(sys, w, C)
    if axis_name is not None:
        z = jax.lax.psum(z, axis_name)
    y = xp.einsum("cde,ec->dc", sys.Hcc_aug, x)
    return y - z


def _precond(sys: PCGSystem, r: jnp.ndarray) -> jnp.ndarray:
    return xp.einsum("cde,ec->dc", sys.M_inv, r)


def _precond_power(
    sys: PCGSystem,
    r: jnp.ndarray,
    terms: int,
    axis_name: str | None,
    cam: "CamShard | None" = None,
) -> jnp.ndarray:
    """Truncated Neumann/power-series preconditioner (PAPERS.md: Power
    Bundle Adjustment applies the same expansion as the *solver*; here it
    strengthens CG): with S = D - O and D the exact block-Jacobi diagonal,

        S^-1 = sum_j (D^-1 O)^j D^-1   =>   z_m = D^-1 (r + O z_{m-1}),

    where O z = D z - S z costs one S-matvec per extra term.  ``terms=1``
    is exactly block-Jacobi; each additional term trades one matvec per CG
    iteration for a better-conditioned system.  Requires ``sys.D_blk``
    (kept by build_pcg_system when terms > 1)."""
    z = _precond(sys, r)
    for _ in range(terms - 1):
        Sz = schur_matvec(sys, z, axis_name, cam)
        Dz = xp.einsum("cde,ec->dc", sys.D_blk, z)
        z = _precond(sys, r + Dz - Sz)
    return z


def _dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b)


def pcg_solve(
    sys: PCGSystem,
    *,
    tol: float = 1e-6,
    max_iters: int = 100,
    axis_name: str | None = None,
    x0: jnp.ndarray | None = None,
    q_tol: float = 0.0,
    precond_terms: int = 1,
    return_iters: bool = False,
    cam: CamShard | None = None,
) -> jnp.ndarray:
    """Preconditioned CG for S dc = rhs; returns dc [CP, C] (or
    ``(dc, n_iters)`` with ``return_iters=True``).

    ``x0`` warm-starts the iteration (pass the previous LM iteration's
    camera step: the reduced system changes only through the damping and
    the relinearization, so the old step is an excellent initial guess
    and typically removes a third to half of the CG iterations).

    ``tol`` may be a traced scalar (the Eisenstat-Walker forcing sequence
    feeds a per-LM-iteration value).  ``q_tol`` > 0 adds quadratic-model
    stagnation termination: with Q(x) = 0.5 x'Sx - b'x (whose decrease per
    CG step is the exactly-known 0.5 alpha_i rz_i), stop at iteration i
    when  i * (Q_{i-1} - Q_i) <= q_tol |Q_i|  — the Ceres ITERATIVE_SCHUR
    rule; near LM convergence the step barely moves the model and CG exits
    in a handful of iterations regardless of the residual norm.

    ``precond_terms`` > 1 applies the power-series preconditioner
    (:func:`_precond_power`; needs ``sys.D_blk``).

    Note on distributed determinism: every quantity entering the CG
    scalars is psum'd (hence bitwise-identical across chips given the
    fixed mesh reduction order), so chips cannot diverge.
    """
    b = sys.rhs

    def gdot(a, bb):
        d = _dot(a, bb)
        # Camera-sharded mode: the vectors are disjoint shards, so the
        # global dot is the psum of local dots (replicated result keeps
        # every chip's CG control flow in lockstep).
        return d if cam is None else jax.lax.psum(d, cam.axis_name)

    def precond(r):
        if precond_terms > 1:
            return _precond_power(sys, r, precond_terms, axis_name, cam)
        return _precond(sys, r)

    if x0 is None:
        x0 = jnp.zeros_like(b)
        r0 = b                                # x0 = 0 => r = b - S x0 = b
        Q0 = jnp.zeros((), b.dtype)
    else:
        if cam is not None:
            # Warm start arrives full [CP, C]; take this chip's columns.
            idx = jax.lax.axis_index(cam.axis_name)
            x0p = jnp.pad(x0, ((0, 0), (0, cam.n_pad - x0.shape[1])))
            x0 = jax.lax.dynamic_slice_in_dim(
                x0p, idx * cam.n_local, cam.n_local, 1
            )
        r0 = b - schur_matvec(sys, x0, axis_name, cam)
        # Q(x0) = 0.5 x0'S x0 - b'x0 with S x0 = b - r0.
        Q0 = -0.5 * (gdot(x0, b) + gdot(x0, r0))
    z0 = precond(r0)
    b_norm = jnp.sqrt(gdot(b, b))
    thresh = tol * jnp.maximum(b_norm, jnp.asarray(1e-30, b.dtype))
    big = jnp.asarray(jnp.finfo(b.dtype).max, b.dtype)

    def cond(state):
        _, r, _, _, rz, it, done, Q, dQ = state
        go = jnp.logical_and(
            jnp.logical_and(it < max_iters, jnp.logical_not(done)),
            jnp.sqrt(gdot(r, r)) > thresh,
        )
        if q_tol > 0.0:
            stag = jnp.logical_and(
                it > 0,
                it.astype(Q.dtype) * dQ <= q_tol * jnp.abs(Q),
            )
            go = jnp.logical_and(go, jnp.logical_not(stag))
        return go

    def body(state):
        x, r, z, p, rz, it, _, Q, _ = state
        Sp = schur_matvec(sys, p, axis_name, cam)
        pSp = gdot(p, Sp)
        # Breakdown guard: S is SPD in exact arithmetic, but f32 rounding at
        # scale can turn a nearly-converged direction indefinite — stop and
        # keep the current iterate (the LM trust region absorbs an inexact
        # step by rejecting it and raising lam).
        bad = jnp.logical_not(
            jnp.logical_and(jnp.isfinite(pSp), pSp > 0)
        )
        alpha = jnp.where(
            bad, jnp.zeros_like(rz),
            rz / jnp.maximum(pSp, jnp.finfo(b.dtype).tiny),
        )
        x = x + alpha * p
        r = r - alpha * Sp
        z = precond(r)
        rz_new = gdot(r, z)
        beta = rz_new / jnp.maximum(rz, jnp.finfo(b.dtype).tiny)
        p = z + beta * p
        dQ = 0.5 * alpha * rz                  # Q_{i-1} - Q_i (exact)
        return (x, r, z, p, rz_new, it + 1, bad, Q - dQ, dQ)

    state = (
        x0, r0, z0, z0, gdot(r0, z0), jnp.asarray(0), jnp.asarray(False),
        Q0, big,
    )
    out = jax.lax.while_loop(cond, body, state)
    x = out[0] if cam is None else _gather_x(out[0], cam)
    if return_iters:
        return x, out[5]
    return x


def back_substitute(sys: PCGSystem, dc: jnp.ndarray) -> jnp.ndarray:
    """dp = -Hpp_inv (g_p + Hcp^T dc), component-major [3, P]; ``dc``
    [CP, C] — identical to the dense path but from the gathered rows
    (local to the chip's point shard)."""
    u = _hcpT_x(sys, dc)
    return -scale_mod.sym6_mv(sys.hinv6, sys.g_p + u)


def solve_step_pcg(
    eqs,
    lam: jnp.ndarray,
    obs_cam: jnp.ndarray,
    obs_pt: jnp.ndarray,
    *,
    tol: float = 1e-6,
    max_iters: int = 100,
    axis_name: str | None = None,
    pt_obsT: jnp.ndarray | None = None,
    pt_obs_maskT: jnp.ndarray | None = None,
    cam_obs: jnp.ndarray | None = None,
    cam_obs_mask: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Drop-in replacement for :func:`schur.solve_step_dense` at scale.

    Returns ``(dc [C, CP], dp [P, 3])`` in the standard layout."""
    dc, dp3, _ = solve_step_pcg_cm3(
        eqs, lam, obs_cam, obs_pt,
        tol=tol, max_iters=max_iters, axis_name=axis_name,
        pt_obsT=pt_obsT, pt_obs_maskT=pt_obs_maskT,
        cam_obs=cam_obs, cam_obs_mask=cam_obs_mask,
    )
    return dc, dp3.T


def solve_step_pcg_cm3(
    eqs,
    lam: jnp.ndarray,
    obs_cam: jnp.ndarray,
    obs_pt: jnp.ndarray,
    *,
    tol: float = 1e-6,
    max_iters: int = 100,
    axis_name: str | None = None,
    pt_obsT: jnp.ndarray | None = None,
    pt_obs_maskT: jnp.ndarray | None = None,
    cam_obs: jnp.ndarray | None = None,
    cam_obs_mask: jnp.ndarray | None = None,
    dc_warm: jnp.ndarray | None = None,
    q_tol: float = 0.0,
    precond_terms: int = 1,
    cam_shards: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Like :func:`solve_step_pcg` but keeps the point step component-major:
    returns ``(dc [C, CP], dp3 [3, P], n_cg)`` — the layout the CM LM loop
    and :func:`pysfm_tpu.problem.cm.apply_update_cm` consume directly, plus
    the CG iterations actually spent (for the forcing-sequence stats).

    ``dc_warm`` ([C, CP], optional) warm-starts CG with the previous LM
    iteration's camera step.  ``tol`` may be traced (adaptive forcing); ``q_tol``
    and ``precond_terms`` as in :func:`pcg_solve`.

    ``cam_shards`` > 0 (static, with ``axis_name``) partitions the camera
    axis of the reduced solve across the mesh (see :class:`CamShard`);
    the returned ``dc`` is still the full [C, CP] step (all-gathered —
    back-substitution and the retraction need it on every chip)."""
    if isinstance(eqs, schur.NormalEqs):
        eqs = _eqs_to_cm(eqs)
    cam = None
    if cam_shards > 0:
        if axis_name is None:
            raise ValueError("cam_shards requires axis_name")
        cam = make_cam_shard(axis_name, eqs.Hcc.shape[0], cam_shards)
    sys = build_pcg_system(
        eqs, lam, obs_cam, obs_pt, axis_name,
        pt_obsT=pt_obsT, pt_obs_maskT=pt_obs_maskT,
        cam_obs=cam_obs, cam_obs_mask=cam_obs_mask,
        keep_D=precond_terms > 1,
        cam=cam,
    )
    # Materialization fence between the system build and the CG
    # while_loop: the gathered operands are built once, outside the loop.
    sys = jax.lax.optimization_barrier(sys)
    x0 = None if dc_warm is None else dc_warm.T
    dc, n_cg = pcg_solve(
        sys, tol=tol, max_iters=max_iters, axis_name=axis_name, x0=x0,
        q_tol=q_tol, precond_terms=precond_terms, return_iters=True,
        cam=cam,
    )
    dp3 = back_substitute(sys, dc)
    return dc.T, dp3, n_cg
