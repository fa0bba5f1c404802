"""Typed configuration (SURVEY §5 "Config / flag system": the reference has
none — constructor args and script constants; here a small explicit
dataclass the whole framework shares)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Levenberg-Marquardt settings (static under jit — changing any field
    triggers one recompile, which is the intended trade for a fully
    on-device loop)."""

    max_iters: int = 50
    # Initial damping and Nielsen trust-region constants (SURVEY §3.1
    # "accept if cost down (lam/=k) else revert (lam*=k)" — we use the
    # smoother Nielsen schedule; the NumPy oracle matches it exactly).
    lam0: float = 1e-4
    lam_min: float = 1e-12
    lam_max: float = 1e10
    # Convergence: infinity-norm of the gradient, relative cost decrease,
    # and step norm (SURVEY §3.1 "convergence check").
    tol_grad: float = 1e-10
    tol_cost_rel: float = 1e-12
    tol_step: float = 1e-12
    # Re-orthonormalize rotations every k accepted steps (0 = never);
    # fights f32 drift of the multiplicative rotation updates.
    renormalize_every: int = 0
    # Reduced-camera-system solver: "dense" materializes the [C*CP, C*CP]
    # Schur complement via the dense-W operand (small/medium C), "pcg" runs
    # matrix-free preconditioned CG with implicit S-matvecs (BAL scale —
    # the dense-W operand is O(P * C * CP * 3) and simply does not exist at
    # 1M points / 1.7k cameras).
    solver: str = "dense"
    cg_iters: int = 100
    cg_tol: float = 1e-6
    # Observation-chunked Jacobian build for the pcg path (0 = unchunked):
    # bounds the residual/Jacobian working set to `obs_chunk` observations
    # via a sequential lax.map (SURVEY §5 "obs-chunked accumulation") so
    # BAL/Venice-scale problems never materialize [M, ...] Jacobians.
    obs_chunk: int = 0
    # Solver data layout: "std" ([M, 2, CP]-style block arrays), "cm"
    # (component-major [D, M] rows, see solver/schur_cm.py), or "auto" (cm for the dense solver, std for pcg).
    layout: str = "auto"
    # Warm-start CG with the previous LM iteration's camera step (pcg
    # solver only).  The reduced system changes between iterations only
    # through relinearization and the damping, so the previous step is an
    # excellent initial guess; with cg_tol-based early exit this removes a
    # large fraction of the S-matvecs.
    cg_warm_start: bool = True
    # Adaptive CG forcing sequence (pcg solver only).  "fixed" runs every
    # LM iteration at cg_tol; "ew" uses an Eisenstat-Walker (choice 2)
    # schedule: the relative CG tolerance for iteration k is
    #   eta_k = clip(0.9 (|g_k| / |g_{k-1}|)^2, cg_tol, cg_tol_max)
    # — loose while LM is far from convergence (big gradient drops do not
    # need an accurate Newton step), tightening toward cg_tol as the
    # gradient stalls, with a 4x tightening after a rejected step (an
    # inexact step is a plausible cause of the rejection).  This spends
    # CG iterations where they buy cost reduction instead of a fixed
    # budget per LM iteration.
    cg_forcing: str = "fixed"
    cg_tol_max: float = 0.3
    # Quadratic-model stagnation termination for CG (0 = off): stop at CG
    # iteration i when  i * (Q_{i-1} - Q_i) <= cg_q_tol * |Q_i|  with
    # Q(x) = 0.5 x^T S x - b^T x (the rule Ceres uses for ITERATIVE_SCHUR).
    # Near LM convergence the step barely changes the quadratic model, so
    # CG exits after a handful of iterations regardless of the residual
    # tolerance — the complementary half of the adaptive forcing.
    cg_q_tol: float = 0.0
    # Reuse the linearization across rejected steps (pcg solver only).
    # A rejected LM step leaves the parameters unchanged, so the normal
    # equations and coupling rows of the NEXT iteration are bitwise the
    # ones just computed; rebuilding them (the most expensive non-CG
    # stage) buys nothing.  The loop carries the normal equations in the
    # while_loop state and a lax.cond skips the rebuild after a reject.
    # Within one executable the reuse is exact (the rebuild is
    # deterministic, so the carried values ARE what a rebuild would
    # produce); flipping this flag recompiles, and two executables can
    # differ by f32 fusion rounding, which can flip an accept-threshold
    # tie.  On CPU the on/off trajectories are bitwise equal
    # (tests/test_pcg.py).  Cost: the carried equations, including the
    # [3*CP, M] coupling rows, stay live across iterations (~0.4 GB at
    # 5M observations with the 6-dof pose model).
    reuse_linearization: bool = True
    # Power-series preconditioner terms (1 = exact block-Jacobi; m > 1
    # adds m-1 Neumann-series terms of S^-1 around its block diagonal at
    # one extra S-matvec per CG iteration per term — see
    # solver/pcg.py _precond_power).
    cg_precond_terms: int = 1


def venice_pcg_config(max_iters: int, **overrides) -> LMConfig:
    """The flagship BAL/Venice-scale settings: matrix-free PCG with the
    adaptive (Eisenstat-Walker) forcing sequence, quadratic-model CG
    termination and an obs-chunked build; tolerances zeroed so exactly
    ``max_iters`` LM iterations run.  ``overrides`` replace any field."""
    kw = dict(
        max_iters=max_iters, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
        solver="pcg", cg_iters=25, cg_tol=1e-2, obs_chunk=1 << 19,
        cg_forcing="ew", cg_q_tol=0.1,
    )
    kw.update(overrides)
    return LMConfig(**kw)
