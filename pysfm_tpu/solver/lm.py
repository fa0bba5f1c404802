"""Levenberg-Marquardt bundle adjustment, fully on device.

Reference analog: ``BundleAdjuster.optimize`` (SURVEY §2, §3.1) — the LM
outer loop with block normal equations, Schur elimination, damping and
accept/reject.  The reference steps this loop in Python with NumPy; here the
*entire* optimization (residuals, Jacobians, Schur solve, trust-region
control) is a single ``lax.while_loop`` under jit with no host round-trips
per iteration (BASELINE.json north-star: "LM damping, gain-ratio
trust-region updates, and robust-kernel reweighting run fully on-device").

Accept/reject is predicated (compute the candidate, ``where``-select), and
the damping parameter follows Nielsen's schedule; the NumPy oracle in
``tests/oracle_numpy.py`` implements the identical control flow so final
costs agree to ~1e-6 relative (BASELINE north-star parity definition).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from pysfm_tpu.problem import problem as problem_mod
from pysfm_tpu.solver import schur
from pysfm_tpu.utils.config import LMConfig
from pysfm_tpu.utils import struct


@struct.dataclass
class LMStats:
    """Per-iteration log, accumulated on device and flushed once at the end
    (SURVEY §5 "Metrics / logging": no per-iteration host sync)."""

    costs: jnp.ndarray       # [max_iters + 1]; costs[0] = initial, then cost
                             # after each iteration (accepted or kept)
    lams: jnp.ndarray        # [max_iters] damping used at each iteration
    accepted: jnp.ndarray    # [max_iters] bool
    grad_inf: jnp.ndarray    # [max_iters] inf-norm of the gradient
    step_norms: jnp.ndarray  # [max_iters]
    n_iters: jnp.ndarray     # scalar int: iterations actually executed
    lam_next: jnp.ndarray    # scalar: damping state AFTER the last iteration
    nu_next: jnp.ndarray     # scalar: Nielsen growth state after the last
                             # iteration (lam_next/nu_next let a segmented or
                             # checkpointed solve continue exactly)
    cg_iters: jnp.ndarray    # [max_iters] int: CG iterations spent per LM
                             # iteration (0 on the dense solver paths) —
                             # the cost-vs-cumulative-CG-work curve of the
                             # adaptive forcing sequence
    dc_next: jnp.ndarray     # [C, CP] the last camera step — CG warm-start
                             # state; pass as ``dc_init`` to the next
                             # segmented/resumed dispatch so the first CG
                             # run there starts from it instead of zero
                             # (zeros on the dense paths)


class _State(struct.PyTreeNode):
    prob: problem_mod.BundleProblem
    lam: jnp.ndarray
    nu: jnp.ndarray
    cost: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray
    stats: LMStats


def _select(pred, a, b):
    return jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y), a, b)


def solve(
    prob,
    config: LMConfig = LMConfig(),
    lam_init=None,
    nu_init=None,
    dc_init=None,
):
    """Run LM to convergence (or ``config.max_iters``) entirely on device.

    Dispatcher: a :class:`~pysfm_tpu.problem.cm.CMProblem` (or any problem
    with ``config.solver == "pcg"``) runs the component-major BAL-scale
    loop (:func:`solve_cm`); everything else runs the standard-layout loop.
    A BundleProblem input always returns a BundleProblem.

    ``lam_init``/``nu_init`` (runtime scalars, optional) override the
    damping state so a segmented/checkpointed solve continues exactly
    where a previous dispatch stopped without recompiling per segment;
    ``dc_init`` ([C, CP], optional — ``stats.dc_next`` of the previous
    dispatch) likewise carries the CG warm-start vector across the
    boundary."""
    from pysfm_tpu.problem import cm

    if isinstance(prob, cm.CMProblem):
        return solve_cm(prob, config, lam_init, nu_init, dc_init)
    if config.solver == "pcg":
        cmp, stats = solve_cm(
            _from_problem_jit(prob), config, lam_init, nu_init, dc_init
        )
        return _merge_params_jit(prob, cmp), stats
    return _solve_std(prob, config, lam_init, nu_init)


@jax.jit
def _from_problem_jit(prob):
    from pysfm_tpu.problem import cm

    return cm.from_problem(prob)


@jax.jit
def _merge_params_jit(prob, cmp):
    from pysfm_tpu.problem import cm

    return cm.merge_params(prob, cmp)


@partial(jax.jit, static_argnames=("config",))
def _solve_std(
    prob: problem_mod.BundleProblem,
    config: LMConfig = LMConfig(),
    lam_init=None,
    nu_init=None,
) -> Tuple[problem_mod.BundleProblem, LMStats]:
    """Standard-layout LM loop (dense / dense-cm Schur solvers)."""
    dtype = prob.X.dtype
    n_it = config.max_iters
    cost_fn = problem_mod.cost
    init_cost = cost_fn(prob)
    lam0 = (
        jnp.asarray(config.lam0, dtype)
        if lam_init is None
        else jnp.asarray(lam_init, dtype)
    )
    nu0 = (
        jnp.asarray(2.0, dtype)
        if nu_init is None
        else jnp.asarray(nu_init, dtype)
    )
    stats = LMStats(
        costs=jnp.full((n_it + 1,), jnp.nan, dtype).at[0].set(init_cost),
        lams=jnp.full((n_it,), jnp.nan, dtype),
        accepted=jnp.zeros((n_it,), bool),
        grad_inf=jnp.full((n_it,), jnp.nan, dtype),
        step_norms=jnp.full((n_it,), jnp.nan, dtype),
        n_iters=jnp.asarray(0),
        lam_next=lam0,
        nu_next=nu0,
        cg_iters=jnp.zeros((n_it,), jnp.int32),
        dc_next=jnp.zeros((prob.n_cameras, prob.cam_dof), dtype),
    )
    state = _State(
        prob=prob,
        lam=lam0,
        nu=nu0,
        cost=init_cost,
        it=jnp.asarray(0),
        done=jnp.asarray(False),
        stats=stats,
    )

    def cond(s: _State):
        return jnp.logical_and(s.it < n_it, jnp.logical_not(s.done))

    use_cm = config.solver == "dense" and (
        config.layout == "cm" or config.layout == "auto"
    )

    def body(s: _State) -> _State:
        from pysfm_tpu.problem import cm
        from pysfm_tpu.solver import schur_cm

        p = s.prob
        if use_cm:
            rt, Jct, Jpt, wt = cm.residuals_and_jacobians_rows(p)
            eqs = schur_cm.build_normal_equations_cm(
                rt, Jct, Jpt, wt, p.obs_cam, p.pt_obs, p.pt_obs_mask,
                p.n_cameras,
            )
            grad_inf = schur_cm.grad_inf_cm(eqs)
            dc, dp = schur_cm.solve_step_cm(
                eqs, s.lam, p.obs_cam, p.obs_pt, p.pt_obs, p.pt_obs_mask,
            )
        else:
            r, J_cam, J_pt, w = problem_mod.residuals_and_jacobians(p)
            eqs = schur.build_normal_equations(
                r, J_cam, J_pt, w, p.obs_cam, p.obs_pt,
                p.n_cameras, p.n_points,
                pt_obs=p.pt_obs, pt_obs_mask=p.pt_obs_mask,
            )
            grad_inf = jnp.maximum(
                jnp.max(jnp.abs(eqs.g_c)), jnp.max(jnp.abs(eqs.g_p))
            )
            dc, dp = schur.solve_step_dense(
                eqs, s.lam, p.obs_cam, p.obs_pt,
                pt_obs=p.pt_obs, pt_obs_mask=p.pt_obs_mask,
            )
        cand = problem_mod.apply_update(p, dc, dp)
        new_cost = cost_fn(cand)
        if use_cm:
            pred = schur_cm.predicted_reduction_cm(eqs, s.lam, dc, dp)
        else:
            pred = schur.predicted_reduction(eqs, s.lam, dc, dp)
        actual = s.cost - new_cost
        rho = actual / jnp.maximum(pred, jnp.finfo(dtype).tiny)

        ok = jnp.logical_and(jnp.isfinite(new_cost), actual > 0)
        ok = jnp.logical_and(ok, pred > 0)

        # Nielsen damping schedule (same constants in the oracle).
        factor = jnp.maximum(
            jnp.asarray(1.0 / 3.0, dtype), 1.0 - (2.0 * rho - 1.0) ** 3
        )
        lam_acc = jnp.clip(s.lam * factor, config.lam_min, config.lam_max)
        lam_rej = jnp.clip(s.lam * s.nu, config.lam_min, config.lam_max)
        lam_next = jnp.where(ok, lam_acc, lam_rej)
        nu_next = jnp.where(ok, jnp.asarray(2.0, dtype), s.nu * 2.0)

        new_params = _select(
            ok,
            (cand.R, cand.t, cand.intr, cand.X),
            (p.R, p.t, p.intr, p.X),
        )
        if config.renormalize_every > 0:
            renorm = jnp.logical_and(
                ok, (s.it % config.renormalize_every) == config.renormalize_every - 1
            )
            from pysfm_tpu.geometry import so3

            new_params = (
                jnp.where(renorm, so3.normalize(new_params[0]), new_params[0]),
            ) + new_params[1:]
        prob_next = p.replace(
            R=new_params[0], t=new_params[1], intr=new_params[2], X=new_params[3]
        )
        cost_next = jnp.where(ok, new_cost, s.cost)

        step_norm = jnp.sqrt(jnp.sum(dc * dc) + jnp.sum(dp * dp))
        converged = grad_inf < config.tol_grad
        converged = jnp.logical_or(
            converged,
            jnp.logical_and(ok, actual < config.tol_cost_rel * s.cost),
        )
        converged = jnp.logical_or(converged, step_norm < config.tol_step)

        st = s.stats
        st = st.replace(
            costs=st.costs.at[s.it + 1].set(cost_next),
            lams=st.lams.at[s.it].set(s.lam),
            accepted=st.accepted.at[s.it].set(ok),
            grad_inf=st.grad_inf.at[s.it].set(grad_inf),
            step_norms=st.step_norms.at[s.it].set(step_norm),
            n_iters=s.it + 1,
        )
        return _State(
            prob=prob_next,
            lam=lam_next,
            nu=nu_next,
            cost=cost_next,
            it=s.it + 1,
            done=converged,
            stats=st,
        )

    final = jax.lax.while_loop(cond, body, state)
    # Forward-fill the cost log past convergence so the tail is usable.
    it_idx = jnp.arange(n_it + 1)
    costs = jnp.where(
        it_idx <= final.it, final.stats.costs, final.cost
    )
    return final.prob, final.stats.replace(
        costs=costs, lam_next=final.lam, nu_next=final.nu
    )


class _CMState(struct.PyTreeNode):
    prob: "object"        # pysfm_tpu.problem.cm.CMProblem
    lam: jnp.ndarray
    nu: jnp.ndarray
    cost: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray
    stats: LMStats
    dc_prev: jnp.ndarray  # [C, CP] last camera step (CG warm start)
    eta: jnp.ndarray      # CG tolerance used last iteration (EW forcing)
    grad_prev: jnp.ndarray  # |g|_inf of the previous linearization
    prev_ok: jnp.ndarray    # was the previous step accepted?
    eqs: "object"           # carried linearization (ScaleEqs) — valid for
                            # `prob`; reused after a rejected step instead
                            # of rebuilding (config.reuse_linearization).
                            # None when the carry is disabled.


@partial(jax.jit, static_argnames=("config",))
def solve_cm(
    cmp,
    config: LMConfig = LMConfig(),
    lam_init=None,
    nu_init=None,
    dc_init=None,
):
    """Component-major BAL-scale LM loop (the ``pcg`` solver path).

    Same control flow as :func:`_solve_std` (Nielsen damping, predicated
    accept/reject, on-device stats), but the problem state, normal-equation
    build, CG Schur solve and retraction all run in the component-major
    layout (problem/cm.py, solver/scale.py, solver/pcg.py) — nothing
    observation- or point-sized ever materializes with a small minor axis.
    Returns ``(CMProblem, LMStats)``.
    """
    return cm_lm_loop(cmp, config, lam_init, nu_init, dc_init=dc_init)


def cm_lm_loop(
    cmp,
    config: LMConfig = LMConfig(),
    lam_init=None,
    nu_init=None,
    axis_name: str | None = None,
    cam_shards: int = 0,
    dc_init=None,
):
    """The CM LM while_loop, parameterized over an optional mesh axis.

    With ``axis_name`` set this is the DISTRIBUTED flagship path (called
    inside ``shard_map`` by :mod:`pysfm_tpu.dist.sharded_cm`): ``cmp`` is
    one chip's point/observation shard with replicated camera state, and every camera-sized or scalar control quantity is psum'd so
    all chips execute the identical accept/reject sequence in lockstep.
    With ``axis_name=None`` it is exactly the single-chip :func:`solve_cm`.

    ``cam_shards`` > 0 (static; requires ``axis_name``) additionally
    partitions the camera axis of the reduced solve over the same mesh
    axis: damped camera blocks, reduced rhs, the block-Jacobi Cholesky,
    and the CG vectors live only on their owner chip
    (:class:`pysfm_tpu.solver.pcg.CamShard`); the camera *parameters*
    stay replicated (they are O(C) and every chip's projections need
    them — partitioning them would trade one [CP, C] all-gather for an
    identical-size parameter gather per iteration).
    """
    from pysfm_tpu.problem import cm
    from pysfm_tpu.solver import pcg, scale
    def psum(x):
        return x if axis_name is None else jax.lax.psum(x, axis_name)

    def pmax(x):
        return x if axis_name is None else jax.lax.pmax(x, axis_name)

    dtype = cmp.dtype
    n_it = config.max_iters
    cost_fn = lambda q: psum(scale.cost_scale_cm(q, config.obs_chunk))  # noqa: E731

    def build_lin(q):
        return scale.build_normal_equations_scale_cm(q, config.obs_chunk)

    reuse_lin = config.reuse_linearization
    init_cost = cost_fn(cmp)
    lam0 = (
        jnp.asarray(config.lam0, dtype)
        if lam_init is None
        else jnp.asarray(lam_init, dtype)
    )
    nu0 = (
        jnp.asarray(2.0, dtype)
        if nu_init is None
        else jnp.asarray(nu_init, dtype)
    )
    stats = LMStats(
        costs=jnp.full((n_it + 1,), jnp.nan, dtype).at[0].set(init_cost),
        lams=jnp.full((n_it,), jnp.nan, dtype),
        accepted=jnp.zeros((n_it,), bool),
        grad_inf=jnp.full((n_it,), jnp.nan, dtype),
        step_norms=jnp.full((n_it,), jnp.nan, dtype),
        n_iters=jnp.asarray(0),
        lam_next=lam0,
        nu_next=nu0,
        cg_iters=jnp.zeros((n_it,), jnp.int32),
        dc_next=jnp.zeros((cmp.n_cameras, cmp.cam_dof), dtype),
    )
    dc0 = (
        jnp.zeros((cmp.n_cameras, cmp.cam_dof), dtype)
        if dc_init is None
        else jnp.asarray(dc_init, dtype)
    )
    # With the carry enabled, the initial linearization is hoisted out of
    # the loop: the loop body then rebuilds only after ACCEPTED steps, so
    # the total number of builds is (accepted + 1) instead of (iterations).
    eqs0 = build_lin(cmp) if reuse_lin else None
    state = _CMState(
        prob=cmp,
        lam=lam0,
        nu=nu0,
        cost=init_cost,
        it=jnp.asarray(0),
        done=jnp.asarray(False),
        stats=stats,
        dc_prev=dc0,
        eta=jnp.asarray(config.cg_tol_max, dtype),
        grad_prev=jnp.asarray(0.0, dtype),
        prev_ok=jnp.asarray(True),
        eqs=eqs0,
    )

    def cond(s: _CMState):
        return jnp.logical_and(s.it < n_it, jnp.logical_not(s.done))

    def body(s: _CMState) -> _CMState:
        p = s.prob
        # After a REJECTED step the parameters are unchanged, so the
        # carried eqs are already exactly the linearization at p — skip
        # the rebuild (the predicate is replicated in the distributed
        # loop, so all chips branch together and no collective sits
        # inside the cond).
        if reuse_lin:
            need_build = jnp.logical_and(s.prev_ok, s.it > 0)
            eqs = jax.lax.cond(
                need_build, lambda _: build_lin(p), lambda _: s.eqs, None
            )
        else:
            eqs = build_lin(p)
        grad_inf = jnp.maximum(
            jnp.max(jnp.abs(psum(eqs.g_c))),
            pmax(jnp.max(jnp.abs(eqs.g_p))),
        )
        if config.cg_forcing == "ew":
            # Eisenstat-Walker choice 2 (gamma = 0.9, alpha = 2) on the
            # gradient-norm ratio, with the standard safeguard against
            # over-tightening (don't drop below gamma * eta_prev^2 while
            # that is still > 0.1) and a 4x tighten after a rejected step.
            # All inputs (grad_inf, s.*) are replicated/psum'd, so every
            # chip computes the identical eta in the distributed loop.
            gamma = jnp.asarray(0.9, dtype)
            ratio = grad_inf / jnp.maximum(
                s.grad_prev, jnp.finfo(dtype).tiny
            )
            eta_ew = gamma * ratio * ratio
            safe = gamma * s.eta * s.eta
            eta_ew = jnp.where(safe > 0.1, jnp.maximum(eta_ew, safe), eta_ew)
            eta_acc = jnp.clip(eta_ew, config.cg_tol, config.cg_tol_max)
            eta_rej = jnp.maximum(0.25 * s.eta, config.cg_tol)
            eta_i = jnp.where(s.prev_ok, eta_acc, eta_rej)
            eta_i = jnp.where(
                s.it == 0, jnp.asarray(config.cg_tol_max, dtype), eta_i
            )
            tol_i = eta_i
        else:
            eta_i = jnp.asarray(config.cg_tol, dtype)
            tol_i = config.cg_tol
        dc, dp3, n_cg = pcg.solve_step_pcg_cm3(
            eqs, s.lam, p.obs_cam, p.obs_pt,
            tol=tol_i, max_iters=config.cg_iters,
            axis_name=axis_name,
            pt_obsT=p.pt_obsT, pt_obs_maskT=p.pt_obs_maskT,
            cam_obs=p.cam_obs, cam_obs_mask=p.cam_obs_mask,
            dc_warm=s.dc_prev if config.cg_warm_start else None,
            q_tol=config.cg_q_tol,
            precond_terms=config.cg_precond_terms,
            cam_shards=cam_shards,
        )
        cand = cm.apply_update_cm(p, dc, dp3)
        new_cost = cost_fn(cand)
        pred = scale.predicted_reduction_scale_cm(
            eqs, s.lam, dc, dp3, axis_name=axis_name
        )
        actual = s.cost - new_cost
        rho = actual / jnp.maximum(pred, jnp.finfo(dtype).tiny)

        ok = jnp.logical_and(jnp.isfinite(new_cost), actual > 0)
        ok = jnp.logical_and(ok, pred > 0)

        factor = jnp.maximum(
            jnp.asarray(1.0 / 3.0, dtype), 1.0 - (2.0 * rho - 1.0) ** 3
        )
        lam_acc = jnp.clip(s.lam * factor, config.lam_min, config.lam_max)
        lam_rej = jnp.clip(s.lam * s.nu, config.lam_min, config.lam_max)
        lam_next = jnp.where(ok, lam_acc, lam_rej)
        nu_next = jnp.where(ok, jnp.asarray(2.0, dtype), s.nu * 2.0)

        new_params = _select(
            ok,
            (cand.R, cand.t, cand.intr, cand.X3),
            (p.R, p.t, p.intr, p.X3),
        )
        if config.renormalize_every > 0:
            renorm = jnp.logical_and(
                ok,
                (s.it % config.renormalize_every)
                == config.renormalize_every - 1,
            )
            from pysfm_tpu.geometry import so3

            new_params = (
                jnp.where(renorm, so3.normalize(new_params[0]), new_params[0]),
            ) + new_params[1:]
        prob_next = p.replace(
            R=new_params[0], t=new_params[1], intr=new_params[2],
            X3=new_params[3],
        )
        cost_next = jnp.where(ok, new_cost, s.cost)

        step_norm = jnp.sqrt(
            jnp.sum(dc * dc) + psum(jnp.sum(dp3 * dp3))
        )
        converged = grad_inf < config.tol_grad
        converged = jnp.logical_or(
            converged,
            jnp.logical_and(ok, actual < config.tol_cost_rel * s.cost),
        )
        converged = jnp.logical_or(converged, step_norm < config.tol_step)

        st = s.stats
        st = st.replace(
            costs=st.costs.at[s.it + 1].set(cost_next),
            lams=st.lams.at[s.it].set(s.lam),
            accepted=st.accepted.at[s.it].set(ok),
            grad_inf=st.grad_inf.at[s.it].set(grad_inf),
            step_norms=st.step_norms.at[s.it].set(step_norm),
            n_iters=s.it + 1,
            cg_iters=st.cg_iters.at[s.it].set(n_cg.astype(jnp.int32)),
        )
        return _CMState(
            prob=prob_next,
            lam=lam_next,
            nu=nu_next,
            cost=cost_next,
            it=s.it + 1,
            done=converged,
            stats=st,
            dc_prev=dc,
            eta=eta_i,
            grad_prev=grad_inf,
            prev_ok=ok,
            eqs=eqs if reuse_lin else None,
        )

    final = jax.lax.while_loop(cond, body, state)
    it_idx = jnp.arange(n_it + 1)
    costs = jnp.where(it_idx <= final.it, final.stats.costs, final.cost)
    return final.prob, final.stats.replace(
        costs=costs, lam_next=final.lam, nu_next=final.nu,
        dc_next=final.dc_prev,
    )


def solve_segmented(
    prob: problem_mod.BundleProblem,
    config: LMConfig = LMConfig(),
    iters_per_dispatch: int = 6,
) -> Tuple[problem_mod.BundleProblem, LMStats]:
    """Host-driven segmentation of :func:`solve` for VERY long-running
    problems: runs ``config.max_iters`` as segments of
    ``iters_per_dispatch`` iterations, each a single on-device
    ``while_loop`` dispatch, carrying (lam, nu) across segments exactly.

    Why: a bounded dispatch gives natural checkpoint / progress points on
    problems whose iterations take seconds each; the per-segment host
    round-trip is one scalar sync, noise against the segment.

    Compiles at most twice (full segment + remainder segment).
    """
    import dataclasses

    import numpy as np

    total = config.max_iters
    k = max(1, iters_per_dispatch)
    cfg_seg = dataclasses.replace(config, max_iters=k)
    lam = jnp.asarray(config.lam0, prob.dtype)
    nu = jnp.asarray(2.0, prob.dtype)
    # CG warm-start vector, carried across segments (r5).  Zeros (not
    # None) so every segment shares one trace.
    dc = jnp.zeros((prob.n_cameras, prob.cam_dof), prob.dtype)
    p = prob
    costs = []
    lams, accepted, grad_inf, step_norms, cg_its = [], [], [], [], []
    n_done = 0
    while n_done < total:
        kk = min(k, total - n_done)
        cfg_k = cfg_seg if kk == k else dataclasses.replace(
            config, max_iters=kk
        )
        p, st = solve(p, cfg_k, lam_init=lam, nu_init=nu, dc_init=dc)
        n_it = int(st.n_iters)
        seg_costs = np.asarray(st.costs)
        if not costs:
            costs.append(seg_costs[:1])
        costs.append(seg_costs[1 : n_it + 1])
        lams.append(np.asarray(st.lams)[:n_it])
        accepted.append(np.asarray(st.accepted)[:n_it])
        grad_inf.append(np.asarray(st.grad_inf)[:n_it])
        step_norms.append(np.asarray(st.step_norms)[:n_it])
        cg_its.append(np.asarray(st.cg_iters)[:n_it])
        lam, nu, dc = st.lam_next, st.nu_next, st.dc_next
        n_done += n_it
        if n_it < kk:  # converged inside the segment
            break
    return p, LMStats(
        costs=np.concatenate(costs),
        lams=np.concatenate(lams),
        accepted=np.concatenate(accepted),
        grad_inf=np.concatenate(grad_inf),
        step_norms=np.concatenate(step_norms),
        n_iters=np.asarray(n_done),
        lam_next=np.asarray(lam),
        nu_next=np.asarray(nu),
        cg_iters=np.concatenate(cg_its),
        dc_next=np.asarray(dc),
    )
