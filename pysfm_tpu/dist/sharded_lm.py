"""Distributed Levenberg-Marquardt: point-sharded Schur BA under shard_map.

The mapping BASELINE.json's north star asks for: point blocks eliminated
device-locally, the reduced camera system allreduced and solved, with
the whole LM loop (damping, gain-ratio trust region) on device and no host
round-trips per iteration.

Every chip runs the identical ``lax.while_loop``; the only cross-chip
traffic per iteration is:

- one ``psum`` of the camera-sized partials (Hcc, g_c, partial S, rhs),
- one ``psum`` of the scalar candidate cost / predicted-reduction terms.

All control state (lam, nu, accept) is computed redundantly from psum'd
scalars, so it is replicated by construction and chips never diverge.
Reduction order is fixed by the mesh, so an n-chip solve matches the
1-chip solve to fp tolerance (SURVEY §4 invariant test; exact in f64).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from pysfm_tpu.dist.mesh import AXIS
from pysfm_tpu.dist.shard import ShardedProblem
from pysfm_tpu.problem import problem as problem_mod
from pysfm_tpu.problem import robust as robust_mod
from pysfm_tpu.solver import schur
from pysfm_tpu.solver.lm import LMStats
from pysfm_tpu.utils.config import LMConfig


def _local_problem(sp: ShardedProblem) -> problem_mod.BundleProblem:
    """View one chip's shard (inside shard_map, leading axis stripped) as a
    BundleProblem so the L1 evaluation code is reused verbatim."""
    pl = sp.X.shape[0]
    return problem_mod.BundleProblem(
        R=sp.R, t=sp.t, intr=sp.intr, X=sp.X,
        obs_cam=sp.obs_cam, obs_pt=sp.obs_pt, obs_uv=sp.obs_uv, obs_w=sp.obs_w,
        pt_obs=sp.pt_obs,
        pt_obs_mask=sp.pt_obs_mask,
        cam_obs=sp.cam_obs,
        cam_obs_mask=sp.cam_obs_mask,
        cam_fixed=sp.cam_fixed, robust_scale=sp.robust_scale,
        camera_model=sp.camera_model, robust=sp.robust,
    )


def _cost(
    lp: problem_mod.BundleProblem, obs_chunk: int = 0
) -> jnp.ndarray:
    """Chip-local robust cost; caller psums.  ``obs_chunk`` > 0 bounds the
    per-chunk gather the same way as the single-device pcg path instead of
    a plain [Ml, 3, 3] rotation gather (scale.cost_scale)."""
    if obs_chunk > 0:
        from pysfm_tpu.solver import scale as scale_mod

        return scale_mod.cost_scale(lp, obs_chunk)
    r = problem_mod.residuals(lp)
    s = jnp.sum(r * r, axis=-1)
    return 0.5 * jnp.sum(
        lp.obs_w * robust_mod.rho(lp.robust, s, lp.robust_scale)
    )


def solve_sharded(
    sp: ShardedProblem, mesh, config: LMConfig = LMConfig()
) -> Tuple[ShardedProblem, LMStats]:
    """Distributed LM solve. ``sp`` must be placed with
    :func:`pysfm_tpu.dist.shard.device_put_sharded` on ``mesh``."""

    spec_sharded = ShardedProblem(
        R=P(), t=P(), intr=P(), cam_fixed=P(),
        X=P(AXIS), pt_mask=P(AXIS),
        obs_cam=P(AXIS), obs_pt=P(AXIS), obs_uv=P(AXIS), obs_w=P(AXIS),
        pt_obs=P(AXIS), pt_obs_mask=P(AXIS),
        cam_obs=P(AXIS), cam_obs_mask=P(AXIS),
        robust_scale=P(),
        camera_model=sp.camera_model, robust=sp.robust,
    )
    stats_spec = LMStats(
        costs=P(), lams=P(), accepted=P(), grad_inf=P(), step_norms=P(),
        n_iters=P(), lam_next=P(), nu_next=P(), cg_iters=P(), dc_next=P(),
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec_sharded,),
        out_specs=(spec_sharded, stats_spec),
        check_vma=False,
    )
    def run(sp_local: ShardedProblem):
        # Strip the size-1 local shard axis shard_map leaves on sharded fields.
        sp_local = sp_local.replace(
            X=sp_local.X[0], pt_mask=sp_local.pt_mask[0],
            obs_cam=sp_local.obs_cam[0], obs_pt=sp_local.obs_pt[0],
            obs_uv=sp_local.obs_uv[0], obs_w=sp_local.obs_w[0],
            pt_obs=sp_local.pt_obs[0], pt_obs_mask=sp_local.pt_obs_mask[0],
            cam_obs=sp_local.cam_obs[0],
            cam_obs_mask=sp_local.cam_obs_mask[0],
        )
        dtype = sp_local.X.dtype
        n_it = config.max_iters
        lp0 = _local_problem(sp_local)
        init_cost = jax.lax.psum(_cost(lp0, config.obs_chunk if config.solver == "pcg" else 0), AXIS)

        stats = LMStats(
            costs=jnp.full((n_it + 1,), jnp.nan, dtype).at[0].set(init_cost),
            lams=jnp.full((n_it,), jnp.nan, dtype),
            accepted=jnp.zeros((n_it,), bool),
            grad_inf=jnp.full((n_it,), jnp.nan, dtype),
            step_norms=jnp.full((n_it,), jnp.nan, dtype),
            n_iters=jnp.asarray(0),
            lam_next=jnp.asarray(config.lam0, dtype),
            nu_next=jnp.asarray(2.0, dtype),
            cg_iters=jnp.zeros((n_it,), jnp.int32),
            dc_next=jnp.zeros((lp0.n_cameras, lp0.cam_dof), dtype),
        )
        state = (
            sp_local,
            jnp.asarray(config.lam0, dtype),   # lam
            jnp.asarray(2.0, dtype),           # nu
            init_cost,                          # cost
            jnp.asarray(0),                     # it
            jnp.asarray(False),                 # done
            stats,
        )

        def cond(s):
            return jnp.logical_and(s[4] < n_it, jnp.logical_not(s[5]))

        use_cm = config.solver == "dense" and config.layout in ("cm", "auto")

        def body(s):
            from pysfm_tpu.problem import cm
            from pysfm_tpu.solver import schur_cm

            spl, lam, nu, cost0, it, _, st = s
            lp = _local_problem(spl)
            if config.solver == "pcg":
                from pysfm_tpu.solver import pcg, scale

                eqs = scale.build_normal_equations_scale(lp, config.obs_chunk)
                g_c_glob = jax.lax.psum(eqs.g_c, AXIS)
                grad_inf = jnp.maximum(
                    jnp.max(jnp.abs(g_c_glob)),
                    jax.lax.pmax(jnp.max(jnp.abs(eqs.g_p)), AXIS),
                )
                dc, dp = pcg.solve_step_pcg(
                    eqs, lam, lp.obs_cam, lp.obs_pt,
                    tol=config.cg_tol, max_iters=config.cg_iters,
                    axis_name=AXIS,
                    pt_obsT=lp.pt_obs.T, pt_obs_maskT=lp.pt_obs_mask.T,
                    cam_obs=lp.cam_obs, cam_obs_mask=lp.cam_obs_mask,
                )
            elif use_cm:
                rt, Jct, Jpt, wt = cm.residuals_and_jacobians_rows(lp)
                eqs = schur_cm.build_normal_equations_cm(
                    rt, Jct, Jpt, wt, lp.obs_cam, lp.pt_obs, lp.pt_obs_mask,
                    lp.n_cameras,
                )
                grad_inf = schur_cm.grad_inf_cm(eqs, axis_name=AXIS)
                dc, dp = schur_cm.solve_step_cm(
                    eqs, lam, lp.obs_cam, lp.obs_pt,
                    lp.pt_obs, lp.pt_obs_mask, axis_name=AXIS,
                )
            else:
                r, J_cam, J_pt, w = problem_mod.residuals_and_jacobians(lp)
                eqs = schur.build_normal_equations(
                    r, J_cam, J_pt, w, lp.obs_cam, lp.obs_pt,
                    lp.n_cameras, lp.n_points,
                    pt_obsT=lp.pt_obs.T, pt_obs_maskT=lp.pt_obs_mask.T,
                )
                g_c_glob = jax.lax.psum(eqs.g_c, AXIS)
                grad_inf = jnp.maximum(
                    jnp.max(jnp.abs(g_c_glob)),
                    jax.lax.pmax(jnp.max(jnp.abs(eqs.g_p)), AXIS),
                )
                dc, dp = schur.solve_step_dense(
                    eqs, lam, lp.obs_cam, lp.obs_pt, axis_name=AXIS,
                    pt_obsT=lp.pt_obs.T, pt_obs_maskT=lp.pt_obs_mask.T,
                )
            cand = problem_mod.apply_update(lp, dc, dp)
            new_cost = jax.lax.psum(_cost(cand, config.obs_chunk if config.solver == "pcg" else 0), AXIS)
            if config.solver == "pcg":
                from pysfm_tpu.solver import scale

                pred = scale.predicted_reduction_scale(
                    eqs, lam, dc, dp, axis_name=AXIS
                )
            elif use_cm:
                pred = schur_cm.predicted_reduction_cm(
                    eqs, lam, dc, dp, axis_name=AXIS
                )
            else:
                pred = schur.predicted_reduction(
                    eqs, lam, dc, dp, axis_name=AXIS
                )
            actual = cost0 - new_cost
            rho = actual / jnp.maximum(pred, jnp.finfo(dtype).tiny)

            ok = jnp.logical_and(jnp.isfinite(new_cost), actual > 0)
            ok = jnp.logical_and(ok, pred > 0)

            factor = jnp.maximum(
                jnp.asarray(1.0 / 3.0, dtype), 1.0 - (2.0 * rho - 1.0) ** 3
            )
            lam_next = jnp.where(
                ok,
                jnp.clip(lam * factor, config.lam_min, config.lam_max),
                jnp.clip(lam * nu, config.lam_min, config.lam_max),
            )
            nu_next = jnp.where(ok, jnp.asarray(2.0, dtype), nu * 2.0)

            keep = lambda a, b: jnp.where(ok, a, b)
            spl_next = spl.replace(
                R=keep(cand.R, spl.R),
                t=keep(cand.t, spl.t),
                intr=keep(cand.intr, spl.intr),
                X=keep(cand.X, spl.X),
            )
            cost_next = jnp.where(ok, new_cost, cost0)

            step_sq = jnp.sum(dc * dc) + jax.lax.psum(jnp.sum(dp * dp), AXIS)
            step_norm = jnp.sqrt(step_sq)
            converged = grad_inf < config.tol_grad
            converged = jnp.logical_or(
                converged,
                jnp.logical_and(ok, actual < config.tol_cost_rel * cost0),
            )
            converged = jnp.logical_or(converged, step_norm < config.tol_step)

            st = st.replace(
                costs=st.costs.at[it + 1].set(cost_next),
                lams=st.lams.at[it].set(lam),
                accepted=st.accepted.at[it].set(ok),
                grad_inf=st.grad_inf.at[it].set(grad_inf),
                step_norms=st.step_norms.at[it].set(step_norm),
                n_iters=it + 1,
            )
            return (spl_next, lam_next, nu_next, cost_next, it + 1, converged, st)

        spl, lam, nu, cost0, it, done, st = jax.lax.while_loop(cond, body, state)
        it_idx = jnp.arange(n_it + 1)
        st = st.replace(
            costs=jnp.where(it_idx <= it, st.costs, cost0),
            lam_next=lam, nu_next=nu,
        )
        # Restore the local shard axis for the sharded out_specs.
        spl = spl.replace(
            X=spl.X[None], pt_mask=spl.pt_mask[None],
            obs_cam=spl.obs_cam[None], obs_pt=spl.obs_pt[None],
            obs_uv=spl.obs_uv[None], obs_w=spl.obs_w[None],
            pt_obs=spl.pt_obs[None], pt_obs_mask=spl.pt_obs_mask[None],
            cam_obs=spl.cam_obs[None], cam_obs_mask=spl.cam_obs_mask[None],
        )
        return spl, st

    return jax.jit(run)(sp)
