"""Component-major (CM) layout tests: the BAL-scale fast path must be
numerically identical to the standard-layout math it replaces.

Discipline per SURVEY §4: synthetic ground truth + cross-implementation
equality in f64 (the CPU test platform), so any layout-induced divergence
is a hard failure, not a tolerance question.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pysfm_tpu.geometry import projection
from pysfm_tpu.pipeline import synthetic
from pysfm_tpu.problem import cm, problem as problem_mod
from pysfm_tpu.solver import LMConfig, scale
from pysfm_tpu.solver.lm import solve

MODELS = ("pose", "pose_k", "bal")


def _scene(model, seed=3):
    return synthetic.make_scene(
        6, 200, camera_model=model, noise_px=0.5, visibility=0.7,
        robust="huber", robust_scale=2.0, seed=seed, dtype=np.float64,
    )


@pytest.mark.parametrize("model", MODELS)
def test_project_jac_cm_matches_aos(model):
    """Scalar-unrolled CM projection+Jacobian == AoS projection to f64
    roundoff, for every camera model."""
    p = _scene(model).problem
    cmp = cm.from_problem(p)
    ctab = cm.cam_table(cmp)
    oc, op = p.obs_cam, p.obs_pt
    u, v, Jc, Jp = cm.project_jac_cm(model, ctab[:, oc], cmp.X3[:, op])
    uv_ref, Jc_ref, Jp_ref = projection.project_with_jac(
        model, p.R[oc], p.t[oc], p.intr[oc], p.X[op]
    )
    free = jnp.logical_not(p.cam_fixed)[oc].astype(uv_ref.dtype)
    Jc_ref = Jc_ref * free[:, None, None]
    np.testing.assert_allclose(np.asarray(u), uv_ref[:, 0], atol=1e-10)
    np.testing.assert_allclose(np.asarray(v), uv_ref[:, 1], atol=1e-10)
    cp = projection.CAM_DOF[model]
    for i in range(2):
        for d in range(cp):
            np.testing.assert_allclose(
                np.asarray(Jc[i][d]), np.asarray(Jc_ref[:, i, d]),
                atol=1e-10, err_msg=f"Jc[{i}][{d}]",
            )
        for s in range(3):
            np.testing.assert_allclose(
                np.asarray(Jp[i][s]), np.asarray(Jp_ref[:, i, s]),
                atol=1e-10, err_msg=f"Jp[{i}][{s}]",
            )
    # project_cm (no-jac variant) agrees too.
    u2, v2 = cm.project_cm(model, ctab[:, oc], cmp.X3[:, op])
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v), rtol=1e-14)


@pytest.mark.parametrize("model", MODELS)
def test_cost_scale_cm_matches_plain(model):
    p = _scene(model).problem
    cmp = cm.from_problem(p)
    c_ref = float(problem_mod.cost(p))
    for chunk in (0, 64):
        c_cm = float(scale.cost_scale_cm(cmp, chunk))
        assert abs(c_cm - c_ref) <= 1e-12 * abs(c_ref)


def test_make_cm_problem_matches_from_problem():
    """Host CM builder == device conversion of the standard builder."""
    sc = _scene("pose", seed=7)
    p = sc.problem
    a = dict(
        camera_model=p.camera_model, robust=p.robust,
        robust_scale=float(p.robust_scale), dtype=np.float64,
    )
    cmp_host = cm.make_cm_problem(
        np.asarray(p.R), np.asarray(p.t), np.asarray(p.intr),
        np.asarray(p.X), np.asarray(p.obs_cam), np.asarray(p.obs_pt),
        np.asarray(p.obs_uv), **a,
    )
    cmp_dev = cm.from_problem(p)
    for name in (
        "R", "t", "intr", "X3", "obs_cam", "obs_pt", "u", "v", "obs_w",
        "pt_obsT", "pt_obs_maskT", "cam_obs", "cam_obs_mask", "cam_fixed",
    ):
        np.testing.assert_array_equal(
            np.asarray(getattr(cmp_host, name)),
            np.asarray(getattr(cmp_dev, name)),
            err_msg=name,
        )


def test_solve_cm_matches_bundle_entry_and_dense():
    """solve(CMProblem) == solve(BundleProblem, pcg) exactly, and both land
    on the dense solver's optimum (BASELINE parity-style check)."""
    sc = _scene("pose")
    p = sc.problem
    cmp = cm.from_problem(p)
    cfg_p = LMConfig(
        max_iters=12, solver="pcg", cg_iters=200, cg_tol=1e-12,
        obs_chunk=128, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
    )
    cfg_d = LMConfig(
        max_iters=12, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0
    )
    p1, st1 = solve(p, cfg_p)
    assert isinstance(p1, problem_mod.BundleProblem)
    cm2, st2 = solve(cmp, cfg_p)
    assert isinstance(cm2, cm.CMProblem)
    np.testing.assert_array_equal(np.asarray(st1.costs), np.asarray(st2.costs))
    np.testing.assert_array_equal(np.asarray(p1.X), np.asarray(cm2.X3.T))
    pd, std = solve(p, cfg_d)
    ref = float(std.costs[-1])
    assert abs(float(st1.costs[-1]) - ref) <= 1e-6 * ref


@pytest.mark.parametrize("robust", ["gaussian", "huber", "cauchy"])
@pytest.mark.parametrize("model", ["pose", "pose_k", "bal"])
def test_residuals_and_jacobians_rows_match_std(model, robust):
    """The dense solver's component-major build == the standard-layout
    build, transposed (f64; outliers exercise the robust weights)."""
    from pysfm_tpu.pipeline import synthetic

    p = synthetic.make_scene(
        5, 101, camera_model=model, noise_px=1.0, outlier_frac=0.1,
        outlier_px=30.0, robust=robust, robust_scale=2.0, seed=3,
    ).problem
    r, J_cam, J_pt, w = problem_mod.residuals_and_jacobians(p)
    rt, Jct, Jpt, wt = cm.residuals_and_jacobians_rows(p)
    M = p.n_obs
    for a, b in ((rt, r.T), (Jct, J_cam.reshape(M, -1).T),
                 (Jpt, J_pt.reshape(M, 6).T), (wt, w)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-9
        )
