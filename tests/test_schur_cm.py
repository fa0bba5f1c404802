"""Component-major solver path (solver/schur_cm.py) equality tests.

The cm path is the dense solver's default layout; its math must match the
standard-layout path (itself verified against the NumPy oracle and an
explicit full-H solve) to f64 roundoff.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pysfm_tpu.pipeline import synthetic
from pysfm_tpu.problem import problem as problem_mod
from pysfm_tpu.solver import LMConfig, schur, schur_cm, solve


def _eqs_pair(p):
    r, Jc, Jp, w = problem_mod.residuals_and_jacobians(p)
    M = p.n_obs
    eqs0 = schur.build_normal_equations(
        r, Jc, Jp, w, p.obs_cam, p.obs_pt, p.n_cameras, p.n_points,
        pt_obs=p.pt_obs, pt_obs_mask=p.pt_obs_mask,
    )
    eqs1 = schur_cm.build_normal_equations_cm(
        r.T, Jc.reshape(M, -1).T, Jp.reshape(M, 6).T, w,
        p.obs_cam, p.pt_obs, p.pt_obs_mask, p.n_cameras,
    )
    return eqs0, eqs1


@pytest.mark.parametrize("model", ["pose", "bal"])
def test_normal_equations_match(rng, model):
    sc = synthetic.make_scene(
        6, 80, camera_model=model, noise_px=1.0, outlier_frac=0.1,
        outlier_px=20.0, robust="huber", robust_scale=2.0, seed=2,
        dtype=np.float64,
    )
    eqs0, eqs1 = _eqs_pair(sc.problem)
    np.testing.assert_allclose(eqs0.Hcc, eqs1.Hcc, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(eqs0.g_c, eqs1.g_c, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(eqs0.g_p, eqs1.g_p.T, rtol=1e-9, atol=1e-9)
    for i, (a, b) in enumerate(schur_cm._TRI):
        np.testing.assert_allclose(
            eqs0.Hpp[:, a, b], eqs1.hpp6[i], rtol=1e-9, atol=1e-9
        )


def test_solve_step_matches(rng):
    sc = synthetic.make_scene(
        6, 80, noise_px=1.0, seed=3, robust="cauchy", robust_scale=3.0,
        dtype=np.float64,
    )
    p = sc.problem
    eqs0, eqs1 = _eqs_pair(p)
    lam = jnp.float64(1e-3)
    dc0, dp0 = schur.solve_step_dense(
        eqs0, lam, p.obs_cam, p.obs_pt,
        pt_obs=p.pt_obs, pt_obs_mask=p.pt_obs_mask,
    )
    dc1, dp1 = schur_cm.solve_step_cm(
        eqs1, lam, p.obs_cam, p.obs_pt, p.pt_obs, p.pt_obs_mask,
    )
    np.testing.assert_allclose(dc0, dc1, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(dp0, dp1, rtol=1e-9, atol=1e-12)
    pr0 = schur.predicted_reduction(eqs0, lam, dc0, dp0)
    pr1 = schur_cm.predicted_reduction_cm(eqs1, lam, dc1, dp1)
    np.testing.assert_allclose(pr0, pr1, rtol=1e-9)


def test_full_lm_solve_matches(rng):
    sc = synthetic.make_scene(
        8, 300, noise_px=0.8, outlier_frac=0.05, outlier_px=20.0,
        robust="huber", robust_scale=2.0, seed=4, dtype=np.float64,
    )
    p = sc.problem
    _, st_std = solve(p, LMConfig(max_iters=15, layout="std"))
    _, st_cm = solve(p, LMConfig(max_iters=15, layout="cm"))
    c0 = np.asarray(st_std.costs)
    c1 = np.asarray(st_cm.costs)
    np.testing.assert_allclose(c0, c1, rtol=1e-9)
