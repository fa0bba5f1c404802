"""The two matrix-free routes of solver/pcg.py against a materialized S.

``build_pcg_system`` and ``schur_matvec`` take the fenced gathered-table
route when visibility tables are passed and the ``segment_sum`` route
otherwise.  Both must reproduce the dense reduced camera system of
``schur.reduce_dense`` (f64, tight): the reduced rhs, the exact
block-Jacobi preconditioner (the inverse of S's diagonal blocks) and S x.
Every camera model, at a few-camera, a many-camera and a many-point shape.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from pysfm_tpu.pipeline import synthetic
from pysfm_tpu.problem import problem as problem_mod
from pysfm_tpu.solver import pcg, schur

MODELS = ["pose", "pose_k", "bal"]
SHAPES = [(5, 40), (300, 700), (130, 3000)]


@functools.lru_cache(maxsize=None)
def _systems(model, C, P):
    p = synthetic.make_bal_scene(
        C, P, mean_track=4.0, max_track=min(8, C), noise_px=0.5,
        camera_model=model, robust="huber", robust_scale=2.0, seed=C + P,
        dtype=np.float64, with_truth=False,
    ).problem
    r, J_cam, J_pt, w = problem_mod.residuals_and_jacobians(p)
    eqs = schur.build_normal_equations(
        r, J_cam, J_pt, w, p.obs_cam, p.obs_pt, p.n_cameras, p.n_points
    )
    lam = jnp.asarray(1e-2, p.dtype)
    dense = schur.reduce_dense(eqs, lam, p.obs_cam, p.obs_pt)
    table = pcg.build_pcg_system(
        eqs, lam, p.obs_cam, p.obs_pt,
        pt_obsT=p.pt_obs.T, pt_obs_maskT=p.pt_obs_mask.T,
        cam_obs=p.cam_obs, cam_obs_mask=p.cam_obs_mask,
    )
    seg = pcg.build_pcg_system(eqs, lam, p.obs_cam, p.obs_pt)
    assert table.Bp is not None and table.B_cm is None
    assert seg.Bp is None and seg.B_cm is not None
    return dense, table, seg


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * np.abs(b).max())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("model", MODELS)
def test_build_pcg_system_routes_match_dense(model, shape):
    dense, table, seg = _systems(model, *shape)
    C, cp = table.Hcc_aug.shape[:2]
    rhs = np.asarray(dense.rhs).reshape(C, cp).T
    S = np.asarray(dense.S).reshape(C, cp, C, cp)
    diag_inv = np.linalg.inv(S[np.arange(C), :, np.arange(C), :])
    for sys_ in (table, seg):
        _close(sys_.rhs, rhs)
        _close(sys_.M_inv, diag_inv)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("model", MODELS)
def test_schur_matvec_routes_match_dense(model, shape):
    dense, table, seg = _systems(model, *shape)
    C, cp = table.Hcc_aug.shape[:2]
    x = np.random.default_rng(C).standard_normal((C, cp))
    y = (np.asarray(dense.S) @ x.reshape(-1)).reshape(C, cp).T
    for sys_ in (table, seg):
        _close(pcg.schur_matvec(sys_, jnp.asarray(x.T)), y)
