"""Distributed CM flagship path (dist/sharded_cm.py).

SURVEY §4 invariant: the sharded Schur solve must equal the single-device
solve on the same problem: tightly in f64, and to f32 roundoff in f32
(where only the cross-shard summation order differs).
"""

import numpy as np
import pytest

from pysfm_tpu import dist
from pysfm_tpu.pipeline import synthetic
from pysfm_tpu.solver import LMConfig
from pysfm_tpu.solver.lm import solve


def _bal_cm(dtype, seed=3, C=8, P=500, camera_model="pose"):
    return synthetic.make_bal_scene(
        C, P, mean_track=4.0, max_track=8, noise_px=0.5, seed=seed,
        dtype=dtype, with_truth=False, layout="cm",
        camera_model=camera_model,
    ).problem


def _cfg(**kw):
    base = dict(
        max_iters=3, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
        solver="pcg", cg_iters=20, cg_tol=1e-8,
    )
    base.update(kw)
    return LMConfig(**base)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_cm_xla_matches_single_f64(n_shards):
    """f64 XLA-table CM solve: sharded == single-chip (tight)."""
    cmp = _bal_cm(np.float64)
    cfg = _cfg()
    p_ref, st_ref = solve(cmp, cfg)
    mesh = dist.make_mesh(n_shards)
    scm = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, n_shards), mesh)
    out, st = dist.solve_sharded_cm(scm, mesh, cfg)
    np.testing.assert_allclose(
        np.asarray(st.costs), np.asarray(st_ref.costs), rtol=1e-9
    )
    merged = dist.unshard_cm(out, cmp)
    np.testing.assert_allclose(
        np.asarray(merged.X3), np.asarray(p_ref.X3), rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(merged.R), np.asarray(p_ref.R), rtol=1e-7, atol=1e-10
    )


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_cm_camera_axis_matches_single_f32(n_shards):
    """f32 BAL-model solve with points AND cameras sharded: sharded ==
    single-device.  The per-observation products are identical; only the
    cross-shard summation order differs, so costs agree to f32 roundoff
    (a one-device mesh runs the same collectives as identity routing)."""
    cmp = _bal_cm(np.float32, camera_model="bal")
    cfg = _cfg(cg_tol=1e-6)
    p_ref, st_ref = solve(cmp, cfg)
    mesh = dist.make_mesh(n_shards)
    scm = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, n_shards), mesh)
    out, st = dist.solve_sharded_cm(scm, mesh, cfg, cam_axis=True)
    np.testing.assert_allclose(
        np.asarray(st.costs), np.asarray(st_ref.costs), rtol=1e-3
    )
    merged = dist.unshard_cm(out, cmp)
    np.testing.assert_allclose(
        np.asarray(merged.X3), np.asarray(p_ref.X3), rtol=2e-2, atol=2e-3
    )


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_cm_ew_forcing_matches_single_f64(n_shards):
    """Adaptive forcing in the distributed loop: eta is computed from
    psum'd quantities, so chips stay in lockstep and the sharded solve
    still equals the single-chip one — including the per-iteration CG
    counts (the forcing sequence itself must be identical)."""
    cmp = _bal_cm(np.float64)
    cfg = _cfg(max_iters=5, cg_forcing="ew", cg_q_tol=0.1, cg_tol=1e-6)
    _, st_ref = solve(cmp, cfg)
    mesh = dist.make_mesh(n_shards)
    scm = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, n_shards), mesh)
    _, st = dist.solve_sharded_cm(scm, mesh, cfg)
    np.testing.assert_allclose(
        np.asarray(st.costs), np.asarray(st_ref.costs), rtol=1e-9
    )
    np.testing.assert_array_equal(
        np.asarray(st.cg_iters), np.asarray(st_ref.cg_iters)
    )


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_cm_camera_axis_matches_single_f64(n_shards):
    """Camera-axis partitioning (points AND cameras sharded over the 1-D
    mesh): the camera-sharded reduced solve must equal the single-chip
    solve to f64 tightness — psum_scatter routes per-chip partials to
    owner chips and the all-gathered iterate reproduces the replicated
    matvec exactly up to summation order (C=8 deliberately does not
    divide 4 shards evenly: pad rows must stay exactly zero)."""
    cmp = _bal_cm(np.float64)
    cfg = _cfg(max_iters=4)
    _, st_ref = solve(cmp, cfg)
    mesh = dist.make_mesh(n_shards)
    scm = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, n_shards), mesh)
    out, st = dist.solve_sharded_cm(scm, mesh, cfg, cam_axis=True)
    np.testing.assert_allclose(
        np.asarray(st.costs), np.asarray(st_ref.costs), rtol=1e-9
    )
    np.testing.assert_array_equal(
        np.asarray(st.cg_iters), np.asarray(st_ref.cg_iters)
    )


def test_sharded_cm_warm_start_lockstep():
    """CG warm start stays in lockstep across shards (replicated dc)."""
    cmp = _bal_cm(np.float64, seed=11, C=6, P=320)
    cfg = _cfg(max_iters=4, cg_warm_start=True)
    p_ref, st_ref = solve(cmp, cfg)
    mesh = dist.make_mesh(2)
    scm = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, 2), mesh)
    _, st = dist.solve_sharded_cm(scm, mesh, cfg)
    np.testing.assert_allclose(
        np.asarray(st.costs), np.asarray(st_ref.costs), rtol=1e-9
    )
