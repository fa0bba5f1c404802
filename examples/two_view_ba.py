"""Two-view bundle adjustment on a synthetic scene (BASELINE config 1).

Reference analog: pysfm's built-in two-camera test scene driven through
``BundleAdjuster.optimize`` (SURVEY §3.1, §4). Here the whole LM loop —
residuals, analytic Jacobians, Schur solve, trust-region control — runs
on device inside one ``lax.while_loop`` dispatch.

Run:  python3 examples/two_view_ba.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

from pysfm_tpu.pipeline import synthetic
from pysfm_tpu.solver import LMConfig, solve
from pysfm_tpu.utils import metrics

NOISE_PX = 0.5

scene = synthetic.make_scene(
    2, 100, noise_px=NOISE_PX, perturb_rot=0.05, perturb_trans=0.1,
    perturb_point=0.1, seed=0,
)
print(f"problem: {scene.problem.n_cameras} cams, "
      f"{scene.problem.n_points} pts, {scene.problem.n_obs} obs")

solved, stats = solve(scene.problem, LMConfig(max_iters=30))

rmse = metrics.reprojection_rmse(solved)
print(f"cost {float(stats.costs[0]):.2f} -> {float(stats.costs[-1]):.4f} "
      f"in {int(stats.n_iters)} iters "
      f"({int(np.asarray(stats.accepted).sum())} accepted)")
print(f"final reprojection RMSE {rmse:.4f} px "
      f"(noise floor ~{NOISE_PX} px)")
assert rmse < 2.0 * NOISE_PX, "did not reach the noise floor"
print("OK")
