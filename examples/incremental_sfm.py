"""Incremental SfM on a 10-keyframe synthetic sequence (BASELINE config 2).

Reference analog: the ``sequence``-style driver scripts (SURVEY §3.3) —
two-view bootstrap, next-best-view PnP registration, triangulation of new
tracks, windowed bundle adjustment. Host orchestrates; all inner math is
batched device dispatches with pow2 shape buckets so the whole run
compiles a handful of programs.

Run:  python3 examples/incremental_sfm.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

from pysfm_tpu.pipeline import IncrementalConfig, run_incremental, synthetic
from pysfm_tpu.utils import metrics

# Ground-truth scene -> dense track table (uv, vis), as a tracker would
# produce (pipeline/tracks.py builds the same table from raw images).
scene = synthetic.make_scene(
    10, 300, noise_px=0.3, visibility=0.85, seed=13, radius=10.0
)
truth = scene.truth
uv = np.zeros((truth.n_cameras, truth.n_points, 2))
vis = np.zeros((truth.n_cameras, truth.n_points), bool)
for m in range(truth.n_obs):
    f, tr = int(truth.obs_cam[m]), int(truth.obs_pt[m])
    uv[f, tr] = np.asarray(truth.obs_uv[m])
    vis[f, tr] = True

rec = run_incremental(
    uv, vis, np.asarray(truth.intr), "pose", IncrementalConfig(seed=2)
)

C_gt = np.asarray(metrics.camera_centers(truth.R, truth.t))
C_est = np.asarray(metrics.camera_centers(rec.problem.R, rec.problem.t))
ate = float(metrics.ate_rmse(C_est, C_gt))
print(f"registered {int(rec.registered.sum())}/{len(rec.registered)} frames, "
      f"{int(rec.has_point.sum())} points triangulated")
print(f"ATE (Sim(3)-aligned) {ate:.5f} on a radius-10 scene; "
      f"reprojection RMSE {metrics.reprojection_rmse(rec.problem):.3f} px")
assert rec.registered.all() and ate < 2e-2
print("OK")
