"""Distributed bundle adjustment over a device mesh (SURVEY §1 L7).

Points (with their observations) AND the camera axis of the reduced
solve are sharded over the mesh; the LM loop is literally the single-device
``cm_lm_loop`` running inside ``shard_map`` with psum'd control scalars,
so every device executes the identical accept/reject sequence. No
reference analog — pysfm is a single NumPy process; this layer is what
this framework adds.

Run on all local GPUs:  python3 examples/distributed_ba.py
Run on 8 virtual CPU devices (the same code path):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python3 examples/distributed_ba.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import jax
import numpy as np

from pysfm_tpu import dist
from pysfm_tpu.pipeline import synthetic
from pysfm_tpu.problem import cm
from pysfm_tpu.solver import LMConfig, solve

n_dev = len(jax.devices())
print(f"devices: {n_dev} x {jax.devices()[0].platform}")
mesh = dist.make_mesh(n_dev)

scene = synthetic.make_scene(
    24, 3000, noise_px=0.5, visibility=0.35, seed=5, dtype=np.float32
)
cmp = cm.from_problem(scene.problem)
cfg = LMConfig(
    max_iters=10, solver="pcg", cg_iters=25, cg_tol=1e-2,
    tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
)

# Shard points + observations (and with cam_axis=True the reduced camera
# system too) over the mesh; solve; gather back.
scm = dist.device_put_sharded_cm(dist.shard_cm_problem(cmp, n_dev), mesh)
out, st_d = dist.solve_sharded_cm(scm, mesh, cfg, cam_axis=True)
solved = dist.unshard_cm(out, cmp)

# Single-device reference: identical control flow, identical trajectory.
_, st_s = solve(cmp, cfg)
cd, cs = np.asarray(st_d.costs), np.asarray(st_s.costs)
rel = float(np.max(np.abs(cd - cs) / np.maximum(np.abs(cs), 1.0)))
print(f"cost {cd[0]:.1f} -> {cd[-1]:.4f} on {n_dev} devices; "
      f"max rel deviation vs single-device trajectory {rel:.2e}")
assert rel < 1e-4
print("OK")
