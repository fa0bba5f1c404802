"""Subprocess worker for the multi-host test (SURVEY §4: "Multi-host logic
testable with multiple processes on CPU via jax.distributed.initialize").

Spawned by tests/test_multihost.py, one process per fake "host", each with
a 4-device virtual CPU mesh (2 procs x 4 devices = 8 global).  Builds the
same deterministic scene, joins the global runtime, runs the sharded solve
over the global mesh, and writes the replicated per-iteration costs to
OUT_PATH for the parent to compare against the single-process solve.

Usage: python _multihost_worker.py <coord_addr> <num_procs> <proc_id> <out>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

coord, n_procs, proc_id, out_path = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
)

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
# Parent may have set device_count=8; force this worker to 4.
flags = " ".join(
    f for f in flags.split() if "host_platform_device_count" not in f
)
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from pysfm_tpu import dist  # noqa: E402
from pysfm_tpu.dist import multihost  # noqa: E402
from pysfm_tpu.pipeline import synthetic  # noqa: E402
from pysfm_tpu.solver import LMConfig  # noqa: E402

multihost.initialize(
    coordinator_address=coord, num_processes=n_procs, process_id=proc_id
)
assert jax.process_count() == n_procs, jax.process_count()
assert len(jax.devices()) == 4 * n_procs, len(jax.devices())

sc = synthetic.make_scene(8, 100, noise_px=0.4, visibility=0.8, seed=31)
mesh = multihost.global_mesh()
sp = multihost.shard_problem_multihost(sc.problem, mesh)
cfg = LMConfig(max_iters=20)
solved, stats = dist.solve_sharded(sp, mesh, cfg)

# stats are fully replicated -> addressable on every process.
costs = np.asarray(jax.device_get(stats.costs))
np.save(out_path, costs)

# Flagship layout across hosts: the component-major + PCG path
# (dist/sharded_cm.py) over the same global mesh — SURVEY §2 P4
# ("map blocks partitioned across hosts", same solver as one chip).
from pysfm_tpu.problem import cm  # noqa: E402

cmp = cm.from_problem(sc.problem)
cfg_pcg = LMConfig(
    max_iters=10, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
    solver="pcg", cg_iters=30, cg_tol=1e-10,
)
scm = multihost.shard_cm_problem_multihost(cmp, mesh)
out_cm, stats_cm = dist.solve_sharded_cm(scm, mesh, cfg_pcg)
np.save(out_path + ".cm.npy", np.asarray(jax.device_get(stats_cm.costs)))

# Camera-axis partition across hosts: the reduced camera system sharded
# over the global (host-spanning) mesh axis — SURVEY §2 P4, "keyframes ...
# partitioned" (r5): psum_scatter / all_gather ride the same mesh.
_, stats_cam = dist.solve_sharded_cm(scm, mesh, cfg_pcg, cam_axis=True)
np.save(
    out_path + ".cam.npy", np.asarray(jax.device_get(stats_cam.costs))
)
jax.distributed.shutdown()
