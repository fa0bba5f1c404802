"""Multi-host execution-path tests (SURVEY §2 P4, §4).

The real thing — ``jax.distributed`` across processes — exercised with two
CPU subprocesses of 4 virtual devices each, exactly as a 2-host pod launch
would run one process per host.  The invariant is the same as
tests/test_dist.py: the globally-sharded solve must equal the
single-process solve.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pysfm_tpu.pipeline import synthetic
from pysfm_tpu.solver import LMConfig, solve

_WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_solve_matches_single(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"costs{i}.npy") for i in range(2)]
    env = dict(os.environ)
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coord, "2", str(i), outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker timed out")
        logs.append(out.decode(errors="replace"))
    for i, pr in enumerate(procs):
        assert pr.returncode == 0, f"worker {i} failed:\n{logs[i]}"

    # Same scene, single process (this process, 8 virtual devices).
    sc = synthetic.make_scene(8, 100, noise_px=0.4, visibility=0.8, seed=31)
    _, stats_1 = solve(sc.problem, LMConfig(max_iters=20))
    ref = np.asarray(stats_1.costs)
    for path in outs:
        got = np.load(path)
        np.testing.assert_allclose(got, ref, rtol=1e-9)

    # Flagship CM/PCG path across the 2 processes == single-process CM.
    from pysfm_tpu.problem import cm

    cfg_pcg = LMConfig(
        max_iters=10, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
        solver="pcg", cg_iters=30, cg_tol=1e-10,
    )
    _, stats_cm1 = solve(cm.from_problem(sc.problem), cfg_pcg)
    ref_cm = np.asarray(stats_cm1.costs)
    for path in outs:
        got = np.load(path + ".cm.npy")
        np.testing.assert_allclose(got, ref_cm, rtol=1e-8)
        # Camera-axis partition across the 2 processes (r5): the reduced
        # camera system sharded over the host-spanning mesh axis still
        # reproduces the single-process solve.
        got_cam = np.load(path + ".cam.npy")
        np.testing.assert_allclose(got_cam, ref_cm, rtol=1e-8)


def test_initialize_rejects_partial_config(monkeypatch):
    """A half-configured pod launch must fail loudly, not silently degrade
    to a single-process run (VERDICT r1 weak item 6)."""
    from pysfm_tpu.dist import multihost

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    with pytest.raises(RuntimeError, match="partial multi-host"):
        multihost.initialize()
