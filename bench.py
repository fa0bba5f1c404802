"""Benchmark entry point: prints ONE JSON line.

Metric: BA iterations/s on the robust-BA config from BASELINE.json ("50
cams, 10k points, Huber + outlier matches"), full LM iterations of the
component-major PCG path (residual+Jacobian build, normal equations,
preconditioned CG on the reduced camera system, back-substitution,
retraction, candidate cost + trust-region update) with tolerances zeroed
so every run executes exactly ``ITERS`` iterations.

``vs_baseline``: speedup of this framework over a reference-style
pure-NumPy per-measurement LM implementation (tests/oracle_numpy.py — the
stand-in for pysfm, which is itself a per-measurement NumPy codebase;
SURVEY §0/§6: the reference publishes no numbers) measured as
BA-iterations/s ratio on pysfm's own two-view test-scene shape (2 cameras,
100 points, BASELINE config 1).

Every figure is one warm run timed on the host clock around work that
ends in a device->host copy.  The JSON names the device it ran on; with
no accelerator the script exits non-zero instead of timing the CPU.

Run:  python bench.py
"""

import json
import os
import sys
import time

import numpy as np

ITERS = 30


def main():
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pysfm_tpu.utils import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("bench.py: no accelerator found; refusing to time the CPU")
    enable_compilation_cache()
    from pysfm_tpu.pipeline import synthetic
    from pysfm_tpu.solver import LMConfig, solve
    from pysfm_tpu.utils.timing import sync

    def timed(fn):
        t0 = time.perf_counter()
        sync(fn())
        return time.perf_counter() - t0

    # --- main metric: 50 cams / 10k points robust BA, f32 ------------------
    sc = synthetic.make_scene(
        50, 10_000, noise_px=0.5, outlier_frac=0.05, outlier_px=40.0,
        visibility=0.3, robust="huber", robust_scale=2.0, seed=42,
        dtype=np.float32,
    )
    cfg = LMConfig(max_iters=ITERS, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0)
    cfg_main = LMConfig(
        max_iters=ITERS, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
        solver="pcg", cg_iters=25, cg_tol=1e-2,
        cg_forcing="ew", cg_q_tol=0.3,
    )
    compile_s = timed(lambda: solve(sc.problem, cfg_main))
    iters_per_s = ITERS / timed(lambda: solve(sc.problem, cfg_main))

    # --- vs_baseline: two-view scene, jax vs NumPy oracle ------------------
    sc2 = synthetic.make_scene(2, 100, noise_px=0.5, seed=1, dtype=np.float32)
    sync(solve(sc2.problem, cfg))
    jax_two_view = ITERS / timed(lambda: solve(sc2.problem, cfg))

    # --- frames/s: incremental pipeline, BASELINE config 2 -----------------
    # (10 keyframes, 1k points, incremental pose init + windowed BA).  Host
    # orchestrates, device computes (SURVEY §3.3); wall time includes both.
    from pysfm_tpu.pipeline import IncrementalConfig, run_incremental

    sc3 = synthetic.make_scene(
        10, 1_000, noise_px=0.5, visibility=0.85, seed=13, radius=10.0,
        dtype=np.float32,
    )
    F, T = sc3.truth.n_cameras, sc3.truth.n_points
    uv_tab = np.zeros((F, T, 2), np.float32)
    vis_tab = np.zeros((F, T), bool)
    oc = np.asarray(sc3.truth.obs_cam)
    op = np.asarray(sc3.truth.obs_pt)
    uv_tab[oc, op] = np.asarray(sc3.truth.obs_uv)
    vis_tab[oc, op] = True
    intr_tab = np.asarray(sc3.truth.intr)
    inc_cfg = IncrementalConfig(seed=2)
    run_incremental(uv_tab, vis_tab, intr_tab, "pose", inc_cfg)  # compile
    t0 = time.perf_counter()
    run_incremental(uv_tab, vis_tab, intr_tab, "pose", inc_cfg)
    frames_per_s = F / (time.perf_counter() - t0)  # warm (in-process caches)

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from oracle_numpy import Oracle

    p2 = sc2.problem
    n_oracle = 3
    oracle = Oracle(
        p2.camera_model,
        np.asarray(p2.R), np.asarray(p2.t), np.asarray(p2.intr),
        np.asarray(p2.X), np.asarray(p2.obs_cam), np.asarray(p2.obs_pt),
        np.asarray(p2.obs_uv),
    )
    t0 = time.perf_counter()
    oracle.optimize(
        max_iters=n_oracle, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0
    )
    oracle_two_view = n_oracle / (time.perf_counter() - t0)

    print(json.dumps({
        "metric": "ba_iters_per_s_50cam_10kpt_robust",
        "value": iters_per_s,
        "unit": "iters/s",
        "vs_baseline": jax_two_view / oracle_two_view,
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "route": "cm+pcg(ew,q=0.3); 30 full LM iterations",
        "compile_s_first_call": compile_s,
        "two_view_iters_per_s": jax_two_view,
        "oracle_two_view_iters_per_s": oracle_two_view,
        "frames_per_s_10kf_1kpt_warm": frames_per_s,
        "timing": "one warm run per figure, host clock, device->host fence",
    }))


if __name__ == "__main__":
    main()
