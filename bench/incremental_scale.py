"""Incremental-pipeline host-side scaling benchmark (VERDICT r1 item 7).

Runs the incremental driver on a 50-keyframe synthetic sequence and
reports per-keyframe registration wall time.  The claim under test: with
window-extracted BA at bucketed static shapes and per-point parallax
computation, per-keyframe time stays roughly flat as the map grows
(previously: full-problem BA per keyframe + O(F^2 P) parallax checks made
registration cost grow with the whole reconstruction).

Run:  python bench/incremental_scale.py [--frames 50] [--points 2000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from pysfm_tpu.pipeline import (
        IncrementalConfig, incremental, run_incremental, synthetic,
    )
    from pysfm_tpu.utils import metrics

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--points", type=int, default=2000)
    ap.add_argument("--noise-px", type=float, default=0.5)
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the persistent compilation cache")
    args = ap.parse_args()

    cache = None
    if not args.no_cache:
        from pysfm_tpu.utils import enable_compilation_cache

        cache = enable_compilation_cache()

    sc = synthetic.make_scene(
        args.frames, args.points, noise_px=args.noise_px, visibility=0.35,
        seed=13, radius=10.0, dtype=np.float32,
    )
    F, T = sc.truth.n_cameras, sc.truth.n_points
    uv = np.zeros((F, T, 2), np.float32)
    vis = np.zeros((F, T), bool)
    oc = np.asarray(sc.truth.obs_cam)
    op = np.asarray(sc.truth.obs_pt)
    uv[oc, op] = np.asarray(sc.truth.obs_uv)
    vis[oc, op] = True
    intr = np.asarray(sc.truth.intr)

    # Instrument try_register via a timing wrapper on windowed BA calls:
    # simplest robust probe is total wall + per-registration timestamps
    # captured by monkey-taping the driver's solve entry.
    times = []
    orig = incremental.solve

    def timed_solve(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        import jax

        jax.block_until_ready(out[1].costs)
        times.append(time.perf_counter() - t0)
        return out

    incremental.solve = timed_solve
    try:
        t0 = time.perf_counter()
        rec = run_incremental(
            uv, vis, intr, "pose", IncrementalConfig(seed=2)
        )
        total = time.perf_counter() - t0
    finally:
        incremental.solve = orig

    C_gt = np.asarray(metrics.camera_centers(sc.truth.R, sc.truth.t))
    C_est = np.asarray(
        metrics.camera_centers(rec.problem.R, rec.problem.t)
    )
    ate = float(metrics.ate_rmse(np.asarray(C_est), C_gt))

    ba_times = np.asarray(times)
    n = len(ba_times)
    first_q = float(ba_times[: max(n // 4, 1)].mean())
    last_q = float(ba_times[-max(n // 4, 1):].mean())
    out = {
        "config": "incremental_scale",
        "compilation_cache": cache,
        "frames": F,
        "points": T,
        "registered": int(rec.registered.sum()),
        "total_s": round(total, 2),
        "frames_per_s": round(F / total, 3),
        "ate": ate,
        "ba_calls": n,
        "ba_ms_first_quarter": round(1e3 * first_q, 1),
        "ba_ms_last_quarter": round(1e3 * last_q, 1),
        "ba_ms_per_call": [round(1e3 * t, 1) for t in ba_times],
        "stage_timings_s": rec.stats.get("timings_s", {}),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
