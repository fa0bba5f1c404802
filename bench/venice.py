"""BAL/Venice-scale benchmark (BASELINE config 4: 1.7k cams, 1M points,
~5M observations) — the flagship scale target.

Builds a Venice-shaped synthetic problem (window visibility over a camera
ring, Poisson track lengths), solves it with the matrix-free PCG Schur path
(obs-chunked scatter-free build + gathered-domain CG, solver/scale.py +
solver/pcg.py) on one device, and reports iterations/s, the convergence
curve, and device memory (``memory_stats()``).

The whole solve is one on-device ``while_loop`` dispatch; the first call
compiles and runs it, the second is timed.

Run:  python bench/venice.py [--cams 1712] [--points 1000000] [--iters 18]
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
    import jax

    from pysfm_tpu.pipeline.synthetic import make_venice_scene
    from pysfm_tpu.solver import solve
    from pysfm_tpu.utils import enable_compilation_cache
    from pysfm_tpu.utils.config import venice_pcg_config
    from pysfm_tpu.utils.timing import sync

    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=1712)
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--mean-track", type=float, default=5.0)
    ap.add_argument("--max-track", type=int, default=12)
    ap.add_argument("--iters", type=int, default=18)
    ap.add_argument("--cg-iters", type=int, default=25)
    ap.add_argument("--cg-tol", type=float, default=1e-2)
    ap.add_argument("--forcing", choices=["fixed", "ew"], default="ew",
                    help="CG forcing sequence: 'fixed' runs cg_iters at "
                         "cg_tol every LM iteration; 'ew' is the adaptive "
                         "Eisenstat-Walker schedule")
    ap.add_argument("--q-tol", type=float, default=0.1,
                    help="CG quadratic-model stagnation tolerance "
                         "(0 disables; applies to both forcing modes)")
    ap.add_argument("--precond-terms", type=int, default=1,
                    help=">1 enables the power-series preconditioner")
    ap.add_argument("--obs-chunk", type=int, default=1 << 19)
    ap.add_argument("--noise-px", type=float, default=0.5)
    ap.add_argument("--camera-model", type=str, default="pose",
                    help="pose (6-dof) or bal (9-dof: +f,k1,k2)")
    ap.add_argument("--no-reuse", action="store_true",
                    help="rebuild the linearization every iteration even "
                         "after rejected steps (A/B for "
                         "LMConfig.reuse_linearization)")
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("venice.py: no accelerator found; refusing to time the CPU")
    enable_compilation_cache()

    t0 = time.perf_counter()
    p = make_venice_scene(
        args.cams, args.points, mean_track=args.mean_track,
        max_track=args.max_track, noise_px=args.noise_px,
        camera_model=args.camera_model,
    )
    t_build = time.perf_counter() - t0
    print(f"# scene: C={p.n_cameras} P={p.n_points} M={p.n_obs} "
          f"K={p.pt_obsT.shape[0]} Kc={p.cam_obs.shape[1]} "
          f"built in {t_build:.1f}s", flush=True)

    cfg = venice_pcg_config(
        args.iters, cg_iters=args.cg_iters, cg_tol=args.cg_tol,
        cg_forcing=args.forcing, cg_q_tol=args.q_tol,
        cg_precond_terms=args.precond_terms, obs_chunk=args.obs_chunk,
        reuse_linearization=not args.no_reuse,
    )
    t0 = time.perf_counter()
    sync(solve(p, cfg))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    solved, stats = solve(p, cfg)
    sync(solved.X3)
    dt = time.perf_counter() - t0

    costs = np.asarray(stats.costs, np.float64)
    n_exec = int(stats.n_iters)
    cg_per_lm = np.asarray(stats.cg_iters)[:n_exec]
    cum_cg = np.concatenate([[0], np.cumsum(cg_per_lm)])
    ms = dev.memory_stats() or {}
    out = {
        "config": "bal_venice",
        "camera_model": args.camera_model,
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "cams": p.n_cameras,
        "points": p.n_points,
        "observations": p.n_obs,
        "iters": n_exec,
        "iters_per_s": n_exec / dt,
        "ms_per_iter": 1e3 * dt / n_exec,
        "accepted": int(np.asarray(stats.accepted).sum()),
        "cost_initial": float(costs[0]),
        "cost_final": float(costs[n_exec]),
        "cg_iters": args.cg_iters,
        "cg_tol": args.cg_tol,
        "forcing": args.forcing,
        "cg_q_tol": args.q_tol,
        "precond_terms": args.precond_terms,
        "cg_iters_per_lm": [int(c) for c in cg_per_lm],
        "total_cg_iters": int(cg_per_lm.sum()),
        # cost after each LM iteration vs cumulative CG iterations spent.
        "cost_vs_cumulative_cg": [
            [int(g), float(c)] for g, c in zip(cum_cg, costs[: n_exec + 1])
        ],
        "reuse_linearization": not args.no_reuse,
        "obs_chunk": args.obs_chunk,
        "scene_build_s": t_build,
        "compile_s": t_first - dt,
        "peak_bytes_in_use": int(ms.get("peak_bytes_in_use", 0)),
        "bytes_limit": int(ms.get("bytes_limit", 0)),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
