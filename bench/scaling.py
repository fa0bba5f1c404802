"""Distributed Schur-BA strong-scaling benchmark (BASELINE config 5).

A fixed problem is point-sharded over 1/2/4/... local devices and the fully
on-device LM loop (:func:`pysfm_tpu.dist.solve_sharded`) is timed at each
mesh size.  On the GPUs of one host this is strong scaling over NVLink.  On
a virtual CPU mesh all devices share one host, so speedup is capped at 1.0
by construction and ``t_n_over_t_1`` reads as the distribution overhead
(collectives, replication, padding) of the same shard_map program.

Run:  python bench/scaling.py [--cams 20] [--points 20000]
      XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
          python bench/scaling.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import numpy as np

    from pysfm_tpu import dist
    from pysfm_tpu.utils.timing import sync
    from pysfm_tpu.pipeline import synthetic
    from pysfm_tpu.solver import LMConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=20)
    ap.add_argument("--points", type=int, default=20_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--solver", default="dense", choices=["dense", "pcg"])
    args = ap.parse_args()

    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16) if n <= n_dev]
    sc = synthetic.make_scene(
        args.cams, args.points, noise_px=0.5, visibility=0.3,
        robust="huber", robust_scale=2.0, seed=0, dtype=np.float32,
    )
    cfg = LMConfig(
        max_iters=args.iters, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
        solver=args.solver,
    )

    results = []
    t1 = None
    for n in sizes:
        mesh = dist.make_mesh(n)
        sp = dist.device_put_sharded(dist.shard_problem(sc.problem, n), mesh)
        solved, stats = dist.solve_sharded(sp, mesh, cfg)   # compile+run
        sync(solved)
        t0 = time.perf_counter()
        solved, stats = dist.solve_sharded(sp, mesh, cfg)
        sync(solved)
        dt = time.perf_counter() - t0
        ips = args.iters / dt
        if t1 is None:
            t1 = ips
        eff = ips / (t1 * n)
        results.append({
            "devices": n, "iters_per_s": round(ips, 3),
            "speedup": round(ips / t1, 3), "efficiency": round(eff, 3),
            "final_cost": float(np.asarray(stats.costs)[-1]),
        })
        print(f"n={n:2d}  {ips:8.2f} iters/s  speedup {ips/t1:5.2f}x  "
              f"efficiency {100*eff:5.1f}%")

    dev = jax.devices()[0]
    print(json.dumps({
        "scaling": results,
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "t_n_over_t_1": [
            {"devices": r["devices"],
             "t_n_over_t_1": t1 / r["iters_per_s"]}
            for r in results
        ],
    }))


if __name__ == "__main__":
    main()
