"""At-scale I/O loop: BAL text file -> C++ tokenizer -> CM layout -> PCG
solve -> mid-solve CM checkpoint -> resume -> equality.

Prints one JSON line with the timings and the resumed-vs-straight cost
comparison (``--out`` also writes it to a file).

Run:  python bench/io_scale.py [--cams 428] [--points 125000]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from pysfm_tpu.io import (
        load_bal, load_checkpoint_cm, save_bal, save_checkpoint_cm,
    )
    from pysfm_tpu.io.native import have_native
    from pysfm_tpu.pipeline import synthetic
    from pysfm_tpu.solver import LMConfig
    from pysfm_tpu.solver.lm import solve, solve_segmented
    from pysfm_tpu.utils.timing import sync

    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=428)
    ap.add_argument("--points", type=int, default=125_000)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--cg-iters", type=int, default=25)
    ap.add_argument("--out", type=str, default="")
    args = ap.parse_args()

    dev = jax.devices()[0]
    # 1. Synthesize a BAL-convention scene and write it as a BAL text file.
    sc = synthetic.make_bal_scene(
        args.cams, args.points, mean_track=5.0, max_track=12, noise_px=0.5,
        camera_model="bal", seed=4, dtype=np.float32, with_truth=False,
        layout="std",
    )
    tmpdir = tempfile.mkdtemp(prefix="pysfm_io_scale_")
    bal_path = os.path.join(tmpdir, "scene.bal")
    t0 = time.perf_counter()
    save_bal(bal_path, sc.problem)
    t_save = time.perf_counter() - t0
    size_mb = os.path.getsize(bal_path) / 1e6

    # 2. Load through the C++ tokenizer straight into the CM layout.
    t0 = time.perf_counter()
    cmp = load_bal(
        bal_path, layout="cm", dtype=np.float32,
        robust="huber", robust_scale=2.0,
    )
    t_load = time.perf_counter() - t0

    # 3. PCG solve, straight through.
    cfg = LMConfig(
        max_iters=args.iters, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0,
        solver="pcg", cg_iters=args.cg_iters, cg_tol=1e-2,
    )
    t0 = time.perf_counter()
    p_full, st_full = solve_segmented(cmp, cfg, iters_per_dispatch=6)
    sync(p_full.X3)
    t_solve = time.perf_counter() - t0

    # 4. Half solve -> checkpoint -> load -> resume; tail must match.
    half = args.iters // 2
    cfg_half = dataclasses.replace(cfg, max_iters=half)
    p_half, st_half = solve_segmented(cmp, cfg_half, iters_per_dispatch=6)
    ck_path = os.path.join(tmpdir, "ckpt.npz")
    t0 = time.perf_counter()
    save_checkpoint_cm(
        ck_path, p_half,
        lam=float(st_half.lam_next), nu=float(st_half.nu_next),
        iteration=half,
    )
    t_ckpt = time.perf_counter() - t0
    t0 = time.perf_counter()
    cmp_r, lam_r, nu_r, it_r = load_checkpoint_cm(ck_path)
    t_restore = time.perf_counter() - t0
    p_res, st_res = solve(cmp_r, cfg_half, lam_init=lam_r, nu_init=nu_r)
    c_full = np.asarray(st_full.costs, np.float64)
    c_res = np.asarray(st_res.costs, np.float64)
    tail = c_full[half + 1:]
    resumed = c_res[1: 1 + len(tail)]
    rel = float(np.max(np.abs(resumed - tail) / tail))
    ok = rel < 1e-5

    out = {
        "config": "io_scale",
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "cams": cmp.n_cameras,
        "points": cmp.n_points,
        "observations": cmp.n_obs,
        "native_tokenizer": have_native(),
        "bal_file_mb": round(size_mb, 1),
        "save_bal_s": round(t_save, 2),
        "load_bal_cm_s": round(t_load, 2),
        "solve_s": round(t_solve, 2),
        "checkpoint_save_s": round(t_ckpt, 2),
        "checkpoint_load_s": round(t_restore, 2),
        "cost_initial": float(c_full[0]),
        "cost_final_straight": float(c_full[-1]),
        "cost_final_resumed": float(c_res[len(tail)]),
        "resume_tail_rel_err": rel,
        "resume_equality_ok": ok,
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
