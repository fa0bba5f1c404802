"""On-card timings of the two Schur-matvec routes of ``solver/pcg.py``.

The fenced gathered-table route and the ``segment_sum`` route, per S-matvec
and per LM-iteration linear solve (system build + 25 CG iterations +
back-substitution), at the Venice shape and the robust 50-camera /
10k-point scene, with the bytes each matvec must move (PERF.md, "Kernel
findings").

A and B are timed in alternation (A B B A ...) inside one process on one
card.  Every figure is the mean over ``--reps`` warm calls on the host
clock, fenced by a device->host copy.  Also measured: a large f32 copy, as
the card's achievable bandwidth next to the 3.35 TB/s data-sheet peak.

Run:  python bench/kernel_findings.py [--out chiprun_out/kernel_findings.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_PEAK = 3.35e12  # H100 SXM data sheet, bytes/s


def _timer(reps):
    from pysfm_tpu.utils.timing import sync

    def run(fn, *args):
        sync(fn(*args))                     # compile + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        sync(out)
        return (time.perf_counter() - t0) / reps

    return run


def ab(timer, fa, fb, args_a, args_b, rounds=2):
    """Alternate A and B (A B B A ...); mean seconds of each."""
    ta, tb = [], []
    for r in range(rounds):
        if r % 2 == 0:
            ta.append(timer(fa, *args_a))
            tb.append(timer(fb, *args_b))
        else:
            tb.append(timer(fb, *args_b))
            ta.append(timer(fa, *args_a))
    return float(np.mean(ta)), float(np.mean(tb))


def matvec_bytes(route, cp, C, P, M, K, Kc):
    """Bytes one S-matvec must read and write from device memory.

    table: Bp [3cp, K, P] + camg [K, P] + the gathered iterate
      [cp, K, P] (written, then read) + Bg [3cp, C, Kc] + ptg [C, Kc] + the
      gathered point vector [3, C, Kc] (written, then read) + hinv6 and the
      [3, P] point vectors.
    segment_sum: B_cm [3cp, M] twice (Hcp^T x and Hcp w) + obs_cam and
      obs_pt twice + the per-observation products [3, M] and [cp, M]
      (written, then read by the scatter) + hinv6 and the point vectors.
    """
    f = 4
    vec = (6 + 3 * 3) * P * f
    if route == "table":
        return (3 * cp * K * P + K * P + 2 * cp * K * P
                + 3 * cp * C * Kc + C * Kc + 2 * 3 * C * Kc) * f + vec
    return (2 * 3 * cp * M + 2 * 2 * M + 2 * (3 + cp) * M) * f + vec


def route_case(timer, cmp, cg_iters=25):
    import jax
    import jax.numpy as jnp

    from pysfm_tpu.solver import pcg, scale

    eqs = scale.build_normal_equations_scale_cm(cmp, 1 << 19)
    lam = jnp.asarray(1e-3, jnp.float32)
    tables = dict(pt_obsT=cmp.pt_obsT, pt_obs_maskT=cmp.pt_obs_maskT,
                  cam_obs=cmp.cam_obs, cam_obs_mask=cmp.cam_obs_mask)

    def build(e, with_tables):
        kw = tables if with_tables else {}
        return pcg.build_pcg_system(e, lam, cmp.obs_cam, cmp.obs_pt, **kw)

    def step(e, with_tables):
        s = jax.lax.optimization_barrier(build(e, with_tables))
        dc = pcg.pcg_solve(s, tol=0.0, max_iters=cg_iters)
        return dc, pcg.back_substitute(s, dc)

    sys_t = jax.jit(lambda e: build(e, True))(eqs)
    sys_s = jax.jit(lambda e: build(e, False))(eqs)
    x = jnp.ones_like(sys_t.rhs)
    mv = jax.jit(pcg.schur_matvec)
    mv_t, mv_s = ab(timer, mv, mv, (sys_t, x), (sys_s, x))
    del sys_t, sys_s
    st_t, st_s = ab(
        timer,
        jax.jit(lambda e: step(e, True)), jax.jit(lambda e: step(e, False)),
        (eqs,), (eqs,),
    )
    cp, C, P, M = cmp.cam_dof, cmp.n_cameras, cmp.n_points, cmp.n_obs
    K, Kc = cmp.pt_obsT.shape[0], cmp.cam_obs.shape[1]
    out = {"C": C, "P": P, "M": M, "K": K, "Kc": Kc, "cp": cp,
           "cg_iters_per_step": cg_iters}
    for name, t_mv, t_st in (("table", mv_t, st_t),
                             ("segment_sum", mv_s, st_s)):
        b = matvec_bytes(name, cp, C, P, M, K, Kc)
        out[name] = {
            "matvec_s": t_mv, "linear_solve_step_s": t_st,
            "matvec_bytes": b, "matvec_bytes_per_s": b / t_mv,
            "matvec_share_of_3.35TBps": b / t_mv / HBM_PEAK,
        }
    return out


def main():
    import jax
    import jax.numpy as jnp

    from pysfm_tpu.pipeline import synthetic
    from pysfm_tpu.problem import cm
    from pysfm_tpu.utils import enable_compilation_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=str,
                    default="chiprun_out/kernel_findings.json")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("kernel_findings.py: no accelerator found")
    enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"# {smi}; jax {jax.__version__}", flush=True)
    timer = _timer(args.reps)
    res = {"nvidia_smi": smi, "device_kind": dev.device_kind,
           "reps": args.reps}

    # Achievable bandwidth: a 1 GiB f32 copy (read + write).
    big = jnp.ones((1 << 28,), jnp.float32)
    t = timer(jax.jit(lambda a: a * 1.0000001), big)
    res["copy_1GiB_bytes_per_s"] = 2 * big.size * 4 / t
    del big
    print(f"# copy: {res['copy_1GiB_bytes_per_s'] / 1e12:.3f} TB/s",
          flush=True)

    robust = synthetic.make_scene(
        50, 10_000, noise_px=0.5, outlier_frac=0.05, outlier_px=40.0,
        visibility=0.3, robust="huber", robust_scale=2.0, seed=42,
        dtype=np.float32,
    ).problem
    venice = synthetic.make_venice_scene()

    res["routes_venice"] = route_case(timer, venice)
    print("# routes venice", json.dumps(res["routes_venice"]), flush=True)
    res["routes_50_10k"] = route_case(timer, cm.from_problem(robust))
    print("# routes 50/10k", json.dumps(res["routes_50_10k"]), flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
