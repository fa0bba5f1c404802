"""Per-stage roofline accounting (SURVEY §5 "Tracing / profiling").

For each hot stage of the LM iteration this times the jitted stage in
isolation (host clock, device->host fence), counts the bytes it must move
and the FLOPs it must execute from the problem shapes, and reports achieved
GB/s / GFLOP/s against the device's published peak.  Peaks come from the
table below, keyed by ``device_kind``; a device that is not in the table is
an error.

Run:  python bench/roofline.py [--cams 50] [--points 10000] [--vis 0.3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published dense peaks, keyed by a substring of ``device_kind``.  Source:
# NVIDIA H100 SXM data sheet (rates assume the full 700 W power limit).
DEVICE_PEAKS = {
    "H100": {
        "f32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12, "power_w": 700,
    },
}


def device_peaks(dev) -> dict:
    kind = dev.device_kind
    for key, peaks in DEVICE_PEAKS.items():
        if key in kind:
            return peaks
    raise ValueError(
        f"no published peaks for device kind {kind!r}; add a row to "
        "bench/roofline.py DEVICE_PEAKS"
    )


def timeit(fn, *args, n=20, **kw):
    from pysfm_tpu.utils.timing import timeit as _timeit

    return _timeit(fn, *args, n=n, **kw)


def main():
    import jax
    import jax.numpy as jnp

    from pysfm_tpu.pipeline import synthetic
    from pysfm_tpu.problem import problem as problem_mod
    from pysfm_tpu.solver import pcg, schur

    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=50)
    ap.add_argument("--points", type=int, default=10_000)
    ap.add_argument("--vis", type=float, default=0.3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    dev = jax.devices()[0]
    peaks = device_peaks(dev)
    peak_f32 = peaks["f32_flops"] / 1e9          # GFLOP/s
    peak_bw = peaks["hbm_bytes_per_s"] / 1e9     # GB/s

    sc = synthetic.make_scene(
        args.cams, args.points, noise_px=0.5, visibility=args.vis,
        robust="huber", robust_scale=2.0, seed=42, dtype=np.float32,
    )
    p = sc.problem
    C, P, M = p.n_cameras, p.n_points, p.n_obs
    CP = p.cam_dof
    K = p.pt_obs.shape[1]
    f4 = 4  # f32 bytes
    print(f"# device={dev.device_kind} C={C} P={P} M={M} CP={CP} K={K}")
    print(f"# peaks: f32 {peak_f32/1e3:.0f} Tf/s, hbm {peak_bw} GB/s")
    rows = []

    def report(name, dt, flops, bytes_moved):
        gf = flops / dt / 1e9
        gb = bytes_moved / dt / 1e9
        frac_c = gf / peak_f32
        frac_m = gb / peak_bw
        bound = "compute" if frac_c > frac_m else "memory"
        frac = max(frac_c, frac_m)
        rows.append({
            "stage": name, "ms": round(dt * 1e3, 4),
            "gflops": round(gf, 1), "gbps": round(gb, 1),
            "bound": bound, "roofline_frac": round(frac, 3),
        })
        print(f"{name:28s} {dt*1e3:8.3f} ms  {gf:9.1f} GF/s  {gb:8.1f} GB/s"
              f"  {bound:7s}-bound  {100*frac:5.1f}% of roof")

    # --- Stage 1: residual + Jacobian + robust weight build ---------------
    # Traffic: read gathered operands (R 9, t 3, intr I, X 3, uv 2, w 1 per
    # obs) + write (r 2, J_cam 2CP, J_pt 6, w 1).  FLOPs ~ 150/obs (pose
    # chain, dominated by the 3 matvecs + robust weight).
    in_f = 9 + 3 + p.intr.shape[1] + 3 + 2 + 1
    out_f = 2 + 2 * CP + 6 + 1
    bytes_jac = M * (in_f + out_f) * f4
    flops_jac = M * 150

    jac_jax = jax.jit(problem_mod.residuals_and_jacobians)
    report("jac_build/jax", timeit(jac_jax, p, n=args.reps),
           flops_jac, bytes_jac)

    r, J_cam, J_pt, w = jac_jax(p)
    lam = jnp.asarray(1e-4, jnp.float32)

    # --- Stage 2: normal equations ----------------------------------------
    # Traffic: read J (2CP + 6 + 2 + 1 per obs) and the gathered tables,
    # write Hcc/Hpp/g + per-obs B blocks.  FLOPs: Hcc one-hot matmul
    # M*C*(CP^2+CP) + point-side gathers P*K*(9*2*... ) ~ M*(CP^2*2 + 18).
    build = jax.jit(lambda r, Jc, Jp, w: schur.build_normal_equations(
        r, Jc, Jp, w, p.obs_cam, p.obs_pt, C, P,
        pt_obs=p.pt_obs, pt_obs_mask=p.pt_obs_mask))
    flops_ne = M * C * (CP * CP + CP) * 2 + M * (2 * CP * CP + 2 * CP * 3 + 30)
    bytes_ne = (M * (2 * CP + 6 + 3 + CP * 3) + C * CP * CP + P * 9) * f4
    report("normal_eqs", timeit(build, r, J_cam, J_pt, w, n=args.reps),
           flops_ne, bytes_ne)
    eqs = build(r, J_cam, J_pt, w)

    # --- Stage 3: dense-W Schur reduce + Cholesky solve --------------------
    step_dense = jax.jit(lambda eqs, lam: schur.solve_step_dense(
        eqs, lam, p.obs_cam, p.obs_pt,
        pt_obs=p.pt_obs, pt_obs_mask=p.pt_obs_mask))
    A = C * CP
    flops_schur = (
        P * K * C * CP * 3 * 2        # W assembly one-hot matmul
        + P * A * 9 * 2               # Y = W Hppinv
        + P * 3 * A * A * 2           # S = Y W^T
        + A ** 3 / 3                  # Cholesky
    )
    bytes_schur = (2 * P * A * 3 + A * A + P * 9) * f4 * 2
    report("schur_dense+chol", timeit(step_dense, eqs, lam, n=args.reps),
           flops_schur, bytes_schur)

    # --- Stage 4: PCG matvec ------------------------------------------------
    sysm = jax.jit(lambda eqs, lam: pcg.build_pcg_system(
        eqs, lam, p.obs_cam, p.obs_pt,
        pt_obsT=p.pt_obs.T, pt_obs_maskT=p.pt_obs_mask.T,
        cam_obs=p.cam_obs, cam_obs_mask=p.cam_obs_mask))(eqs, lam)
    x = jnp.ones((CP, C), jnp.float32)
    mv = jax.jit(lambda s, x: pcg.schur_matvec(s, x))
    flops_mv = M * (CP * 3 * 2 * 2) + P * 9 * 2 + C * CP * CP * 2
    bytes_mv = (2 * M * CP * 3 + P * 9 + M * (3 + CP)) * f4
    report("pcg_matvec", timeit(mv, sysm, x, n=args.reps),
           flops_mv, bytes_mv)

    # --- Stage 5: BAL-scale build + system (component-major, obs-chunked) --
    from pysfm_tpu.solver import scale as scale_mod

    K = p.pt_obs.shape[1]
    Kc = p.cam_obs.shape[1]
    chunk = min(1 << 17, M)
    build_s = jax.jit(
        lambda p: scale_mod.build_normal_equations_scale(p, chunk)
    )
    # Traffic: payload write [3CP+Rc+9, M]; reductions read the rows once
    # more through the tables.  FLOPs ~ jac (150/obs) + block products.
    rc = CP * (CP + 3) // 2
    rows_w = 3 * CP + rc + 9
    bytes_sb = (M * rows_w * 2 + C * Kc * rc + P * K * 9) * f4
    flops_sb = M * (150 + 2 * (3 * CP + rc + 9))
    report("scale_build", timeit(build_s, p, n=args.reps),
           flops_sb, bytes_sb)
    eqs_s = build_s(p)

    sys_b = jax.jit(lambda e, lam: pcg.build_pcg_system(
        e, lam, p.obs_cam, p.obs_pt,
        pt_obsT=p.pt_obs.T, pt_obs_maskT=p.pt_obs_mask.T,
        cam_obs=p.cam_obs, cam_obs_mask=p.cam_obs_mask))
    # Gathers Bp/Bg (2 x 3CP*M), block-jacobi D (C*Kc*(3CP+CP^2)), inverses.
    bytes_ps = (M * 3 * CP * 4 + C * Kc * (3 * CP + 3) + C * CP * CP * 3) * f4
    flops_ps = C * Kc * (CP * 9 + CP * CP * 3) * 2 + C * CP ** 3
    report("pcg_system_build", timeit(sys_b, eqs_s, lam, n=args.reps),
           flops_ps, bytes_ps)

    print(json.dumps({
        "roofline": rows,
        "device": {"platform": dev.platform, "kind": dev.device_kind},
    }))


if __name__ == "__main__":
    main()
