"""Smoke test of the main paths on an NVIDIA GPU, at real size.

Drives the user entry points (``solve``, ``dist``, ``pipeline``) once on
the card and checks every result against a reference, phase by phase.
Each phase prints one line with what it checked, the numbers and the
tolerance (with its precision and reason).  Any exception or failed check
exits non-zero and prints no result line.  The last line on success is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Run:  python chip_smoke.py             # phases 0-5 on one card
      python chip_smoke.py --chips 4   # phase 6 only: dist on four cards

Phases (there is no phase 1: no hand-written kernel is on the main path,
every kernel is XLA's own):
  0  device: a GPU or fail; card name and power limit, versions, flags;
  2  two-view BA (2 cams / 100 pts, f32) against the f64 NumPy oracle;
  3  robust BA (50 cams / 10k pts, Huber, pcg) against the same f32 solve
     on the host CPU backend, and against the dense-Schur route;
  4  the Venice shape (1712 cams / 1M pts / ~5M obs, pose, Huber, pcg):
     cost falls, f64 re-evaluation of the final cost, table-route vs
     segment_sum-route Schur matvec, placement, compile/warm time, memory;
  5  incremental pipeline (10 keyframes / 1k points): all frames
     registered, ATE finite;
  6  (--chips 4) Venice shape through ``dist.solve_sharded_cm`` on a
     4-card mesh, point-sharded and with ``cam_axis=True``, and
     ``dist.solve_sharded`` on a small dense scene, each against the
     single-card solve; every card must hold its shard.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rel_err(a, b) -> float:
    """|a - b| / |b| for scalars."""
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def curve_rel(curve, ref) -> float:
    """Largest relative gap between two cost curves (elementwise, each
    point relative to the reference, floored at 1 like the distributed
    parity checks)."""
    curve = np.asarray(curve, np.float64)
    ref = np.asarray(ref, np.float64)[: curve.shape[0]]
    return float(np.max(np.abs(curve - ref) / np.maximum(np.abs(ref), 1.0)))


def vec_rel(a, b) -> float:
    """||a - b|| / ||b|| for arrays."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def memory_balanced(bytes_in_use) -> bool:
    """Every card holds at least a quarter of the busiest card's bytes."""
    b = [int(x) for x in bytes_in_use]
    return min(b) * 4 >= max(b)


def say(phase: str, text: str) -> None:
    print(f"phase {phase}: {text}", flush=True)


@contextlib.contextmanager
def x64():
    """Enable f64 for the enclosed tracing (the solves themselves run with
    x64 off, as a user's f32 run does)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def f32_cfg(iters, **kw):
    from pysfm_tpu.solver import LMConfig

    return LMConfig(
        max_iters=iters, tol_grad=0.0, tol_cost_rel=0.0, tol_step=0.0, **kw
    )


def robust_pcg_cfg(iters=30):
    """bench.py's headline configuration."""
    return f32_cfg(
        iters, solver="pcg", cg_iters=25, cg_tol=1e-2, cg_forcing="ew",
        cg_q_tol=0.3,
    )


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase0_device():
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: jax.devices()[0].platform is {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        say("0", f"nvidia-smi: {line}")
    from pysfm_tpu.utils import enable_compilation_cache

    cache = enable_compilation_cache()
    say("0", f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}; "
             f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
             f"compile cache {cache}")
    return devs


def phase2_two_view():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle_numpy import Oracle

    from pysfm_tpu.pipeline import synthetic
    from pysfm_tpu.solver import LMConfig, solve
    from pysfm_tpu.utils import metrics

    sc = synthetic.make_scene(2, 100, noise_px=0.5, seed=1, dtype=np.float32)
    p = sc.problem
    solved, stats = solve(p, LMConfig(max_iters=40))
    cost = float(np.asarray(stats.costs)[int(stats.n_iters)])
    rmse = float(metrics.reprojection_rmse(solved))
    oracle = Oracle(
        p.camera_model,
        np.asarray(p.R, np.float64), np.asarray(p.t, np.float64),
        np.asarray(p.intr, np.float64), np.asarray(p.X, np.float64),
        np.asarray(p.obs_cam), np.asarray(p.obs_pt),
        np.asarray(p.obs_uv, np.float64),
    )
    cost_ref = float(oracle.optimize(max_iters=40)[-1])
    rel = rel_err(cost, cost_ref)
    check(rel < 1e-4, f"two-view cost rel {rel:.2e} vs oracle")
    check(rmse < 0.6, f"two-view rmse {rmse:.4f} px")
    # f32 carries ~1e-7 relative resolution in the cost and the iterates
    # round differently from the f64 oracle: 1e-4 on the optimum, and the
    # RMSE must sit at the 0.5 px injected noise floor.
    say("2", f"two-view f32 cost {cost:.8g} vs f64 oracle {cost_ref:.8g}: "
             f"rel {rel:.2e} < 1e-4 (f32 resolution); rmse {rmse:.4f} px "
             f"< 0.6 (0.5 px noise floor)")


def phase3_robust():
    import jax

    from pysfm_tpu.pipeline import synthetic
    from pysfm_tpu.solver import solve

    sc = synthetic.make_scene(
        50, 10_000, noise_px=0.5, outlier_frac=0.05, outlier_px=40.0,
        visibility=0.3, robust="huber", robust_scale=2.0, seed=42,
        dtype=np.float32,
    )
    cfg = robust_pcg_cfg(30)
    _, st = solve(sc.problem, cfg)
    cost = float(np.asarray(st.costs)[-1])
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        _, st_cpu = solve(jax.device_put(sc.problem, cpu), cfg)
    cost_cpu = float(np.asarray(st_cpu.costs)[-1])
    rel = rel_err(cost, cost_cpu)
    check(rel < 5e-3, f"robust pcg gpu vs cpu rel {rel:.2e}")
    _, st_d = solve(sc.problem, f32_cfg(30))
    cost_d = float(np.asarray(st_d.costs)[-1])
    rel_d = rel_err(cost_d, cost)
    check(rel_d < 5e-3, f"robust dense vs pcg rel {rel_d:.2e}")
    # Same f32 code on two backends: summation order differs, so an
    # accept/reject tie can flip one step; the optimum agrees to 5e-3.
    say("3", f"robust 50/10k pcg f32 gpu {cost:.8g} vs cpu {cost_cpu:.8g}: "
             f"rel {rel:.2e} < 5e-3; dense-Schur gpu {cost_d:.8g} vs pcg: "
             f"rel {rel_d:.2e} < 5e-3 (f32 accept/reject ties)")


def phase4_venice(gpu, venice, iters=6):
    import jax
    import jax.numpy as jnp

    from pysfm_tpu.solver import pcg, scale, solve
    from pysfm_tpu.utils.config import venice_pcg_config
    from pysfm_tpu.utils.timing import sync

    p = venice
    cfg = venice_pcg_config(iters)
    t0 = time.perf_counter()
    solved, st = solve(p, cfg)
    sync(solved.X3)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    solved, st = solve(p, cfg)
    sync(solved.X3)
    t_warm = time.perf_counter() - t0
    costs = np.asarray(st.costs, np.float64)
    n = int(st.n_iters)
    check(n == iters, f"venice ran {n} of {iters} iterations")
    check(costs[n] < costs[0],
          f"venice cost did not fall: {costs[0]:.8g} -> {costs[n]:.8g}")

    with x64():
        p64 = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64)
            if jnp.issubdtype(x.dtype, jnp.floating) else x,
            solved,
        )
        cost64 = float(scale.cost_scale_cm(p64, cfg.obs_chunk))
    rel64 = rel_err(costs[n], cost64)
    check(rel64 < 1e-4, f"venice f32 cost vs f64 re-evaluation {rel64:.2e}")

    eqs = scale.build_normal_equations_scale_cm(solved, cfg.obs_chunk)
    lam = jnp.asarray(1e-3, jnp.float32)
    sys_t = jax.jit(lambda e: pcg.build_pcg_system(
        e, lam, solved.obs_cam, solved.obs_pt,
        pt_obsT=solved.pt_obsT, pt_obs_maskT=solved.pt_obs_maskT,
        cam_obs=solved.cam_obs, cam_obs_mask=solved.cam_obs_mask,
    ))(eqs)
    sys_s = jax.jit(lambda e: pcg.build_pcg_system(
        e, lam, solved.obs_cam, solved.obs_pt,
    ))(eqs)
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(sys_t.rhs.shape),
        jnp.float32,
    )
    mv = jax.jit(pcg.schur_matvec)
    y_t, y_s = mv(sys_t, x), mv(sys_s, x)
    rel_mv = vec_rel(y_s, y_t)
    check(rel_mv < 1e-4, f"schur matvec table vs segment_sum {rel_mv:.2e}")
    del sys_t, sys_s, eqs

    placed = {d.platform for d in solved.X3.devices()} | {
        d.platform for d in solved.R.devices()
    }
    check(placed == {gpu.platform}, f"solved arrays on {placed}")
    peak = int((gpu.memory_stats() or {}).get("peak_bytes_in_use", 0))
    check(peak > 0, "memory_stats() reports no peak bytes")
    # The f64 re-evaluation uses the f32 final parameters, so the only gap
    # is the f32 accumulation of ~5M robust terms: 1e-4.  The two matvec
    # routes sum the same f32 products in another order: 1e-4 of ||Sx||.
    say("4", f"venice C={p.n_cameras} P={p.n_points} M={p.n_obs} pcg f32, "
             f"{iters} LM iters in one dispatch: cost {costs[0]:.8g} -> "
             f"{costs[n]:.8g} (accepted "
             f"{int(np.asarray(st.accepted).sum())}); f64 re-eval "
             f"{cost64:.8g} rel {rel64:.2e} < 1e-4 (f32 accumulation); "
             f"matvec table vs segment_sum rel {rel_mv:.2e} < 1e-4 "
             f"(f32 summation order); on {sorted(placed)}; compile "
             f"{t_first - t_warm:.1f} s, warm {t_warm / iters * 1e3:.1f} "
             f"ms/iter; peak_bytes_in_use {peak}")


def phase5_incremental():
    from pysfm_tpu.pipeline import IncrementalConfig, run_incremental
    from pysfm_tpu.pipeline import synthetic
    from pysfm_tpu.utils import metrics

    sc = synthetic.make_scene(
        10, 1_000, noise_px=0.5, visibility=0.85, seed=13, radius=10.0,
        dtype=np.float32,
    )
    t = sc.truth
    F, T = t.n_cameras, t.n_points
    uv = np.zeros((F, T, 2), np.float32)
    vis = np.zeros((F, T), bool)
    oc, op = np.asarray(t.obs_cam), np.asarray(t.obs_pt)
    uv[oc, op] = np.asarray(t.obs_uv)
    vis[oc, op] = True
    t0 = time.perf_counter()
    rec = run_incremental(uv, vis, np.asarray(t.intr), "pose",
                          IncrementalConfig(seed=2))
    wall = time.perf_counter() - t0
    check(bool(rec.registered.all()),
          f"registered {int(rec.registered.sum())}/{F} frames")
    ate = float(metrics.ate_rmse(
        np.asarray(metrics.camera_centers(rec.problem.R, rec.problem.t)),
        np.asarray(metrics.camera_centers(t.R, t.t)),
    ))
    check(np.isfinite(ate), f"ATE {ate}")
    say("5", f"incremental 10 keyframes / 1k points: {F}/{F} registered, "
             f"ATE {ate:.3e} (scene radius 10) finite; wall {wall:.1f} s "
             f"incl. compile")


def phase6_four_cards(venice_host, iters=4):
    import jax

    from pysfm_tpu import dist
    from pysfm_tpu.pipeline import synthetic
    from pysfm_tpu.solver import LMConfig, solve
    from pysfm_tpu.utils.config import venice_pcg_config

    devs = jax.devices()
    check(len(devs) == 4, f"--chips 4 needs 4 cards, found {len(devs)}")
    mesh = dist.make_mesh(4)
    cfg = venice_pcg_config(iters)
    scm = dist.device_put_sharded_cm(dist.shard_cm_problem(venice_host, 4),
                                     mesh)
    _, st_pt = dist.solve_sharded_cm(scm, mesh, cfg)
    c_pt = np.asarray(st_pt.costs)
    in_use = [int((d.memory_stats() or {}).get("bytes_in_use", 0)) for d in devs]
    say("6", "bytes_in_use per card with the sharded Venice problem "
             f"resident: {in_use}")
    check(memory_balanced(in_use),
          f"a card holds < 1/4 of the busiest card's bytes: {in_use}")
    _, st_cam = dist.solve_sharded_cm(scm, mesh, cfg, cam_axis=True)
    c_cam = np.asarray(st_cam.costs)
    del scm
    _, st_ref = solve(jax.device_put(venice_host, devs[0]), cfg)
    c_ref = np.asarray(st_ref.costs)
    r_pt, r_cam = curve_rel(c_pt, c_ref), curve_rel(c_cam, c_ref)
    check(r_pt < 1e-3, f"point-sharded vs single rel {r_pt:.2e}")
    check(r_cam < 1e-3, f"cam-axis-sharded vs single rel {r_cam:.2e}")
    # f32: the cross-card psum changes the summation order, so CG and an
    # accept/reject tie may round differently; 1e-3 on the cost curve.
    say("6", f"venice solve_sharded_cm on 4 cards, {iters} LM iters: "
             f"point-sharded curve rel {r_pt:.2e}, cam_axis rel "
             f"{r_cam:.2e} vs single card (< 1e-3, f32 summation order); "
             f"final {c_pt[-1]:.8g} / {c_cam[-1]:.8g} / {c_ref[-1]:.8g}")

    prob = synthetic.make_scene(
        8, 4000, noise_px=0.5, visibility=0.8, seed=1, dtype=np.float32
    ).problem
    cfg_d = LMConfig(max_iters=5)
    sp = dist.device_put_sharded(dist.shard_problem(prob, 4), mesh)
    _, st_d = dist.solve_sharded(sp, mesh, cfg_d)
    _, st_d1 = solve(prob, cfg_d)
    r_d = curve_rel(np.asarray(st_d.costs), np.asarray(st_d1.costs))
    check(r_d < 1e-3, f"dense sharded vs single rel {r_d:.2e}")
    say("6", f"dense solve_sharded 8 cams / 4k pts on 4 cards vs single: "
             f"curve rel {r_d:.2e} < 1e-3 (f32 summation order)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    devs = phase0_device()
    t_all = time.perf_counter()
    if args.chips == 4:
        import jax

        from pysfm_tpu.pipeline.synthetic import make_venice_scene

        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            venice_host = make_venice_scene()
        phase6_four_cards(venice_host)
    else:
        from pysfm_tpu.pipeline.synthetic import make_venice_scene

        t0 = time.perf_counter()
        venice = make_venice_scene()
        say("4", f"venice scene built in {time.perf_counter() - t0:.1f} s")
        phase2_two_view()
        phase3_robust()
        phase4_venice(devs[0], venice)
        phase5_incremental()
    say("all", f"passed in {time.perf_counter() - t_all:.1f} s")
    d = devs[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devs)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
