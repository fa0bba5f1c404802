"""Synthetic ground-truth scene generation.

The reference's test discipline (SURVEY §4.2): generate random 3-D points in
a box, cameras looking at them, project for exact measurements, optionally
add noise/outliers, perturb, and check the optimizer recovers.  Ground truth
*is* the fixture — no mocks.

Host-side NumPy (runs once per test/bench setup); emits a
:class:`~pysfm_tpu.problem.BundleProblem`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pysfm_tpu.geometry import projection
from pysfm_tpu.problem import BundleProblem, make_problem


def look_at_rotation(center: np.ndarray, target: np.ndarray, flip_z: bool) -> np.ndarray:
    """World->camera rotation for a camera at ``center`` looking at ``target``.

    ``flip_z=False``: +z forward (pinhole models).  ``flip_z=True``: -z
    forward (BAL convention, SURVEY §2 / io/bal.py).
    Rows of R are the camera axes expressed in world coordinates.
    """
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    z = -fwd if flip_z else fwd
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(up, z)) > 0.99:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


@dataclass
class SyntheticScene:
    """Ground truth + a perturbed problem ready for the solver."""

    truth: BundleProblem      # exact parameters, zero-residual measurements
    problem: BundleProblem    # perturbed initial guess (same measurements)
    noise_px: float
    outlier_frac: float


def make_bal_scene(
    n_cameras: int = 1712,
    n_points: int = 1_000_000,
    *,
    mean_track: float = 5.0,
    max_track: int = 12,
    camera_model: str = "pose",
    robust: str = "gaussian",
    robust_scale: float = 1.0,
    noise_px: float = 0.0,
    outlier_frac: float = 0.0,
    outlier_px: float = 50.0,
    perturb_rot: float = 0.01,
    perturb_trans: float = 0.02,
    perturb_point: float = 0.02,
    radius: float = 10.0,
    seed: int = 0,
    dtype=np.float32,
    with_truth: bool = True,
    layout: str = "std",
) -> SyntheticScene:
    """BAL/Venice-scale scene (BASELINE config 4: 1.7k cams, 1M points).

    ``with_truth=False`` skips building the ground-truth problem (its
    device tables cost a second multi-hundred-MB host->device transfer at
    Venice scale; benchmarks only need the perturbed problem).

    ``layout="cm"`` emits :class:`~pysfm_tpu.problem.cm.CMProblem` pytrees
    (component-major — the pcg solver's native layout) instead of
    :class:`BundleProblem`; at Venice scale this also avoids ever putting
    the standard layout's padded [M, 2]/[P, 3]/[P, K] buffers on device.

    Unlike :func:`make_scene` this never materializes the all-pairs
    visibility grid (1.7k x 1M = 1.7e9 entries): each point draws a track
    length in [2, max_track] (mean ``mean_track``) and observes a
    *contiguous window* of cameras on the ring — the locality structure of
    real sequential captures, which also bounds the per-camera observation
    count so the padded ``cam_obs`` table stays tight.
    """
    rng = np.random.default_rng(seed)
    flip_z = camera_model == "bal"

    X = rng.uniform(-2.0, 2.0, size=(n_points, 3))
    angles = 2.0 * np.pi * np.arange(n_cameras) / max(n_cameras, 3)
    centers = np.stack(
        [
            radius * np.cos(angles),
            0.5 * rng.normal(size=n_cameras),
            radius * np.sin(angles),
        ],
        axis=-1,
    )
    R = np.stack(
        [look_at_rotation(c, np.zeros(3), flip_z) for c in centers], axis=0
    )
    t = -np.einsum("cij,cj->ci", R, centers)
    if camera_model == "bal":
        intr = np.stack(
            [
                800.0 + 10.0 * rng.normal(size=n_cameras),
                np.full(n_cameras, 1e-4),
                np.full(n_cameras, 1e-7),
            ],
            axis=-1,
        )
    else:
        intr = np.stack(
            [
                np.full(n_cameras, 800.0),
                np.full(n_cameras, 800.0),
                np.full(n_cameras, 320.0),
                np.full(n_cameras, 240.0),
            ],
            axis=-1,
        )

    # Track lengths: 2 + Poisson(mean-2), clipped to max_track.
    k = 2 + rng.poisson(max(mean_track - 2.0, 0.0), size=n_points)
    k = np.minimum(k, max_track)
    # Window start per point; slots index consecutive cameras (mod C).
    start = rng.integers(0, n_cameras, size=n_points)
    pt_idx = np.repeat(np.arange(n_points, dtype=np.int64), k)
    # Vectorized per-track slot offsets without a Python loop over points.
    offs = np.arange(max_track)
    grid_mask = offs[None, :] < k[:, None]                  # [P, max_track]
    cam_grid = (start[:, None] + offs[None, :]) % n_cameras
    cam_idx = cam_grid[grid_mask].astype(np.int64)

    import jax
    import jax.numpy as jnp

    # Project on the host CPU backend when available: the gathered
    # [M, ...] operands are built on the host and the pixels are read back
    # to the host for noise and sorting, so shipping them through the
    # accelerator at Venice scale only adds transfers.
    try:
        cpu_dev = jax.devices("cpu")[0]
    except RuntimeError:
        cpu_dev = None
    M = cam_idx.shape[0]
    uv = np.empty((M, 2), dtype=np.float64)
    proj = jax.jit(
        lambda Rg, tg, ig, Xg: projection.project(camera_model, Rg, tg, ig, Xg)
    )
    import contextlib

    ctx = (
        jax.default_device(cpu_dev)
        if cpu_dev is not None
        else contextlib.nullcontext()
    )
    chunk = 1 << 20
    with ctx:
        for lo in range(0, M, chunk):
            hi = min(lo + chunk, M)
            ci, pi = cam_idx[lo:hi], pt_idx[lo:hi]
            uv[lo:hi] = np.asarray(
                proj(
                    jnp.asarray(R[ci]), jnp.asarray(t[ci]),
                    jnp.asarray(intr[ci]), jnp.asarray(X[pi]),
                )
            )
    if noise_px > 0:
        uv += rng.normal(scale=noise_px, size=uv.shape)
    if outlier_frac > 0:
        n_out = int(outlier_frac * M)
        which = rng.choice(M, size=n_out, replace=False)
        uv[which] += rng.uniform(-outlier_px, outlier_px, size=(n_out, 2))

    if layout not in ("std", "cm"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "cm":
        from pysfm_tpu.problem.cm import make_cm_problem as _builder
    else:
        _builder = make_problem
    common = dict(
        camera_model=camera_model, robust=robust,
        robust_scale=robust_scale, dtype=dtype,
    )
    truth = (
        _builder(R, t, intr, X, cam_idx, pt_idx, uv, **common)
        if with_truth
        else None
    )

    from pysfm_tpu.geometry import so3

    dw = rng.normal(scale=perturb_rot, size=(n_cameras, 3))
    dw[0] = 0.0
    dt = rng.normal(scale=perturb_trans, size=(n_cameras, 3))
    dt[0] = 0.0
    # Perturbation on the host CPU backend too: a tiny op on host data.
    with ctx:
        R_pert = np.asarray(so3.exp(jnp.asarray(dw))) @ R
    t_pert = t + dt
    X_pert = X + rng.normal(scale=perturb_point, size=X.shape)
    problem = _builder(
        R_pert, t_pert, intr, X_pert, cam_idx, pt_idx, uv, **common
    )
    return SyntheticScene(
        truth=truth, problem=problem,
        noise_px=noise_px, outlier_frac=outlier_frac,
    )


def make_venice_scene(
    n_cameras: int = 1712,
    n_points: int = 1_000_000,
    *,
    mean_track: float = 5.0,
    max_track: int = 12,
    noise_px: float = 0.5,
    camera_model: str = "pose",
    seed: int = 4,
):
    """The Venice-shaped f32 component-major problem (BASELINE config 4:
    1.7k cameras, 1M points, ~5M observations; Huber at 2 px) that the
    flagship benchmark and the smoke test solve."""
    return make_bal_scene(
        n_cameras, n_points, mean_track=mean_track, max_track=max_track,
        noise_px=noise_px, camera_model=camera_model,
        robust="huber", robust_scale=2.0, seed=seed, dtype=np.float32,
        with_truth=False, layout="cm",
    ).problem


def make_scene(
    n_cameras: int = 2,
    n_points: int = 100,
    *,
    camera_model: str = "pose",
    robust: str = "gaussian",
    robust_scale: float = 1.0,
    noise_px: float = 0.0,
    outlier_frac: float = 0.0,
    outlier_px: float = 50.0,
    perturb_rot: float = 0.02,
    perturb_trans: float = 0.05,
    perturb_point: float = 0.05,
    visibility: float = 1.0,
    radius: float = 10.0,
    seed: int = 0,
    dtype=np.float64,
) -> SyntheticScene:
    """Cameras on a ring of ``radius`` looking at a unit-ish point cloud.

    ``visibility`` < 1 drops a random subset of (camera, point) pairs so the
    visibility graph is irregular, exercising the padded Schur gather path.
    """
    rng = np.random.default_rng(seed)
    flip_z = camera_model == "bal"

    X = rng.uniform(-2.0, 2.0, size=(n_points, 3))
    angles = 2.0 * np.pi * np.arange(n_cameras) / max(n_cameras, 3)
    centers = np.stack(
        [
            radius * np.cos(angles),
            0.5 * rng.normal(size=n_cameras),
            radius * np.sin(angles),
        ],
        axis=-1,
    )
    R = np.stack(
        [look_at_rotation(c, np.zeros(3), flip_z) for c in centers], axis=0
    )
    t = -np.einsum("cij,cj->ci", R, centers)

    if camera_model == "bal":
        intr = np.stack(
            [
                800.0 + 10.0 * rng.normal(size=n_cameras),
                np.full(n_cameras, 1e-4),
                np.full(n_cameras, 1e-7),
            ],
            axis=-1,
        )
    else:
        intr = np.stack(
            [
                np.full(n_cameras, 800.0),
                np.full(n_cameras, 800.0),
                np.full(n_cameras, 320.0),
                np.full(n_cameras, 240.0),
            ],
            axis=-1,
        )

    # All pairs, thinned by `visibility`; every point keeps >= 2 views so it
    # stays constrained.
    cam_idx, pt_idx = np.meshgrid(
        np.arange(n_cameras), np.arange(n_points), indexing="ij"
    )
    cam_idx, pt_idx = cam_idx.ravel(), pt_idx.ravel()
    if visibility < 1.0:
        keep = rng.random(cam_idx.shape[0]) < visibility
        # Force the first two cameras of every point to stay.
        keep |= cam_idx < 2
        cam_idx, pt_idx = cam_idx[keep], pt_idx[keep]

    import jax.numpy as jnp

    uv = np.asarray(
        projection.project(
            camera_model,
            jnp.asarray(R[cam_idx]),
            jnp.asarray(t[cam_idx]),
            jnp.asarray(intr[cam_idx]),
            jnp.asarray(X[pt_idx]),
        )
    )
    if noise_px > 0:
        uv = uv + rng.normal(scale=noise_px, size=uv.shape)
    if outlier_frac > 0:
        n_out = int(outlier_frac * uv.shape[0])
        which = rng.choice(uv.shape[0], size=n_out, replace=False)
        uv[which] += rng.uniform(-outlier_px, outlier_px, size=(n_out, 2))

    common = dict(
        camera_model=camera_model,
        robust=robust,
        robust_scale=robust_scale,
        dtype=dtype,
    )
    truth = make_problem(R, t, intr, X, cam_idx, pt_idx, uv, **common)

    # Perturb everything except the gauge-fixed camera 0.
    from pysfm_tpu.geometry import so3
    import jax.numpy as jnp2

    dw = rng.normal(scale=perturb_rot, size=(n_cameras, 3))
    dw[0] = 0.0
    dt = rng.normal(scale=perturb_trans, size=(n_cameras, 3))
    dt[0] = 0.0
    R_pert = np.asarray(so3.exp(jnp2.asarray(dw))) @ R
    t_pert = t + dt
    X_pert = X + rng.normal(scale=perturb_point, size=X.shape)
    problem = make_problem(
        R_pert, t_pert, intr, X_pert, cam_idx, pt_idx, uv, **common
    )
    return SyntheticScene(
        truth=truth, problem=problem, noise_px=noise_px, outlier_frac=outlier_frac
    )
