"""BAL ("Bundle Adjustment in the Large") problem file I/O.

Reference analog: ``bundle_io.py`` load/save of reconstruction problems
(SURVEY §2 "Bundle I/O"; SURVEY §3.5 problem-load entry point).  The BAL
text format is the de-facto interchange format for large BA problems
(Agarwal et al., "Bundle Adjustment in the Large", ECCV 2010) and is the
format of BASELINE config 4 (Ladybug/Venice scale).

Format (whitespace-separated tokens; one value per line in the originals):

    n_cameras n_points n_observations
    cam_idx point_idx u v              # x n_observations
    <9 params per camera>              # 3 Rodrigues, 3 translation, f, k1, k2
    <3 coords per point>

Convention: ``x_cam = R X + t`` with the camera looking down **-z**
(projection is ``-p/z`` — see geometry/projection.py model "bal").

The loader emits the device-ready SoA problem (SURVEY §3.5 "loader emits
the device layout"): observations sorted by point, padded per-point
visibility table built once, dtype selectable.  Supports ``.gz`` and ``.bz2``
transparently (BAL distribution files ship bzip2'd).
"""

from __future__ import annotations

import bz2
import gzip
import io as _io
from typing import Tuple

import numpy as np

from pysfm_tpu.geometry import so3
from pysfm_tpu.problem import BundleProblem, make_problem


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    if str(path).endswith(".bz2"):
        return bz2.open(path, mode)
    return open(path, mode)


def load_bal(
    path: str,
    *,
    robust: str = "gaussian",
    robust_scale: float = 1.0,
    dtype=np.float64,
    max_track: int | None = None,
    layout: str = "std",
):
    """Load a BAL problem file.

    ``layout="std"`` returns a :class:`BundleProblem`; ``layout="cm"``
    returns the component-major :class:`~pysfm_tpu.problem.cm.CMProblem`
    the BAL-scale solver path consumes directly (pass the result to
    ``lm.solve`` with ``solver="pcg"``)."""
    from pysfm_tpu.io import native

    with _open(path, "rb") as f:
        tokens = native.parse_doubles(f.read())
    n_cam, n_pt, n_obs = int(tokens[0]), int(tokens[1]), int(tokens[2])
    k = 3
    obs = tokens[k : k + 4 * n_obs].reshape(n_obs, 4)
    k += 4 * n_obs
    cams = tokens[k : k + 9 * n_cam].reshape(n_cam, 9)
    k += 9 * n_cam
    X = tokens[k : k + 3 * n_pt].reshape(n_pt, 3)

    obs_cam = obs[:, 0].astype(np.int32)
    obs_pt = obs[:, 1].astype(np.int32)
    uv = obs[:, 2:4]

    import jax
    import jax.numpy as jnp

    # Rodrigues -> R on the host CPU backend when available: the inputs
    # were just parsed on the host and the problem builder reads the result
    # back on the host, so a round trip through the accelerator buys
    # nothing.
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = None
    if cpu is not None:
        with jax.default_device(cpu):
            R = np.asarray(so3.exp(jnp.asarray(cams[:, 0:3])))
    else:
        R = np.asarray(so3.exp(jnp.asarray(cams[:, 0:3])))
    t = cams[:, 3:6]
    intr = cams[:, 6:9]                       # f, k1, k2
    kw = dict(
        camera_model="bal", robust=robust, robust_scale=robust_scale,
        dtype=dtype, max_track=max_track,
    )
    if layout == "cm":
        from pysfm_tpu.problem import cm as cm_mod

        return cm_mod.make_cm_problem(
            R, t, intr, X, obs_cam, obs_pt, uv, **kw
        )
    return make_problem(R, t, intr, X, obs_cam, obs_pt, uv, **kw)


def save_bal(path: str, problem: BundleProblem) -> None:
    """Write a :class:`BundleProblem` (camera_model="bal") as a BAL file."""
    if problem.camera_model != "bal":
        raise ValueError(
            f"save_bal requires camera_model='bal', got {problem.camera_model!r}"
        )
    import jax
    import jax.numpy as jnp

    R = np.asarray(problem.R, dtype=np.float64)
    # Rodrigues conversion on the host CPU backend when available: a tiny
    # op whose result is written to a file from the host.
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = None
    if cpu is not None:
        with jax.default_device(cpu):
            w = np.asarray(so3.log(jnp.asarray(R)))
    else:
        w = np.asarray(so3.log(jnp.asarray(R)))
    t = np.asarray(problem.t, dtype=np.float64)
    intr = np.asarray(problem.intr, dtype=np.float64)
    X = np.asarray(problem.X, dtype=np.float64)
    obs_cam = np.asarray(problem.obs_cam)
    obs_pt = np.asarray(problem.obs_pt)
    uv = np.asarray(problem.obs_uv, dtype=np.float64)

    from pysfm_tpu.io import native

    header = f"{R.shape[0]} {X.shape[0]} {obs_cam.shape[0]}\n".encode()
    cams = np.concatenate([w, t, intr], axis=-1)          # [C, 9]
    vals = np.concatenate([cams.reshape(-1), X.reshape(-1)])
    # Native writer (fast_parse.cpp pysfm_format_bal): the per-line Python
    # f-string loop took minutes for 626k observations; the snprintf loop
    # is ~3 orders of magnitude faster.  Fallback: np.savetxt-style
    # block formatting (still vectorized over lines, ~30x the loop).
    body = native.format_bal(obs_cam, obs_pt, uv, vals)
    if body is None:
        buf = _io.BytesIO()
        obs_block = np.column_stack(
            [obs_cam.astype(np.float64), obs_pt.astype(np.float64), uv]
        )
        np.savetxt(buf, obs_block, fmt="%d %d %.17g %.17g")
        np.savetxt(buf, vals[:, None], fmt="%.17g")
        body = buf.getvalue()
    with _open(path, "wb") as f:
        f.write(header)
        f.write(body)


def make_synthetic_bal(
    n_cameras: int, n_points: int, **kw
) -> Tuple[BundleProblem, BundleProblem]:
    """(truth, perturbed) synthetic problem in BAL convention — the stand-in
    for the BAL datasets in an offline container (no downloads)."""
    from pysfm_tpu.pipeline import synthetic

    sc = synthetic.make_scene(n_cameras, n_points, camera_model="bal", **kw)
    return sc.truth, sc.problem
