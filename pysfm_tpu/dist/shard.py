"""Host-side problem partitioning for point-sharded Schur BA.

Layout (SURVEY §2 parallelism inventory):

- **Points and their observations are sharded**: chip ``k`` owns a
  contiguous block of points and *all* observations of those points, with
  point ids relocalized to the chip ("point blocks eliminated chip-locally").
- **Cameras are replicated**: every chip sees the full camera arrays; the
  camera-sized reduced system is psum'd across the mesh (SURVEY §5 long-context
  analog — ship the small operand, keep the big one resident).

Padding makes every per-chip array the same (static) shape: padded points
have no observations (identity-filled Hpp, zero update); padded
observations carry ``obs_w = 0``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from pysfm_tpu.dist.mesh import AXIS
from pysfm_tpu.problem import BundleProblem
from pysfm_tpu.utils import struct


@struct.dataclass
class ShardedProblem:
    """Leading axis of the sharded fields is the shard axis [n, ...]."""

    # Replicated camera state.
    R: jnp.ndarray            # [C, 3, 3]
    t: jnp.ndarray            # [C, 3]
    intr: jnp.ndarray         # [C, I]
    cam_fixed: jnp.ndarray    # [C]
    # Sharded points.
    X: jnp.ndarray            # [n, Pl, 3]
    pt_mask: jnp.ndarray      # [n, Pl] bool — False for padding points
    # Sharded observations (point ids are LOCAL to the shard).
    obs_cam: jnp.ndarray      # [n, Ml]
    obs_pt: jnp.ndarray       # [n, Ml]
    obs_uv: jnp.ndarray       # [n, Ml, 2]
    obs_w: jnp.ndarray        # [n, Ml]
    # Per-shard padded point-observation tables (local obs indices) — the
    # scatter-free normal-equation/W path (see solver/schur.py).
    pt_obs: jnp.ndarray       # [n, Pl, K]
    pt_obs_mask: jnp.ndarray  # [n, Pl, K] bool
    # Per-shard padded camera-observation tables (local obs indices) — the
    # scatter-free camera-side reduction for the PCG path (solver/pcg.py):
    # each chip reduces its own observations per camera; partials psum
    # across the mesh.  Kc is the max per-(camera, shard) observation count.
    cam_obs: jnp.ndarray       # [n, C, Kc]
    cam_obs_mask: jnp.ndarray  # [n, C, Kc] bool
    robust_scale: jnp.ndarray
    camera_model: str = struct.field(pytree_node=False, default="pose")
    robust: str = struct.field(pytree_node=False, default="gaussian")

    @property
    def n_shards(self) -> int:
        return self.X.shape[0]


def shard_problem(p: BundleProblem, n_shards: int) -> ShardedProblem:
    """Partition a (host) BundleProblem into ``n_shards`` point blocks.

    Requires the builder's invariant that observations are sorted by point
    id (``make_problem`` guarantees it), so each chip's observations are a
    contiguous slice.
    """
    P_, M = p.n_points, p.n_obs
    obs_pt = np.asarray(p.obs_pt)
    if np.any(np.diff(obs_pt) < 0):
        raise ValueError("observations must be sorted by point id")
    pl = -(-P_ // n_shards)  # points per shard (ceil)
    # Observation slice per shard: points [k*pl, (k+1)*pl).
    starts = np.searchsorted(obs_pt, np.arange(n_shards) * pl)
    ends = np.searchsorted(obs_pt, np.minimum((np.arange(n_shards) + 1) * pl, P_))
    ml = int(np.max(ends - starts, initial=1))

    def pad_pts(arr, fill=0.0):
        out = np.full((n_shards, pl) + arr.shape[1:], fill, dtype=arr.dtype)
        for k in range(n_shards):
            lo, hi = k * pl, min((k + 1) * pl, P_)
            out[k, : hi - lo] = arr[lo:hi]
        return out

    X = pad_pts(np.asarray(p.X))
    pt_mask = pad_pts(np.ones(P_, dtype=bool), fill=False)

    def pad_obs(arr, fill=0):
        out = np.full((n_shards, ml) + arr.shape[1:], fill, dtype=arr.dtype)
        for k in range(n_shards):
            lo, hi = starts[k], ends[k]
            out[k, : hi - lo] = arr[lo:hi]
        return out

    obs_cam = pad_obs(np.asarray(p.obs_cam))
    obs_ptl = pad_obs(obs_pt)
    for k in range(n_shards):
        obs_ptl[k] -= k * pl  # relocalize
    obs_ptl = np.clip(obs_ptl, 0, pl - 1)
    obs_uv = pad_obs(np.asarray(p.obs_uv))
    obs_w = pad_obs(np.asarray(p.obs_w), fill=0.0)

    # Local per-point observation tables (built on the real obs only, so
    # padding observations are never referenced).
    from pysfm_tpu.problem.problem import build_point_obs_table

    tables, masks = [], []
    for k in range(n_shards):
        n_real = int(ends[k] - starts[k])
        tab, msk = build_point_obs_table(obs_ptl[k, :n_real], pl)
        tables.append(tab)
        masks.append(msk)
    K = max(t.shape[1] for t in tables)
    pt_obs_t = np.zeros((n_shards, pl, K), np.int32)
    pt_obs_m = np.zeros((n_shards, pl, K), bool)
    for k in range(n_shards):
        pt_obs_t[k, :, : tables[k].shape[1]] = tables[k]
        pt_obs_m[k, :, : masks[k].shape[1]] = masks[k]

    # Local per-camera observation tables (every shard sees all C cameras,
    # but only its own observations of them).
    C = p.n_cameras
    ctables, cmasks = [], []
    for k in range(n_shards):
        n_real = int(ends[k] - starts[k])
        tab, msk = build_point_obs_table(obs_cam[k, :n_real], C)
        ctables.append(tab)
        cmasks.append(msk)
    Kc = max(t.shape[1] for t in ctables)
    cam_obs_t = np.zeros((n_shards, C, Kc), np.int32)
    cam_obs_m = np.zeros((n_shards, C, Kc), bool)
    for k in range(n_shards):
        cam_obs_t[k, :, : ctables[k].shape[1]] = ctables[k]
        cam_obs_m[k, :, : cmasks[k].shape[1]] = cmasks[k]

    return ShardedProblem(
        R=p.R, t=p.t, intr=p.intr, cam_fixed=p.cam_fixed,
        X=jnp.asarray(X), pt_mask=jnp.asarray(pt_mask),
        obs_cam=jnp.asarray(obs_cam), obs_pt=jnp.asarray(obs_ptl),
        obs_uv=jnp.asarray(obs_uv), obs_w=jnp.asarray(obs_w),
        pt_obs=jnp.asarray(pt_obs_t), pt_obs_mask=jnp.asarray(pt_obs_m),
        cam_obs=jnp.asarray(cam_obs_t), cam_obs_mask=jnp.asarray(cam_obs_m),
        robust_scale=p.robust_scale,
        camera_model=p.camera_model, robust=p.robust,
    )


def device_put_sharded(sp: ShardedProblem, mesh) -> ShardedProblem:
    """Place sharded fields on the mesh (leading axis over AXIS), replicate
    the camera state."""
    shard = NamedSharding(mesh, P(AXIS))
    repl = NamedSharding(mesh, P())

    def put(x, sharded):
        return jax.device_put(x, shard if sharded else repl)

    return sp.replace(
        R=put(sp.R, False), t=put(sp.t, False), intr=put(sp.intr, False),
        cam_fixed=put(sp.cam_fixed, False),
        X=put(sp.X, True), pt_mask=put(sp.pt_mask, True),
        obs_cam=put(sp.obs_cam, True), obs_pt=put(sp.obs_pt, True),
        obs_uv=put(sp.obs_uv, True), obs_w=put(sp.obs_w, True),
        pt_obs=put(sp.pt_obs, True), pt_obs_mask=put(sp.pt_obs_mask, True),
        cam_obs=put(sp.cam_obs, True), cam_obs_mask=put(sp.cam_obs_mask, True),
        robust_scale=put(sp.robust_scale, False),
    )


def unshard_points(sp: ShardedProblem) -> jnp.ndarray:
    """Gather the global point array back from shards (host-side)."""
    X = np.asarray(sp.X)
    mask = np.asarray(sp.pt_mask)
    return jnp.asarray(np.concatenate([X[k][mask[k]] for k in range(X.shape[0])]))


def unshard_problem(sp: ShardedProblem, template: BundleProblem) -> BundleProblem:
    """Rebuild a BundleProblem (host-side) from a solved ShardedProblem."""
    return template.replace(
        R=sp.R, t=sp.t, intr=sp.intr, X=unshard_points(sp)
    )
