"""Checkpoint / resume of bundle-adjustment state (SURVEY §5).

The reference's only persistence is the ``bundle_io`` text format; for a
production framework the mandated mechanism is mid-solve checkpointing:
save ``(cameras, points, tracks, lambda, iteration, rng)`` and resume BA
from exactly that state (SURVEY §5 "Checkpoint / resume").

Design: one ``.npz`` per host + a tiny JSON sidecar for static metadata.
Arrays are gathered to host (for sharded problems each host saves only its
addressable shards — pass ``suffix=jax.process_index()``).  npz is
deliberately chosen over a heavier checkpoint library: BA state is a flat
dict of a dozen arrays, atomicity is achieved with a rename, and the file
round-trips with zero dependencies.  Failure recovery (SURVEY §5 "failure
detection"): re-launch the orchestrator and ``load_checkpoint`` the latest
complete file — a torn write is never visible because of the tmp+rename.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np

from pysfm_tpu.problem import BundleProblem, make_problem


@dataclasses.dataclass
class SolverCheckpoint:
    """Everything needed to resume LM mid-solve."""

    problem: BundleProblem
    lam: float = 1e-3
    nu: float = 2.0
    iteration: int = 0
    rng_key: Optional[np.ndarray] = None
    extra: Optional[dict] = None


def save_checkpoint(path: str, ckpt: SolverCheckpoint) -> None:
    """Atomically write a checkpoint (tmp file + rename)."""
    p = ckpt.problem
    arrays = dict(
        R=np.asarray(p.R), t=np.asarray(p.t), intr=np.asarray(p.intr),
        X=np.asarray(p.X),
        obs_cam=np.asarray(p.obs_cam), obs_pt=np.asarray(p.obs_pt),
        obs_uv=np.asarray(p.obs_uv), obs_w=np.asarray(p.obs_w),
        cam_fixed=np.asarray(p.cam_fixed),
        robust_scale=np.asarray(p.robust_scale),
        lam=np.asarray(ckpt.lam), nu=np.asarray(ckpt.nu),
        iteration=np.asarray(ckpt.iteration),
    )
    if ckpt.rng_key is not None:
        arrays["rng_key"] = np.asarray(ckpt.rng_key)
    meta = {
        "camera_model": p.camera_model,
        "robust": p.robust,
        "extra": ckpt.extra or {},
        "version": 1,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    # Data first, sidecar last: the .json rename is the commit marker, so a
    # crash between the two renames can never leave a fresh sidecar pointing
    # at a stale or missing .npz.
    os.replace(tmp, path)
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")


def load_checkpoint(path: str, dtype=None) -> SolverCheckpoint:
    """Load a checkpoint written by :func:`save_checkpoint`."""
    with open(path + ".json") as f:
        meta = json.load(f)
    z = np.load(path)
    prob = make_problem(
        z["R"], z["t"], z["intr"], z["X"],
        z["obs_cam"], z["obs_pt"], z["obs_uv"],
        camera_model=meta["camera_model"], robust=meta["robust"],
        robust_scale=float(z["robust_scale"]),
        obs_w=z["obs_w"], cam_fixed=z["cam_fixed"], dtype=dtype,
    )
    return SolverCheckpoint(
        problem=prob,
        lam=float(z["lam"]),
        nu=float(z["nu"]),
        iteration=int(z["iteration"]),
        rng_key=z["rng_key"] if "rng_key" in z else None,
        extra=meta.get("extra") or None,
    )


# --------------------------------------------------------------------------
# Component-major (BAL/Venice-scale) checkpointing.
# --------------------------------------------------------------------------

_CM_FIELDS = (
    "R", "t", "intr", "cam_fixed", "X3", "obs_cam", "obs_pt", "u", "v",
    "obs_w", "pt_obsT", "pt_obs_maskT", "cam_obs", "cam_obs_mask",
    "robust_scale",
)


def save_checkpoint_cm(
    path: str,
    cmp,
    *,
    lam: float = 1e-3,
    nu: float = 2.0,
    iteration: int = 0,
    extra: Optional[dict] = None,
) -> None:
    """Atomically save a :class:`~pysfm_tpu.problem.cm.CMProblem` mid-solve
    (the natural segment boundary of ``lm.solve_segmented`` at Venice
    scale).  Uncompressed npz: at 5M observations zlib costs ~10x the
    write and the arrays are float/int noise anyway."""
    arrays = {name: np.asarray(getattr(cmp, name)) for name in _CM_FIELDS}
    arrays.update(
        lam=np.asarray(lam), nu=np.asarray(nu),
        iteration=np.asarray(iteration),
    )
    meta = {
        "camera_model": cmp.camera_model,
        "robust": cmp.robust,
        "extra": extra or {},
        "version": 1,
        "layout": "cm",
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    # npz first, .json sidecar last (the commit marker).
    os.replace(tmp, path)
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")


def load_checkpoint_cm(path: str):
    """Load a CM checkpoint; returns ``(CMProblem, lam, nu, iteration)``.

    Arrays come back host-resident; the first ``solve`` call device-puts
    them."""
    import jax.numpy as jnp

    from pysfm_tpu.problem.cm import CMProblem

    with open(path + ".json") as f:
        meta = json.load(f)
    if meta.get("layout") != "cm":
        raise ValueError(f"{path} is not a CM checkpoint")
    z = np.load(path)
    cmp = CMProblem(
        camera_model=meta["camera_model"], robust=meta["robust"],
        **{name: jnp.asarray(z[name]) for name in _CM_FIELDS},
    )
    return cmp, float(z["lam"]), float(z["nu"]), int(z["iteration"])


# --------------------------------------------------------------------------
# Sharded (multi-chip / multi-host) checkpointing.
# --------------------------------------------------------------------------

_SHARDED_FIELDS = (
    "X", "pt_mask", "obs_cam", "obs_pt", "obs_uv", "obs_w",
    "pt_obs", "pt_obs_mask", "cam_obs", "cam_obs_mask",
)
_REPL_FIELDS = ("R", "t", "intr", "cam_fixed", "robust_scale")


def _collect_shards(x):
    """Gather one field's locally-addressable shards to host: returns
    ``(concatenated array, shard starts, shard sizes)`` in start order."""
    if hasattr(x, "addressable_shards") and x.addressable_shards:
        ids, blocks = [], []
        for s in x.addressable_shards:
            sl = s.index[0] if s.index else slice(0, x.shape[0])
            ids.append(0 if sl.start is None else int(sl.start))
            blocks.append(np.asarray(s.data))
        order = np.argsort(ids)
        arr = np.concatenate([blocks[i] for i in order], axis=0)
        starts = np.asarray(sorted(ids))
        sizes = np.asarray([blocks[i].shape[0] for i in order])
        return arr, starts, sizes
    arr = np.asarray(x)  # host array (tests / single device): all local
    return arr, np.zeros(1, np.int64), np.asarray([arr.shape[0]])


def _check_shard_layout(name, starts, sizes, starts0, sizes0):
    """All sharded fields of one checkpoint part must share the first
    field's (starts, sizes) layout — load applies that single layout to
    every field, so mixed placement would be silently mis-assembled."""
    if not (
        np.array_equal(starts, starts0) and np.array_equal(sizes, sizes0)
    ):
        raise ValueError(
            f"sharded field {name!r} has shard layout starts={list(starts)} "
            f"sizes={list(sizes)} != the first field's "
            f"starts={list(starts0)} sizes={list(sizes0)}; refusing to "
            "save a checkpoint that would mis-assemble on load"
        )


def _check_shard_coverage(path, n, covered):
    """Raise unless the union of all loaded part ranges is [0, n): a
    missing or short part (e.g. a host crashed before writing its file —
    the exact failure-recovery scenario) must be a loud error, not
    silently zero-filled rows."""
    if not covered.all():
        missing = np.flatnonzero(~covered)
        lo, hi = int(missing[0]), int(missing[-1])
        raise ValueError(
            f"checkpoint {path!r} is incomplete: {missing.size} of {n} "
            f"shard rows (first {lo}, last {hi}) are covered by no part "
            f"file — a part is missing or torn; refusing to resume from "
            "zero-filled state"
        )


def save_checkpoint_sharded(
    path: str,
    sp,
    *,
    lam: float = 1e-3,
    nu: float = 2.0,
    iteration: int = 0,
) -> str:
    """Save a :class:`~pysfm_tpu.dist.shard.ShardedProblem` mid-solve.

    Each process writes ONE part file ``<path>.p<proc>`` holding only its
    addressable shards (leading shard axis) plus the replicated camera
    state — no cross-host gather, no unsharding to a single host (SURVEY
    §5 "Checkpoint / resume" for the distributed solver).  Atomic via
    tmp+rename, same torn-write discipline as :func:`save_checkpoint`.

    Returns the part path written by this process.
    """
    import jax

    proc = jax.process_index()
    arrays = dict(
        lam=np.asarray(lam), nu=np.asarray(nu), iteration=np.asarray(iteration)
    )
    for name in _REPL_FIELDS:
        arrays[name] = np.asarray(getattr(sp, name))
    starts = sizes = None
    for name in _SHARDED_FIELDS:
        arrays[name], f_starts, f_sizes = _collect_shards(getattr(sp, name))
        if starts is None:
            starts, sizes = f_starts, f_sizes
            arrays["shard_starts"] = starts
            arrays["shard_sizes"] = sizes
        else:
            _check_shard_layout(name, f_starts, f_sizes, starts, sizes)
        global_dim = getattr(sp, name).shape[0]
    meta = {
        "camera_model": sp.camera_model,
        "robust": sp.robust,
        "n_shards": int(global_dim),
        "version": 1,
        "sharded": True,
    }
    part = f"{path}.p{proc}"
    tmp = part + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    # npz first, .json sidecar last (the commit marker).
    os.replace(tmp, part)
    with open(part + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(part + ".json.tmp", part + ".json")
    return part


def load_checkpoint_sharded(path: str):
    """Reassemble a sharded checkpoint from all part files visible at
    ``path.p*`` (single host, or a shared filesystem across hosts).

    Returns ``(sharded_problem, lam, nu, iteration)`` with host-resident
    arrays; re-place with :func:`pysfm_tpu.dist.shard.device_put_sharded`
    (single host) or per-process shard selection (multi-host resume: each
    process may also load only its own part — the part files are
    self-contained for their shard ranges).
    """
    import glob as _glob

    from pysfm_tpu.dist.shard import ShardedProblem

    parts = sorted(_glob.glob(path + ".p*"))
    parts = [q for q in parts if not q.endswith((".json", ".tmp"))]
    if not parts:
        raise FileNotFoundError(f"no checkpoint parts at {path}.p*")
    with open(parts[0] + ".json") as f:
        meta = json.load(f)
    loaded = [np.load(q) for q in parts]
    n = meta["n_shards"]
    fields = {}
    for name in _REPL_FIELDS:
        fields[name] = loaded[0][name]
    covered = np.zeros(n, bool)
    for name in _SHARDED_FIELDS:
        # Each part stores its shards concatenated in start order; split
        # back out by the recorded sizes.
        out = None
        for z in loaded:
            starts = z["shard_starts"]
            sizes = z["shard_sizes"]
            arr = z[name]
            if out is None:
                out = np.zeros((n,) + arr.shape[1:], arr.dtype)
            off = 0
            for s, sz in zip(starts, sizes):
                out[int(s) : int(s) + int(sz)] = arr[off : off + int(sz)]
                covered[int(s) : int(s) + int(sz)] = True
                off += int(sz)
        fields[name] = out
    _check_shard_coverage(path, n, covered)
    sp = ShardedProblem(
        camera_model=meta["camera_model"], robust=meta["robust"], **fields
    )
    z0 = loaded[0]
    return sp, float(z0["lam"]), float(z0["nu"]), int(z0["iteration"])


_CM_SHARDED_FIELDS = (
    "X3", "pt_mask", "obs_cam", "obs_pt", "u", "v", "obs_w",
    "pt_obsT", "pt_obs_maskT", "cam_obs", "cam_obs_mask",
)
_CM_REPL_FIELDS = ("R", "t", "intr", "cam_fixed", "robust_scale")


def save_checkpoint_sharded_cm(
    path: str,
    scm,
    *,
    lam: float = 1e-3,
    nu: float = 2.0,
    iteration: int = 0,
) -> str:
    """Save a :class:`~pysfm_tpu.dist.sharded_cm.ShardedCMProblem`
    mid-solve — the distributed-flagship analog of
    :func:`save_checkpoint_sharded`.  Each process writes ONE part file
    with only its addressable shards plus the replicated camera state;
    atomic via tmp+rename.

    Returns the part path written by this process."""
    import jax

    proc = jax.process_index()
    arrays = dict(
        lam=np.asarray(lam), nu=np.asarray(nu),
        iteration=np.asarray(iteration),
    )
    for name in _CM_REPL_FIELDS:
        arrays[name] = np.asarray(getattr(scm, name))
    starts = sizes = None
    for name in _CM_SHARDED_FIELDS:
        arrays[name], f_starts, f_sizes = _collect_shards(getattr(scm, name))
        if starts is None:
            starts, sizes = f_starts, f_sizes
            arrays["shard_starts"] = starts
            arrays["shard_sizes"] = sizes
        else:
            _check_shard_layout(name, f_starts, f_sizes, starts, sizes)
        global_dim = getattr(scm, name).shape[0]
    meta = {
        "camera_model": scm.camera_model,
        "robust": scm.robust,
        "n_shards": int(global_dim),
        "version": 1,
        "sharded_cm": True,
    }
    part = f"{path}.p{proc}"
    tmp = part + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    # npz first, .json sidecar last (the commit marker).
    os.replace(tmp, part)
    with open(part + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(part + ".json.tmp", part + ".json")
    return part


def load_checkpoint_sharded_cm(path: str):
    """Reassemble a sharded CM checkpoint from all parts at ``path.p*``;
    returns ``(ShardedCMProblem, lam, nu, iteration)`` host-resident.
    Re-place with :func:`pysfm_tpu.dist.device_put_sharded_cm` before
    resuming."""
    import glob as _glob

    from pysfm_tpu.dist.sharded_cm import ShardedCMProblem

    parts = sorted(_glob.glob(path + ".p*"))
    parts = [q for q in parts if not q.endswith((".json", ".tmp"))]
    if not parts:
        raise FileNotFoundError(f"no checkpoint parts at {path}.p*")
    with open(parts[0] + ".json") as f:
        meta = json.load(f)
    if not meta.get("sharded_cm"):
        raise ValueError(f"{path} is not a sharded CM checkpoint")
    loaded = [np.load(q) for q in parts]
    n = meta["n_shards"]
    fields = {}
    for name in _CM_REPL_FIELDS:
        fields[name] = loaded[0][name]
    covered = np.zeros(n, bool)
    for name in _CM_SHARDED_FIELDS:
        out = None
        for z in loaded:
            starts = z["shard_starts"]
            sizes = z["shard_sizes"]
            arr = z[name]
            if out is None:
                out = np.zeros((n,) + arr.shape[1:], arr.dtype)
            off = 0
            for s, sz in zip(starts, sizes):
                out[int(s) : int(s) + int(sz)] = arr[off : off + int(sz)]
                covered[int(s) : int(s) + int(sz)] = True
                off += int(sz)
        fields[name] = out
    _check_shard_coverage(path, n, covered)
    scm = ShardedCMProblem(
        camera_model=meta["camera_model"], robust=meta["robust"], **fields
    )
    z0 = loaded[0]
    return scm, float(z0["lam"]), float(z0["nu"]), int(z0["iteration"])


def latest_checkpoint(directory: str, prefix: str = "ckpt") -> Optional[str]:
    """Newest complete checkpoint in ``directory`` (by iteration suffix
    ``<prefix>_<iteration>.npz``), or None."""
    best: tuple[int, str] | None = None
    for name in os.listdir(directory):
        if not (name.startswith(prefix + "_") and name.endswith(".npz")):
            continue
        stem = name[len(prefix) + 1 : -4]
        if not stem.isdigit():
            continue
        full = os.path.join(directory, name)
        if not os.path.exists(full + ".json"):
            continue  # torn write — the sidecar rename is the commit marker
        it = int(stem)
        if best is None or it > best[0]:
            best = (it, full)
    return best[1] if best else None
