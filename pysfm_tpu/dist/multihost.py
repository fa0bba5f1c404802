"""Multi-host runtime glue (SURVEY §2 "Keyframe/map partitioning across
hosts", §5 "Distributed communication backend").

The framework's cross-host story is deliberately thin: one process per
host, ``jax.distributed.initialize`` to form the PJRT global runtime, and
then the SAME 1-D point-shard mesh (:func:`pysfm_tpu.dist.make_mesh`)
spanning every device of every host — XLA routes the per-iteration psum
over NVLink within a host and over the network across hosts.  No transport
code lives in this framework (jax collectives are the entire backend).

Host-sharded data loading: each host materializes only its own point
shards (``shard_problem`` is deterministic, so hosts agree on the global
partition without communicating) and builds the global sharded arrays with
``jax.make_array_from_single_device_arrays``.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pysfm_tpu.dist.mesh import AXIS
from pysfm_tpu.dist.shard import ShardedProblem, shard_problem
from pysfm_tpu.problem import BundleProblem


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-host runtime (idempotent).

    With no arguments, defers to the environment (a cluster jax detects by
    itself, such as SLURM, or
    ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``),
    which is how cluster launchers invoke one process per host.
    """
    # NB: probing with jax.process_count() would itself initialize the XLA
    # backend, after which jax.distributed.initialize() refuses to run.
    if jax.distributed.is_initialized():
        return  # already joined
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env is not None else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env is not None else None

    given = {
        "coordinator_address": coordinator_address,
        "num_processes": num_processes,
        "process_id": process_id,
    }
    supplied = {k: v for k, v in given.items() if v is not None}
    if not supplied:
        # Nothing configured anywhere: explicit single-process run, or a
        # cluster whose environment jax discovers by itself.
        try:
            jax.distributed.initialize()
        except (ValueError, RuntimeError):
            return  # no cluster environment — stay a local single process
        return
    if len(supplied) != len(given):
        # A PARTIAL configuration is a misconfigured launch; silently
        # degrading to a single-process run would corrupt the reduction
        # (each host would solve its own shard as if it were the world) —
        # fail loudly instead (SURVEY §5 "failure detection").
        missing = sorted(set(given) - set(supplied))
        raise RuntimeError(
            "multihost.initialize: partial multi-host configuration — got "
            f"{sorted(supplied)} but missing {missing} (set all of "
            "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID "
            "or pass them explicitly)"
        )
    jax.distributed.initialize(**supplied)


def global_mesh() -> Mesh:
    """1-D mesh over every device of every host (call after
    :func:`initialize`)."""
    return Mesh(np.asarray(jax.devices()), (AXIS,))


def _putters(mesh: Mesh):
    """(put_sharded, put_repl) building global jax.Arrays from the buffers
    owned by THIS process's devices — no host ever materializes another
    host's shards on device."""
    shard_sharding = NamedSharding(mesh, P(AXIS))
    repl_sharding = NamedSharding(mesh, P())
    local = set(jax.local_devices())

    def put_sharded(x):
        x = np.asarray(x)
        bufs = [
            jax.device_put(x[i : i + 1], d)   # keep the sharded leading axis
            for i, d in enumerate(mesh.devices.ravel())
            if d in local
        ]
        return jax.make_array_from_single_device_arrays(
            x.shape, shard_sharding, bufs
        )

    def put_repl(x):
        x = np.asarray(x)
        bufs = [
            jax.device_put(x, d) for d in mesh.devices.ravel() if d in local
        ]
        return jax.make_array_from_single_device_arrays(
            x.shape, repl_sharding, bufs
        )

    return put_sharded, put_repl


def shard_cm_problem_multihost(cmp, mesh: Mesh):
    """Build the globally point-sharded COMPONENT-MAJOR problem (the
    BAL-scale flagship layout) across hosts: the same deterministic
    global partition as :func:`pysfm_tpu.dist.sharded_cm.shard_cm_problem`
    over all devices of the mesh, assembled from per-host buffers.
    Returns a ``ShardedCMProblem`` ready for
    :func:`pysfm_tpu.dist.solve_sharded_cm` on ``mesh``."""
    from pysfm_tpu.dist.sharded_cm import shard_cm_problem

    n = mesh.devices.size
    scm = shard_cm_problem(cmp, n)
    put_sharded, put_repl = _putters(mesh)
    scm = scm.replace(
        R=put_repl(scm.R), t=put_repl(scm.t), intr=put_repl(scm.intr),
        cam_fixed=put_repl(scm.cam_fixed),
        robust_scale=put_repl(scm.robust_scale),
        X3=put_sharded(scm.X3), pt_mask=put_sharded(scm.pt_mask),
        obs_cam=put_sharded(scm.obs_cam), obs_pt=put_sharded(scm.obs_pt),
        u=put_sharded(scm.u), v=put_sharded(scm.v),
        obs_w=put_sharded(scm.obs_w),
        pt_obsT=put_sharded(scm.pt_obsT),
        pt_obs_maskT=put_sharded(scm.pt_obs_maskT),
        cam_obs=put_sharded(scm.cam_obs),
        cam_obs_mask=put_sharded(scm.cam_obs_mask),
    )
    return scm


def shard_problem_multihost(p: BundleProblem, mesh: Mesh) -> ShardedProblem:
    """Build the globally point-sharded problem across hosts.

    Every host runs the same deterministic global partition
    (:func:`shard_problem` over ``n_total_shards`` = global device count)
    but only uploads the shards owned by its local devices; the global
    jax.Arrays are assembled from single-device buffers so no host ever
    materializes another host's points on device.
    """
    n = mesh.devices.size
    sp = shard_problem(p, n)  # host-side global partition (NumPy)
    put_sharded, put_repl = _putters(mesh)

    return sp.replace(
        R=put_repl(sp.R), t=put_repl(sp.t), intr=put_repl(sp.intr),
        cam_fixed=put_repl(sp.cam_fixed),
        X=put_sharded(sp.X), pt_mask=put_sharded(sp.pt_mask),
        obs_cam=put_sharded(sp.obs_cam), obs_pt=put_sharded(sp.obs_pt),
        obs_uv=put_sharded(sp.obs_uv), obs_w=put_sharded(sp.obs_w),
        pt_obs=put_sharded(sp.pt_obs), pt_obs_mask=put_sharded(sp.pt_obs_mask),
        cam_obs=put_sharded(sp.cam_obs),
        cam_obs_mask=put_sharded(sp.cam_obs_mask),
        robust_scale=put_repl(sp.robust_scale),
    )
