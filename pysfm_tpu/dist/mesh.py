"""Device mesh construction (SURVEY §2 "Communication backend").

The framework's entire communication backend is jax/XLA collectives over an
explicit :class:`jax.sharding.Mesh` — ``psum``/``pmax`` become NCCL
collectives over NVLink within a host and over the network across hosts on
a multi-host mesh; there is no hand-written transport (SURVEY §5 "Distributed communication backend").
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

# The single data-parallel axis used by point-sharded Schur BA.
AXIS = "shard"


def make_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all local devices).

    Multi-host use: call ``jax.distributed.initialize()`` first (one process
    per host); ``jax.devices()`` then spans every host's devices and the
    same mesh covers them all.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))
