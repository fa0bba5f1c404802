"""Device-completion fences for benchmarking.

JAX dispatches asynchronously: a call returns before the device finishes,
so a host-clock timing must end in a fence.  :func:`sync` copies one
element of one leaf to the host — a device->host copy is enqueued after
all preceding work on the stream, so it completes only when that work has.
"""

from __future__ import annotations

import time

import numpy as np


def sync(tree) -> None:
    """Completion barrier: copy one element of `tree` to host."""
    import jax

    leaves = jax.tree_util.tree_leaves(tree)
    if leaves:
        np.asarray(leaves[0].ravel()[:1])


def timeit(fn, *args, n: int = 20, **kw) -> float:
    """Mean seconds/call over `n` calls after one warmup (compile) call."""
    sync(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    sync(out)
    return (time.perf_counter() - t0) / n
