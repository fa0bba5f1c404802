"""Descriptor matching — one matmul + mutual-NN and ratio tests.

Reference analog: SURVEY §2 "feature detection & matching" (descriptor
correlation).  The similarity matrix ``d1 @ d2^T`` is the matmul core;
Lowe's ratio test and the mutual-nearest-neighbour constraint run as
elementwise selects on top.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Matches(NamedTuple):
    idx1: jnp.ndarray    # [K] indices into set 1 (K = min(N1, N2), padded)
    idx2: jnp.ndarray    # [K] indices into set 2
    score: jnp.ndarray   # [K] cosine similarity
    valid: jnp.ndarray   # [K] bool


def match_descriptors(
    d1: jnp.ndarray,          # [N1, D] unit-norm
    d2: jnp.ndarray,          # [N2, D]
    *,
    valid1: jnp.ndarray | None = None,
    valid2: jnp.ndarray | None = None,
    min_similarity: float = 0.7,
    ratio: float = 0.9,
    mutual: bool = True,
) -> Matches:
    """Cosine matching with ratio + mutual checks; static [N1] output.

    The ratio test uses distances: for unit descriptors
    ``dist^2 = 2 - 2 sim``, so the test is
    ``(1 - sim_best) < ratio^2 * (1 - sim_second)``.
    """
    # Default precision on purpose: on a GPU this may run in TF32 (~3
    # decimal digits).  The similarities only rank candidates for the
    # ratio and mutual-NN tests; geometry is re-verified by RANSAC, so
    # nothing here feeds optimizer state.
    sim = d1 @ d2.T                                     # [N1, N2]
    if valid1 is not None:
        sim = jnp.where(valid1[:, None], sim, -1.0)
    if valid2 is not None:
        sim = jnp.where(valid2[None, :], sim, -1.0)

    top2, top2_idx = jax.lax.top_k(sim, 2)              # [N1, 2]
    best, second = top2[:, 0], top2[:, 1]
    idx2 = top2_idx[:, 0]
    ok = best > min_similarity
    ok &= (1.0 - best) < (ratio * ratio) * (1.0 - second)
    if mutual:
        back = jnp.argmax(sim, axis=0)                  # [N2] best 1 for each 2
        ok &= back[idx2] == jnp.arange(d1.shape[0])
    if valid1 is not None:
        ok &= valid1
    return Matches(
        idx1=jnp.arange(d1.shape[0]),
        idx2=idx2,
        score=best,
        valid=ok,
    )
