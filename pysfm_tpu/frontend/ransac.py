"""Batched RANSAC — all hypotheses fitted and scored in parallel.

Reference analog (SURVEY §2 "RANSAC"): a generic sequential
hypothesize-and-verify loop.  Here (SURVEY §3.2): sample all N
minimal sets at once, ``vmap`` the fit and the scoring, ``argmax`` the
inlier counts — no sequential loop, one fused device program.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    model: jnp.ndarray        # best (possibly refit) model
    inliers: jnp.ndarray      # [N] bool
    n_inliers: jnp.ndarray    # scalar
    best_hypothesis: jnp.ndarray  # index of the winning minimal set


def ransac(
    key: jax.Array,
    n_data: int,
    fit: Callable,            # (idx [k], w [N]) -> model   (w: sample weights)
    score: Callable,          # (model) -> residual^2 [N]
    *,
    sample_size: int,
    n_hypotheses: int = 256,
    threshold: float = 1e-2,
    refit: bool = True,
    data_weights: jnp.ndarray | None = None,
) -> RansacResult:
    """Generic batched RANSAC.

    ``fit`` receives the indices of a minimal sample plus a one-hot-ish
    weight vector over all data (so weighted solvers can be reused for both
    the minimal fit and the final all-inlier refit).  ``score`` returns
    squared residuals for all N data under one model; hypotheses producing
    non-finite models are discarded by scoring.
    """
    if data_weights is None:
        data_weights = jnp.ones((n_data,))

    keys = jax.random.split(key, n_hypotheses)

    def one(key_h):
        idx = jax.random.choice(
            key_h, n_data, shape=(sample_size,), replace=False,
            p=data_weights / jnp.sum(data_weights),
        )
        w = jnp.zeros((n_data,)).at[idx].set(1.0)
        model = fit(idx, w)
        res = score(model)
        finite = jnp.all(jnp.isfinite(res))
        inl = jnp.logical_and(res < threshold, data_weights > 0)
        count = jnp.where(finite, jnp.sum(inl), -1)
        return model, inl, count

    models, inls, counts = jax.vmap(one)(keys)
    best = jnp.argmax(counts)
    model = jax.tree_util.tree_map(lambda m: m[best], models)
    inliers = inls[best]

    if refit:
        w_in = inliers.astype(jnp.float32) * data_weights
        model_refit = fit(jnp.zeros((sample_size,), jnp.int32), w_in)
        res = score(model_refit)
        inl_refit = jnp.logical_and(res < threshold, data_weights > 0)
        better = jnp.logical_and(
            jnp.all(jnp.isfinite(res)), jnp.sum(inl_refit) >= jnp.sum(inliers)
        )
        model = jax.tree_util.tree_map(
            lambda a, b: jnp.where(better, a, b), model_refit, model
        )
        inliers = jnp.where(better, inl_refit, inliers)

    return RansacResult(
        model=model,
        inliers=inliers,
        n_inliers=jnp.sum(inliers),
        best_hypothesis=best,
    )
