"""BAL-scale normal-equation build: obs-chunked, scatter-free, component-
major, O(M) memory.

This is the build path for BASELINE config 4 (Venice: 1.7k cams, 1M points,
~5M observations), where the small-problem builders break down:

- :func:`pysfm_tpu.solver.schur.build_normal_equations`'s camera-side
  one-hot reduction materializes an ``[M, C]`` operand (34 GB at Venice
  scale) and costs ``M*C*D`` flops;
- materializing the full Jacobians ``J_cam [M, 2, CP]`` / ``J_pt [M, 2, 3]``
  plus their products peaks at several GB of HBM that the LM while_loop
  holds across the iteration.

**Layout rule:** every array whose leading axis is observation/point-sized
keeps that big axis MINOR (last).  Component-major ``[3*CP, M]`` rows are
read and written as contiguous runs of observations, so every elementwise
stage and every masked reduce below is a coalesced, memory-bound pass; a
block array like ``B [M, CP, 3]`` would interleave its tiny (6, 3) tail with
the observation axis.  The same rule shapes every gathered table below.

The residual/Jacobian build runs as a ``lax.map`` over observation chunks
(SURVEY §5 "obs-chunked accumulation"; the map lowers to a
sequential scan, so only one chunk's Jacobians ever exist), emitting compact
component-major per-observation rows:

- ``B_cm [3*CP, M]``   coupling blocks, row ``s*CP + d`` = B(d, s)
  (kept: the PCG operand),
- ``cam_rows [CP(CP+3)/2, M]`` packed symmetric ``w Jc^T Jc`` + ``Jc^T w r``,
- ``pt_rows [9, M]``           packed symmetric ``w Jp^T Jp`` + ``Jp^T w r``.

Both block reductions then run in the **gathered (table) domain** — one
row-gather through the padded ``cam_obs`` / ``pt_obs`` visibility tables
followed by a masked sum over the track axis.  No ``segment_sum`` scatter,
no one-hot matmuls, every op memory-bound with static shapes.

The result is numerically the same normal equations the small-problem
builders produce (same per-observation products, different — but fixed —
summation order); equality is asserted in f64 by ``tests/test_scale.py``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pysfm_tpu.problem import cm
from pysfm_tpu.problem import problem as problem_mod
from pysfm_tpu.problem import robust as robust_mod

# Lower-triangular 3x3 component order used throughout (matches schur_cm).
TRI3 = ((0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2))


class ScaleEqs(NamedTuple):
    """Component-major undamped normal equations for the BAL-scale path."""

    Hcc: jnp.ndarray    # [C, CP, CP] (dense, symmetric; small)
    g_c: jnp.ndarray    # [C, CP]
    hpp6: jnp.ndarray   # [6, P] lower-tri point blocks (00,10,11,20,21,22)
    g_p: jnp.ndarray    # [3, P]
    B_cm: jnp.ndarray   # [3*CP, M]; row s*CP+d = sum_i Jc[i,d] w Jp[i,s]


def _tri_pairs(cp: int):
    return [(d, e) for d in range(cp) for e in range(d + 1)]


def _payload_rows(cmp: cm.CMProblem, ctab, oc, op, u_o, v_o, w_conf):
    """Component-major per-observation payload for one chunk — every
    intermediate is an [m] vector (see problem/cm.py's layout rationale).

    Returns (B_cm [3*CP, m], cam_rows [Rc, m], pt_rows [9, m]) with
    Rc = CP*(CP+1)/2 + CP (Hcc lower triangle, then g_c)."""
    cols = ctab[:, oc]                                       # [Dc, m]
    Xg = cmp.X3[:, op]                                       # [3, m]
    u, v, Jc, Jp = cm.project_jac_cm(cmp.camera_model, cols, Xg)
    r0 = u - u_o
    r1 = v - v_o
    s = r0 * r0 + r1 * r1
    w = w_conf * robust_mod.weight(cmp.robust, s, cmp.robust_scale)
    cp = len(Jc[0])

    wJp = [[w * Jp[i][k] for k in range(3)] for i in range(2)]
    wr0 = w * r0
    wr1 = w * r1
    # B(d, s) rows, s-major: row s*CP + d = sum_i Jc[i][d] w Jp[i][s].
    B_cm = jnp.stack(
        [
            Jc[0][d] * wJp[0][k] + Jc[1][d] * wJp[1][k]
            for k in range(3)
            for d in range(cp)
        ]
    )                                                        # [3*CP, m]
    wJc = [[w * Jc[i][d] for d in range(cp)] for i in range(2)]
    cam_rows = jnp.stack(
        [
            wJc[0][d] * Jc[0][e] + wJc[1][d] * Jc[1][e]
            for d, e in _tri_pairs(cp)
        ]
        + [Jc[0][d] * wr0 + Jc[1][d] * wr1 for d in range(cp)]
    )                                                        # [Rc, m]
    pt_rows = jnp.stack(
        [
            Jp[0][d] * wJp[0][e] + Jp[1][d] * wJp[1][e]
            for d, e in TRI3
        ]
        + [Jp[0][k] * wr0 + Jp[1][k] * wr1 for k in range(3)]
    )                                                        # [9, m]
    return B_cm, cam_rows, pt_rows


def _unpack_sym(rows: jnp.ndarray, cp: int) -> jnp.ndarray:
    """[N_tri, C] packed lower-tri rows -> [C, cp, cp] symmetric blocks."""
    out = jnp.zeros((rows.shape[1], cp, cp), rows.dtype)
    for i, (d, e) in enumerate(_tri_pairs(cp)):
        out = out.at[:, d, e].set(rows[i])
        if d != e:
            out = out.at[:, e, d].set(rows[i])
    return out


def _chunked(arrs, M, obs_chunk):
    """Pad flat [M] observation arrays to a chunk multiple and reshape to
    [n_chunks, m] for ``lax.map``.  Padding slots carry obs_w = 0 (the
    weight array is padded with zeros), so every payload row is zero."""
    obs_chunk = min(obs_chunk or (1 << 18), M)
    n_chunks = -(-M // obs_chunk)
    pad = n_chunks * obs_chunk - M

    def padded(x):
        return jnp.pad(x, ((0, pad),)) if pad else x

    return [padded(x).reshape(n_chunks, obs_chunk) for x in arrs], n_chunks


@partial(jax.jit, static_argnames=("obs_chunk",))
def build_normal_equations_scale_cm(
    cmp: cm.CMProblem, obs_chunk: int = 0
) -> ScaleEqs:
    """Scatter-free component-major normal equations for the PCG path;
    ``obs_chunk`` > 0 bounds the Jacobian working set to one chunk (padded
    to a chunk multiple)."""
    M = cmp.n_obs
    cp = cmp.cam_dof
    # The payload always runs through the chunked lax.map, even when a
    # single chunk covers the problem: one program shape for every size,
    # and only one chunk's Jacobians are live at a time.
    ctab = cm.cam_table(cmp)                                  # [Dc, C]
    (oc, op, u, v, wc), _ = _chunked(
        [cmp.obs_cam, cmp.obs_pt, cmp.u, cmp.v, cmp.obs_w], M, obs_chunk
    )
    B_cm, cam_rows, pt_rows = jax.lax.map(
        lambda args: _payload_rows(cmp, ctab, *args), (oc, op, u, v, wc)
    )
    # [n_chunks, D, m] -> [D, M]: chunk axis folds into the minor axis.
    m_pad = oc.shape[0] * oc.shape[1]

    def unchunk(x):
        return x.transpose(1, 0, 2).reshape(x.shape[1], m_pad)[:, :M]

    B_cm = unchunk(B_cm)
    cam_rows = unchunk(cam_rows)
    pt_rows = unchunk(pt_rows)

    # Camera-side reduction through the cam_obs table: gather the rows into
    # the [C, Kc] grid (big axes in the two minor positions) + masked sum.
    # Gathers are fenced with optimization_barrier throughout, so each
    # gathered table is materialized once before its masked reduce.
    cmask = cmp.cam_obs_mask.astype(B_cm.dtype)               # [C, Kc]
    cam_g = jax.lax.optimization_barrier(cam_rows[:, cmp.cam_obs])
    cred = jnp.sum(cam_g * cmask, axis=-1)                    # [Rc, C]
    n_tri = cp * (cp + 1) // 2
    Hcc = _unpack_sym(cred[:n_tri], cp)
    g_c = cred[n_tri:].T                                      # [C, CP]

    # Point-side reduction through the (pre-transposed) pt_obs table, track
    # axis leading so the point axis stays minor: [9, K, P] -> [9, P].
    pmask_t = cmp.pt_obs_maskT.astype(B_cm.dtype)             # [K, P]
    pt_g = jax.lax.optimization_barrier(pt_rows[:, cmp.pt_obsT])
    pred = jnp.sum(pt_g * pmask_t, axis=1)                    # [9, P]
    hpp6 = pred[:6]
    g_p = pred[6:]
    # Materialization fence: keeps XLA from fusing the payload/reduction
    # graph into the downstream CG while_loop.
    return jax.lax.optimization_barrier(
        ScaleEqs(Hcc=Hcc, g_c=g_c, hpp6=hpp6, g_p=g_p, B_cm=B_cm)
    )


@partial(jax.jit, static_argnames=("obs_chunk",))
def build_normal_equations_scale(
    p: problem_mod.BundleProblem, obs_chunk: int = 0
) -> ScaleEqs:
    """Standard-layout entry: converts to the CM layout (one transpose of
    the point/obs arrays) and delegates to
    :func:`build_normal_equations_scale_cm`."""
    return build_normal_equations_scale_cm(cm.from_problem(p), obs_chunk)


def sym6_inv(h6: jnp.ndarray) -> jnp.ndarray:
    """Inverse of symmetric 3x3 blocks in 6-component form ([6, N])."""
    a, b, c, d, e, f = h6
    adj00 = c * f - e * e
    adj10 = d * e - b * f
    adj20 = b * e - c * d
    adj11 = a * f - d * d
    adj21 = b * d - a * e
    adj22 = a * c - b * b
    det = a * adj00 + b * adj10 + d * adj20
    inv_det = 1.0 / det
    return jnp.stack([adj00, adj10, adj11, adj20, adj21, adj22]) * inv_det


def sym6_mv(h6: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """[6, N] symmetric blocks times [3, N] vectors -> [3, N]."""
    a, b, c, d, e, f = h6
    return jnp.stack([
        a * v[0] + b * v[1] + d * v[2],
        b * v[0] + c * v[1] + e * v[2],
        d * v[0] + e * v[1] + f * v[2],
    ])


def augment6(h6: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """LM damping of lower-tri point blocks with unit fill on zero diagonals
    (padding / unobserved points) — matches schur.augment_block_diag."""
    def aug(x):
        return x + lam * x + jnp.where(x == 0, jnp.ones_like(x), 0.0)

    return jnp.stack(
        [aug(h6[0]), h6[1], aug(h6[2]), h6[3], h6[4], aug(h6[5])]
    )


@partial(jax.jit, static_argnames=("obs_chunk",))
def cost_scale_cm(cmp: cm.CMProblem, obs_chunk: int = 0) -> jnp.ndarray:
    """Robust cost, obs-chunked, component-major: the per-chunk working set
    is one [Dc, m] camera-column gather + one [3, m] point gather instead
    of the standard layout's ``R[obs_cam] [M, 3, 3]`` gather."""
    M = cmp.n_obs
    ctab = cm.cam_table(cmp)
    (oc, op, u, v, wc), _ = _chunked(
        [cmp.obs_cam, cmp.obs_pt, cmp.u, cmp.v, cmp.obs_w], M, obs_chunk
    )

    def chunk_cost(args):
        oci, opi, ui, vi, wi = args
        uh, vh = cm.project_cm(
            cmp.camera_model, ctab[:, oci], cmp.X3[:, opi]
        )
        r0 = uh - ui
        r1 = vh - vi
        s = r0 * r0 + r1 * r1
        return jnp.sum(wi * robust_mod.rho(cmp.robust, s, cmp.robust_scale))

    parts = jax.lax.map(chunk_cost, (oc, op, u, v, wc))
    return 0.5 * jnp.sum(parts)


@partial(jax.jit, static_argnames=("obs_chunk",))
def cost_scale(
    p: problem_mod.BundleProblem, obs_chunk: int = 0
) -> jnp.ndarray:
    """Standard-layout entry for :func:`cost_scale_cm`."""
    return cost_scale_cm(cm.from_problem(p), obs_chunk)


def predicted_reduction_scale(
    eqs: ScaleEqs,
    lam: jnp.ndarray,
    dc: jnp.ndarray,
    dp: jnp.ndarray,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """Same LM model-reduction formula as schur.predicted_reduction, from
    the component-major containers.  ``dc [C, CP]``, ``dp [P, 3]``."""
    Hcc, g_c = eqs.Hcc, eqs.g_c
    if axis_name is not None:
        Hcc = jax.lax.psum(Hcc, axis_name)
        g_c = jax.lax.psum(g_c, axis_name)
    d_cc = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
    d_pp = jnp.stack([eqs.hpp6[0], eqs.hpp6[2], eqs.hpp6[5]], axis=-1)
    fill_c = jnp.where(d_cc == 0, 1.0, 0.0)
    fill_p = jnp.where(d_pp == 0, 1.0, 0.0)
    cam_term = jnp.sum((lam * d_cc + fill_c) * dc * dc) - jnp.sum(dc * g_c)
    pt_term = (
        jnp.sum((lam * d_pp + fill_p) * dp * dp) - jnp.sum(dp * eqs.g_p.T)
    )
    if axis_name is not None:
        pt_term = jax.lax.psum(pt_term, axis_name)
    return 0.5 * (cam_term + pt_term)


def predicted_reduction_scale_cm(
    eqs: ScaleEqs,
    lam: jnp.ndarray,
    dc: jnp.ndarray,
    dp3: jnp.ndarray,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """:func:`predicted_reduction_scale` with the point step kept
    component-major (``dp3 [3, P]``, no transpose)."""
    Hcc, g_c = eqs.Hcc, eqs.g_c
    if axis_name is not None:
        Hcc = jax.lax.psum(Hcc, axis_name)
        g_c = jax.lax.psum(g_c, axis_name)
    d_cc = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
    d_pp3 = jnp.stack([eqs.hpp6[0], eqs.hpp6[2], eqs.hpp6[5]])     # [3, P]
    fill_c = jnp.where(d_cc == 0, 1.0, 0.0)
    fill_p = jnp.where(d_pp3 == 0, 1.0, 0.0)
    cam_term = jnp.sum((lam * d_cc + fill_c) * dc * dc) - jnp.sum(dc * g_c)
    pt_term = (
        jnp.sum((lam * d_pp3 + fill_p) * dp3 * dp3)
        - jnp.sum(dp3 * eqs.g_p)
    )
    if axis_name is not None:
        pt_term = jax.lax.psum(pt_term, axis_name)
    return 0.5 * (cam_term + pt_term)
