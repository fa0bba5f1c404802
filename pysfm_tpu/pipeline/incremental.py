"""Incremental SfM driver (SURVEY §3.3, BASELINE config 2).

Reference analog: the sequence pipeline — two-view bootstrap, then per
keyframe: 2D-3D resection (RANSAC'd PnP), triangulate newly-visible tracks,
windowed or full bundle adjustment.

Host/device split (SURVEY §3.3 boundary note): per-keyframe orchestration runs on
the host (Python state machine, small bookkeeping), every inner solve is a
batched device computation (batched-hypothesis RANSAC, masked multi-view
DLT, on-device LM).

Static-shape discipline (SURVEY §7 "Irregular visibility graph"): every
device computation in the incremental loop runs at a FIXED shape for the
whole reconstruction —

- the BA problem always carries all ``F`` cameras, all ``T`` tracks and all
  ``M = vis.sum()`` potential observations; registration/triangulation
  status is expressed through ``obs_w``/``cam_fixed`` masks, so each LM
  solve reuses one compiled executable instead of recompiling per keyframe;
- RANSAC inputs (epipolar + PnP) are padded to multiples of 32 with
  zero-weight rows;
- multi-view triangulation always spans all ``F`` views with a mask.

Robustness beyond the reference:

- init-pair selection: the bootstrap pair is chosen by essential-matrix
  inlier count *gated on median parallax* — a low-parallax pair yields a
  quasi-degenerate (forward-translation) pose that poisons the whole map;
- a minimum triangulation-angle gate at point creation and in post-BA
  hygiene (depth-ill-conditioned points drift to infinity and drag LM into
  the rotation-only degeneracy);
- scale-gauge renormalization after every BA (first camera frozen, baseline
  of the init pair rescaled to 1) instead of freezing a second camera.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pysfm_tpu.frontend import epipolar, p3p, ransac, triangulate
from pysfm_tpu.problem import BundleProblem, make_problem
from pysfm_tpu.solver import solve
from pysfm_tpu.utils.config import LMConfig as _LMConfig


@dataclasses.dataclass(frozen=True)
class IncrementalConfig:
    window: int = 5                  # cameras optimized in windowed BA
    ransac_hypotheses: int = 256
    epipolar_threshold: float = 1e-6   # Sampson (normalized coords, squared)
    pnp_threshold: float = 1e-5        # squared normalized-coord residual
    min_track_views: int = 2
    min_pnp_points: int = 5
    ba_iters_window: int = 10
    ba_iters_final: int = 30
    # Post-BA hygiene: deactivate observations with reprojection error above
    # an adaptive threshold clip(4 * 1.4826 * MAD, min_reproj_px,
    # max_reproj_px); points left with < min_track_views views lose their
    # 3-D status (and may be re-triangulated later from clean views).  The
    # MAD-based noise estimate tracks the actual detector jitter instead of
    # assuming a fixed pixel noise.
    max_reproj_px: float = 4.0
    min_reproj_px: float = 0.3
    # Minimum triangulation (parallax) angle, degrees: a point whose
    # observing rays subtend less than this has ill-conditioned depth and
    # drifts toward infinity under BA.  Gated at creation and in hygiene.
    min_tri_angle_deg: float = 1.0
    # Init-pair selection: candidate pairs ranked by common-track count;
    # the chosen pair needs its RANSAC-inlier median parallax above
    # ``init_min_parallax_deg``.  This is deliberately much stricter than
    # the per-point gate: a marginal-parallax pair admits the
    # rotation-only/forward-translation degenerate pose, and two-view BA
    # then collapses the map (small-baseline scenes fit ANY epipolar
    # geometry to noise level).  COLMAP uses ~16 deg for the same reason.
    init_max_pairs: int = 20
    init_min_parallax_deg: float = 4.0
    # Robust kernel: Cauchy by default.  Huber's convex linear tail still
    # lets a mismatched track pull cameras toward itself; the redescending
    # Cauchy weight ~ 1/r^2 makes gross outliers inert, which proved the
    # difference between ATE ~0.5 and ~0.04 on the tracked-video tests.
    robust: str = "cauchy"
    robust_scale: float = 0.5
    # Frames resected per batched PnP dispatch (all against the same map
    # state) before the next windowed BA.  Cuts device round-trips per
    # keyframe ~register_batch-fold; 1 recovers the one-frame-per-BA
    # schedule.  Keep <= window so the window BA still covers every newly
    # registered camera.
    register_batch: int = 4
    seed: int = 0


@dataclasses.dataclass
class Reconstruction:
    """Host-side result: the final (globally adjusted) problem + history.

    ``problem`` carries ALL frames/tracks at static shape; inactive
    observations have ``obs_w == 0`` and unregistered cameras are frozen at
    identity.  ``registered``/``has_point`` give the live subsets.
    """

    problem: BundleProblem
    registered: np.ndarray          # [F] bool
    has_point: np.ndarray           # [T] bool
    stats: dict


def _pad_count(n: int, mult: int = 32) -> int:
    """Static-shape bucket for RANSAC inputs (avoids per-call recompiles)."""
    return max(mult, int(np.ceil(n / mult)) * mult)


def _pow2_bucket(n: int, floor: int = 512) -> int:
    """Next power-of-two bucket — shape classes grow O(log n), so the
    window-BA executable recompiles only O(log n) times over a run."""
    b = floor
    while b < n:
        b *= 2
    return b


def _max_tri_angle(X_pts, R, t, obs_mask):
    """Max pairwise parallax angle (rad) subtended at each point by its
    observing camera centers.  X_pts [P,3]; R [F,3,3]; t [F,3];
    obs_mask [F,P] bool.  Host-side bookkeeping.

    Works per point over its observing subset (compressed [P, K] table with
    K = max views per point) — O(P K^2) instead of the all-pairs O(F^2 P)
    that dominated host time past ~20 keyframes.
    """
    P = X_pts.shape[0]
    C = -np.einsum("fij,fi->fj", R, t)                     # [F, 3] centers
    p_idx, f_idx = np.nonzero(obs_mask.T)                  # sorted by point
    counts = np.bincount(p_idx, minlength=P)
    K = int(counts.max(initial=1))
    start = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    pos = np.arange(len(p_idx)) - start[p_idx]
    cam_tab = np.zeros((P, K), dtype=np.int64)
    m = np.zeros((P, K), dtype=bool)
    cam_tab[p_idx, pos] = f_idx
    m[p_idx, pos] = True
    d = X_pts[:, None, :] - C[cam_tab]                     # [P, K, 3]
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    cosang = np.einsum("pkd,pld->pkl", d, d)               # [P, K, K]
    pair_ok = m[:, :, None] & m[:, None, :]
    cosang = np.where(pair_ok, cosang, 1.0)
    return np.arccos(np.clip(cosang.min(axis=(1, 2)), -1.0, 1.0))  # [P]


@partial(jax.jit, static_argnames=("n_hypotheses", "threshold"))
def _two_view_batch(keys, pn1s, pn2s, ws, *, n_hypotheses, threshold):
    """All candidate init pairs in ONE dispatch: vmap of the two-view
    RANSAC + pose selection + per-point parallax angle over the pair axis.

    The sequential per-pair loop cost up to ``init_max_pairs`` device
    round-trips (each a RANSAC dispatch, with one executable per padding
    bucket).  Inputs are padded to ONE common bucket; returns
    ``(R2 [B,3,3], t2 [B,3], inliers [B,N], ang [B,N])`` with ``ang`` the
    triangulation angle each point subtends at the two camera centers.
    """
    def one(key, pn1, pn2, w):
        def fit(_, wfit):
            return epipolar.eight_point(pn1, pn2, w=wfit, essential=True)

        def score(E):
            return epipolar.sampson_distance(E, pn1, pn2)

        res = ransac.ransac(
            key, pn1.shape[0], fit, score,
            sample_size=8, n_hypotheses=n_hypotheses,
            threshold=threshold, data_weights=w,
        )
        R2, t2, _, Xtri = epipolar.select_pose(
            res.model, pn1, pn2, w=res.inliers.astype(pn1.dtype)
        )
        # Parallax per point: angle between the rays from the two camera
        # centers C0 = 0 and C1 = -R2^T t2 (same quantity the host-side
        # _max_tri_angle computes for a 2-view problem).
        C1 = -R2.T @ t2
        d1 = Xtri
        d2 = Xtri - C1[None]
        n1 = jnp.linalg.norm(d1, axis=-1)
        n2 = jnp.linalg.norm(d2, axis=-1)
        cosang = jnp.sum(d1 * d2, axis=-1) / jnp.maximum(n1 * n2, 1e-12)
        ang = jnp.arccos(jnp.clip(cosang, -1.0, 1.0))
        return R2, t2, res.inliers, Xtri, ang

    return jax.vmap(one)(keys, pn1s, pn2s, ws)


@partial(jax.jit, static_argnames=("n_hypotheses", "threshold"))
def _pnp_batch(keys, Xps, pns, wps, *, n_hypotheses, threshold):
    """A batch of P3P-RANSAC resections in ONE dispatch (vmap over the
    frame axis) — same round-trip-batching pattern as
    :func:`_two_view_batch`.  Inputs padded to a common point count with
    zero-weight rows; returns ``(R [B,3,3], t [B,3], inliers [B,N])``."""
    def one(key, Xp, pn, w):
        return p3p.p3p_ransac(
            key, Xp, pn,
            n_hypotheses=n_hypotheses, threshold=threshold,
            data_weights=w,
        )

    return jax.vmap(one)(keys, Xps, pns, wps)


def _hygiene_uvhat(camera_model, R, t, intr, X, ff_all, tt_all):
    """Reprojection of every (static) observation slot for post-BA
    filtering — one device dispatch per BA round."""
    from pysfm_tpu.geometry import projection as _proj

    return np.asarray(
        _proj.project(
            camera_model,
            jnp.asarray(R[ff_all]), jnp.asarray(t[ff_all]),
            jnp.asarray(intr[ff_all]), jnp.asarray(X[tt_all]),
        )
    )


def run_incremental(
    uv: np.ndarray,        # [F, T, 2] pixel measurement of track t in frame f
    vis: np.ndarray,       # [F, T] bool visibility
    intr: np.ndarray,      # [F, I] intrinsics per frame
    camera_model: str = "pose",
    config: IncrementalConfig = IncrementalConfig(),
) -> Reconstruction:
    """Run the full incremental pipeline on a track table.

    Bootstraps from the best-conditioned frame pair (inliers x parallax),
    then registers remaining frames next-best-view first.
    """
    import time as _time

    F, T = vis.shape
    cfg = config
    if cfg.register_batch > cfg.window:
        # The windowed BA must cover every newly registered camera before
        # it becomes fixed context (see IncrementalConfig.register_batch);
        # silently degraded poses for the overflow cameras are worse than
        # a loud error.
        raise ValueError(
            f"register_batch ({cfg.register_batch}) must be <= window "
            f"({cfg.window}) so windowed BA optimizes every newly "
            "registered camera"
        )
    key = jax.random.PRNGKey(cfg.seed)
    uv_j = jnp.asarray(uv)
    intr_j = jnp.asarray(intr)

    timings = {
        "pnp": 0.0, "triangulate": 0.0, "window_ba": 0.0,
        "hygiene": 0.0, "bootstrap": 0.0, "host_other": 0.0,
    }
    _t_run0 = _time.perf_counter()

    class _T:
        """Accumulate wall time of a stage into ``timings``."""

        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0 = _time.perf_counter()

        def __exit__(self, *a):
            timings[self.name] += _time.perf_counter() - self.t0

    # Normalized coordinates for every (frame, track) — batched, once.
    pn_all = np.asarray(
        triangulate.pixel_to_normalized(
            camera_model, intr_j[:, None, :], uv_j
        )
    )                                                     # [F, T, 2]

    R = np.tile(np.eye(3), (F, 1, 1))
    t = np.zeros((F, 3))
    X = np.zeros((T, 3))
    X[:, 2] = 10.0  # safe depth for padding rows (keeps projection finite)
    registered = np.zeros(F, bool)
    has_pt = np.zeros(T, bool)
    # `active` masks observations considered live; post-BA filtering turns
    # off high-residual ones (they never return).
    active = vis.copy()
    stats = {"bootstrap_inliers": 0, "init_pair": None, "init_pairs_tried": [],
             "pnp_inliers": [], "ba_costs": [], "filtered_obs": 0,
             "pnp_candidates": []}

    # Static observation list for every BA problem in this run.
    ff_all, tt_all = np.nonzero(vis)

    min_angle = np.deg2rad(cfg.min_tri_angle_deg)

    # ---- init-pair selection + two-view bootstrap (SURVEY §3.2) -----------
    counts = np.einsum("ft,gt->fg", vis.astype(np.int64), vis.astype(np.int64))
    iu = np.triu_indices(F, k=1)
    order = np.argsort(counts[iu])[::-1]
    cand_pairs = [
        (int(iu[0][k]), int(iu[1][k]))
        for k in order[: cfg.init_max_pairs]
        if counts[iu[0][k], iu[1][k]] >= 8
    ]
    if not cand_pairs:
        raise ValueError("no frame pair shares >= 8 tracks")

    # All candidate pairs RANSAC'd + scored in ONE device dispatch (a
    # sequential per-pair loop costs init_max_pairs round-trips and one
    # compiled executable per padding bucket).
    idx_list = [np.flatnonzero(vis[i0] & vis[i1]) for i0, i1 in cand_pairs]
    npad = _pad_count(max(len(ix) for ix in idx_list))
    NP = len(cand_pairs)
    pn1s = np.zeros((NP, npad, 2))
    pn2s = np.zeros((NP, npad, 2))
    ws = np.zeros((NP, npad))
    for k, ((i0, i1), ix) in enumerate(zip(cand_pairs, idx_list)):
        n = len(ix)
        pn1s[k, :n] = pn_all[i0, ix]
        pn2s[k, :n] = pn_all[i1, ix]
        ws[k, :n] = 1.0
    key, sub = jax.random.split(key)
    keys = jax.random.split(sub, NP)
    with _T("bootstrap"):
        R2b, t2b, inlb, Xtrib, angb = _two_view_batch(
            keys, jnp.asarray(pn1s), jnp.asarray(pn2s), jnp.asarray(ws),
            n_hypotheses=cfg.ransac_hypotheses,
            threshold=cfg.epipolar_threshold,
        )
    R2b, t2b, Xtrib, angb = map(np.asarray, (R2b, t2b, Xtrib, angb))
    inlb = np.asarray(inlb) & (ws > 0)

    best = None  # (score, n_inl, i0, i1, idx, inl, R2, t2, Xtri, ang)
    gate = np.deg2rad(cfg.init_min_parallax_deg)
    for k, ((i0, i1), idx) in enumerate(zip(cand_pairs, idx_list)):
        inl = inlb[k]
        n_inl = int(inl.sum())
        if n_inl < 8:
            continue
        med = float(np.median(angb[k][inl]))
        score = n_inl * (1.0 if med >= gate else 0.0)
        stats["init_pairs_tried"].append(
            (i0, i1, n_inl, round(np.rad2deg(med), 2))
        )
        entry = (
            score, n_inl, i0, i1, idx, inl, R2b[k], t2b[k], Xtrib[k],
            angb[k][inl],
        )
        if best is None or (score, n_inl) > (best[0], best[1]):
            best = entry
    if best is None:
        raise ValueError("two-view bootstrap failed on every candidate pair")
    _, n_inl, i0, i1, idx, inl, R2n, t2n, Xtri, ang = best
    stats["init_pair"] = (i0, i1)
    stats["bootstrap_inliers"] = n_inl

    scale = max(float(np.linalg.norm(t2n)), 1e-12)
    R[i1] = R2n
    t[i1] = t2n / scale              # unit-baseline scale gauge
    registered[i0] = registered[i1] = True
    # Assign triangulated, parallax-gated inliers (padded axis -> track ids;
    # `ang` was computed on the inlier subset, expand it back).
    keep = inl.copy()
    keep[inl] &= ang >= min_angle
    ok_rows = np.flatnonzero(keep[: len(idx)])
    X[idx[ok_rows]] = Xtri[ok_rows] / scale
    has_pt[idx[ok_rows]] = True

    def renormalize():
        """Scale-gauge renormalization: similarity-rescale about the anchor
        camera so the init-pair baseline keeps unit length (SURVEY §7
        "gauge fixing under sharding" — host-side analog)."""
        C0 = -R[i0].T @ t[i0]
        C1 = -R[i1].T @ t[i1]
        base = np.linalg.norm(C1 - C0)
        if base < 1e-9:
            return
        s = 1.0 / base
        reg = np.flatnonzero(registered)
        C = -np.einsum("fij,fi->fj", R[reg], t[reg])
        C = C0 + s * (C - C0)
        t[reg] = -np.einsum("fij,fj->fi", R[reg], C)
        live = has_pt
        X[live] = C0 + s * (X[live] - C0)

    def _full_ba(free_mask, iters):
        """BA over the full static-shape problem (bootstrap + final polish)."""
        obs_w = (
            active[ff_all, tt_all] & registered[ff_all] & has_pt[tt_all]
        ).astype(np.float64)
        X_dev = np.where(has_pt[:, None], X, np.array([0.0, 0.0, 10.0]))
        fixed = ~free_mask
        fixed[i0] = True  # gauge anchor (scale handled by renormalize())
        prob = make_problem(
            R, t, intr, X_dev, ff_all, tt_all, uv[ff_all, tt_all],
            camera_model=camera_model,
            robust=cfg.robust, robust_scale=cfg.robust_scale,
            cam_fixed=fixed | ~registered,
            obs_w=obs_w,
        )
        with _T("window_ba"):
            solved, st = solve(prob, _LMConfig(max_iters=iters))
            stats["ba_costs"].append(float(np.asarray(st.costs)[-1]))
        R[:] = np.asarray(solved.R)
        t[:] = np.asarray(solved.t)
        X[:] = np.asarray(solved.X)
        return solved

    def _window_ba_extracted():
        """Window BA on an EXTRACTED subproblem at bucketed static shapes:
        the device solve touches only the window cameras, the points they
        see, and the registered cameras anchoring those points —
        O(window) work per keyframe instead of O(F), with
        power-of-two shape buckets so the executable recompiles O(log n)
        times over a whole reconstruction."""
        reg_idx = np.flatnonzero(registered)
        win_mask = np.zeros(F, bool)
        win_mask[reg_idx[-cfg.window:]] = True
        sel_pt_mask = has_pt & active[win_mask].any(axis=0)
        sel_pts = np.flatnonzero(sel_pt_mask)
        cam_mask = registered & (
            win_mask | active[:, sel_pts].any(axis=1)
        )
        sel_cams = np.flatnonzero(cam_mask)
        nc, np_ = len(sel_cams), len(sel_pts)
        sub_vis = active[np.ix_(sel_cams, sel_pts)]
        fl, tl = np.nonzero(sub_vis)
        nm = len(fl)

        Cs = _pow2_bucket(nc, 8)
        Ps = _pow2_bucket(np_, 128)
        Ms = _pow2_bucket(nm, 512)
        # Table buckets (>= actual maxima; make_problem validates).
        k_pt = int(np.bincount(tl, minlength=1).max()) if nm else 1
        k_cam = int(np.bincount(fl, minlength=1).max()) if nm else 1
        Kb = _pad_count(k_pt, 4)
        Kcb = _pow2_bucket(k_cam, 64)

        R_s = np.tile(np.eye(3), (Cs, 1, 1))
        t_s = np.zeros((Cs, 3))
        intr_s = np.tile(intr[0], (Cs, 1))
        R_s[:nc] = R[sel_cams]
        t_s[:nc] = t[sel_cams]
        intr_s[:nc] = intr[sel_cams]
        X_s = np.tile(np.array([0.0, 0.0, 10.0]), (Ps, 1))
        X_s[:np_] = X[sel_pts]
        fixed_s = np.ones(Cs, bool)
        fixed_s[:nc] = ~win_mask[sel_cams]
        loc_i0 = np.searchsorted(sel_cams, i0)
        if loc_i0 < nc and sel_cams[loc_i0] == i0:
            fixed_s[loc_i0] = True  # gauge anchor stays frozen
        if fixed_s[:nc].all():
            return  # nothing free to optimize (degenerate window)

        oc_s = np.zeros(Ms, np.int64)
        op_s = np.zeros(Ms, np.int64)
        uv_s = np.zeros((Ms, 2))
        w_s = np.zeros(Ms)
        oc_s[:nm] = fl
        op_s[:nm] = tl
        uv_s[:nm] = uv[sel_cams[fl], sel_pts[tl]]
        w_s[:nm] = 1.0

        prob = make_problem(
            R_s, t_s, intr_s, X_s, oc_s, op_s, uv_s,
            camera_model=camera_model,
            robust=cfg.robust, robust_scale=cfg.robust_scale,
            cam_fixed=fixed_s, obs_w=w_s,
            max_track=Kb, max_cam_obs=Kcb,
        )
        with _T("window_ba"):
            solved, st = solve(prob, _LMConfig(max_iters=cfg.ba_iters_window))
            stats["ba_costs"].append(float(np.asarray(st.costs)[-1]))
        free_rows = np.flatnonzero(~fixed_s[:nc])
        R[sel_cams[free_rows]] = np.asarray(solved.R)[free_rows]
        t[sel_cams[free_rows]] = np.asarray(solved.t)[free_rows]
        X[sel_pts] = np.asarray(solved.X)[:np_]

    def windowed_ba(final=False):
        reg_idx = np.flatnonzero(registered)
        if final or len(reg_idx) <= cfg.window + 1:
            free = np.zeros(F, bool)
            free[reg_idx if final else reg_idx[-cfg.window:]] = True
            solved = _full_ba(
                free, cfg.ba_iters_final if final else cfg.ba_iters_window
            )
        else:
            solved = None
            _window_ba_extracted()
        renormalize()
        # Hygiene (SURVEY §3.3): deactivate observations whose reprojection
        # error exceeds the bound; demote points left under-observed.
        with _T("hygiene"):
            uv_hat = _hygiene_uvhat(
                camera_model, R, t, intr, X, ff_all, tt_all
            )
        err = np.linalg.norm(uv_hat - uv[ff_all, tt_all], axis=-1)
        live = active[ff_all, tt_all] & registered[ff_all] & has_pt[tt_all]
        sigma = 1.4826 * np.median(err[live]) if live.any() else 0.0
        thr = float(np.clip(4.0 * sigma, cfg.min_reproj_px, cfg.max_reproj_px))
        bad = (err > thr) & live
        if bad.any():
            active[ff_all[bad], tt_all[bad]] = False
            stats["filtered_obs"] += int(bad.sum())
            view_counts = (active & registered[:, None]).sum(axis=0)
            has_pt[view_counts < cfg.min_track_views] = False
        # Demote points whose post-BA parallax has degenerated (drifting
        # toward infinity); they may re-triangulate later from clean views.
        live = np.flatnonzero(has_pt)
        if len(live) > 0:
            reg_i = np.flatnonzero(registered)
            pang = _max_tri_angle(
                X[live], R[reg_i], t[reg_i], active[reg_i][:, live]
            )
            has_pt[live[pang < min_angle]] = False
        return solved

    windowed_ba()

    # ---- incremental loop (SURVEY §3.3), next-best-view order -------------
    def resect_frames(frames):
        """Resect a BATCH of candidate frames in one vmapped PnP-RANSAC
        dispatch instead of one dispatch per frame (the init-pair RANSAC
        is batched the same way — _two_view_batch is the template).
        All candidates are resected against the SAME map state, so their
        poses are independent of acceptance order; returns the accepted
        subset."""
        nonlocal key
        # Static shapes: the batch axis is ALWAYS register_batch (short
        # batches padded with zero-weight dummy rows) and the point axis
        # a power-of-two bucket, so the whole reconstruction compiles ONE
        # PnP executable per O(log n) bucket instead of one per distinct
        # (batch, n_points) pair — a compile costs far more than a cached
        # dispatch.
        B = max(1, cfg.register_batch)
        n_uses = [int((active[f] & has_pt).sum()) for f in frames]
        npad = _pow2_bucket(max(n_uses), 128)
        Xps = np.tile(np.array([0.0, 0.0, 10.0]), (B, npad, 1))
        pns = np.zeros((B, npad, 2))
        wps = np.zeros((B, npad))
        for k, f in enumerate(frames):
            uidx = np.flatnonzero(active[f] & has_pt)
            stats["pnp_candidates"].append(len(uidx))
            Xps[k, : len(uidx)] = X[uidx]
            pns[k, : len(uidx)] = pn_all[f, uidx]
            wps[k, : len(uidx)] = 1.0
        # Pad batch rows (short final batches) duplicate the first real
        # frame: an all-zero weight row makes the RANSAC sampling
        # distribution w/sum(w) NaN, which under x64 poisoned the whole
        # vmapped dispatch (frames resected in the same batch came back
        # with 0 inliers).  Duplicate results are simply discarded.
        for k in range(len(frames), B):
            Xps[k] = Xps[0]
            pns[k] = pns[0]
            wps[k] = wps[0]
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, B)
        with _T("pnp"):
            Rb, tb, inlb = _pnp_batch(
                keys, jnp.asarray(Xps), jnp.asarray(pns), jnp.asarray(wps),
                n_hypotheses=cfg.ransac_hypotheses,
                threshold=cfg.pnp_threshold,
            )
            Rb, tb = np.asarray(Rb), np.asarray(tb)
            inlb = np.asarray(inlb) & (wps > 0)
        newly = []
        for k, f in enumerate(frames[:B]):
            n_inl = int(inlb[k].sum())
            stats["pnp_inliers"].append(n_inl)
            if n_inl < cfg.min_pnp_points:
                # Resection unreliable — skip rather than poisoning the
                # map with a garbage pose; retried after the map grows.
                continue
            R[f] = Rb[k]
            t[f] = tb[k]
            registered[f] = True
            newly.append(f)
        return newly

    def triangulate_new(new_frames):
        """Triangulate tracks newly visible in >= min_track_views
        registered frames (masked multi-view DLT, static shape) — one
        dispatch for the whole batch of newly registered frames."""
        obs_reg = active & registered[:, None]              # [F, T]
        counts_t = obs_reg.sum(axis=0)
        new = (
            (~has_pt)
            & (counts_t >= cfg.min_track_views)
            & active[new_frames].any(axis=0)
        )
        nidx = np.flatnonzero(new)
        if len(nidx) > 0:
            # View axis restricted to the registered frames, padded to a
            # bucket of 8 — device triangulation work stays O(registered),
            # and the executable recompiles only when the bucket grows.
            reg_i = np.flatnonzero(registered)
            Fr = _pow2_bucket(len(reg_i), 8)
            R_r = np.tile(np.eye(3), (Fr, 1, 1))
            t_r = np.zeros((Fr, 3))
            R_r[: len(reg_i)] = R[reg_i]
            t_r[: len(reg_i)] = t[reg_i]
            npadt = _pow2_bucket(len(nidx), 64)
            mask = np.zeros((npadt, Fr))
            pn_sel = np.zeros((npadt, Fr, 2))
            mask[: len(nidx), : len(reg_i)] = obs_reg[reg_i][:, nidx].T
            pn_sel[: len(nidx), : len(reg_i)] = (
                pn_all[reg_i][:, nidx].transpose(1, 0, 2)
            )
            Rj, tj = jnp.asarray(R_r), jnp.asarray(t_r)
            with _T("triangulate"):
                Xn = jax.vmap(
                    lambda pn_v, m: triangulate.triangulate_linear(
                        Rj, tj, pn_v, m
                    )
                )(jnp.asarray(pn_sel), jnp.asarray(mask))
                # Cheirality screen: every observing view must see z > 0.
                z = jax.vmap(lambda Xq: triangulate.depths(Rj, tj, Xq))(Xn)
                good = np.array(
                    jnp.sum((z > 0) * mask, axis=1) >= jnp.sum(mask, axis=1)
                )
            good[: len(nidx)] &= mask[: len(nidx)].sum(axis=1) >= 2
            good[len(nidx):] = False
            # Parallax gate: reject depth-ill-conditioned triangulations.
            Xn_np = np.asarray(Xn)
            ang_n = _max_tri_angle(
                Xn_np, R[reg_i], t[reg_i],
                (mask[:, : len(reg_i)] > 0).T,
            )
            good &= ang_n >= min_angle
            sel_rows = np.flatnonzero(good[: len(nidx)])
            X[nidx[sel_rows]] = Xn_np[sel_rows]
            has_pt[nidx[sel_rows]] = True

    remaining = [f for f in range(F) if not registered[f]]
    failed: set = set()
    while True:
        # Next-best-view: most usable 2D-3D correspondences first; frames
        # that failed since the last map improvement wait for the next one.
        cand = [
            f for f in remaining
            if f not in failed
            and int((active[f] & has_pt).sum()) >= cfg.min_pnp_points
        ]
        if not cand:
            break
        cand.sort(key=lambda f: -(int((active[f] & has_pt).sum())))
        batch = cand[: max(1, cfg.register_batch)]
        newly = resect_frames(batch)
        if not newly:
            failed.update(batch)
            continue
        failed.clear()  # the map is about to improve — failures retry
        for f in newly:
            remaining.remove(f)
        triangulate_new(newly)
        windowed_ba()

    windowed_ba(final=True)
    obs_w = (
        active[ff_all, tt_all] & registered[ff_all] & has_pt[tt_all]
    ).astype(np.float64)
    X_dev = np.where(has_pt[:, None], X, np.array([0.0, 0.0, 10.0]))
    fixed = ~registered.copy()
    fixed[i0] = True
    prob = make_problem(
        R, t, intr, X_dev, ff_all, tt_all, uv[ff_all, tt_all],
        camera_model=camera_model,
        robust=cfg.robust, robust_scale=cfg.robust_scale,
        cam_fixed=fixed, obs_w=obs_w,
    )
    timings["host_other"] = (
        _time.perf_counter() - _t_run0 - sum(timings.values())
    )
    stats["timings_s"] = {k: round(v, 3) for k, v in timings.items()}
    return Reconstruction(
        problem=prob, registered=registered, has_point=has_pt, stats=stats
    )
