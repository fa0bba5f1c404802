"""Minimal, obviously-correct NumPy LM/Schur oracle (SURVEY §4).

Plays the role the reference played for parity checks (the reference mount
was empty — SURVEY §0): a straightforward per-measurement NumPy
implementation of robust LM bundle adjustment with Schur elimination, written
independently of the jax code path (explicit Python loops, numeric-friendly
formulas, ``np.linalg.solve``), against which the device solver must match
final reprojection cost to ~1e-6 relative (BASELINE north-star).

Deliberately mirrors the *mathematical contract* of the jax solver —
Marquardt damping ``H + lam*diag(H)`` with unit fill on zero diagonals,
Nielsen's lambda schedule, IRLS robust weights ``rho'(s)`` — but shares no
code with it.
"""

from __future__ import annotations

import numpy as np


def rodrigues(w):
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        W = skew(w)
        return np.eye(3) + W + 0.5 * W @ W
    k = w / theta
    K = skew(k)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def skew(w):
    return np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=float
    )


def project(model, R, t, intr, X):
    p = R @ X + t
    if model == "bal":
        f, k1, k2 = intr[:3]
        pn = -p[:2] / p[2]
        r2 = pn @ pn
        rho = 1 + k1 * r2 + k2 * r2 * r2
        return f * rho * pn
    fx, fy, cx, cy = intr[:4]
    return np.array([fx * p[0] / p[2] + cx, fy * p[1] / p[2] + cy])


def num_jac(f, x, h=1e-7):
    """Central finite differences — the reference's ``numeric_jacobian``
    discipline (SURVEY §2)."""
    y0 = f(x)
    J = np.zeros((y0.size, x.size))
    for k in range(x.size):
        d = np.zeros_like(x)
        d[k] = h
        J[:, k] = (f(x + d) - f(x - d)) / (2 * h)
    return J


def robust_rho_weight(kernel, s, c):
    if kernel == "gaussian":
        return s, 1.0
    c2 = c * c
    if kernel == "huber":
        if s <= c2:
            return s, 1.0
        return 2 * c * np.sqrt(s) - c2, c / np.sqrt(s)
    if kernel == "cauchy":
        return c2 * np.log1p(s / c2), 1.0 / (1.0 + s / c2)
    raise ValueError(kernel)


class Oracle:
    """Dense-ish LM with Schur elimination, per-measurement Python loops."""

    def __init__(self, model, R, t, intr, X, obs_cam, obs_pt, obs_uv,
                 obs_w=None, cam_fixed=None, robust="gaussian", robust_scale=1.0):
        self.model = model
        self.R = np.array(R, dtype=float)
        self.t = np.array(t, dtype=float)
        self.intr = np.array(intr, dtype=float)
        self.X = np.array(X, dtype=float)
        self.obs_cam = np.asarray(obs_cam)
        self.obs_pt = np.asarray(obs_pt)
        self.obs_uv = np.array(obs_uv, dtype=float)
        self.obs_w = (
            np.ones(len(obs_cam)) if obs_w is None else np.asarray(obs_w, float)
        )
        C = self.R.shape[0]
        if cam_fixed is None:
            cam_fixed = np.zeros(C, bool)
            cam_fixed[0] = True
        self.cam_fixed = np.asarray(cam_fixed, bool)
        self.robust = robust
        self.c = robust_scale
        self.cp = {"pose": 6, "pose_k": 10, "bal": 9}[model]

    # -- residuals / jacobians (per measurement, finite-difference free) ----

    def residual(self, m):
        i, j = self.obs_cam[m], self.obs_pt[m]
        return (
            project(self.model, self.R[i], self.t[i], self.intr[i], self.X[j])
            - self.obs_uv[m]
        )

    def jac(self, m):
        """Numeric Jacobians (the oracle is allowed to be slow & dumb)."""
        i, j = self.obs_cam[m], self.obs_pt[m]
        R0, t0, intr0, X0 = self.R[i], self.t[i], self.intr[i], self.X[j]

        def f_cam(d):
            Rr = rodrigues(d[:3]) @ R0
            tt = t0 + d[3:6]
            ii = intr0.copy()
            if self.cp > 6:
                ii = intr0 + d[6:self.cp]
            return project(self.model, Rr, tt, ii, X0)

        def f_pt(d):
            return project(self.model, R0, t0, intr0, X0 + d)

        Jc = num_jac(f_cam, np.zeros(self.cp))
        Jp = num_jac(f_pt, np.zeros(3))
        if self.cam_fixed[i]:
            Jc = np.zeros_like(Jc)
        return Jc, Jp

    def cost(self):
        total = 0.0
        for m in range(len(self.obs_cam)):
            r = self.residual(m)
            rho, _ = robust_rho_weight(self.robust, r @ r, self.c)
            total += 0.5 * self.obs_w[m] * rho
        return total

    # -- one damped step via Schur ------------------------------------------

    def step(self, lam):
        C, P, cp = self.R.shape[0], self.X.shape[0], self.cp
        M = len(self.obs_cam)
        Hcc = np.zeros((C, cp, cp))
        Hpp = np.zeros((P, 3, 3))
        Hcp = np.zeros((C, P, cp, 3))
        gc = np.zeros((C, cp))
        gp = np.zeros((P, 3))
        for m in range(M):
            i, j = self.obs_cam[m], self.obs_pt[m]
            r = self.residual(m)
            Jc, Jp = self.jac(m)
            _, wr = robust_rho_weight(self.robust, r @ r, self.c)
            w = self.obs_w[m] * wr
            Hcc[i] += w * Jc.T @ Jc
            Hpp[j] += w * Jp.T @ Jp
            Hcp[i, j] += w * Jc.T @ Jp
            gc[i] += w * Jc.T @ r
            gp[j] += w * Jp.T @ r

        def aug(H):
            d = np.diagonal(H).copy()
            fill = np.where(d == 0, 1.0, 0.0)
            return H + np.diag(lam * d + fill)

        Hcc_a = np.stack([aug(h) for h in Hcc])
        Hpp_a = np.stack([aug(h) for h in Hpp])
        Hpp_inv = np.stack([np.linalg.inv(h) for h in Hpp_a])

        S = np.zeros((C * cp, C * cp))
        for i in range(C):
            S[i * cp:(i + 1) * cp, i * cp:(i + 1) * cp] = Hcc_a[i]
        rhs = -gc.reshape(-1)
        for j in range(P):
            cams = np.unique(self.obs_cam[self.obs_pt == j])
            for a in cams:
                Ya = Hcp[a, j] @ Hpp_inv[j]
                rhs[a * cp:(a + 1) * cp] += Ya @ gp[j]
                for b in cams:
                    S[a * cp:(a + 1) * cp, b * cp:(b + 1) * cp] -= (
                        Ya @ Hcp[b, j].T
                    )
        dc = np.linalg.solve(S, rhs).reshape(C, cp)
        dp = np.zeros((P, 3))
        for j in range(P):
            acc = gp[j].copy()
            for a in np.unique(self.obs_cam[self.obs_pt == j]):
                acc += Hcp[a, j].T @ dc[a]
            dp[j] = -Hpp_inv[j] @ acc

        # Predicted model reduction, same formula as the jax solver.
        pred = 0.0
        for i in range(C):
            d = np.diagonal(Hcc[i])
            pred += 0.5 * np.sum(
                (lam * d + np.where(d == 0, 1.0, 0.0)) * dc[i] ** 2
            )
            pred -= 0.5 * dc[i] @ gc[i]
        for j in range(P):
            d = np.diagonal(Hpp[j])
            pred += 0.5 * np.sum(
                (lam * d + np.where(d == 0, 1.0, 0.0)) * dp[j] ** 2
            )
            pred -= 0.5 * dp[j] @ gp[j]
        grad_inf = max(np.abs(gc).max(), np.abs(gp).max())
        return dc, dp, pred, grad_inf

    def apply(self, dc, dp):
        for i in range(self.R.shape[0]):
            self.R[i] = rodrigues(dc[i, :3]) @ self.R[i]
            self.t[i] += dc[i, 3:6]
            if self.cp > 6:
                self.intr[i] += dc[i, 6:self.cp]
        self.X += dp

    def optimize(self, max_iters=50, lam0=1e-4, lam_min=1e-12, lam_max=1e10,
                 tol_grad=1e-10, tol_cost_rel=1e-12, tol_step=1e-12):
        """Nielsen-schedule LM, control flow mirroring the jax solver."""
        lam, nu = lam0, 2.0
        cost = self.cost()
        costs = [cost]
        for _ in range(max_iters):
            dc, dp, pred, grad_inf = self.step(lam)
            saved = (self.R.copy(), self.t.copy(), self.intr.copy(), self.X.copy())
            self.apply(dc, dp)
            new_cost = self.cost()
            actual = cost - new_cost
            rho = actual / max(pred, 1e-300)
            ok = np.isfinite(new_cost) and actual > 0 and pred > 0
            if ok:
                lam = np.clip(lam * max(1 / 3, 1 - (2 * rho - 1) ** 3),
                              lam_min, lam_max)
                nu = 2.0
                cost = new_cost
            else:
                self.R, self.t, self.intr, self.X = saved
                lam = np.clip(lam * nu, lam_min, lam_max)
                nu *= 2.0
            costs.append(cost)
            step_norm = np.sqrt(np.sum(dc ** 2) + np.sum(dp ** 2))
            if grad_inf < tol_grad or step_norm < tol_step:
                break
            if ok and actual < tol_cost_rel * cost:
                break
        return np.array(costs)
