"""Trajectory alignment and ATE computation (evaluation protocol of
BASELINE.md: SE3 Umeyama alignment against ground truth, RMSE of translation).
"""

from __future__ import annotations

import numpy as np


def umeyama_se3(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment dst ~ s R src + t.

    Returns (s, R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(S) @ D) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after alignment. est/gt: (N, 3)."""
    s, R, t = umeyama_se3(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association; returns (idx_est, idx_gt)."""
    ie, ig = [], []
    j = 0
    for i, te in enumerate(t_est):
        j = int(np.searchsorted(t_gt, te))
        best, bd = None, max_dt
        for k in (j - 1, j, j + 1):
            if 0 <= k < len(t_gt) and abs(t_gt[k] - te) <= bd:
                best, bd = k, abs(t_gt[k] - te)
        if best is not None:
            ie.append(i)
            ig.append(best)
    return np.asarray(ie, int), np.asarray(ig, int)
