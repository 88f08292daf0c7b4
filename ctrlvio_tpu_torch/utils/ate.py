"""Trajectory evaluation: ATE RMSE with SE(3) / 4-DoF alignment (the port's
copy of `ctrlvio_tpu/utils/ate.py`).

The reference has no in-tree evaluation (ATE was computed externally against
TUM ground truth, SURVEY §5); here it is first-class so synthetic benchmarks
report accuracy directly.
"""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, yaw_only: bool = False):
    """Find (R, t) minimizing ||gt - (R est + t)||. est/gt: (N, 3)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    if yaw_only:
        # restrict to rotation about z
        C = E[:, :2].T @ G[:, :2]
        # optimal 2D rotation from 2x2 correlation
        A = C[0, 0] + C[1, 1]
        B = C[0, 1] - C[1, 0]
        yaw = np.arctan2(B, A)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    else:
        H = E.T @ G
        U, _, Vt = np.linalg.svd(H)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: str = "se3") -> float:
    """ATE RMSE after alignment. align in {none, se3, yaw}."""
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    if align == "none":
        err = gt - est
    else:
        R, t = align_umeyama(est, gt, yaw_only=(align == "yaw"))
        err = gt - (est @ R.T + t)
    return float(np.sqrt(np.mean(np.sum(err**2, axis=-1))))
