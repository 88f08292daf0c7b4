"""Fundamental-matrix RANSAC outlier rejection for the feature tracker (the
port's numpy copy of `ctrlvio_tpu/frontend/fransac.py`; host code, it
returns the same mask bit for bit).

≙ FeatureTracker::rejectWithF (`feature_tracker.cpp:201-235` of the
reference's visual front end): the reference lifts tracked
points to rays, projects them onto a virtual pinhole image with
FOCAL_LENGTH=460, and runs cv::findFundamentalMat(FM_RANSAC, F_THRESHOLD).
Here the same geometry runs as one vectorized numpy batch: all RANSAC
hypotheses' 8-point systems are solved with a single batched SVD and scored
against all points at once — no per-iteration Python loop.
"""

from __future__ import annotations

import numpy as np

VIRTUAL_FOCAL = 460.0  # ≙ feature_tracker::FOCAL_LENGTH (parameters.cpp)


def _eight_point(a, b):
    """Batched 8-point: a, b (S, 8, 2) matched virtual-pixel coords.
    Returns F (S, 3, 3) (not rank-2-projected — inlier scoring only)."""
    x0, y0 = a[..., 0], a[..., 1]
    x1, y1 = b[..., 0], b[..., 1]
    one = np.ones_like(x0)
    A = np.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, one],
                 axis=-1)  # (S, 8, 9)
    # row scaling keeps the batched SVD well-conditioned
    A = A / np.maximum(np.linalg.norm(A, axis=-1, keepdims=True), 1e-12)
    _, _, Vt = np.linalg.svd(A)
    return Vt[:, -1].reshape(-1, 3, 3)


def _epipolar_dist(F, a, b):
    """Symmetric epipolar point-line distance (virtual pixels).
    F: (S, 3, 3); a, b: (N, 2) -> (S, N)."""
    N = len(a)
    ah = np.concatenate([a, np.ones((N, 1))], axis=1)  # (N, 3)
    bh = np.concatenate([b, np.ones((N, 1))], axis=1)
    l1 = np.einsum("sij,nj->sni", F, ah)        # epiline in image 1
    l0 = np.einsum("sji,nj->sni", F, bh)        # epiline in image 0
    num = np.abs(np.einsum("ni,sni->sn", bh, l1))
    d1 = num / np.maximum(np.hypot(l1[..., 0], l1[..., 1]), 1e-12)
    d0 = num / np.maximum(np.hypot(l0[..., 0], l0[..., 1]), 1e-12)
    return np.maximum(d0, d1)


def reject_with_f(norm_prev: np.ndarray, norm_cur: np.ndarray,
                  thresh_px: float = 1.0, iters: int = 200,
                  seed: int = 0) -> np.ndarray:
    """Inlier mask (N,) for matched normalized-plane points.

    norm_prev/norm_cur: (N, 2) undistorted normalized coords of the same
    track in the previous / current frame. thresh_px in virtual pixels
    (≙ F_THRESHOLD, `cam_tumrs.yaml`)."""
    n = len(norm_prev)
    if n < 8:
        return np.ones(n, bool)
    a = np.asarray(norm_prev, np.float64) * VIRTUAL_FOCAL
    b = np.asarray(norm_cur, np.float64) * VIRTUAL_FOCAL

    # Hartley normalization: the 8-point algorithm's algebraic error is
    # catastrophically ill-conditioned on raw pixel coordinates. Estimate
    # F~ on whitened points, score with F = T1^T F~ T0 in pixels.
    def _whiten(x):
        mu = x.mean(axis=0)
        s = np.sqrt(2.0) / max(np.linalg.norm(x - mu, axis=1).mean(), 1e-9)
        T = np.array([[s, 0, -s * mu[0]], [0, s, -s * mu[1]], [0, 0, 1.0]])
        return (x - mu) * s, T

    an, T0 = _whiten(a)
    bn, T1 = _whiten(b)

    def _unnorm(Fn):
        return np.einsum("ji,sjk,kl->sil", T1, Fn, T0)

    rng = np.random.default_rng(seed)
    # sample-without-replacement per hypothesis, vectorized
    sel = np.argsort(rng.random((iters, n)), axis=1)[:, :8]
    F = _unnorm(_eight_point(an[sel], bn[sel]))
    d = _epipolar_dist(F, a, b)                 # (S, N)
    inl = d < thresh_px
    best = int(np.argmax(inl.sum(axis=1)))
    mask = inl[best]
    # iterated least-squares refit on the consensus set (the minimal-sample
    # F is noisy; two refits approach the all-inlier LS solution)
    for _ in range(2):
        if mask.sum() < 8:
            break
        x0, y0 = an[mask, 0], an[mask, 1]
        x1, y1 = bn[mask, 0], bn[mask, 1]
        one = np.ones_like(x0)
        A = np.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                      x0, y0, one], axis=-1)
        _, _, Vt = np.linalg.svd(A)
        F2 = _unnorm(Vt[-1].reshape(1, 3, 3))
        mask = _epipolar_dist(F2, a, b)[0] < thresh_px
    return mask
