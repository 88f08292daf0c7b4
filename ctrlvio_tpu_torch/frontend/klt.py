"""Batched pyramidal Lucas-Kanade optical flow (PyTorch port of
`ctrlvio_tpu/frontend/klt.py`).

All features track together: the coarse-to-fine forward pass, the
backward pass and the forward-backward consistency gate (≙
`flow_back`/FB_THRESHOLD) are one call of `ops.lk.lk_track`, which
launches the hand-written kernel K1 once for CUDA tensors and runs the
plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ctrlvio_tpu_torch.ops import lk
from ctrlvio_tpu_torch.ops.lk import bilinear  # noqa: F401  (≙ klt._bilinear)


class KLTConfig(NamedTuple):
    win: int = 10          # patch half-size -> 21x21 window (OpenCV (21,21))
    levels: int = 4        # pyramid levels (OpenCV maxLevel=3 -> 4 levels)
    iters: int = 10        # LK iterations per level
    min_eig: float = 1e-4  # min eigenvalue threshold on G (normalized)
    fb_thresh: float = 0.5  # forward-backward distance gate (≙ FB_THRESHOLD)
    pred_levels: int = 2   # levels used when an initial flow is given


def _pad_edge(x, pad: int, dim: int):
    lo = x.narrow(dim, 0, 1)
    hi = x.narrow(dim, x.shape[dim] - 1, 1)
    reps = [1] * x.dim()
    reps[dim] = pad
    return torch.cat([lo.repeat(*reps), x, hi.repeat(*reps)], dim=dim)


def pyramid(img, levels: int):
    """[level0 = img, ...]: 5-tap binomial blur + 2x decimation per level.
    img: (H, W) float."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=img.dtype) / 16.0
    k = [float(v) for v in k]
    out = [img]
    cur = img
    for _ in range(levels - 1):
        H, W = cur.shape
        c = _pad_edge(cur, 2, 0)
        c = sum(k[i] * c[i : i + H, :] for i in range(5))
        c2 = _pad_edge(c, 2, 1)
        c = sum(k[i] * c2[:, i : i + W] for i in range(5))
        cur = c[::2, ::2].contiguous()
        out.append(cur)
    return out


def track_level(img_prev, img_cur, pts_prev, guess, cfg: KLTConfig):
    """LK at one pyramid level for a batch of features (≙ `_track_level`
    vmapped). Returns (new_guess (N, 2), min_eig (N,))."""
    return lk.lk_level(img_prev.contiguous(), img_cur.contiguous(),
                       pts_prev.contiguous(), guess.contiguous(), cfg.iters,
                       cfg.win)


def track(pyr_prev, pyr_cur, pts, cfg: KLTConfig = KLTConfig(), init=None):
    """Track pts (N, 2) from prev to cur. Returns (pts_cur (N,2), ok (N,)).

    Coarse-to-fine with forward-backward verification. init (N, 2),
    optional: initial guess of the tracked positions (gyro-predicted flow,
    `frontend/fused.py::rotation_flow`); the backward pass always starts
    from the original pts."""
    L = len(pyr_prev) if init is None else min(len(pyr_prev),
                                               max(cfg.pred_levels, 1))
    pts = pts.contiguous()
    pts_cur, ok, _ = lk.lk_track(
        [p.contiguous() for p in pyr_prev[:L]],
        [p.contiguous() for p in pyr_cur[:L]], pts,
        pts if init is None else init.contiguous(), cfg.iters, cfg.win,
        cfg.fb_thresh, cfg.min_eig)
    return pts_cur, ok
