"""Batched pyramidal Lucas-Kanade optical flow (PyTorch port of
`ctrlvio_tpu/frontend/klt.py`).

All features track together: a Python coarse-to-fine loop over pyramid
levels, and at each level one call of `ops.lk.lk_level`, which launches the
hand-written kernel K1 for CUDA tensors (every level, whatever its size)
and runs the plain PyTorch version for CPU tensors. The forward-backward
consistency check (≙ `flow_back`/FB_THRESHOLD) follows.
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
    H, W = pyr_prev[0].shape
    L = len(pyr_prev) if init is None else min(len(pyr_prev),
                                               max(cfg.pred_levels, 1))
    pyr_prev, pyr_cur = list(pyr_prev[:L]), list(pyr_cur[:L])

    def fwd(pyrs_a, pyrs_b, p0, g0):
        g = g0 / (2 ** (L - 1))
        eig = torch.zeros_like(p0[:, 0])
        for lev in range(L - 1, -1, -1):
            g, eig = track_level(pyrs_a[lev], pyrs_b[lev], p0 / (2 ** lev), g,
                                 cfg)
            if lev > 0:
                g = g * 2.0
        return g, eig

    pts_cur, eig = fwd(pyr_prev, pyr_cur, pts, pts if init is None else init)
    pts_back, _ = fwd(pyr_cur, pyr_prev, pts_cur, pts)

    fb = torch.linalg.vector_norm(pts_back - pts, dim=-1)
    inb = ((pts_cur[:, 0] >= 1.0) & (pts_cur[:, 0] < W - 1.0)
           & (pts_cur[:, 1] >= 1.0) & (pts_cur[:, 1] < H - 1.0))
    ok = (fb < cfg.fb_thresh) & inb & (eig > cfg.min_eig)
    return pts_cur, ok
