"""Shi-Tomasi corner detection with min-distance suppression (PyTorch port of
`ctrlvio_tpu/frontend/corners.py`).

Structure tensor by separable convolutions, minimum-eigenvalue response,
3x3 NMS, best-per-cell suppression on a min_dist grid, top-K candidates by
response, then the exact greedy min-distance pass (≙ `applyMask`) as a
Python loop over the candidates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fnn

from .klt import _pad_edge


def _sep_conv(img, kv, kh):
    pad_v = len(kv) // 2
    pad_h = len(kh) // 2
    c = _pad_edge(img, pad_v, 0)
    c = sum(kv[i] * c[i : i + img.shape[0], :] for i in range(len(kv)))
    c2 = _pad_edge(c, pad_h, 1)
    return sum(kh[i] * c2[:, i : i + img.shape[1]] for i in range(len(kh)))


def shi_tomasi_response(img, block: int = 3):
    """Min-eigenvalue of the 2x2 structure tensor, box-filtered over
    block x block (OpenCV default blockSize=3)."""
    dt = img.dtype
    deriv = [float(v) for v in torch.tensor([-0.5, 0.0, 0.5], dtype=dt)]
    smooth = [float(v) for v in torch.tensor([0.25, 0.5, 0.25], dtype=dt)]
    Ix = _sep_conv(img, smooth, deriv)
    Iy = _sep_conv(img, deriv, smooth)
    box = [float(v) for v in torch.ones(block, dtype=dt) / block]
    gxx = _sep_conv(Ix * Ix, box, box)
    gxy = _sep_conv(Ix * Iy, box, box)
    gyy = _sep_conv(Iy * Iy, box, box)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    return 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))


def detect(img, max_corners: int, min_dist: int, quality: float = 0.01,
           exclude_yx=None, border: int = 3):
    """Top-K Shi-Tomasi corners with min-distance suppression.

    exclude_yx: (M, 2) existing feature positions (y, x) whose min_dist
    cells are masked out; rows of -1 for empty slots.
    Returns (pts (K, 2) as x,y float, valid (K,))."""
    H, W = img.shape
    dev = img.device
    r = shi_tomasi_response(img)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    r = torch.where(inb, r, torch.zeros_like(r))
    r = torch.where(r >= quality * torch.max(r), r, torch.zeros_like(r))
    # 3x3 NMS
    pooled = Fnn.max_pool2d(r[None, None], 3, stride=1, padding=1)[0, 0]
    r = torch.where(r >= pooled, r, torch.zeros_like(r))

    # best response per min_dist grid cell
    g = max(int(min_dist), 1)
    Hc, Wc = -(-H // g), -(-W // g)
    rp = Fnn.pad(r, (0, Wc * g - W, 0, Hc * g - H))
    cells = rp.reshape(Hc, g, Wc, g).permute(0, 2, 1, 3).reshape(Hc * Wc, g * g)
    vals, offs = cells.max(dim=1)
    ci = torch.arange(Hc * Wc, device=dev)
    py = (ci // Wc) * g + offs // g
    px = (ci % Wc) * g + offs % g

    if exclude_yx is not None:
        ey = torch.clamp(exclude_yx[:, 0], 0, H - 1).to(torch.int64)
        ex = torch.clamp(exclude_yx[:, 1], 0, W - 1).to(torch.int64)
        ecell = (ey // g) * Wc + (ex // g)
        valid_ex = (exclude_yx[:, 0] >= 0).to(torch.int32)
        occupied = torch.zeros((Hc * Wc,), dtype=torch.int32, device=dev)
        occupied = occupied.scatter_reduce(0, ecell, valid_ex, reduce="amax")
        vals = torch.where(occupied > 0, torch.zeros_like(vals), vals)

    # top candidates by response (ties: lower cell index first, as lax.top_k)
    K = min(2 * max_corners, int(vals.shape[0]))
    topv, topi = torch.sort(vals, descending=True, stable=True)
    topv, topi = topv[:K], topi[:K]
    pts = torch.stack([px[topi].to(img.dtype), py[topi].to(img.dtype)], dim=-1)
    keep = topv > 0.0

    # exact greedy min-distance pass in response order
    d2 = torch.sum((pts[None, :, :] - pts[:, None, :]) ** 2, dim=-1)
    later = torch.arange(K, device=dev)[None, :] > torch.arange(K, device=dev)[:, None]
    clash = later & (d2 < float(min_dist) ** 2)
    for i in range(K):
        keep = keep & ~(clash[i] & keep[i])
    order = torch.sort((~keep).to(torch.int32), stable=True).indices[:max_corners]
    return pts[order], keep[order]
