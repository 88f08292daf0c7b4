"""CLAHE (contrast-limited adaptive histogram equalization), PyTorch port of
`ctrlvio_tpu/frontend/clahe.py`.

≙ `cv::createCLAHE(3.0, cv::Size(8, 8))`: per-tile histograms, clip +
uniform redistribution, CDF lookup tables, bilinear interpolation between
the four neighbouring tile LUTs per pixel. The LUT lookup is a direct
gather (`clahe.py:69-74`); the blocked one-hot matmul form of the JAX
package existed only because the TPU cannot gather, and gives the same
values.
"""

from __future__ import annotations

import torch


def clahe(img, tiles: int = 8, clip_limit: float = 3.0, nbins: int = 256):
    """img: (H, W) in [0, 255]. Returns float32 (H, W) in [0, 255].
    H and W must be divisible by `tiles`."""
    H, W = img.shape
    th, tw = H // tiles, W // tiles
    dev = img.device
    x = torch.clamp(img, 0, 255).to(torch.float32)
    b = x.to(torch.int64).clamp(0, nbins - 1)

    # per-tile histograms (exact integer counts)
    tiles_img = b.reshape(tiles, th, tiles, tw).permute(0, 2, 1, 3).reshape(
        tiles * tiles, th * tw)
    hist = torch.zeros((tiles * tiles, nbins), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, tiles_img, torch.ones_like(tiles_img,
                                                    dtype=torch.float32))

    # clip + redistribute (OpenCV semantics: clipLimit scaled by tile size)
    limit = max(clip_limit * th * tw / nbins, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins

    # CDF -> LUT
    cdf = torch.cumsum(hist, dim=1)
    lut = (cdf - cdf[:, :1]) / torch.clamp(cdf[:, -1:] - cdf[:, :1],
                                           min=1.0) * 255.0

    # bilinear interpolation between tile centers
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    ty = (yy - th / 2.0) / th
    tx = (xx - tw / 2.0) / tw
    y0 = torch.floor(ty).to(torch.int64).clamp(0, tiles - 1)
    x0 = torch.floor(tx).to(torch.int64).clamp(0, tiles - 1)
    wy = torch.clamp(ty - y0, 0.0, 1.0)
    wx = torch.clamp(tx - x0, 0.0, 1.0)
    y1 = (y0 + 1).clamp(0, tiles - 1)
    x1 = (x0 + 1).clamp(0, tiles - 1)
    flat = lut.reshape(-1)
    v00 = flat[(y0 * tiles + x0) * nbins + b]
    v01 = flat[(y0 * tiles + x1) * nbins + b]
    v10 = flat[(y1 * tiles + x0) * nbins + b]
    v11 = flat[(y1 * tiles + x1) * nbins + b]
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)
