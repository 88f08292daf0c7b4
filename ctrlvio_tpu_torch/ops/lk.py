"""Lucas-Kanade refinement at one pyramid level: kernel K1 and its plain
version.

K1 (`csrc/lk.cu`) replaces the Pallas TPU kernel
`ctrlvio_tpu/ops/pallas/lk_kernel.py::_lk_kernel` and holds to the
semantics of `ctrlvio_tpu/frontend/klt.py::_track_level`, batched over
features. `lk_level` is the one entry point the front end calls:

- tensors on the CPU go to `lk_level_plain` (the plain PyTorch version);
- tensors on a CUDA device launch K1, or raise: there is no fallback.

`lk_level.launches` counts K1 launches (and nothing else), so a run can
show that its main path went through the kernel; `lk_level_plain.calls`
counts runs of the plain version, so it can show that the plain version
stayed off the path.
"""

from __future__ import annotations

import ctypes

import torch

HALF = 10                     # patch half-size -> 21x21 window
PATCH = 2 * HALF + 1


def bilinear(img, y, x):
    """Sample img (H, W) at float coords (y, x), border-clamping the integer
    corner index (not the weight), exactly like `klt._bilinear`."""
    H, W = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.to(torch.int64).clamp(0, W - 2)
    y0i = y0.to(torch.int64).clamp(0, H - 2)
    flat = img.reshape(-1)
    base = y0i * W + x0i
    i00 = flat[base]
    i01 = flat[base + 1]
    i10 = flat[base + W]
    i11 = flat[base + W + 1]
    return (i00 * (1 - wy) * (1 - wx) + i01 * (1 - wy) * wx
            + i10 * wy * (1 - wx) + i11 * wy * wx)


def lk_level_plain(img_prev, img_cur, pts, guess, iters: int = 10,
                   win: int = HALF):
    """`klt._track_level` with the feature batch written out.

    img_prev, img_cur: (H, W); pts, guess: (N, 2) x,y in this level's
    coordinates. Returns (pts_cur (N, 2), min_eig (N,))."""
    lk_level_plain.calls += 1
    dt = img_prev.dtype
    r = torch.arange(-win, win + 1, dtype=dt, device=img_prev.device)
    dy = r[:, None].expand(2 * win + 1, 2 * win + 1)
    dx = r[None, :].expand(2 * win + 1, 2 * win + 1)
    py = pts[:, 1, None, None] + dy
    px = pts[:, 0, None, None] + dx
    T = bilinear(img_prev, py, px)
    Ix = 0.5 * (bilinear(img_prev, py, px + 1) - bilinear(img_prev, py, px - 1))
    Iy = 0.5 * (bilinear(img_prev, py + 1, px) - bilinear(img_prev, py - 1, px))

    gxx = torch.sum(Ix * Ix, dim=(1, 2))
    gxy = torch.sum(Ix * Iy, dim=(1, 2))
    gyy = torch.sum(Iy * Iy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    min_eig = min_eig / (2 * win + 1) ** 2
    den = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    a00 = gyy / den
    a01 = -gxy / den
    a11 = gxx / den

    g = guess
    for _ in range(iters):
        I = bilinear(img_cur, g[:, 1, None, None] + dy, g[:, 0, None, None] + dx)
        dI = I - T
        bx = torch.sum(dI * Ix, dim=(1, 2))
        by = torch.sum(dI * Iy, dim=(1, 2))
        g = g - torch.stack([a00 * bx + a01 * by, a01 * bx + a11 * by], dim=-1)
    return g, min_eig


def _check(name, t, shape, dev):
    if t.device != dev:
        raise ValueError(f"lk_level: {name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"lk_level: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"lk_level: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"lk_level: {name} must be contiguous")


def _kernel():
    from ctrlvio_tpu_torch.utils import cuda_build

    lib = cuda_build.load("lk")
    fn = lib.lk_level_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, p, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def lk_level(img_prev, img_cur, pts, guess, iters: int = 10,
             win: int = HALF):
    """One pyramid level of batched LK (see `lk_level_plain`).

    CPU tensors take the plain version; CUDA tensors launch K1, which is
    built for the 21x21 window (win = HALF) only."""
    dev = img_prev.device
    if dev.type == "cpu":
        return lk_level_plain(img_prev, img_cur, pts, guess, iters, win)
    if dev.type != "cuda":
        raise ValueError(f"lk_level: unsupported device {dev}")
    if win != HALF:
        raise ValueError(f"lk_level: K1 takes win={HALF} only, got {win}")
    H, W = img_prev.shape
    N = pts.shape[0]
    _check("img_prev", img_prev, (H, W), dev)
    _check("img_cur", img_cur, (H, W), dev)
    _check("pts", pts, (N, 2), dev)
    _check("guess", guess, (N, 2), dev)
    if H < 2 or W < 2:
        raise ValueError("lk_level: image must be at least 2x2")
    out = torch.empty((N, 2), dtype=torch.float32, device=dev)
    eig = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out, eig
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(img_prev.data_ptr(), img_cur.data_ptr(), H, W,
                 pts.data_ptr(), guess.data_ptr(), N, int(iters),
                 out.data_ptr(), eig.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"lk_level: K1 launch failed (cudaError {err})")
    lk_level.launches += 1
    return out, eig


lk_level.launches = 0
lk_level_plain.calls = 0
