"""Batched pyramidal Lucas-Kanade: kernel K1 and its plain versions.

K1 (`csrc/lk.cu`) replaces the Pallas TPU kernel
`ctrlvio_tpu/ops/pallas/lk_kernel.py::_lk_kernel` and the per-level loop
around it, and holds to the semantics of `ctrlvio_tpu/frontend/klt.py`
(`track`, non-Pallas branch, and `_track_level`), batched over features.
Two entry points launch it:

- `lk_track`: the whole forward-backward track of a frame with the FB
  gate, in one launch (what the front end calls);
- `lk_level`: one pyramid level, the kernel's L = 1 forward-only case.

Tensors on the CPU go to the plain PyTorch versions (`lk_track_plain`,
`lk_level_plain`); tensors on a CUDA device launch K1, or raise: there is
no fallback.

`lk_track.launches` and `lk_level.launches` count K1 launches (and nothing
else), so a run can show that its main path went through the kernel;
`lk_track.launches_by_levels` splits the former by the number of pyramid
levels tracked (the fused tracker's gyro-predicted track takes
`pred_levels`, `klt.track` without an initial guess every level).
`lk_track_plain.calls` and `lk_level_plain.calls` count runs of the plain
versions, so a run can show that they stayed off the path. `reset_counts`
sets all of them to 0. The counts are registered with `utils/graphs.py`: a
launch recorded into a captured graph counts when the graph replays it,
once a replay.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ctrlvio_tpu_torch.utils import graphs

HALF = 10                     # patch half-size -> 21x21 window
PATCH = 2 * HALF + 1
MAX_LEVELS = 4                # pyramid levels K1 takes


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


def lk_pass_plain(pyr_a, pyr_b, p0, g0, iters: int = 10, win: int = HALF):
    """One coarse-to-fine pass (`fwd` in
    `ctrlvio_tpu/frontend/klt.py::track`): start at
    g0 / 2^(L-1), refine at each level against the template of pyr_a at
    p0 / 2^lev, double g between levels. Returns (g (N, 2), min_eig (N,)
    of level 0)."""
    L = len(pyr_a)
    g = g0 / (2 ** (L - 1))
    eig = torch.zeros_like(p0[:, 0])
    for lev in range(L - 1, -1, -1):
        g, eig = lk_level_plain(pyr_a[lev], pyr_b[lev], p0 / (2 ** lev), g,
                                iters, win)
        if lev > 0:
            g = g * 2.0
    return g, eig


def lk_track_plain(pyr_prev, pyr_cur, pts, init, iters: int = 10,
                   win: int = HALF, fb_thresh: float = 0.5,
                   min_eig: float = 1e-4):
    """`klt.track` over the given levels: the forward pass from init, the
    backward pass from pts, and the gate. Returns (pts_cur (N, 2),
    ok (N,) bool, min_eig (N,) of the forward pass's level 0)."""
    lk_track_plain.calls += 1
    H, W = pyr_prev[0].shape
    pts_cur, eig = lk_pass_plain(pyr_prev, pyr_cur, pts, init, iters, win)
    pts_back, _ = lk_pass_plain(pyr_cur, pyr_prev, pts_cur, pts, iters, win)
    fb = torch.linalg.vector_norm(pts_back - pts, dim=-1)
    inb = ((pts_cur[:, 0] >= 1.0) & (pts_cur[:, 0] < W - 1.0)
           & (pts_cur[:, 1] >= 1.0) & (pts_cur[:, 1] < H - 1.0))
    ok = (fb < fb_thresh) & inb & (eig > min_eig)
    return pts_cur, ok, eig


def _check(fn, name, t, shape, dev):
    if t.device != dev:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _require_cuda(fn, dev, win):
    """Raise unless `dev` is a CUDA device and the window is K1's."""
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    if win != HALF:
        raise ValueError(f"{fn}: K1 takes win={HALF} only, got {win}")


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its entry points' signatures declared."""
    from ctrlvio_tpu_torch.utils import cuda_build

    lib = cuda_build.load("lk")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lk_level_f32.argtypes = [p, p, i, i, p, p, i, i, p, p, p]
    lib.lk_level_f32.restype = ctypes.c_int
    lib.lk_track_f32.argtypes = [p, p, p, p, i, p, p, i, i, f, f, p, p, p, p]
    lib.lk_track_f32.restype = ctypes.c_int
    return lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def lk_level(img_prev, img_cur, pts, guess, iters: int = 10,
             win: int = HALF):
    """One pyramid level of batched LK (see `lk_level_plain`).

    CPU tensors take the plain version; CUDA tensors launch K1 (its L = 1,
    forward-only case), which is built for the 21x21 window only."""
    dev = img_prev.device
    if dev.type == "cpu":
        return lk_level_plain(img_prev, img_cur, pts, guess, iters, win)
    _require_cuda("lk_level", dev, win)
    H, W = img_prev.shape
    N = pts.shape[0]
    _check("lk_level", "img_prev", img_prev, (H, W), dev)
    _check("lk_level", "img_cur", img_cur, (H, W), dev)
    _check("lk_level", "pts", pts, (N, 2), dev)
    _check("lk_level", "guess", guess, (N, 2), dev)
    if H < 2 or W < 2:
        raise ValueError("lk_level: image must be at least 2x2")
    out = torch.empty((N, 2), dtype=torch.float32, device=dev)
    eig = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out, eig
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.lk_level_f32(img_prev.data_ptr(), img_cur.data_ptr(), H, W,
                               pts.data_ptr(), guess.data_ptr(), N,
                               int(iters), out.data_ptr(), eig.data_ptr(),
                               _stream(dev))
    if err != 0:
        raise RuntimeError(f"lk_level: K1 launch failed (cudaError {err})")
    lk_level.launches += 1
    return out, eig


def lk_track(pyr_prev, pyr_cur, pts, init, iters: int = 10, win: int = HALF,
             fb_thresh: float = 0.5, min_eig: float = 1e-4):
    """The forward-backward pyramidal track of a frame (see
    `lk_track_plain`): pyr_prev, pyr_cur are lists of the L levels to use,
    pts and init (N, 2) in level-0 coordinates. Returns (pts_cur (N, 2),
    ok (N,) bool, min_eig (N,)).

    CPU tensors take the plain version; CUDA tensors launch K1 once, for
    the 21x21 window and at most MAX_LEVELS levels."""
    dev = pyr_prev[0].device
    if dev.type == "cpu":
        return lk_track_plain(pyr_prev, pyr_cur, pts, init, iters, win,
                              fb_thresh, min_eig)
    _require_cuda("lk_track", dev, win)
    L = len(pyr_prev)
    if len(pyr_cur) != L or not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"lk_track: K1 takes 1 to {MAX_LEVELS} levels of "
                         f"both pyramids, got {L} and {len(pyr_cur)}")
    N = pts.shape[0]
    _check("lk_track", "pts", pts, (N, 2), dev)
    _check("lk_track", "init", init, (N, 2), dev)
    shapes = []
    for lev, (a, b) in enumerate(zip(pyr_prev, pyr_cur)):
        if a.dim() != 2:
            raise ValueError(f"lk_track: level {lev} must be (H, W), got "
                             f"{tuple(a.shape)}")
        H, W = a.shape
        if H < 2 or W < 2:
            raise ValueError("lk_track: every level must be at least 2x2")
        _check("lk_track", f"pyr_prev[{lev}]", a, (H, W), dev)
        _check("lk_track", f"pyr_cur[{lev}]", b, (H, W), dev)
        shapes.append((H, W))
    out = torch.empty((N, 2), dtype=torch.float32, device=dev)
    ok = torch.empty((N,), dtype=torch.bool, device=dev)
    eig = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out, ok, eig
    ptrs = ctypes.c_void_p * L
    ints = ctypes.c_int * L
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.lk_track_f32(
            ptrs(*[a.data_ptr() for a in pyr_prev]),
            ptrs(*[b.data_ptr() for b in pyr_cur]),
            ints(*[h for h, _ in shapes]), ints(*[w for _, w in shapes]), L,
            pts.data_ptr(), init.data_ptr(), N, int(iters), float(fb_thresh),
            float(min_eig), out.data_ptr(), eig.data_ptr(), ok.data_ptr(),
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"lk_track: K1 launch failed (cudaError {err})")
    lk_track.launches += 1
    lk_track.launches_by_levels[L] = lk_track.launches_by_levels.get(L, 0) + 1
    return out, ok, eig


def reset_counts():
    """Set every launch and plain-call count of this module to 0."""
    lk_level.launches = 0
    lk_track.launches = 0
    lk_track.launches_by_levels = {}
    lk_level_plain.calls = 0
    lk_track_plain.calls = 0


def _counts():
    """Every count of this module by name (what a graph replay adds to)."""
    out = {"lk_level": lk_level.launches, "lk_track": lk_track.launches,
           "lk_level_plain": lk_level_plain.calls,
           "lk_track_plain": lk_track_plain.calls}
    out.update({f"lk_track/{L}": n
                for L, n in lk_track.launches_by_levels.items()})
    return out


def _add_counts(delta):
    for k, v in delta.items():
        if k.startswith("lk_track/"):
            L = int(k.split("/")[1])
            n = lk_track.launches_by_levels.get(L, 0) + v
            if n:
                lk_track.launches_by_levels[L] = n
            else:
                lk_track.launches_by_levels.pop(L, None)
        elif k.endswith("_plain"):
            fn = lk_level_plain if k == "lk_level_plain" else lk_track_plain
            fn.calls += v
        else:
            fn = lk_level if k == "lk_level" else lk_track
            fn.launches += v


reset_counts()
graphs.register_counter(_counts, _add_counts)
