"""Rasterize a synthetic scene into rolling-shutter images (the port's numpy
copy of `render_sequence` from `ctrlvio_tpu/sim/render.py`; the textured
ray-cast world renderer is not ported yet).

Each landmark is drawn as a sub-pixel Gaussian blob at its
rolling-shutter-correct projection (row v exposed at `t_frame + v * ld`,
the time model of the estimator's RS reprojection factor). Projection is
numpy on the host, pinhole or Kannala-Brandt fisheye.
"""

from __future__ import annotations

import numpy as np

from ctrlvio_tpu_torch.ops import so3np


def _project_np(camera, Xc):
    """Camera-frame points (L, 3) -> (uv (L, 2), front (L,) bool). numpy
    mirrors of `models/cameras.py` project() (host-side)."""
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    if hasattr(camera, "mu"):  # Equidistant / Kannala-Brandt
        r = np.sqrt(x * x + y * y)
        theta = np.arctan2(r, z)
        t2 = theta * theta
        td = theta * (1.0 + t2 * (camera.k2 + t2 * (camera.k3 + t2 * (
            camera.k4 + t2 * camera.k5))))
        scale = np.where(r < 1e-12, 0.0, td / np.where(r < 1e-12, 1.0, r))
        uv = np.stack([camera.mu * scale * x + camera.u0,
                       camera.mv * scale * y + camera.v0], axis=1)
        # fisheye sees past 90 deg in principle; keep a solid margin
        front = theta < 1.25
        return uv, front
    # pinhole + radtan
    zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
    xn, yn = x / zs, y / zs
    r2 = xn * xn + yn * yn
    rad = 1.0 + camera.k1 * r2 + camera.k2 * r2 * r2
    dx = 2.0 * camera.p1 * xn * yn + camera.p2 * (r2 + 2.0 * xn * xn)
    dy = camera.p1 * (r2 + 2.0 * yn * yn) + 2.0 * camera.p2 * xn * yn
    uv = np.stack([camera.fx * (xn * rad + dx) + camera.cx,
                   camera.fy * (yn * rad + dy) + camera.cy], axis=1)
    return uv, z > 0.25


def render_sequence(sim, H: int, W: int, fx: float = None, fy: float = None,
                    cx: float = None, cy: float = None,
                    blob_sigma: float = 1.4, background: float = 24.0,
                    seed: int = 0, camera=None, texture: float = 0.0,
                    big_every: int = 0, big_sigma: tuple = (5.0, 12.0),
                    ) -> np.ndarray:
    """Render all frames of a SimData. Returns (F, H, W) uint8.

    camera: a `models.cameras` Pinhole/Equidistant instance; if None a
    distortion-free Pinhole(fx, fy, cx, cy) is used (legacy signature).
    The row-time dependency is resolved by fixed-point iteration (3 rounds —
    the same contraction the reference's factor exploits). texture > 0 adds
    fixed-pattern background clutter (weak corners the detector must reject).

    big_every > 0 renders every k-th landmark as a LARGE blob (sigma drawn
    from big_sigma): coarse-scale scene structure that survives pyramid
    decimation, so coarse-to-fine LK can absorb large inter-frame motion the
    way it does on real multi-scale imagery (pure dot scenes alias away at
    the coarse levels and cap trackable motion at ~1 window).
    """
    if camera is None:
        from ctrlvio_tpu_torch.models.cameras import Pinhole

        camera = Pinhole(fx, fy, cx, cy)

    rng = np.random.default_rng(seed)
    lm = np.asarray(sim.landmarks, np.float64)
    L = len(lm)
    intens = rng.uniform(110.0, 235.0, L)
    sigma = np.full(L, float(blob_sigma))
    if big_every > 0:
        big = np.arange(L) % big_every == big_every - 1
        sigma[big] = rng.uniform(*big_sigma, int(big.sum()))
        intens[big] *= 0.55  # dimmer, like diffuse large-scale structure
    R_CtoI = so3np.quat_to_matrix(
        so3np.quat_exp(np.asarray(sim.cfg.ext_rot, np.float64)[None]))[0]
    p_CinI = np.asarray(sim.cfg.ext_pos, np.float64)
    ld = sim.cfg.line_delay
    cy0 = getattr(camera, "cy", None) or getattr(camera, "v0", H / 2)

    r_small = int(np.ceil(3 * blob_sigma))
    r_big = int(np.ceil(3 * max(big_sigma))) if big_every > 0 else r_small

    bg_img = np.full((H, W), background, np.float64)
    if texture > 0:
        # smooth fixed-pattern clutter: low-freq sinusoid mix (static in the
        # image plane — weak gradients everywhere, no stable world anchor)
        yy, xx = np.mgrid[0:H, 0:W]
        bg_img = bg_img + texture * (
            np.sin(xx * 0.11 + yy * 0.07) + np.sin(xx * 0.031 - yy * 0.023))

    def project_frame(t_rows):
        """Project all landmarks at per-landmark exposure times."""
        q, p, _, _ = sim.poses_at(np.clip(t_rows, 0.0, None))
        R = so3np.quat_to_matrix(q)  # (L,3,3) IMU->world
        Xi = np.einsum("nji,nj->ni", R, lm - p)  # R^T (lm - p)
        Xc = (Xi - p_CinI) @ R_CtoI  # rowwise R_CtoI^T (Xi - p)
        return _project_np(camera, Xc)

    def splat(img, li, uv, r):
        """Accumulate Gaussian blobs for landmark indices li at uv."""
        oy, ox = np.mgrid[-r : r + 1, -r : r + 1]
        u0, v0 = uv[li, 0], uv[li, 1]
        iu = np.round(u0).astype(np.int64)
        iv = np.round(v0).astype(np.int64)
        py = (iv[:, None, None] + oy) - v0[:, None, None]
        px = (iu[:, None, None] + ox) - u0[:, None, None]
        patch = intens[li, None, None] * np.exp(
            -(py * py + px * px) / (2 * sigma[li, None, None] ** 2))
        flat = (iv[:, None, None] + oy) * W + (iu[:, None, None] + ox)
        np.add.at(img.reshape(-1), flat.reshape(-1), patch.reshape(-1))

    is_big = sigma > blob_sigma
    frames = np.zeros((len(sim.frames), H, W), np.uint8)
    for fidx, fr in enumerate(sim.frames):
        t0 = fr.t_ns * 1e-9
        # fixed-point on the row time: v -> t_row -> reproject
        v = np.full(L, float(cy0))
        for _ in range(3):
            uv, front = project_frame(t0 + v * ld)
            v = np.where(front, np.clip(uv[:, 1], 0, H - 1), v)
        img = bg_img.copy()
        for r, grp in ((r_small, ~is_big), (r_big, is_big)):
            if not grp.any():
                continue
            vis = grp & front & (uv[:, 0] > r + 1) & (uv[:, 0] < W - r - 2) \
                & (uv[:, 1] > r + 1) & (uv[:, 1] < H - r - 2)
            li = np.nonzero(vis)[0]
            if len(li):
                splat(img, li, uv, r)
        frames[fidx] = np.clip(img, 0, 255).astype(np.uint8)
    return frames
