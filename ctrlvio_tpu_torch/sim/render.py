"""Rasterize a synthetic scene into rolling-shutter images (the port's numpy
copy of `ctrlvio_tpu/sim/render.py`: same arithmetic, same random draws).

Two renderers, both host numpy:

- `render_sequence`: each landmark is drawn as a sub-pixel Gaussian blob
  at its rolling-shutter-correct projection (row v exposed at
  `t_frame + v * ld`, the time model of the estimator's RS reprojection
  factor).
- `render_textured_sequence`: every image row is ray-cast at its own
  exposure time through a box room with procedurally textured faces and
  textured occluder quads (optionally moving, which plants tracks the
  front end's epipolar gate must reject), with photometric gain/offset
  drift, vignetting and pixel noise. Nothing is drawn at landmark
  projections: the tracker finds its own corners.

Projection is pinhole or Kannala-Brandt fisheye.
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


# ---------------------------------------------------------------------------
# texture-mapped world renderer
# ---------------------------------------------------------------------------


def _make_texture(rng, res: int = 768) -> np.ndarray:
    """Procedural surface texture (res, res) f32 in [0, 1]: multi-octave
    value noise (corners at every scale) + high-contrast random rectangles
    (sharp Shi-Tomasi corners) + speckle."""
    img = np.zeros((res, res), np.float32)
    amp = 1.0
    for cells in (6, 12, 24, 48, 96):
        g = rng.uniform(-1.0, 1.0, (cells + 1, cells + 1)).astype(np.float32)
        # bilinear upsample of the coarse grid to (res, res)
        t = np.linspace(0, cells, res, endpoint=False, dtype=np.float32)
        i0 = np.minimum(t.astype(np.int32), cells - 1)
        f = t - i0
        gx = g[i0] * (1 - f)[:, None] + g[i0 + 1] * f[:, None]
        img += amp * (gx[:, i0] * (1 - f)[None, :] + gx[:, i0 + 1] * f[None, :])
        amp *= 0.55
    # random rectangles: crisp intensity steps -> strong corners
    for _ in range(160):
        h = rng.integers(6, res // 6)
        w = rng.integers(6, res // 6)
        y = rng.integers(0, res - h)
        x = rng.integers(0, res - w)
        img[y : y + h, x : x + w] += rng.uniform(-0.9, 0.9)
    img += (rng.random((res, res)) < 0.002) * rng.uniform(0.8, 1.6)
    lo, hi = np.percentile(img, [2, 98])
    return np.clip((img - lo) / max(hi - lo, 1e-6), 0.0, 1.0).astype(np.float32)


def _sample_bilinear(tex: np.ndarray, u, v):
    """Periodic bilinear texture sample; u, v in texture coords (texels)."""
    res = tex.shape[0]
    u = np.mod(u, res)
    v = np.mod(v, res)
    # f32 mod can return exactly `res` for tiny negative inputs
    i0 = np.minimum(np.floor(u).astype(np.int32), res - 1) % res
    j0 = np.minimum(np.floor(v).astype(np.int32), res - 1) % res
    fu = np.clip(u - i0, 0.0, 1.0).astype(np.float32)
    fv = np.clip(v - j0, 0.0, 1.0).astype(np.float32)
    i1 = (i0 + 1) % res
    j1 = (j0 + 1) % res
    return (tex[j0, i0] * (1 - fu) * (1 - fv) + tex[j0, i1] * fu * (1 - fv)
            + tex[j1, i0] * (1 - fu) * fv + tex[j1, i1] * fu * fv)


class TexturedWorld:
    """Box room (6 textured faces) + textured occluder quads. All geometry
    world-anchored; occluders may move (planting epipolar-outlier tracks)."""

    def __init__(self, lo, hi, seed: int = 0, n_occluders: int = 4,
                 occluder_speed: float = 0.0, tex_res: int = 768,
                 texels_per_m: float = 96.0, keepout_path=None):
        rng = np.random.default_rng(seed)
        self.lo = np.asarray(lo, np.float32)
        self.hi = np.asarray(hi, np.float32)
        self.tex_faces = [_make_texture(rng, tex_res) for _ in range(6)]
        self.tpm = np.float32(texels_per_m)
        # occluder quads inside the room: center, orthonormal edge dirs,
        # half extents, texture, velocity (m/s; 0 = static scenery)
        self.occ = []
        c0 = 0.5 * (self.lo + self.hi)
        span = 0.5 * (self.hi - self.lo)
        keepout = np.asarray(keepout_path, np.float32).reshape(-1, 3) \
            if keepout_path is not None else None
        for k in range(n_occluders):
            for _ in range(64):  # keep quads off the flight path
                c = c0 + rng.uniform(-0.55, 0.55, 3).astype(np.float32) * span
                if keepout is None or np.min(
                        np.linalg.norm(keepout - c[None, :], axis=1)) > 1.6:
                    break
            a = rng.normal(size=3)
            a /= np.linalg.norm(a)
            b = rng.normal(size=3)
            b -= a * (a @ b)
            b /= np.linalg.norm(b)
            half = rng.uniform(0.35, 0.9, 2).astype(np.float32)
            vel = np.zeros(3, np.float32)
            if occluder_speed > 0 and k % 2 == 0:
                vel = rng.normal(size=3).astype(np.float32)
                vel *= occluder_speed / max(np.linalg.norm(vel), 1e-9)
            self.occ.append(dict(
                c=c.astype(np.float32), e1=a.astype(np.float32),
                e2=b.astype(np.float32),
                n=np.cross(a, b).astype(np.float32), half=half,
                tex=_make_texture(rng, tex_res // 2), vel=vel))

    def add_quad(self, c, e1, e2, half, vel=(0.0, 0.0, 0.0), seed: int = 99,
                 tex_res: int = 384):
        """Plant an occluder quad deliberately (tests: put a MOVING quad in
        the camera's view to guarantee epipolar-outlier tracks)."""
        rng = np.random.default_rng(seed)
        e1 = np.asarray(e1, np.float32)
        e1 /= np.linalg.norm(e1)
        e2 = np.asarray(e2, np.float32)
        e2 -= e1 * (e1 @ e2)
        e2 /= np.linalg.norm(e2)
        self.occ.append(dict(
            c=np.asarray(c, np.float32), e1=e1, e2=e2,
            n=np.cross(e1, e2).astype(np.float32),
            half=np.asarray(half, np.float32),
            tex=_make_texture(rng, tex_res),
            vel=np.asarray(vel, np.float32)))

    def occluder_mask(self, o, d, t: float):
        """(R,) bool: rays (origin o (R,3) or (3,), dirs d (R,3)) that hit a
        MOVING occluder before the room at time t — the planted-outlier
        region (for tests/diagnostics)."""
        t_box = self._box_t(np.broadcast_to(o, d.shape), d)
        hit = np.zeros(d.shape[0], bool)
        for q in self.occ:
            if not np.any(q["vel"]):
                continue
            tq, _, _ = self._quad_t(q, np.broadcast_to(o, d.shape), d, t)
            hit |= tq < t_box
        return hit

    # -- intersections ---------------------------------------------------
    def _box_t(self, o, d):
        """Distance to the room walls from inside. o, d: (R, 3)."""
        big = np.float32(1e9)
        inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
        t_lo = (self.lo[None, :] - o) * inv
        t_hi = (self.hi[None, :] - o) * inv
        t_far = np.maximum(t_lo, t_hi)         # exit distance per axis
        return np.min(np.where(t_far > 1e-4, t_far, big), axis=1)

    def _quad_t(self, q, o, d, t_now: float):
        c = q["c"] + q["vel"] * np.float32(t_now)
        dn = d @ q["n"]
        dn = np.where(np.abs(dn) < 1e-7, 1e-7, dn)
        t = ((c[None, :] - o) @ q["n"]) / dn
        p = o + t[:, None] * d
        a = (p - c[None, :]) @ q["e1"]
        b = (p - c[None, :]) @ q["e2"]
        ok = (t > 1e-4) & (np.abs(a) <= q["half"][0]) & (np.abs(b) <= q["half"][1])
        big = np.float32(1e9)
        return np.where(ok, t, big), a, b

    # -- shading -----------------------------------------------------------
    def shade(self, o, d, t_now: float):
        """Intensity in [0,1] for rays o (R,3) origins, d (R,3) dirs at
        world time t_now (seconds). Nearest hit among quads and room."""
        o = np.asarray(o, np.float32)
        d = np.asarray(d, np.float32)
        R = d.shape[0]
        t_box = self._box_t(o, d)
        p = o + t_box[:, None] * d
        # face id: axis of the exit plane (0..2) + 3*(hi side)
        dist_lo = np.abs(p - self.lo[None, :])
        dist_hi = np.abs(p - self.hi[None, :])
        both = np.concatenate([dist_lo, dist_hi], axis=1)  # (R, 6)
        face = np.argmin(both, axis=1)
        out = np.zeros(R, np.float32)
        for f in range(6):
            m = face == f
            if not m.any():
                continue
            ax = f % 3
            u_ax, v_ax = [(1, 2), (0, 2), (0, 1)][ax]
            out[m] = _sample_bilinear(self.tex_faces[f],
                                      p[m, u_ax] * self.tpm,
                                      p[m, v_ax] * self.tpm)
        # occluders override where nearer
        t_best = t_box
        for q in self.occ:
            tq, a, b = self._quad_t(q, o, d, t_now)
            m = tq < t_best
            if m.any():
                out[m] = _sample_bilinear(q["tex"], a[m] * self.tpm,
                                          b[m] * self.tpm)
                t_best = np.where(m, tq, t_best)
        return out


def _unproject_np(camera, H: int, W: int) -> np.ndarray:
    """(H, W, 3) unit ray directions in the CAMERA frame for every pixel
    center — numpy inverse of `_project_np` (Newton for the KB theta)."""
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    if hasattr(camera, "mu"):  # Kannala-Brandt
        mx = (uu - camera.u0) / camera.mu
        my = (vv - camera.v0) / camera.mv
        rd = np.hypot(mx, my)
        th = rd.copy()
        for _ in range(6):
            t2 = th * th
            f = th * (1.0 + t2 * (camera.k2 + t2 * (camera.k3 + t2 * (
                camera.k4 + t2 * camera.k5)))) - rd
            df = 1.0 + t2 * (3 * camera.k2 + t2 * (5 * camera.k3 + t2 * (
                7 * camera.k4 + t2 * 9 * camera.k5)))
            th = th - f / np.where(np.abs(df) < 1e-9, 1e-9, df)
        s = np.where(rd < 1e-12, 0.0, np.sin(th) / np.where(rd < 1e-12, 1.0, rd))
        dirs = np.stack([s * mx, s * my, np.cos(th)], axis=-1)
    else:  # pinhole + radtan: fixed-point undistort
        xn = (uu - camera.cx) / camera.fx
        yn = (vv - camera.cy) / camera.fy
        x, y = xn.copy(), yn.copy()
        for _ in range(6):
            r2 = x * x + y * y
            rad = 1.0 + camera.k1 * r2 + camera.k2 * r2 * r2
            dx = 2 * camera.p1 * x * y + camera.p2 * (r2 + 2 * x * x)
            dy = camera.p1 * (r2 + 2 * y * y) + 2 * camera.p2 * x * y
            x = (xn - dx) / rad
            y = (yn - dy) / rad
        dirs = np.stack([x, y, np.ones_like(x)], axis=-1)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.astype(np.float32)


def make_world(sim, seed: int = 0, margin: float = 6.0,
               n_occluders: int = 4, occluder_speed: float = 0.0
               ) -> TexturedWorld:
    """A TexturedWorld box sized to enclose the sim trajectory + margin."""
    p = np.asarray(sim.knots_p)
    return TexturedWorld(p.min(axis=0) - margin, p.max(axis=0) + margin,
                         seed=seed, n_occluders=n_occluders,
                         occluder_speed=occluder_speed, keepout_path=p)


def render_textured_sequence(sim, H: int, W: int, camera,
                             world: TexturedWorld = None, seed: int = 0,
                             n_occluders: int = 4,
                             occluder_speed: float = 0.0,
                             photometric: bool = True,
                             pixel_noise: float = 2.0,
                             row_chunk: int = 64) -> np.ndarray:
    """Ray-cast rolling-shutter frames of a texture-mapped world.

    Every image ROW is cast with the camera pose at its own exposure time
    t0 + v*ld (exact rolling shutter, the reference's time model
    `image_feature_factor.h:84-85`); rows are processed in chunks of
    `row_chunk` only to bound memory. Returns (F, H, W) uint8.
    """
    if world is None:
        world = make_world(sim, seed=seed, n_occluders=n_occluders,
                           occluder_speed=occluder_speed)

    rng = np.random.default_rng(seed + 17)
    R_CtoI = so3np.quat_to_matrix(
        so3np.quat_exp(np.asarray(sim.cfg.ext_rot, np.float64)[None]))[0]
    p_CinI = np.asarray(sim.cfg.ext_pos, np.float64)
    ld = sim.cfg.line_delay
    dirs_cam = _unproject_np(camera, H, W)          # (H, W, 3) f32

    # fixed vignette
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cx = getattr(camera, "cx", None) or getattr(camera, "u0", W / 2)
    cy = getattr(camera, "cy", None) or getattr(camera, "v0", H / 2)
    r2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / np.float32(cx * cx + cy * cy)
    vignette = (1.0 - 0.30 * r2).astype(np.float32)

    frames = np.zeros((len(sim.frames), H, W), np.uint8)
    v_rows = np.arange(H, dtype=np.float64)
    for fidx, fr in enumerate(sim.frames):
        t0 = fr.t_ns * 1e-9
        t_rows = t0 + v_rows * ld
        q, p, _, _ = sim.poses_at(t_rows)
        R_i2w = so3np.quat_to_matrix(q)               # (H, 3, 3)
        R_c2w = (R_i2w @ R_CtoI).astype(np.float32)   # (H, 3, 3)
        c_w = (p + np.einsum("nij,j->ni", R_i2w, p_CinI)).astype(np.float32)
        img = np.empty((H, W), np.float32)
        for r0 in range(0, H, row_chunk):
            r1 = min(r0 + row_chunk, H)
            # per-ROW pose: rotate each row's pixel dirs by its own R
            d_w = np.einsum("rij,rwj->rwi", R_c2w[r0:r1],
                            dirs_cam[r0:r1]).reshape(-1, 3)
            o_w = np.repeat(c_w[r0:r1], W, axis=0)
            img[r0:r1] = world.shade(
                o_w, d_w, float(0.5 * (t_rows[r0] + t_rows[r1 - 1]))
            ).reshape(r1 - r0, W)
        img = img * vignette
        if photometric:
            gain = 1.0 + 0.10 * np.sin(2 * np.pi * t0 / 7.0) \
                + rng.normal() * 0.02
            offset = 6.0 * np.sin(2 * np.pi * t0 / 11.0) + rng.normal() * 1.5
            img = img * gain + offset / 255.0
        out = 16.0 + 225.0 * img
        if pixel_noise > 0:
            out = out + rng.normal(size=out.shape).astype(np.float32) \
                * pixel_noise
        frames[fidx] = np.clip(out, 0, 255).astype(np.uint8)
    return frames
