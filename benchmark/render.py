"""The textured world of the image traffic, and its rolling-shutter frames
rendered on the card.

The world is drawn on the host from the run's seed, in the same draws as
`ctrlvio_tpu_torch/sim/render.py::TexturedWorld` (a frozen copy of its
arithmetic, as `sequence.py` is of the port's lissajous family): a box
room around the path with a margin, its six faces procedurally textured
(value noise, crisp rectangles, speckle), and textured occluder quads kept
off the path, the even ones moving at the traffic's speed.

`Renderer` ray-casts the frames on the device in float32, as the host
renderer does: each row from the camera pose at its own exposure time
`t + v ld` (the occluders placed at the middle time of each 64-row chunk,
as the host renderer moves them), the nearest of the room and the quads
shaded by a bilinear texture sample; then vignetting, a photometric gain
and offset drift (two numpy draws a frame from `seed + 17`, as the host
renderer draws them) and pixel noise (a torch generator on the device).
The frames are uint8 and stay on the device, as a deployment's frames
arrive there. With the noise off, its frames equal the host renderer's
but for float32 rounding. Nothing here imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import sequence

BIG = 1e9
ROW_CHUNK = 64


def make_texture(rng, res: int = 768) -> np.ndarray:
    """Procedural surface texture (res, res) f32 in [0, 1]: multi-octave
    value noise + high-contrast random rectangles + speckle."""
    img = np.zeros((res, res), np.float32)
    amp = 1.0
    for cells in (6, 12, 24, 48, 96):
        g = rng.uniform(-1.0, 1.0, (cells + 1, cells + 1)).astype(np.float32)
        t = np.linspace(0, cells, res, endpoint=False, dtype=np.float32)
        i0 = np.minimum(t.astype(np.int32), cells - 1)
        f = t - i0
        gx = g[i0] * (1 - f)[:, None] + g[i0 + 1] * f[:, None]
        img += amp * (gx[:, i0] * (1 - f)[None, :] + gx[:, i0 + 1] * f[None, :])
        amp *= 0.55
    for _ in range(160):
        h = rng.integers(6, res // 6)
        w = rng.integers(6, res // 6)
        y = rng.integers(0, res - h)
        x = rng.integers(0, res - w)
        img[y:y + h, x:x + w] += rng.uniform(-0.9, 0.9)
    img += (rng.random((res, res)) < 0.002) * rng.uniform(0.8, 1.6)
    lo, hi = np.percentile(img, [2, 98])
    return np.clip((img - lo) / max(hi - lo, 1e-6), 0.0, 1.0).astype(np.float32)


class World:
    """A box room `lo`..`hi` with six textured faces, and occluder quads
    (`occ`: center `c`, edge directions `e1`, `e2`, normal `n`, half
    extents `half`, texture `tex`, velocity `vel` in m/s), drawn from
    `seed` as `TexturedWorld` draws them."""

    def __init__(self, lo, hi, seed: int, n_occluders: int = 4,
                 occluder_speed: float = 0.0, tex_res: int = 768,
                 texels_per_m: float = 96.0, keepout_path=None):
        rng = np.random.default_rng(seed)
        self.lo = np.asarray(lo, np.float32)
        self.hi = np.asarray(hi, np.float32)
        self.tex_faces = [make_texture(rng, tex_res) for _ in range(6)]
        self.tpm = np.float32(texels_per_m)
        self.occ = []
        c0 = 0.5 * (self.lo + self.hi)
        span = 0.5 * (self.hi - self.lo)
        keepout = (None if keepout_path is None
                   else np.asarray(keepout_path, np.float32).reshape(-1, 3))
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
                e2=b.astype(np.float32), n=np.cross(a, b).astype(np.float32),
                half=half, tex=make_texture(rng, tex_res // 2), vel=vel))

    def add_quad(self, c, e1, e2, half, vel=(0.0, 0.0, 0.0), seed: int = 99,
                 tex_res: int = 384):
        """Plant an occluder quad (as `TexturedWorld.add_quad`)."""
        rng = np.random.default_rng(seed)
        e1 = np.asarray(e1, np.float32)
        e1 /= np.linalg.norm(e1)
        e2 = np.asarray(e2, np.float32)
        e2 -= e1 * (e1 @ e2)
        e2 /= np.linalg.norm(e2)
        self.occ.append(dict(
            c=np.asarray(c, np.float32), e1=e1, e2=e2,
            n=np.cross(e1, e2).astype(np.float32),
            half=np.asarray(half, np.float32), tex=make_texture(rng, tex_res),
            vel=np.asarray(vel, np.float32)))


def path_points(gt: sequence.Lissajous, t_end_s: float, dt_s: float):
    """The path's positions (n, 3) every `dt_s` from 0 to `t_end_s` (the
    spline's knot spacing: what the host renderer's room encloses)."""
    n = int(math.floor(t_end_s / dt_s)) + 1
    ts = torch.arange(n, dtype=torch.float64,
                      device=gt.ph.device) * dt_s
    return gt.pose(ts)[1].cpu().numpy()


def world_for(scene: dict, path: np.ndarray, seed: int) -> World:
    """The traffic's room around `path` (its `margin_m` on every side),
    with its occluders, drawn from `seed` (as `sim/render.py::make_world`
    builds it)."""
    return World(path.min(axis=0) - scene["margin_m"],
                 path.max(axis=0) + scene["margin_m"], seed=seed,
                 n_occluders=scene["n_occluders"],
                 occluder_speed=scene["occluder_speed"],
                 tex_res=scene["tex_res"],
                 texels_per_m=scene["texels_per_m"], keepout_path=path)


def unproject(camera: dict, H: int, W: int) -> np.ndarray:
    """(H, W, 3) f32 unit ray directions in the camera frame through every
    pixel center, for the Kannala-Brandt camera (Newton on theta, float64,
    as the host renderer computes them)."""
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    k2, k3, k4, k5 = (camera[k] for k in ("k2", "k3", "k4", "k5"))
    mx = (uu - camera["u0"]) / camera["mu"]
    my = (vv - camera["v0"]) / camera["mv"]
    rd = np.hypot(mx, my)
    th = rd.copy()
    for _ in range(6):
        t2 = th * th
        f = th * (1.0 + t2 * (k2 + t2 * (k3 + t2 * (k4 + t2 * k5)))) - rd
        df = 1.0 + t2 * (3 * k2 + t2 * (5 * k3 + t2 * (7 * k4 + t2 * 9 * k5)))
        th = th - f / np.where(np.abs(df) < 1e-9, 1e-9, df)
    s = np.where(rd < 1e-12, 0.0, np.sin(th) / np.where(rd < 1e-12, 1.0, rd))
    return np.stack([s * mx, s * my, np.cos(th)], axis=-1).astype(np.float32)


def dot3(x, v):
    """Row-wise x . v for (..., 3) and a 3-vector, as explicit sums."""
    return x[..., 0] * v[0] + x[..., 1] * v[1] + x[..., 2] * v[2]


def fmod_pos(u, res: int):
    """`np.mod(u, res)` for floats: the remainder of the truncated
    division, moved into [0, res)."""
    m = torch.fmod(u, res)
    return torch.where(m < 0, m + res, m)


def sample(tex, base, res: int, u, v):
    """Periodic bilinear samples of the textures stacked in `tex` (flat),
    `base` each sample's texture offset, at texel coordinates (u, v)."""
    u, v = fmod_pos(u, res), fmod_pos(v, res)
    i0 = torch.clamp(torch.floor(u).to(torch.int64), max=res - 1) % res
    j0 = torch.clamp(torch.floor(v).to(torch.int64), max=res - 1) % res
    fu = torch.clamp(u - i0, 0.0, 1.0)
    fv = torch.clamp(v - j0, 0.0, 1.0)
    i1, j1 = (i0 + 1) % res, (j0 + 1) % res
    t = lambda j, i: tex[base + j * res + i]  # noqa: E731
    return (t(j0, i0) * (1 - fu) * (1 - fv) + t(j0, i1) * fu * (1 - fv)
            + t(j1, i0) * (1 - fu) * fv + t(j1, i1) * fu * fv)


class Renderer:
    """Frames of `world` seen by the rig's camera (`camera`, the traffic's
    Kannala-Brandt parameters; `rig`, the extrinsics and line delay) on
    `device`."""

    def __init__(self, world: World, camera: dict, rig: dict, H: int, W: int,
                 device, photometric: bool = True, pixel_noise: float = 0.0,
                 seed: int = 0):
        self.device, self.H, self.W = device, H, W
        f32 = dict(dtype=torch.float32, device=device)
        f64 = dict(dtype=torch.float64, device=device)
        self.res = world.tex_faces[0].shape[0]
        self.faces = torch.tensor(np.stack(world.tex_faces).reshape(-1), **f32)
        self.occ = []
        for q in world.occ:
            self.occ.append(dict(
                {k: torch.tensor(q[k], **f32)
                 for k in ("c", "e1", "e2", "n", "vel")},
                half=[float(q["half"][0]), float(q["half"][1])],
                moving=bool(np.any(q["vel"])), res=q["tex"].shape[0],
                tex=torch.tensor(q["tex"].reshape(-1), **f32)))
        self.lo = torch.tensor(world.lo, **f32)
        self.hi = torch.tensor(world.hi, **f32)
        self.tpm = float(world.tpm)
        self.dirs = torch.tensor(unproject(camera, H, W), **f32)
        yy = torch.arange(H, **f32)[:, None].expand(H, W)
        xx = torch.arange(W, **f32)[None, :].expand(H, W)
        cx, cy = camera["u0"], camera["v0"]
        r2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / float(
            np.float32(cx * cx + cy * cy))
        self.vignette = 1.0 - 0.30 * r2
        self.R_CtoI = sequence.quat_matrix(sequence.quat_exp(
            torch.tensor(rig["ext_rot"], **f64)))
        self.p_CinI = torch.tensor(rig["ext_pos"], **f64)
        self.ld = rig["line_delay"]
        self.photometric = photometric
        self.pixel_noise = pixel_noise
        self.rng = np.random.default_rng(seed + 17)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) + 17)
        rows = torch.arange(H, **f64)
        lo = torch.div(torch.arange(H, device=device), ROW_CHUNK,
                       rounding_mode="floor") * ROW_CHUNK
        hi = torch.clamp(lo + ROW_CHUNK, max=H) - 1
        self.rows = rows
        self.chunk = (lo.to(torch.float64), hi.to(torch.float64))

    def rays(self, gt: sequence.Lissajous, t0: float):
        """Each pixel's ray (origins, directions: (H, W, 3) f32) at its
        row's exposure time, and each row's occluder time (H,) f32."""
        t_rows = t0 + self.rows * self.ld
        q, p = gt.pose(t_rows)
        R_i2w = sequence.quat_matrix(q)
        R_c2w = (R_i2w @ self.R_CtoI).to(torch.float32)
        c_w = (p + (R_i2w * self.p_CinI).sum(-1)).to(torch.float32)
        d = self.dirs
        d_w = torch.stack([R_c2w[:, None, i, 0] * d[..., 0]
                           + R_c2w[:, None, i, 1] * d[..., 1]
                           + R_c2w[:, None, i, 2] * d[..., 2]
                           for i in range(3)], -1)
        lo, hi = self.chunk
        t_now = 0.5 * ((t0 + lo * self.ld) + (t0 + hi * self.ld))
        return c_w[:, None, :].expand_as(d_w), d_w, t_now.to(torch.float32)

    def shade(self, o, d, t_now):
        """Intensity in [0, 1] of rays (o, d) (R, 3) f32 at their occluder
        times `t_now` (R,): the nearest hit of the room and the quads."""
        inv = 1.0 / torch.where(d.abs() < 1e-9, 1e-9, d)
        t_lo = (self.lo - o) * inv
        t_hi = (self.hi - o) * inv
        t_far = torch.maximum(t_lo, t_hi)
        t_box = torch.where(t_far > 1e-4, t_far, BIG).min(-1).values
        p = o + t_box[:, None] * d
        both = torch.cat([(p - self.lo).abs(), (p - self.hi).abs()], -1)
        face = both.argmin(-1)
        ax = face % 3
        u = torch.where(ax == 0, p[:, 1], p[:, 0]) * self.tpm
        v = torch.where(ax == 2, p[:, 1], p[:, 2]) * self.tpm
        out = sample(self.faces, face * self.res * self.res, self.res, u, v)
        t_best = t_box
        for q in self.occ:
            tq, a, b = quad_hit(q, o, d, t_now)
            m = tq < t_best
            s = sample(q["tex"], 0, q["res"], a * self.tpm, b * self.tpm)
            out = torch.where(m, s, out)
            t_best = torch.where(m, tq, t_best)
        return out

    def frame(self, gt: sequence.Lissajous, t_ns: int) -> torch.Tensor:
        """One (H, W) uint8 frame at `t_ns`; draws its photometric and
        noise values next."""
        t0 = t_ns * 1e-9
        o, d, t_now = self.rays(gt, t0)
        H, W = self.H, self.W
        tr = t_now[:, None].expand(H, W).reshape(-1)
        img = self.shade(o.reshape(-1, 3), d.reshape(-1, 3), tr).reshape(H, W)
        img = (img * self.vignette).to(torch.float64)
        if self.photometric:
            gain = 1.0 + 0.10 * np.sin(2 * np.pi * t0 / 7.0) \
                + self.rng.normal() * 0.02
            offset = 6.0 * np.sin(2 * np.pi * t0 / 11.0) \
                + self.rng.normal() * 1.5
            img = img * float(gain) + float(offset) / 255.0
        out = 16.0 + 225.0 * img
        if self.pixel_noise > 0:
            noise = torch.randn((H, W), generator=self.gen,
                                dtype=torch.float32, device=self.device)
            out = out + (noise * self.pixel_noise).to(torch.float64)
        return torch.clamp(out, 0, 255).to(torch.uint8)

    def frames(self, gt: sequence.Lissajous, t_ns) -> torch.Tensor:
        """(F, H, W) uint8 on the device, one frame a time of `t_ns`."""
        out = torch.empty((len(t_ns), self.H, self.W), dtype=torch.uint8,
                          device=self.device)
        for k, t in enumerate(t_ns):
            out[k] = self.frame(gt, int(t))
        return out


def quad_hit(q: dict, o, d, t_now):
    """Distance along rays (o, d) to quad `q` at times `t_now` (BIG where
    they miss it), and the hit's coordinates along its edges."""
    c = q["c"] + q["vel"] * t_now[:, None]
    dn = dot3(d, q["n"])
    dn = torch.where(dn.abs() < 1e-7, 1e-7, dn)
    t = dot3(c - o, q["n"]) / dn
    p = o + t[:, None] * d
    a = dot3(p - c, q["e1"])
    b = dot3(p - c, q["e2"])
    ok = (t > 1e-4) & (a.abs() <= q["half"][0]) & (b.abs() <= q["half"][1])
    return torch.where(ok, t, BIG), a, b
