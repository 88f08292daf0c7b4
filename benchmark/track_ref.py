"""The plain reference of the front end's tracks: plain PyTorch in float64,
nothing of the port.

For a published track pair (one feature id published in frame i and in the
next published frame j), the true correspondence comes from the scene's
geometry (`render.World`, the truth's poses, the rig, the camera):

1. the feature's pixel in frame i is cast, from the camera's pose at its
   row's exposure time `t_i + v_i ld`, along the Kannala-Brandt ray
   through it, onto the world: the nearest of the room's walls and the
   occluder quads, the quads placed at that time;
2. that point is projected into frame j through the Kannala-Brandt model,
   by fixed-point iteration on frame j's row time `t_j + v ld` (a point on
   a moving quad moves with it);
3. a point on a moving quad is flagged, and so is one that frame j sees
   behind something nearer, or outside the image.

The estimator is handed normalized coordinates; they are taken back to
pixels through the camera model here. `check` gives, over a run's
published frames, the median and 90th percentile of the distance from the
published point in frame j to the true one over the static, visible pairs
(px), the share of those pairs more than `GROSS_PX` off (a track that
converged elsewhere), the share of frame i's published features that
frame j publishes again, and the share of pairs whose frame-i point lies
on a moving quad.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import sequence

RS_ITERS = 8
LIFT_ITERS = 12
# a point is hidden where frame j's ray meets something this much nearer
HIDDEN_M = 1e-3
# a track this far from the truth converged on something else
GROSS_PX = 2.0


class Scene:
    """The world's geometry in float64 on `device`."""

    def __init__(self, world, rig: dict, camera: dict, device):
        f64 = dict(dtype=torch.float64, device=device)
        self.lo = torch.tensor(world.lo, **f64)
        self.hi = torch.tensor(world.hi, **f64)
        self.quads = [{k: torch.tensor(np.asarray(q[k], np.float64), **f64)
                       for k in ("c", "e1", "e2", "n", "half", "vel")}
                      for q in world.occ]
        self.R_CtoI = sequence.quat_matrix(sequence.quat_exp(
            torch.tensor(rig["ext_rot"], **f64)))
        self.p_CinI = torch.tensor(rig["ext_pos"], **f64)
        self.ld = rig["line_delay"]
        self.cam = camera

    def camera_pose(self, gt, t):
        """The camera's rotation to the world (n, 3, 3) and center (n, 3)
        at times `t` (n,) s."""
        q, p = gt.pose(t)
        R = sequence.quat_matrix(q)
        return R @ self.R_CtoI, p + (R * self.p_CinI).sum(-1)

    def hit(self, o, d, t):
        """The nearest hit of rays (o, d) (n, 3) at times `t`: its distance
        along d and which quad it is on (-1 the room)."""
        dd = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        t_far = torch.maximum((self.lo - o) / dd, (self.hi - o) / dd)
        best = torch.where(t_far > 1e-9, t_far,
                           torch.full_like(t_far, np.inf)).min(-1).values
        which = torch.full_like(best, -1, dtype=torch.int64)
        for k, q in enumerate(self.quads):
            c = q["c"] + q["vel"] * t[:, None]
            dn = (d * q["n"]).sum(-1)
            dn = torch.where(dn.abs() < 1e-12, torch.full_like(dn, 1e-12),
                             dn)
            tq = ((c - o) * q["n"]).sum(-1) / dn
            p = o + tq[:, None] * d - c
            ok = ((tq > 1e-9) & ((p * q["e1"]).sum(-1).abs() <= q["half"][0])
                  & ((p * q["e2"]).sum(-1).abs() <= q["half"][1])
                  & (tq < best))
            best = torch.where(ok, tq, best)
            which = torch.where(ok, torch.full_like(which, k), which)
        return best, which

    def ray(self, uv):
        """Unit ray directions in the camera frame through pixels (n, 2)."""
        c = self.cam
        mx = (uv[:, 0] - c["u0"]) / c["mu"]
        my = (uv[:, 1] - c["v0"]) / c["mv"]
        rd = torch.sqrt(mx * mx + my * my)
        th = rd.clone()
        for _ in range(LIFT_ITERS):
            t2 = th * th
            f = self.theta_d(th) - rd
            df = 1.0 + t2 * (3 * c["k2"] + t2 * (5 * c["k3"] + t2 * (
                7 * c["k4"] + t2 * 9 * c["k5"])))
            th = th - f / df
        s = torch.where(rd < 1e-12, torch.zeros_like(rd),
                        torch.sin(th) / rd.clamp(min=1e-12))
        return torch.stack([s * mx, s * my, torch.cos(th)], -1)

    def theta_d(self, th):
        c = self.cam
        t2 = th * th
        return th * (1.0 + t2 * (c["k2"] + t2 * (c["k3"] + t2 * (
            c["k4"] + t2 * c["k5"]))))

    def project(self, X):
        """Camera-frame points (n, 3) to pixels (n, 2)."""
        c = self.cam
        r = torch.sqrt(X[:, 0] ** 2 + X[:, 1] ** 2)
        s = self.theta_d(torch.atan2(r, X[:, 2])) / r.clamp(min=1e-12)
        return torch.stack([c["mu"] * s * X[:, 0] + c["u0"],
                            c["mv"] * s * X[:, 1] + c["v0"]], -1)


def pixels(scene: Scene, pts):
    """Normalized coordinates (n, 2) as the estimator takes them, to
    pixels."""
    return scene.project(torch.cat([pts, torch.ones_like(pts[:, :1])], -1))


def correspond(scene: Scene, gt, t_i, uv_i, t_j, H: int, W: int):
    """For points `uv_i` (n, 2) of frames at `t_i` (n,) s: their true
    pixels in frames at `t_j` (n,) s, whether the point lies on a moving
    quad, and whether frame j sees it (in the image, unhidden)."""
    R, c = scene.camera_pose(gt, t_i + uv_i[:, 1] * scene.ld)
    d = (R @ scene.ray(uv_i)[:, :, None])[..., 0]
    t_hit, which = scene.hit(c, d, t_i)
    X0 = c + t_hit[:, None] * d
    vel = torch.zeros_like(X0)
    for k, q in enumerate(scene.quads):
        vel = torch.where((which == k)[:, None], q["vel"], vel)
    moving = (vel.abs().sum(-1) > 0)
    v = uv_i[:, 1].clone()
    for _ in range(RS_ITERS):
        t = t_j + v.clamp(0, H - 1) * scene.ld
        R, c = scene.camera_pose(gt, t)
        X = X0 + vel * (t - t_i)[:, None]
        Xc = (R.transpose(1, 2) @ (X - c)[:, :, None])[..., 0]
        uv = scene.project(Xc)
        v = uv[:, 1]
    dist = (X - c).norm(dim=-1)
    t_seen, _ = scene.hit(c, (X - c) / dist[:, None], t)
    seen = ((Xc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] <= W - 1)
            & (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1)
            & (t_seen > dist - HIDDEN_M))
    return uv, moving, seen


def pairs(frames):
    """The track pairs of published frames (t_ns, ids, pts, rows), in order
    of time: (t_i ns, pts_i, t_j ns, pts_j), one row a feature id
    published in two consecutive frames."""
    out = []
    for (ta, ia, pa, _), (tb, ib, pb, _) in zip(frames, frames[1:]):
        _, ka, kb = np.intersect1d(ia, ib, return_indices=True)
        out.append((np.full(len(ka), ta), pa[ka], np.full(len(kb), tb),
                    pb[kb]))
    if not out:
        return None
    return tuple(np.concatenate(x) for x in zip(*out))


def check(frames, world, gt, rig: dict, camera: dict, H: int, W: int,
          device) -> dict:
    """The published frames' tracks against the scene (see the module
    notes): `pairs`, `static` (the static, visible pairs measured),
    `err_px_median`, `err_px_p90`, `gross_share`, `tracked_share` and
    `moving_share` (%)."""
    got = pairs(frames)
    if got is None or not len(got[0]):
        nan = float("nan")
        return {"pairs": 0, "static": 0, "err_px_median": nan,
                "err_px_p90": nan, "gross_share": nan, "tracked_share": nan,
                "moving_share": nan}
    scene = Scene(world, rig, camera, device)
    f64 = dict(dtype=torch.float64, device=device)
    ti, pi, tj, pj = (torch.tensor(np.asarray(x, np.float64), **f64)
                      for x in got)
    uv_i, uv_j = pixels(scene, pi), pixels(scene, pj)
    true_j, moving, seen = correspond(scene, gt, ti * 1e-9, uv_i, tj * 1e-9,
                                      H, W)
    err = (uv_j - true_j).norm(dim=-1)[seen & ~moving]
    q = (torch.quantile(err, torch.tensor([0.5, 0.9], **f64)).tolist()
         if len(err) else [float("nan")] * 2)
    published = sum(len(f[1]) for f in frames[:-1])
    return {"pairs": int(len(ti)), "static": int(len(err)),
            "err_px_median": q[0], "err_px_p90": q[1],
            "gross_share": (float((err > GROSS_PX).double().mean()) * 100
                            if len(err) else float("nan")),
            "tracked_share": len(ti) / max(published, 1) * 100,
            "moving_share": float(moving.double().mean()) * 100}
