"""The benchmark's sequence generator: a frozen, vectorized copy of the
lissajous family of `ctrlvio_tpu_torch/sim/synthetic.py`.

One call makes a whole sequence on the device, in float64, from a seed: the
ground truth (incommensurate sinusoids in position and in the rotation
vector, not a B-spline of any knot spacing), IMU samples with white noise and
a bias random walk, landmarks around the trajectory, and rolling-shutter
feature frames through a Kannala-Brandt fisheye (each landmark projected at
its own row's exposure time by fixed-point iteration, pixel noise added in
the image and undistorted to normalized coordinates, as the upstream
tracker reports them; at most `max_cnt` tracks a frame, the tracks of the
frame before kept first). Every random number is drawn up front from one
`torch.Generator` on the device, so the projection, which is the costly
part, runs for all frames and landmarks at once; the tests hold it to a
frame-by-frame loop over the same draws.

The traffic file gives every parameter (rates, noise, motion, camera, the
tracker's cap, and one brief pause of the motion early in the warm-up); the
configuration gives the extrinsics and the line delay of the rig.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

S_TO_NS = 1_000_000_000
# position and rotation-vector amplitudes (m, rad) and frequencies (Hz) of
# the lissajous family at speed 1
POS_AMP = (1.2, 0.9, 0.5)
POS_HZ = (0.23, 0.31, 0.19)
ROT_AMP = (0.45, 0.30, 0.55)
ROT_HZ = (0.29, 0.17, 0.37)
# central-difference step for the body rate, and for the start velocity
RATE_H = 1e-5
VEL_H = 1e-4
# fixed-point iterations on each landmark's exposure time, and Newton
# iterations of the fisheye's undistortion
RS_ITERS = 6
LIFT_ITERS = 12


@dataclass
class Sequence:
    """One rig's generated sequence, on the host. `frames` holds
    (t_ns, ids, pts, rows) a frame; `phases` the ground truth's six draws
    (position, then rotation), which `reference.py` evaluates on its own."""
    imu_t_ns: np.ndarray
    gyro: np.ndarray
    accel: np.ndarray
    frames: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]
    phases: np.ndarray
    speed: float
    pause: dict
    bg: np.ndarray
    ba: np.ndarray
    gravity: np.ndarray
    init: dict


def quat_exp(phi):
    t2 = (phi * phi).sum(-1, keepdim=True)
    t = torch.sqrt(t2)
    small = t < 1e-10
    ts = torch.where(small, torch.ones_like(t), t)
    k = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * ts) / ts)
    w = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * ts))
    return torch.cat([w, k * phi], -1)


def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_conj(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_matrix(q):
    """(..., 3, 3) rotation of unit quaternions (w, x, y, z)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def apply_t(R, v):
    """R^T v for (..., 3, 3) and (..., 3), as explicit sums (the same
    arithmetic whatever the batch shape)."""
    return torch.stack([R[..., 0, i] * v[..., 0] + R[..., 1, i] * v[..., 1]
                        + R[..., 2, i] * v[..., 2] for i in range(3)], -1)


class Pause:
    """The rig's clock: s(t), which runs at rate 1 but for one brief pause
    (the rate dips by `depth` over `len_s` from `at_s`, a sin^2 bump), so
    that a few frames of little parallax make the estimator drop its
    second-newest frame rather than its oldest keyframe. `s(t)` and its
    first two derivatives."""

    def __init__(self, pause: dict):
        self.at, self.len, self.depth = (pause["at_s"], pause["len_s"],
                                         pause["depth"])

    def __call__(self, ts):
        x = ((ts - self.at) / self.len).clamp(0.0, 1.0)
        inside = ((ts > self.at) & (ts < self.at + self.len)).to(ts.dtype)
        s = ts - self.depth * self.len * (
            x / 2 - torch.sin(2 * math.pi * x) / (4 * math.pi))
        ds = 1.0 - self.depth * torch.sin(math.pi * x) ** 2
        dds = -self.depth * math.pi / self.len * torch.sin(2 * math.pi * x) \
            * inside
        return s, ds, dds


class Lissajous:
    """The ground truth of one seed: pose(ts) -> (q, p), motion(ts) ->
    (q, p, body rate, world acceleration), on the rig's clock."""

    def __init__(self, phases: torch.Tensor, speed: float, pause: dict):
        dev, dt = phases.device, phases.dtype
        c = lambda v: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
        self.ph, self.ph_r = phases[:3], phases[3:]
        self.A, self.Ar = c(POS_AMP), c(ROT_AMP)
        self.w = 2 * math.pi * c(POS_HZ) * speed
        self.wr = 2 * math.pi * c(ROT_HZ) * speed
        self.clock = Pause(pause)

    def rot(self, ts):
        s = self.clock(ts)[0][..., None]
        return quat_exp(self.Ar * torch.sin(self.wr * s + self.ph_r))

    def pose(self, ts):
        s = self.clock(ts)[0][..., None]
        return self.rot(ts), self.A * torch.sin(self.w * s + self.ph)

    def motion(self, ts):
        q, p = self.pose(ts)
        s, ds, dds = (x[..., None] for x in self.clock(ts))
        arg = self.w * s + self.ph
        acc = -self.A * self.w ** 2 * torch.sin(arg) * ds ** 2 \
            + self.A * self.w * torch.cos(arg) * dds
        dq = (self.rot(ts + RATE_H) - self.rot(ts - RATE_H)) / (2 * RATE_H)
        w_b = 2.0 * quat_mul(quat_conj(q), dq)[..., 1:]
        return q, p, w_b, acc


@dataclass
class Draws:
    """Every random number of one sequence, drawn in a fixed order."""
    phases: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    rw_g: torch.Tensor
    rw_a: torch.Tensor
    n_g: torch.Tensor
    n_a: torch.Tensor
    lm_center: torch.Tensor
    lm_spread: torch.Tensor
    lm_scale: torch.Tensor
    lm_jitter: torch.Tensor
    lm_rank: torch.Tensor
    pix: torch.Tensor


def n_imu(traffic: dict, n_frames: int) -> int:
    """IMU samples to cover every frame and the feed's look-ahead."""
    last = traffic["first_frame_s"] + (n_frames - 1) / traffic["cam_rate"]
    span = last + traffic["imu_ahead_s"] + 0.25
    return int(math.ceil(span * traffic["imu_rate"]))


def n_coarse(traffic: dict, n_frames: int) -> int:
    """Coarse trajectory samples the landmarks are scattered around."""
    return n_frames * int(round(1.0 / (traffic["cam_rate"]
                                       * traffic["coarse_dt"]))) + 4


def draw(traffic: dict, n_frames: int, seed: int, device) -> Draws:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    kw = dict(generator=g, dtype=torch.float64, device=device)
    M, L = n_imu(traffic, n_frames), traffic["n_landmarks"]
    return Draws(
        phases=torch.rand(6, **kw) * (2 * math.pi),
        bg=torch.randn(3, **kw) * traffic["gyro_bias"],
        ba=torch.randn(3, **kw) * traffic["accel_bias"],
        rw_g=torch.randn(M, 3, **kw), rw_a=torch.randn(M, 3, **kw),
        n_g=torch.randn(M, 3, **kw), n_a=torch.randn(M, 3, **kw),
        lm_center=torch.randint(0, n_coarse(traffic, n_frames), (L,),
                                generator=g, device=device),
        lm_spread=torch.randn(L, 3, **kw),
        lm_scale=2.0 + 4.0 * torch.rand(L, 1, **kw),
        lm_jitter=torch.randn(L, 3, **kw),
        lm_rank=torch.rand(L, **kw),
        pix=torch.randn(n_frames, L, 2, **kw))


class Camera:
    """The rig: extrinsics (R_CtoI, p_CinI), the Kannala-Brandt fisheye the
    frames are made with (`cam_tumrs.yaml`'s projection parameters), and
    the line delay."""

    def __init__(self, rig: dict, traffic: dict, device):
        f64 = dict(dtype=torch.float64, device=device)
        self.R_CtoI = quat_matrix(quat_exp(torch.tensor(rig["ext_rot"],
                                                        **f64)))
        self.p_CinI = torch.tensor(rig["ext_pos"], **f64)
        self.ld = rig["line_delay"]
        c = traffic["camera"]
        self.mu, self.mv, self.u0, self.v0 = c["mu"], c["mv"], c["u0"], c["v0"]
        self.k = (c["k2"], c["k3"], c["k4"], c["k5"])
        self.w, self.h = traffic["image_size"]

    def theta_d(self, th):
        t2 = th * th
        k2, k3, k4, k5 = self.k
        return th * (1.0 + t2 * (k2 + t2 * (k3 + t2 * (k4 + t2 * k5))))

    def project(self, gt: Lissajous, lm, t):
        """Landmarks `lm` (L, 3) at exposure times `t` (..., L): pixel
        coordinates (u, v) and visibility."""
        q, p = gt.pose(t)
        X_i = apply_t(quat_matrix(q), lm - p)
        X_c = apply_t(self.R_CtoI, X_i - self.p_CinI)
        x, y, z = X_c.unbind(-1)
        r = torch.sqrt(x * x + y * y)
        s = self.theta_d(torch.atan2(r, z)) / r.clamp(min=1e-12)
        u = self.mu * s * x + self.u0
        v = self.mv * s * y + self.v0
        vis = (z > 0) & ((r * r + z * z) > 0.09) & (u >= 2) \
            & (u < self.w - 2) & (v >= 0) & (v < self.h)
        return u, v, vis

    def lift(self, u, v):
        """Pixels to normalized coordinates (x/z, y/z): theta_d inverted by
        Newton's method, as the tracker's undistortion does."""
        pu, pv = (u - self.u0) / self.mu, (v - self.v0) / self.mv
        td = torch.sqrt(pu * pu + pv * pv)
        th = td.clone()
        k2, k3, k4, k5 = self.k
        for _ in range(LIFT_ITERS):
            t2 = th * th
            d = 1.0 + t2 * (3 * k2 + t2 * (5 * k3 + t2 * (7 * k4
                                                         + t2 * 9 * k5)))
            th = th - (self.theta_d(th) - td) / d
        s = torch.tan(th) / td.clamp(min=1e-12)
        return s * pu, s * pv

    def observe(self, gt: Lissajous, lm, tf):
        """Frames at times `tf` (F,): the fixed point of each landmark's
        exposure time, the row reported (an integer), the pixel at that
        row's time, and which observations a rolling shutter makes."""
        t = tf[:, None].expand(-1, lm.shape[0])
        for _ in range(RS_ITERS):
            u, v, vis = self.project(gt, lm, t)
            t = torch.where(vis, tf[:, None] + v.clamp(0, self.h - 1)
                            * self.ld, tf[:, None])
        rows = torch.round(v.clamp(0, self.h - 1))
        u2, v2, vis2 = self.project(gt, lm, tf[:, None] + rows * self.ld)
        keep = vis2 & vis & ((v2 - rows).abs() < 3.0)
        return u2, v2, rows, keep


def track(keep: np.ndarray, rank: np.ndarray, max_cnt: int) -> np.ndarray:
    """The tracker's feature cap on the landmarks in view (F, L): a frame
    keeps the tracks of the frame before that are still in view and fills
    up to `max_cnt` with new ones in the order of `rank` (a landmark's
    draw), as the upstream tracker keeps its tracks and refills."""
    out = np.zeros_like(keep)
    order = np.argsort(rank, kind="stable")
    prev = np.zeros(keep.shape[1], bool)
    for f in range(keep.shape[0]):
        cont = keep[f] & prev
        n = int(cont.sum())
        if n > max_cnt:
            cont[order[np.cumsum(cont[order]) > max_cnt]] = False
        else:
            new = keep[f] & ~prev
            take = order[new[order]][:max_cnt - n]
            cont[take] = True
        out[f] = prev = cont
    return out


def landmarks(gt: Lissajous, d: Draws, traffic: dict, n_frames: int):
    tk = torch.arange(n_coarse(traffic, n_frames), dtype=torch.float64,
                      device=d.phases.device) * traffic["coarse_dt"]
    span = traffic["first_frame_s"] + (n_frames - 1) / traffic["cam_rate"]
    _, pk = gt.pose(torch.clamp(tk, max=span))
    spread = torch.tensor(traffic["lm_spread"], dtype=torch.float64,
                          device=d.phases.device)
    lift = torch.tensor([0.0, 0.0, traffic["lm_lift"]], dtype=torch.float64,
                        device=d.phases.device)
    return pk[d.lm_center] + d.lm_spread * spread \
        + d.lm_scale * d.lm_jitter * 0.3 + lift


def frame_times(traffic: dict, n_frames: int, device):
    """Frame times in ns (exact integers) and seconds."""
    k = torch.arange(n_frames, dtype=torch.int64, device=device)
    t0 = int(round(traffic["first_frame_s"] * S_TO_NS))
    step = int(round(S_TO_NS / traffic["cam_rate"]))
    t_ns = t0 + k * step
    return t_ns, t_ns.to(torch.float64) / S_TO_NS


def imu(gt: Lissajous, d: Draws, traffic: dict, n_frames: int):
    M = n_imu(traffic, n_frames)
    dev = d.phases.device
    step = int(round(S_TO_NS / traffic["imu_rate"]))
    t_ns = torch.arange(M, dtype=torch.int64, device=dev) * step
    ts = t_ns.to(torch.float64) / S_TO_NS
    q, _, w, acc = gt.motion(ts)
    g = torch.tensor([0.0, 0.0, traffic["gravity"]], dtype=torch.float64,
                     device=dev)
    accel_body = apply_t(quat_matrix(q), acc + g)
    sq = math.sqrt(1.0 / traffic["imu_rate"])
    bg_t = d.bg + torch.cumsum(d.rw_g, 0) * (traffic["gyro_bias_rw"] * sq)
    ba_t = d.ba + torch.cumsum(d.rw_a, 0) * (traffic["accel_bias_rw"] * sq)
    gyro = w + bg_t + d.n_g * traffic["gyro_noise"]
    accel = accel_body + ba_t + d.n_a * traffic["accel_noise"]
    return t_ns, gyro, accel, g


def start_state(gt: Lissajous, t0_s: float, device):
    """Ground truth at the first frame: the estimator's bootstrap."""
    ts = torch.tensor([t0_s, t0_s + VEL_H, t0_s - VEL_H],
                      dtype=torch.float64, device=device)
    q, p = gt.pose(ts)
    v = (p[1] - p[2]) / (2 * VEL_H)
    return q[0], p[0], v


def generate(traffic: dict, rig: dict, n_frames: int, seed: int,
             device) -> Sequence:
    """One rig's sequence of `n_frames` frames from `seed`, made on
    `device` and brought to the host in one transfer a field."""
    d = draw(traffic, n_frames, seed, device)
    gt = Lissajous(d.phases, traffic["speed"], traffic["pause"])
    cam = Camera(rig, traffic, device)
    lm = landmarks(gt, d, traffic, n_frames)
    t_ns, tf = frame_times(traffic, n_frames, device)
    u, v, rows, keep = cam.observe(gt, lm, tf)
    px = traffic["pixel_noise_px"]
    xn, yn = cam.lift(u + d.pix[..., 0] * px, v + d.pix[..., 1] * px)
    pts = torch.stack([xn, yn], -1)
    kept = track(keep.cpu().numpy(), d.lm_rank.cpu().numpy(),
                 traffic["max_cnt"])
    imu_t, gyro, accel, g = imu(gt, d, traffic, n_frames)
    q0, p0, v0 = start_state(gt, float(tf[0]), device)
    host = lambda x: x.cpu().numpy()  # noqa: E731
    return Sequence(
        imu_t_ns=host(imu_t), gyro=host(gyro), accel=host(accel),
        frames=split_frames(host(t_ns), kept, host(pts), host(rows)),
        phases=host(d.phases), speed=traffic["speed"],
        pause=traffic["pause"], bg=host(d.bg),
        ba=host(d.ba), gravity=host(g),
        init=dict(t_ns=int(t_ns[0]), q=host(q0), p=host(p0), v=host(v0)))


def split_frames(t_ns, keep, pts, rows):
    """Dense (F, L) arrays as the estimator takes frames: the ids seen,
    their noisy normalized coordinates and their rows."""
    out = []
    for f in range(len(t_ns)):
        ids = np.nonzero(keep[f])[0].astype(np.int64)
        out.append((int(t_ns[f]), ids, np.ascontiguousarray(pts[f, ids]),
                    rows[f, ids].astype(np.float64)))
    return out
