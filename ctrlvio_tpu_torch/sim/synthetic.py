"""Synthetic rolling-shutter VIO sequence generator (the port's numpy copy of
`ctrlvio_tpu/sim/synthetic.py`).

The reference validates operationally against TUM-RSVI rosbags
(`README.md:37-54`), which are not available here (zero
egress). This module generates physically consistent synthetic sequences
with *known* ground truth — trajectory, gravity, biases, landmark depths and
the rolling-shutter line delay — so accuracy (ATE, line-delay convergence)
is measurable exactly, which the reference could never do in-tree.

Ground truth is itself an order-4 B-spline on SO(3) x R^3 (same
representation the estimator fits), sampled:

- IMU at `imu_rate`: gyro = w_body + bg + noise, accel = R^T(a_w + g) + ba + noise
  (same measurement model the IMU factor inverts).
- Camera frames at `cam_rate`: each landmark is projected with a per-row
  exposure time t = t_frame + row * line_delay, solved by fixed-point
  iteration (row depends on the pose at the row's own exposure time — the
  actual rolling-shutter physics the reference models in
  `image_feature_factor.h:84-101`).

Host-side numpy/f64; output arrays are ragged per frame (packing to static
device shapes happens in the estimator pipeline).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ctrlvio_tpu_torch.ops import so3np

S_TO_NS = 1_000_000_000


@dataclass
class SimConfig:
    duration: float = 12.0
    knot_dt: float = 0.05
    imu_rate: float = 200.0
    cam_rate: float = 10.0
    n_landmarks: int = 400
    line_delay: float = 29.4737e-6  # sec/row (TUM-RSVI nominal, ≙ config comment)
    image_h: int = 1024
    image_w: int = 1280
    fx: float = 739.0
    fy: float = 739.0
    cx: float = 640.0
    cy: float = 512.0
    # dynamics
    rot_excite: float = 0.10  # rad/knot random walk (~2 rad/s peak, handheld-like)
    pos_excite: float = 0.05  # m/knot random walk (~1 m/s)
    gravity: float = 9.80766
    # noise (0 => perfect data for exactness tests)
    gyro_noise: float = 0.0
    accel_noise: float = 0.0
    pixel_noise: float = 0.0  # in normalized coords
    gyro_bias: float = 0.0
    accel_bias: float = 0.0
    # bias random walk (std of per-step increments scaled by sqrt(dt);
    # ≙ σ_bg/σ_ba, `config/ct_odometry_tumrs.yaml:18-20`, which the
    # estimator's BiasFactor random-walk model must track)
    gyro_bias_rw: float = 0.0
    accel_bias_rw: float = 0.0
    seed: int = 0
    # camera-IMU extrinsics
    ext_rot: tuple = (0.02, -0.01, 0.015)  # so3 log of R_CtoI
    ext_pos: tuple = (0.007, -0.057, -0.042)
    # --- ground-truth trajectory family (anti-inverse-crime controls) ----
    # The estimator fits an order-4 B-spline at `knot_dt`; validating only
    # against GT from that same family is an inverse crime. Alternatives:
    #   "spline"    — default: smoothed random-walk knots at `gt_knot_dt`
    #                 (set gt_knot_dt < knot_dt, e.g. 0.01, for GT with
    #                 spectral content the estimator's basis cannot
    #                 represent exactly)
    #   "lissajous" — analytic C-infinity curve (incommensurate-frequency
    #                 sinusoids in position and rotation vector): not a
    #                 B-spline of ANY knot spacing
    gt_family: str = "spline"
    gt_knot_dt: float = None  # GT spline knot spacing (None -> knot_dt)
    speed: float = 1.0        # motion-intensity multiplier (excites / freqs)


# The reference's operating condition: its whole estimation machinery —
# per-axis info vectors 1/σ (`opt_weight.h:119-126`, where σ_g/σ_a are used
# DIRECTLY as per-sample weights, the computed sqrt_dt deliberately unused),
# Cauchy robust loss, bias random walk — exists for noisy sensors at these
# configured levels (`config/ct_odometry_tumrs.yaml:16-20`,
# `config/tumrs/cam_tumrs.yaml` focal≈739 with image_weight 800 → ~0.9 px).
REFERENCE_NOISE = dict(
    gyro_noise=4e-3,      # per-sample std, rad/s   (σ_g, yaml:16)
    accel_noise=8e-2,     # per-sample std, m/s^2   (σ_a, yaml:19)
    pixel_noise=1.35e-3,  # ~1 px at focal 739, normalized coords
    gyro_bias=0.01,       # constant bias draw std, rad/s
    accel_bias=0.05,      # constant bias draw std, m/s^2
    gyro_bias_rw=2e-5,    # σ_bg (yaml:18)
    accel_bias_rw=4e-4,   # σ_ba (yaml:20)
)


def reference_noise(**overrides) -> SimConfig:
    """A SimConfig with sensor noise at the reference's configured operating
    point (see REFERENCE_NOISE). Keyword overrides pass through to SimConfig."""
    return SimConfig(**{**REFERENCE_NOISE, **overrides})


@dataclass
class FrameObs:
    t_ns: int
    ids: np.ndarray      # (n,) int64 landmark ids
    pts: np.ndarray      # (n, 2) normalized undistorted coords
    rows: np.ndarray     # (n,) float pixel row (v coordinate)


@dataclass
class SimData:
    cfg: SimConfig
    knots_q: np.ndarray   # (K, 4) GT SO3 knots, body(IMU)-to-world
    knots_p: np.ndarray   # (K, 3) GT position knots (IMU in world)
    imu_t_ns: np.ndarray  # (M,)
    gyro: np.ndarray      # (M, 3)
    accel: np.ndarray     # (M, 3)
    frames: List[FrameObs] = field(default_factory=list)
    landmarks: np.ndarray = None  # (L, 3) world points
    gravity_vec: np.ndarray = None
    bg: np.ndarray = None
    ba: np.ndarray = None
    # exact GT evaluator ts -> (q, p, w_body, acc_world); set by generate()
    # for every family (for non-default families the knots_q/knots_p above
    # are only a coarse summary for landmark placement / scene bounds)
    gt_pose_fn: object = None

    def poses_at(self, ts):
        """Vectorized exact GT at times ts (seconds).

        Returns (q (N,4), p (N,3), w_body (N,3), acc_world (N,3))."""
        ts = np.atleast_1d(np.asarray(ts, np.float64))
        if self.gt_pose_fn is not None:
            return self.gt_pose_fn(ts)
        return _batched_pose(self.knots_q, self.knots_p, ts,
                             self.cfg.knot_dt)

    def pose_at(self, t_sec):
        """GT IMU pose at time t (seconds). Returns (quat, pos). Numpy."""
        q, p, _, _ = self.poses_at(t_sec)
        return q[0], p[0]


def grid_coords(t_sec, dt):
    """Host-side int64-exact time -> (segment index, fractional u)."""
    t_ns = np.int64(np.round(np.asarray(t_sec) * S_TO_NS))
    dt_ns = np.int64(np.round(dt * S_TO_NS))
    i0 = int(t_ns // dt_ns)
    u = float(t_ns % dt_ns) / float(dt_ns)
    return i0, u


def _smooth_knots(cfg: SimConfig, rng):
    """Random C^2 trajectory: filtered random-walk knot increments.

    ≙ the role of `genRandomTrajectory` (`so3_spline.h:160-177`) but smooth
    enough to look like handheld motion.

    GT knots live at `gt_knot_dt` (default: the estimator's `knot_dt`, in
    which case this is bit-identical to the historical generator). For a
    finer GT grid the per-knot step std scales by sqrt(gdt/knot_dt) — a
    random walk smoothed over a FIXED 5*knot_dt time window has velocity
    variance sigma^2/(dt*tau), so sqrt(dt) scaling keeps the motion
    spectrum magnitude family-comparable — and the smoothing kernel widens
    to cover the same time window.
    """
    gdt = cfg.gt_knot_dt or cfg.knot_dt
    scale = np.sqrt(gdt / cfg.knot_dt) * cfg.speed
    n_knots = int(np.ceil(cfg.duration / gdt)) + 4
    # smooth increments by a moving average over the random walk steps
    rot_steps = rng.normal(size=(n_knots, 3)) * (cfg.rot_excite * scale)
    pos_steps = rng.normal(size=(n_knots, 3)) * (cfg.pos_excite * scale)
    klen = max(5, int(round(5 * cfg.knot_dt / gdt)))
    klen += (klen + 1) % 2  # odd taps: symmetric 'same' convolution
    kernel = np.ones(klen) / klen
    # fine grids (gdt < knot_dt) get a SECOND pass (triangular kernel):
    # a single MA only rolls off ~sinc and leaves violent >10 Hz
    # accelerations a handheld trajectory never has; the GT must be
    # out-of-basis, not un-physical
    passes = 1 if gdt >= cfg.knot_dt else 2
    for k in range(3):
        for _ in range(passes):
            rot_steps[:, k] = np.convolve(rot_steps[:, k], kernel,
                                          mode="same")
            pos_steps[:, k] = np.convolve(pos_steps[:, k], kernel,
                                          mode="same")

    qs = np.zeros((n_knots, 4))
    qs[0] = [1, 0, 0, 0]
    for i in range(1, n_knots):
        qs[i] = so3np.boxplus(qs[i - 1], rot_steps[i])
    ps = np.cumsum(pos_steps, axis=0)
    return qs, ps


def _lissajous_fn(cfg: SimConfig):
    """Analytic GT family: incommensurate-frequency sinusoids in position
    and in the rotation vector — a C-infinity curve that is NOT an order-4
    B-spline of any knot spacing (the anti-inverse-crime control).

    Position/acceleration are closed-form; body angular velocity comes from
    w_b = 2 vec(q* ⊗ dq/dt) with dq/dt by f64 central difference
    (h=1e-5 s -> O(h^2) error ~1e-10 rad/s, far below sensor noise and the
    estimator's own accuracy floor)."""
    sp = cfg.speed
    rs = np.random.default_rng(cfg.seed + 7777)
    ph = rs.uniform(0.0, 2 * np.pi, size=3)
    ph_r = rs.uniform(0.0, 2 * np.pi, size=3)
    A = np.array([1.2, 0.9, 0.5])                    # m
    w = 2 * np.pi * np.array([0.23, 0.31, 0.19]) * sp
    Ar = np.array([0.45, 0.30, 0.55])                # rad
    wr = 2 * np.pi * np.array([0.29, 0.17, 0.37]) * sp

    def theta(ts):
        return Ar * np.sin(wr * ts[:, None] + ph_r)

    def pose(ts):
        ts = np.atleast_1d(np.asarray(ts, np.float64))
        arg = w * ts[:, None] + ph
        p = A * np.sin(arg)
        acc = -A * (w ** 2) * np.sin(arg)
        q = so3np.quat_exp(theta(ts))
        h = 1e-5
        dq = (so3np.quat_exp(theta(ts + h))
              - so3np.quat_exp(theta(ts - h))) / (2 * h)
        w_b = 2.0 * so3np.quat_mul(so3np.quat_conj(q), dq)[:, 1:]
        return q, p, w_b, acc

    return pose


def _batched_pose(knots_q, knots_p, ts, dt):
    """Vectorized GT pose evaluation at many times (numpy, host)."""
    t_ns = np.round(np.asarray(ts) * S_TO_NS).astype(np.int64)
    dt_ns = np.int64(np.round(dt * S_TO_NS))
    i0 = np.clip((t_ns // dt_ns).astype(np.int64), 0, len(knots_q) - 4)
    u = (t_ns % dt_ns).astype(np.float64) / float(dt_ns)
    idx = i0[:, None] + np.arange(4)
    q4 = np.asarray(knots_q)[idx]
    p4 = np.asarray(knots_p)[idx]
    q = so3np.so3_eval(q4, u)
    p = so3np.rd_eval(p4, u, 1.0 / dt, 0)
    w = so3np.so3_vel_body(q4, u, 1.0 / dt)
    acc = so3np.rd_eval(p4, u, 1.0 / dt, 2)
    return q, p, w, acc


def generate(cfg: SimConfig) -> SimData:
    return _generate_impl(cfg)


def _generate_impl(cfg: SimConfig) -> SimData:
    rng = np.random.default_rng(cfg.seed)
    g_vec = np.array([0.0, 0.0, cfg.gravity])
    gdt = cfg.gt_knot_dt or cfg.knot_dt
    if cfg.gt_family == "lissajous":
        gt_pose = _lissajous_fn(cfg)
        t_max = cfg.duration + 1.0
        # coarse trajectory summary only (landmark placement, scene bounds)
        tk = np.minimum(np.arange(
            int(np.ceil(cfg.duration / cfg.knot_dt)) + 4,
        ) * cfg.knot_dt, cfg.duration)
        knots_q, knots_p = gt_pose(tk)[:2]
    elif cfg.gt_family == "spline":
        knots_q, knots_p = _smooth_knots(cfg, rng)
        t_max = (len(knots_q) - 3) * gdt - 2e-3

        def gt_pose(ts, _kq=knots_q, _kp=knots_p, _dt=gdt):
            return _batched_pose(_kq, _kp, ts, _dt)
    else:
        raise ValueError(f"unknown gt_family {cfg.gt_family!r}")

    # --- IMU samples ---------------------------------------------------
    imu_ts = np.arange(0.0, min(cfg.duration, t_max), 1.0 / cfg.imu_rate)
    q, p, w, acc = gt_pose(imu_ts)
    Rt = so3np.quat_to_matrix(q)  # body->world
    accel_body = np.einsum("nij,nj->ni", Rt.transpose(0, 2, 1), acc + g_vec)

    bg = rng.normal(size=3) * cfg.gyro_bias
    ba = rng.normal(size=3) * cfg.accel_bias
    # slow bias drift: random walk with per-step std σ_rw·sqrt(dt) — the
    # model the estimator's BiasFactor assumes (≙ trajectory_value_factor.h
    # :36-105); SimData.bg/ba stay the t=0 values (what a bootstrap sees)
    sqrt_dt = np.sqrt(1.0 / cfg.imu_rate)
    bg_t = bg + np.cumsum(rng.normal(size=w.shape), axis=0) \
        * (cfg.gyro_bias_rw * sqrt_dt)
    ba_t = ba + np.cumsum(rng.normal(size=w.shape), axis=0) \
        * (cfg.accel_bias_rw * sqrt_dt)
    gyro_m = w + bg_t + rng.normal(size=w.shape) * cfg.gyro_noise
    accel_m = accel_body + ba_t + rng.normal(size=w.shape) * cfg.accel_noise

    # --- landmarks ------------------------------------------------------
    # scatter points around the trajectory tube, biased forward of the camera
    centers = knots_p[rng.integers(0, len(knots_p), size=cfg.n_landmarks)]
    lm = centers + rng.normal(size=(cfg.n_landmarks, 3)) * np.array([4.0, 4.0, 3.0]) \
        + rng.uniform(2.0, 6.0, size=(cfg.n_landmarks, 1)) * rng.normal(size=(cfg.n_landmarks, 3)) * 0.3
    lm = lm + np.array([0.0, 0.0, 1.5])

    # camera extrinsics
    q_CtoI = so3np.quat_exp(np.array(cfg.ext_rot))
    R_CtoI = so3np.quat_to_matrix(q_CtoI)
    p_CinI = np.array(cfg.ext_pos)

    # --- camera frames (rolling shutter) --------------------------------
    frames = []
    frame_ts = np.arange(0.3, min(cfg.duration, t_max) - 0.1, 1.0 / cfg.cam_rate)
    def project_at(t_rows):
        qf, pf, _, _ = gt_pose(t_rows)
        Rf = so3np.quat_to_matrix(qf)  # IMU->world
        # world -> camera: X_c = R_CtoI^T (R_IW^T (X_w - p_I) - p_CinI)
        X_i = np.einsum("nij,nj->ni", Rf.transpose(0, 2, 1), lm - pf)
        X_c = np.einsum("ij,nj->ni", R_CtoI.T, X_i - p_CinI)
        z = X_c[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            xn = X_c[:, 0] / z
            yn = X_c[:, 1] / z
        v_pix = cfg.fy * yn + cfg.cy
        u_pix = cfg.fx * xn + cfg.cx
        vis = (
            (z > 0.3)
            & (u_pix >= 2)
            & (u_pix < cfg.image_w - 2)
            & (v_pix >= 0)
            & (v_pix < cfg.image_h)
        )
        return xn, yn, v_pix, vis

    for tf in frame_ts:
        # fixed-point iteration on per-landmark exposure time (row depends on
        # the pose at its own exposure time)
        t_rows = np.full(len(lm), tf)
        for _ in range(6):
            xn, yn, v_pix, vis = project_at(t_rows)
            t_rows = np.where(vis, tf + np.clip(v_pix, 0, cfg.image_h - 1) * cfg.line_delay, tf)
        # report integer rows; re-project exactly at the reported row time so
        # (pts, rows) are consistent with the RS observation model t+row*ld
        vis_fp = vis
        rows_all = np.round(np.clip(v_pix, 0, cfg.image_h - 1))
        xn, yn, v_pix, vis = project_at(tf + rows_all * cfg.line_delay)
        # keep only observations whose reported row matches the row actually
        # imaged at that exposure time (a real rolling shutter can't observe
        # a feature on a row it isn't on)
        vis = vis & vis_fp & (np.abs(v_pix - rows_all) < 3.0)
        ids = np.nonzero(vis)[0]
        pts = np.stack([xn[ids], yn[ids]], axis=1)
        if cfg.pixel_noise > 0:
            pts = pts + rng.normal(size=pts.shape) * cfg.pixel_noise
        rows = rows_all[ids]
        frames.append(
            FrameObs(
                t_ns=int(np.round(tf * S_TO_NS)),
                ids=ids.astype(np.int64),
                pts=pts,
                rows=rows.astype(np.float64),
            )
        )

    return SimData(
        cfg=cfg,
        knots_q=knots_q,
        knots_p=knots_p,
        imu_t_ns=np.round(imu_ts * S_TO_NS).astype(np.int64),
        gyro=gyro_m,
        accel=accel_m,
        frames=frames,
        landmarks=lm,
        gravity_vec=g_vec,
        bg=bg,
        ba=ba,
        gt_pose_fn=gt_pose,
    )
