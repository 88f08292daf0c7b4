"""CtrlVIO: the per-frame estimation pipeline, synchronous path (PyTorch port
of `ctrlvio_tpu/estimator/odometry.py`).

Per frame (after initialization):
  1. buffer IMU, pair with the frame
  2. feature table update -> keyframe decision
  3. extend spline knots to t_frame + 40 ms, seeded by IMU dead-reckoning
  4. triangulate new landmarks
  5. full sliding-window LM solve in the solve dtype on the device
  6. 4-DoF gauge restore
  7. marginalization prior, f64 on the device (MARGIN_OLD frames)
  8. slide window

Initialization is external (`set_initial_state`, e.g. from
`initializer.bootstrap_from_sim`); the first window's bootstrap solve and
its square-root marginalization run once in f64 on the device. Host
bookkeeping (trajectory, feature table, packing) is numpy; the factor
tuples go to the device as tensors each frame.

Not ported yet: the device-resident streaming megastep (`stream=True`),
the visual and static bootstraps, the native C++ feature table, the classic
`FeatureTracker` front end and `residual_summary`.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ctrlvio_tpu_torch.models.trajectory import Trajectory
from ctrlvio_tpu_torch.ops import factors as F
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.solver import gauge, lm, marginalize
from ctrlvio_tpu_torch.solver.layout import (BiasFactors, ImageFactors,
                                             PriorFactor, SolveOptions,
                                             WindowConfig, WindowParams,
                                             empty_prior)
from ctrlvio_tpu_torch.utils.convert import from_numpy, tensor, to_dtype
from ctrlvio_tpu_torch.utils.device import resolve_device
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls

from . import packing
from .features import FeatureTable
from .initializer import InitialState, dead_reckon_poses

S_TO_NS = 1_000_000_000
MARGIN_OLD = 0
MARGIN_SECOND_NEW = 1


@dataclass
class VIOConfig:
    window_config: WindowConfig = WindowConfig(KW=32, NB=11, LM=256, OBS=2048,
                                               MIMU=384)
    knot_dt: float = 0.05
    # IMU noise -> information (≙ OptWeight)
    sigma_gyro: float = 4e-3
    sigma_accel: float = 8e-2
    sigma_bg: float = 2e-5
    sigma_ba: float = 4e-4
    image_weight: float = 800.0
    min_parallax: float = 10.0 / 460.0
    gravity_mag: float = 9.80766
    # line delay
    ld_init: float = 0.0
    fix_ld: bool = False
    ld_lower: float = 0.0
    ld_upper: float = 3.5e-5
    # window BA: at most ba_iters LM iterations, stopping once an accepted
    # step improves the cost by < ba_tol (relative)
    ba_iters: int = 12
    ba_tol: float = 1e-5
    predict_iters: int = 8
    init_ba_iters: int = 30
    # solve dtype (the bootstrap solve and the marginalization are f64)
    dtype: torch.dtype = torch.float32
    # normal equations: "chunked" accumulation (`ne_chunk` factor slots at a
    # time, None = all at once) or "dense" rows (≙ CTRLVIO_NE / _NE_CHUNK)
    ne_mode: str = "chunked"
    ne_chunk: Optional[int] = None
    # compacted subset caps (obs, imu, lm) of the bootstrap's square-root
    # marginalization; None = marginalize.marg_caps defaults
    # (≙ CTRLVIO_MARG_{OBS,IMU,LM})
    marg_caps: Optional[Tuple[int, int, int]] = None
    # IMU capacity policy: "raise" or "subsample"
    imu_overflow: str = "raise"
    # a frame is solved once the IMU buffer covers t + 0.04 s by this margin
    imu_lookahead: float = 0.06


@dataclass
class KeyframePose:
    """Final estimate of a keyframe as it leaves the window."""

    t_ns: int
    q: np.ndarray
    p: np.ndarray


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


class CtrlVIO:
    """Sliding-window continuous-time rolling-shutter VIO. Runs its solves
    on `device` (the card by default; pass device='cpu' to run on the
    CPU)."""

    def __init__(self, cfg: VIOConfig, q_CtoI, p_CinI, device="cuda"):
        self.device = resolve_device(device)
        pin_f32_matmuls()
        self.cfg = cfg
        wc = cfg.window_config
        self.wc = wc
        self.traj = Trajectory(cfg.knot_dt, cfg.ld_init, cfg.fix_ld,
                               cfg.ld_lower, cfg.ld_upper)
        self.features = FeatureTable(wc.NB - 1, cfg.min_parallax)
        self.q_CtoI = np.asarray(q_CtoI, dtype=np.float64)
        self.p_CinI = np.asarray(p_CinI, dtype=np.float64)

        self.imu_t_ns = np.zeros(0, np.int64)
        self.imu_gyro = np.zeros((0, 3))
        self.imu_accel = np.zeros((0, 3))

        self.kf_t_ns = np.zeros(wc.NB, np.int64)
        self.bg = np.zeros((wc.NB, 3))
        self.ba = np.zeros((wc.NB, 3))
        self.gravity = np.array([0.0, 0.0, cfg.gravity_mag])

        self.timing = defaultdict(float)  # per-phase cumulative seconds
        self.initialized = False
        self.frame_count = 0
        self.data_start_ns: Optional[int] = None
        self.prior: Optional[PriorFactor] = None   # solve dtype
        self._prior64: Optional[PriorFactor] = None  # f64 marg chain
        self.win_knot0 = 0
        self.marg_flag = MARGIN_OLD
        self.keyframes: List[KeyframePose] = []
        self.last_solve_stats = None
        self._pending_frames: deque = deque()
        self.tracker = None

        jdt = cfg.dtype
        self.jdt = jdt
        self._ext = F.CamExtrinsics(q_CtoI=self._t(self.q_CtoI, jdt),
                                    p_CinI=self._t(self.p_CinI, jdt))
        self._gravity_j = self._t(self.gravity, jdt)
        self._imu_info = self._t(
            [1.0 / cfg.sigma_gyro] * 3 + [1.0 / cfg.sigma_accel] * 3, jdt)
        self._sqrt_info_img = self._t(cfg.image_weight, jdt)

        self._ba_opts = SolveOptions(
            max_iters=cfg.ba_iters, fix_ld=cfg.fix_ld, ld_lower=cfg.ld_lower,
            ld_upper=cfg.ld_upper, tol=cfg.ba_tol)
        self._init_opts = self._ba_opts._replace(
            max_iters=cfg.init_ba_iters, tol=0.0)
        self._predict_opts = SolveOptions(
            max_iters=cfg.predict_iters, lock_bias=True, fix_ld=True)
        # the IMU-only predict touches no image factors or landmarks
        self._predict_cfg = wc._replace(OBS=8, LM=8)
        self._predict_img = self._dev(
            _empty_image_factors(self._predict_cfg, _np_dtype(jdt)))
        self._predict_bias = self._dev(BiasFactors(
            sqrt_info=np.zeros((wc.NB - 1, 6), _np_dtype(jdt)),
            valid=np.zeros(wc.NB - 1, bool)))
        self._predict_prior = empty_prior(self._predict_cfg, jdt, self.device)
        # the marg subset keeps its image factors but compacts landmarks
        # into dense slots
        self._marg_cfg = wc._replace(OBS=min(wc.OBS, 512),
                                     MIMU=max(wc.MIMU // 4, 64), LM=96)

    # ------------------------------------------------------------------
    def _t(self, x, dtype=None):
        return tensor(x, self.device, dtype)

    def _dev(self, nt, dtype=None):
        return from_numpy(nt, self.device, dtype)

    def _solve(self, params, img, imu, bias, prior, fixed, ext, gravity,
               imu_info, sqrt_info, cfg, opts):
        return lm.solve_window(params, img, imu, bias, prior,
                               self._t(fixed), ext, gravity, imu_info,
                               sqrt_info, cfg, opts, ne_mode=self.cfg.ne_mode,
                               chunk=self.cfg.ne_chunk)

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def process_imu(self, t_ns: int, gyro, accel):
        if self.data_start_ns is not None:
            t_ns = int(t_ns) - self.data_start_ns
        self.imu_t_ns = np.append(self.imu_t_ns, np.int64(t_ns))
        self.imu_gyro = np.vstack([self.imu_gyro, np.asarray(gyro)[None]])
        self.imu_accel = np.vstack([self.imu_accel, np.asarray(accel)[None]])
        if self.initialized:
            self._drain_pending_frames()

    def set_initial_state(self, t0_ns: int, q0, p0, bg, ba, gravity, v0=None):
        """Bootstrap state (≙ SetInitialState): gravity-aligned initial pose
        at the first frame time, biases, gravity, optional initial velocity.
        Shifts the time origin to t0."""
        self.data_start_ns = int(t0_ns)
        self.imu_t_ns = self.imu_t_ns - self.data_start_ns
        keep = self.imu_t_ns >= 0
        self.imu_t_ns = self.imu_t_ns[keep]
        self.imu_gyro = self.imu_gyro[keep]
        self.imu_accel = self.imu_accel[keep]
        self.gravity = np.asarray(gravity, dtype=np.float64)
        self._gravity_j = self._t(self.gravity, self.jdt)
        self.bg[:] = np.asarray(bg)
        self.ba[:] = np.asarray(ba)
        self._init_state = InitialState(
            t_ns=0, q=np.asarray(q0), p=np.asarray(p0), bg=np.asarray(bg),
            ba=np.asarray(ba), gravity=self.gravity,
            v=None if v0 is None else np.asarray(v0))
        self.traj.set_flat(q0, p0, self.traj.dt_ns)

    # ------------------------------------------------------------------
    # image front end
    # ------------------------------------------------------------------
    def attach_frontend(self, camera, image_shape, tracker_cfg=None):
        """Attach the slot-identity KLT front end (`FusedTracker`, on this
        estimator's device) with gyro-predicted initial flow from this
        estimator's own IMU buffer and gyro-bias estimate."""
        from ctrlvio_tpu_torch.frontend.fused import FusedTracker
        from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig

        self.tracker = FusedTracker(tracker_cfg or TrackerConfig(), camera,
                                    image_shape, device=self.device)
        self._prev_img_t_ns = None
        self._img_first_t_ns = None
        self._img_pub = 0

    def process_image(self, t_ns: int, img):
        """Feed one raw image: CLAHE -> gyro-predicted pyramidal KLT ->
        undistort -> feature frame -> per-frame estimation. Returns the pose
        like process_frame, or None for rate-gated frames / pre-init."""
        if self.tracker is None:
            raise RuntimeError("call attach_frontend(camera, image_shape) first")
        from ctrlvio_tpu_torch.frontend.fused import rotation_flow

        M = None
        if self._prev_img_t_ns is not None and len(self.imu_t_ns):
            R_ic = so3np.quat_to_matrix(self.q_CtoI[None])[0]
            # the IMU buffer rebases to data_start_ns at init; frame times
            # stay absolute
            base = self.data_start_ns or 0
            M = rotation_flow(self.imu_t_ns, self.imu_gyro,
                              self._prev_img_t_ns - base, int(t_ns) - base,
                              R_ic, bg=self.bg[-1])
        out = self.tracker.step(int(t_ns), img, R_rel=M)
        self._prev_img_t_ns = int(t_ns)
        # publish-rate gate: track every frame, estimate at cfg.freq
        if self._img_first_t_ns is None:
            self._img_first_t_ns = int(t_ns)
            self._img_pub = 0
        elapsed = (int(t_ns) - self._img_first_t_ns) * 1e-9
        if elapsed > 0 and self._img_pub / elapsed > self.tracker.cfg.freq:
            return None
        self._img_pub += 1
        if out is None:
            return None
        return self.process_frame(out["t_ns"], out["ids"], out["pts"],
                                  out["rows"])

    # ------------------------------------------------------------------
    # per-frame pipeline
    # ------------------------------------------------------------------
    def process_frame(self, t_ns: int, ids, pts, rows):
        """Feed one feature frame. Returns the current IMU pose estimate
        (q, p) at the frame time, or None before initialization."""
        if self.data_start_ns is None:
            raise RuntimeError("call set_initial_state first")
        t_ns = int(t_ns) - self.data_start_ns
        if not self.initialized:
            return self._accumulate_init_frame(t_ns, ids, pts, rows)
        # defer until the IMU buffer covers this frame's extension horizon;
        # the caller still gets the IMU-forecast pose
        self._drain_pending_frames()
        if not self._imu_covers(t_ns):
            self._pending_frames.append(
                (t_ns, np.asarray(ids).copy(), np.asarray(pts).copy(),
                 np.asarray(rows).copy()))
            return self._forecast_pose(t_ns)
        return self._process_frame_ready(t_ns, ids, pts, rows)

    def _imu_covers(self, t_ns: int) -> bool:
        need = int(t_ns) + int(self.cfg.imu_lookahead * S_TO_NS)
        return len(self.imu_t_ns) > 0 and int(self.imu_t_ns[-1]) >= need

    def _drain_pending_frames(self):
        q = self._pending_frames
        while q and self._imu_covers(q[0][0]):
            self._process_frame_ready(*q.popleft())

    def _process_frame_ready(self, t_ns: int, ids, pts, rows):
        wc = self.wc
        is_kf = self.features.add_frame(wc.NB - 1, ids, pts, rows)
        self.marg_flag = MARGIN_OLD if is_kf else MARGIN_SECOND_NEW
        self.kf_t_ns[wc.NB - 1] = t_ns
        self.bg[wc.NB - 1] = self.bg[wc.NB - 2]
        self.ba[wc.NB - 1] = self.ba[wc.NB - 2]

        t0 = time.perf_counter()
        self._extend_and_predict(t_ns)
        self.timing["predict"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        self._triangulate()
        self.timing["triangulate"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        self._solve_window_ba()
        self.timing["ba"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        self._slide_window()
        self.timing["slide"] += time.perf_counter() - t0

        q, p = self.traj.pose(t_ns)
        return q[0], p[0]

    def flush(self):
        """End of stream: solve frames still queued behind the IMU-coverage
        check (best effort)."""
        q = self._pending_frames
        last_imu = int(self.imu_t_ns[-1]) if len(self.imu_t_ns) else -1
        while q and q[0][0] <= last_imu:
            self._process_frame_ready(*q.popleft())

    # ------------------------------------------------------------------
    def _forecast_pose(self, t_ns: int):
        """Online pose at t_ns: midpoint IMU integration from the newest
        image-constrained spline state."""
        dt_ns = int(self.traj.dt_ns)
        hi = self.traj.n
        t0 = max((hi - 4) * dt_ns, 0)
        q0, p0 = self.traj.pose(t0)
        i0 = min(self.traj.ctrl_idx(t0), self.traj.n - 4)
        u = (t0 - i0 * dt_ns) / dt_ns
        v0 = so3np.rd_eval(self.traj.knots_p[i0 : i0 + 4], np.float64(u),
                           1.0 / self.traj.dt, 1)
        st = InitialState(t_ns=0, q=q0[0], p=p0[0], bg=self.bg[-1],
                          ba=self.ba[-1], gravity=self.gravity, v=v0)
        sel = (self.imu_t_ns >= t0) & (self.imu_t_ns <= t_ns)
        kq, kp = dead_reckon_poses(
            np.array([t_ns - t0], np.int64), self.imu_t_ns[sel] - t0,
            self.imu_gyro[sel], self.imu_accel[sel], st)
        return kq[0], kp[0]

    # ------------------------------------------------------------------
    def _accumulate_init_frame(self, t_ns, ids, pts, rows):
        wc = self.wc
        self.features.add_frame(self.frame_count, ids, pts, rows)
        self.kf_t_ns[self.frame_count] = t_ns
        self.frame_count += 1
        if self.frame_count < wc.NB:
            return None

        # window full: knots from IMU dead-reckoning, an IMU-only LM fit of
        # the spline, triangulation, then the long f64 bootstrap BA
        self.win_knot0 = 0
        self.marg_flag = MARGIN_OLD
        self.traj.extend_to(t_ns + int(0.04 * S_TO_NS))
        # curve(i*dt) ~ (P_i + 4 P_{i+1} + P_{i+2})/6: knot P_i carries the
        # pose at (i-1)*dt
        knot_ts = (np.arange(self.traj.n, dtype=np.int64) - 1) \
            * int(self.traj.dt_ns)
        kq, kp = dead_reckon_poses(knot_ts, self.imu_t_ns, self.imu_gyro,
                                   self.imu_accel, self._init_state)
        self.traj.knots_q[: self.traj.n] = kq
        self.traj.knots_p[: self.traj.n] = kp
        self._extend_and_predict(t_ns, from_start=True)
        self._triangulate()
        self._init_solve_f64()
        self._slide_window()
        self.initialized = True
        q, p = self.traj.pose(t_ns)
        return q[0], p[0]

    # ------------------------------------------------------------------
    def _pack_window(self, dtype):
        """Image, IMU and bias factors of the current window (numpy)."""
        wc, cfg = self.wc, self.cfg
        img, dinv0, cands = packing.pack_image_factors(
            list(self.features.tracks.values()), self.kf_t_ns, self.traj.dt,
            self.win_knot0, wc, dtype)
        t_lo = self.win_knot0 * int(self.traj.dt_ns)
        imu = packing.pack_imu_factors(
            self.imu_t_ns, self.imu_gyro, self.imu_accel, self.kf_t_ns,
            t_lo, self.traj.max_time_ns, self.traj.dt, self.win_knot0, wc,
            dtype, on_overflow=cfg.imu_overflow)
        bias = packing.bias_sqrt_info(self.imu_t_ns, self.kf_t_ns,
                                      cfg.sigma_bg, cfg.sigma_ba, wc, dtype)
        return img, dinv0, cands, imu, bias

    def _init_solve_f64(self):
        """One-time f64 bootstrap BA + square-root marginalization prior on
        the device (≙ the first UpdateTrajectory after SetInitialState)."""
        wc, cfg = self.wc, self.cfg
        f64 = torch.float64
        self.win_knot0 = self.traj.ctrl_idx(self.kf_t_ns[0])
        kq, kp, n_active = self.traj.window(self.win_knot0, wc.KW, np.float64)
        img, dinv0, _, imu, bias = self._pack_window(np.float64)
        fixed = np.ones(wc.KW, bool)
        fixed[:n_active] = False
        params = WindowParams(
            knots_q=self._t(kq, f64), knots_p=self._t(kp, f64),
            bg=self._t(self.bg, f64), ba=self._t(self.ba, f64),
            dinv=self._t(dinv0, f64), ld=self._t(self.traj.line_delay, f64))
        ext64 = F.CamExtrinsics(q_CtoI=self._t(self.q_CtoI, f64),
                                p_CinI=self._t(self.p_CinI, f64))
        grav64 = self._t(self.gravity, f64)
        info64 = self._imu_info.to(f64)
        w64 = self._sqrt_info_img.to(f64)
        img_t, imu_t, bias_t = (self._dev(img, f64), self._dev(imu, f64),
                                self._dev(bias, f64))
        opts = self._init_opts
        k1 = self.traj.ctrl_idx(self.kf_t_ns[1]) - self.win_knot0
        drop = np.zeros(wc.KW, bool)
        drop[:k1] = True

        p_out, stats = self._solve(params, img_t, imu_t, bias_t,
                                   empty_prior(wc, f64, self.device), fixed,
                                   ext64, grav64, info64, w64, wc, opts)
        q_new, p_new = gauge.restore_gauge(p_out.knots_q, p_out.knots_p,
                                           params.knots_q[0],
                                           params.knots_p[0], 0, 0)
        p_out = p_out._replace(knots_q=q_new, knots_p=p_new)
        prior64 = marginalize.build_prior_sqrt(
            p_out, img_t, imu_t, bias_t, empty_prior(wc, f64, self.device),
            self._t(drop), ext64, grav64, info64, w64, wc,
            opts._replace(cauchy_c=1.0), knot_shift=k1, bias_shift=1,
            caps=cfg.marg_caps)

        self.last_solve_stats = SimpleNamespace(
            cost0=float(stats.cost0), cost=float(stats.cost),
            accepted=float(stats.accepted))
        self.traj.write_back(self.win_knot0, p_out.knots_q.cpu().numpy(),
                             p_out.knots_p.cpu().numpy(), n_active)
        self.bg = p_out.bg.cpu().numpy().astype(np.float64)
        self.ba = p_out.ba.cpu().numpy().astype(np.float64)
        if not cfg.fix_ld:
            self.traj.line_delay = float(np.clip(
                float(p_out.ld), cfg.ld_lower, cfg.ld_upper))
        dinv_np = p_out.dinv.cpu().numpy().astype(np.float64)
        self.features.set_depths_by_id(self.features.slot_fids(wc.LM),
                                       dinv_np[: wc.LM])
        # the f64 prior seeds the per-frame f64 marg chain; the solve-dtype
        # copy rides in the window solves
        self._prior64 = prior64
        self.prior = to_dtype(prior64, self.jdt)
        return int(np.asarray(img.valid).sum())

    # ------------------------------------------------------------------
    def _extend_and_predict(self, t_ns: int, from_start: bool = False):
        """≙ ExtendTrajectory + InitTrajectory. Per frame, the appended
        knots are seeded by IMU dead-reckoning from the spline's end state;
        the bootstrap (from_start) fits the whole window with an IMU-only
        LM solve."""
        wc = self.wc
        max_bef_ns = self.traj.max_time_ns
        max_bef_idx = self.traj.n - 1
        self.traj.extend_to(t_ns + int(0.04 * S_TO_NS))
        max_aft_ns = self.traj.max_time_ns
        if max_aft_ns <= max_bef_ns and not from_start:
            return
        if not from_start:
            t0 = time.perf_counter()
            self._deadreckon_extension(max_bef_ns, max_bef_idx, max_aft_ns)
            self.timing["predict_dr"] += time.perf_counter() - t0
            return

        pc = self._predict_cfg
        jdt = self.jdt
        kq, kp, n_active = self.traj.window(self.win_knot0, pc.KW, np.float64)
        params = WindowParams(
            knots_q=self._t(kq, jdt), knots_p=self._t(kp, jdt),
            bg=self._t(self.bg, jdt), ba=self._t(self.ba, jdt),
            dinv=torch.full((pc.LM,), 0.2, dtype=jdt, device=self.device),
            ld=self._t(self.traj.line_delay, jdt))
        imu = packing.pack_imu_factors(
            self.imu_t_ns, self.imu_gyro, self.imu_accel, self.kf_t_ns,
            0, max_aft_ns, self.traj.dt, self.win_knot0, pc,
            _np_dtype(jdt), on_overflow=self.cfg.imu_overflow)
        fixed = np.ones(wc.KW, bool)
        fixed[4:n_active] = False
        p_out, _ = self._solve(params, self._predict_img, self._dev(imu),
                               self._predict_bias, self._predict_prior, fixed,
                               self._ext, self._gravity_j, self._imu_info,
                               self._sqrt_info_img, pc, self._predict_opts)
        self.traj.write_back(self.win_knot0, p_out.knots_q.cpu().numpy(),
                             p_out.knots_p.cpu().numpy(), n_active)

    # ------------------------------------------------------------------
    def _deadreckon_extension(self, max_bef_ns: int, max_bef_idx: int,
                              max_aft_ns: int):
        """Fill newly appended knots by integrating IMU from the spline's
        end state (numpy)."""
        dt_ns = int(self.traj.dt_ns)
        t0 = max(max_bef_ns - dt_ns, 0)
        q0, p0 = self.traj.pose(t0)
        i0 = min(self.traj.ctrl_idx(t0), self.traj.n - 4)
        u = (t0 - i0 * dt_ns) / dt_ns
        v0 = so3np.rd_eval(self.traj.knots_p[i0 : i0 + 4], np.float64(u),
                           1.0 / self.traj.dt, 1)
        st = InitialState(t_ns=0, q=q0[0], p=p0[0], bg=self.bg[-1],
                          ba=self.ba[-1], gravity=self.gravity, v=v0)
        # new knots carry poses at (i-1)*dt (cubic B-spline offset)
        new_idx = np.arange(max_bef_idx + 1, self.traj.n, dtype=np.int64)
        knot_ts = (new_idx - 1) * dt_ns - t0
        sel = (self.imu_t_ns >= t0) & (self.imu_t_ns <= max_aft_ns)
        kq, kp = dead_reckon_poses(
            knot_ts, self.imu_t_ns[sel] - t0, self.imu_gyro[sel],
            self.imu_accel[sel], st)
        self.traj.knots_q[new_idx] = kq
        self.traj.knots_p[new_idx] = kp

    # ------------------------------------------------------------------
    def _triangulate(self):
        nb = self.wc.NB
        cam_q, cam_p = self.traj.camera_pose(self.kf_t_ns[:nb], self.q_CtoI,
                                             self.p_CinI)
        self.features.triangulate(cam_q, cam_p)

    # ------------------------------------------------------------------
    def _solve_window_ba(self):
        t_pack0 = time.perf_counter()
        wc, cfg = self.wc, self.cfg
        jdt = self.jdt
        npdt = _np_dtype(jdt)
        self.win_knot0 = self.traj.ctrl_idx(self.kf_t_ns[0])
        span = self.traj.n - self.win_knot0
        if span > wc.KW:
            raise RuntimeError(
                f"window spans {span} knots > KW={wc.KW}: keyframe gaps too "
                f"large for the configured knot capacity; raise WindowConfig.KW")
        kq, kp, n_active = self.traj.window(self.win_knot0, wc.KW, np.float64)
        img, dinv0, cands, imu, bias = self._pack_window(npdt)
        # no knot is hard-fixed: LM damping spans the 4-DoF gauge null
        # space and the post-solve restore re-anchors yaw + position
        fixed = np.ones(wc.KW, bool)
        fixed[:n_active] = False
        params = WindowParams(
            knots_q=self._t(kq.astype(npdt)), knots_p=self._t(kp.astype(npdt)),
            bg=self._t(self.bg.astype(npdt)), ba=self._t(self.ba.astype(npdt)),
            dinv=self._t(dinv0.astype(npdt)),
            ld=self._t(np.asarray(self.traj.line_delay, npdt)))
        prior = self.prior if self.prior is not None else \
            empty_prior(wc, jdt, self.device)
        img_t, imu_t, bias_t = self._dev(img), self._dev(imu), self._dev(bias)
        self.timing["ba_pack"] += time.perf_counter() - t_pack0

        t0 = time.perf_counter()
        p_out, stats = self._solve(params, img_t, imu_t, bias_t, prior, fixed,
                                   self._ext, self._gravity_j, self._imu_info,
                                   self._sqrt_info_img, wc, self._ba_opts)
        q_new, p_new = gauge.restore_gauge(p_out.knots_q, p_out.knots_p,
                                           params.knots_q[0],
                                           params.knots_p[0], 0, 0)
        packed = torch.cat([
            q_new.reshape(-1), p_new.reshape(-1), p_out.bg.reshape(-1),
            p_out.ba.reshape(-1), p_out.dinv, p_out.ld.reshape(1),
            torch.stack([stats.cost0, stats.cost,
                         stats.accepted.to(q_new.dtype)])]).cpu().numpy()
        host = packed.astype(np.float64)
        self.timing["ba_solve"] += time.perf_counter() - t0

        K, B, L = wc.KW, wc.NB, wc.LM
        o = 0
        kq_np = host[o : o + 4 * K].reshape(K, 4); o += 4 * K
        kp_np = host[o : o + 3 * K].reshape(K, 3); o += 3 * K
        bg_np = host[o : o + 3 * B].reshape(B, 3); o += 3 * B
        ba_np = host[o : o + 3 * B].reshape(B, 3); o += 3 * B
        dinv_np = host[o : o + L]; o += L
        ld_np = host[o]; o += 1
        self.last_solve_stats = SimpleNamespace(
            cost0=host[o], cost=host[o + 1], accepted=host[o + 2])

        t0 = time.perf_counter()
        self.traj.write_back(self.win_knot0, kq_np, kp_np, n_active)
        if not cfg.fix_ld:
            self.traj.line_delay = float(ld_np)
        self.bg = bg_np.copy()
        self.ba = ba_np.copy()
        self.features.set_depths(dinv_np, cands)
        self.timing["ba_writeback"] += time.perf_counter() - t0

        # [7] marginalization prior at the gauge-restored state, in f64 on
        # the device (the Schur complement spans too much dynamic range for
        # f32), pre-rolled into the post-slide layout
        if self.marg_flag != MARGIN_OLD:
            return
        t0 = time.perf_counter()
        f64 = torch.float64
        k1 = self.traj.ctrl_idx(self.kf_t_ns[1]) - self.win_knot0
        drop = np.zeros(wc.KW, bool)
        drop[:k1] = True
        mc = self._marg_cfg
        img_m = _compact_factors(img, img.valid & img.marg_drop, mc.OBS)
        imu_m = _compact_factors(imu, imu.valid & imu.marg_drop, mc.MIMU)
        img_m, dinv_m = _compact_landmarks(img_m, dinv_np, mc.LM)
        p_marg = WindowParams(
            knots_q=self._t(kq_np), knots_p=self._t(kp_np),
            bg=self._t(bg_np), ba=self._t(ba_np), dinv=self._t(dinv_m),
            ld=self._t(np.float64(ld_np)))
        knot_shift = (self.traj.ctrl_idx(self.kf_t_ns[1])
                      - self.traj.ctrl_idx(self.kf_t_ns[0]))
        old = self._prior64
        if old is None:
            old = to_dtype(prior, f64)
        prior64 = marginalize.build_prior(
            p_marg, self._dev(img_m, f64), self._dev(imu_m, f64),
            self._dev(bias, f64), old, self._t(drop),
            to_dtype(self._ext, f64), self._t(self.gravity, f64),
            self._imu_info.to(f64), self._sqrt_info_img.to(f64), mc,
            self._ba_opts._replace(cauchy_c=1.0), knot_shift=knot_shift,
            bias_shift=1)
        self._prior64 = prior64
        self.prior = to_dtype(prior64, jdt)
        self.timing["prior"] += time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _slide_window(self):
        wc = self.wc
        nb = wc.NB
        if self.marg_flag == MARGIN_OLD:
            q, p = self.traj.pose(self.kf_t_ns[0])
            self.keyframes.append(KeyframePose(int(self.kf_t_ns[0]), q[0], p[0]))
            cam_q, cam_p = self.traj.camera_pose(
                self.kf_t_ns[:2], self.q_CtoI, self.p_CinI)
            R = so3np.quat_to_matrix(cam_q)
            self.features.slide_old(R[0], cam_p[0], R[1], cam_p[1])
            self.kf_t_ns[:-1] = self.kf_t_ns[1:]
            self.bg[:-1] = self.bg[1:]
            self.ba[:-1] = self.ba[1:]
            self.win_knot0 = self.traj.ctrl_idx(self.kf_t_ns[0])
            # drop stale IMU (≙ RemoveIMUData ts[0]-5s)
            keep = self.imu_t_ns >= self.kf_t_ns[0] - 5 * S_TO_NS
            self.imu_t_ns = self.imu_t_ns[keep]
            self.imu_gyro = self.imu_gyro[keep]
            self.imu_accel = self.imu_accel[keep]
        else:
            self.features.remove_failures()
            self.features.slide_second_new(nb - 1)
            self.kf_t_ns[nb - 2] = self.kf_t_ns[nb - 1]
            self.bg[nb - 2] = self.bg[nb - 1]
            self.ba[nb - 2] = self.ba[nb - 1]


def _empty_image_factors(wc: WindowConfig, dtype) -> ImageFactors:
    OBS = wc.OBS
    z = np.zeros(OBS, dtype)
    return ImageFactors(
        i0_i=np.zeros(OBS, np.int32), f_i=z, row_i=z,
        pt_i=np.zeros((OBS, 3), dtype), i0_j=np.zeros(OBS, np.int32), f_j=z,
        row_j=z, pt_j=np.zeros((OBS, 3), dtype),
        lm_idx=np.zeros(OBS, np.int32), valid=np.zeros(OBS, bool),
        marg_drop=np.zeros(OBS, bool),
    )


def _compact_factors(factors, sel, cap: int):
    """Rows where sel (bool over the slot axis), padded to cap (numpy)."""
    idx = np.nonzero(np.asarray(sel))[0]
    if len(idx) > cap:
        import logging

        logging.getLogger(__name__).warning(
            "marginalization factor capacity %d exceeded (%d); truncating",
            cap, len(idx))
        idx = idx[:cap]

    def take(x):
        x = np.asarray(x)
        out = np.zeros((cap,) + x.shape[1:], dtype=x.dtype)
        out[: len(idx)] = x[idx]
        return out

    return type(factors)(*(take(f) for f in factors))


def _compact_landmarks(img_m: ImageFactors, dinv: np.ndarray, lm_cap: int):
    """Remap the landmark slots of a compacted marg factor set to dense
    indices [0, n); landmarks beyond lm_cap are dropped with all their
    factors."""
    lm_idx = np.asarray(img_m.lm_idx)
    valid = np.asarray(img_m.valid).copy()
    used = np.unique(lm_idx[valid])
    if len(used) > lm_cap:
        import logging

        logging.getLogger(__name__).warning(
            "marginalized landmark capacity %d exceeded (%d); dropping extras",
            lm_cap, len(used))
        dropped = set(used[lm_cap:].tolist())
        valid &= ~np.isin(lm_idx, list(dropped))
        used = used[:lm_cap]
    remap = np.zeros(int(lm_idx.max()) + 1 if len(lm_idx) else 1, np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    new_idx = np.where(valid, remap[lm_idx], 0).astype(np.int32)
    dinv_m = np.full(lm_cap, 0.2)
    dinv_m[: len(used)] = dinv[used]
    return img_m._replace(lm_idx=new_idx, valid=valid), dinv_m
