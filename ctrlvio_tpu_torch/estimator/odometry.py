"""CtrlVIO: the per-frame estimation pipeline (PyTorch port of
`ctrlvio_tpu/estimator/odometry.py`).

Per frame (after initialization):
  1. buffer IMU, pair with the frame
  2. feature table update -> keyframe decision
  3. extend spline knots to t_frame + 40 ms, seeded by IMU dead-reckoning
  4. triangulate new landmarks
  5. full sliding-window LM solve in the solve dtype on the device
  6. 4-DoF gauge restore
  7. marginalization prior (MARGIN_OLD frames)
  8. slide window

Two schedules run steps 5-8:
- synchronous (`stream=False`, and the first `stream_warmup` frames of a
  stream): per frame, one program solves the window and restores the
  gauge (one upload, one pull), and on a MARGIN_OLD frame a second one
  builds the marginalization prior in f64 on the device;
- streaming (`stream=True` after the warmup): one device program a frame
  (`stream.megastep`: solve, gauge, square-root marginalization in the
  solve dtype, slide) chained through a device-resident state with no host
  read; the host mirror consumes the solve summaries `stream_lag` frames
  later, pulling every `stream_consume_every`-th asynchronously.

On the card each program is a captured CUDA graph (`utils/graphs.py`, the
counterpart of the JAX package's `jax.jit`): the streamed megastep one per
slide branch and seed source, held by the estimator with its state in
place; the synchronous solve, prior build and predict solve shared by
every estimator of the process with the same configuration
(`_SYNC_PROGRAMS`), the first window's f64 bootstrap solve among them.
Each solve leaves its LM loop on the device once it has converged (a
CUDA-graph WHILE node holds the later iterations, its condition set by the
accept step, K4: `lm.solve_window_fixed`); `lm_iters` lists every solve's
iteration count.

Initialization: external (`set_initial_state`, e.g. from
`initializer.bootstrap_from_sim`), static (stillness, with the IMU
attitude as fallback) or visual (SfM + visual-inertial alignment,
`vio_init.VIOInitializer`). The first window's bootstrap solve and its
square-root marginalization run once in f64 on the device; a self-bootstrap
whose solve stays above `init_max_rms` is rejected and retried on a later
window. Host bookkeeping (trajectory, feature table, packing) is numpy, the
feature table native C++ by default (`native.NativeFeatureTable`).

Raw images enter through `attach_frontend` and `process_image`, with the
slot-identity `FusedTracker` or the classic `FeatureTracker` (the latter
whenever the F-RANSAC gate is asked for, as in the JAX package). B
streaming instances serve in lockstep behind `parallel.stream_batch.
BatchedStream`, which sets their `_dispatch_hook`. `residual_summary`
re-linearizes the current window in f64 for the per-factor-type report
(`VIOConfig.debug_residual_summary` prints it every frame).
"""

from __future__ import annotations

import contextlib
import sys
import warnings
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
                                             ImuFactors, PriorFactor,
                                             SolveOptions, WindowConfig,
                                             WindowParams, empty_params,
                                             empty_prior)
from ctrlvio_tpu_torch.utils import graphs, spans
from ctrlvio_tpu_torch.utils.convert import from_numpy, tensor, to_dtype
from ctrlvio_tpu_torch.utils.device import (SYNC_WARNING,  # noqa: F401
                                            recorded_syncs, resolve_device)
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls

from . import packing, stream
from .features import FeatureTable
from .initializer import (ActiveInitializer, InitialState, StaticInitializer,
                          dead_reckon_poses)

S_TO_NS = 1_000_000_000
MARGIN_OLD = 0
MARGIN_SECOND_NEW = 1

# the synchronous path's programs (window solve, prior build, predict
# solve): one per window configuration, options, dtype and device, shared
# by every CtrlVIO of the process, as `jax.jit`'s cache is
_SYNC_PROGRAMS = graphs.ProgramCache()


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
    # Schur solver of the window and streamed solves: "chol" (exact) or
    # "cg" (`cg_iters` iterations of block-Jacobi PCG, `lm.schur_solve`);
    # the bootstrap and predict solves always take "chol"
    # (≙ CTRLVIO_SOLVE / CTRLVIO_CG_ITERS)
    solver: str = "chol"
    cg_iters: int = 48
    predict_iters: int = 8
    init_ba_iters: int = 30
    # solve dtype (the bootstrap solve and the synchronous marginalization
    # are f64)
    dtype: torch.dtype = torch.float32
    # the C++ feature table (`native.NativeFeatureTable`, built at first
    # use); a failed build raises. False = the python FeatureTable
    use_native: bool = True
    # bootstrap: "external" (the caller runs set_initial_state), "static"
    # (stationary IMU, the IMU attitude as fallback) or "visual" (SfM +
    # visual-inertial alignment)
    bootstrap: str = "external"
    excite_threshold: float = 0.25
    # precision of the synchronous path's marginalization prior: True = f64
    # (the safest), False = the solve dtype. Both build on the estimator's
    # device: the JAX package runs its True branch on the host CPU only
    # because the TPU has no f64, and the card builds the same f64 prior.
    # In float32 the Cholesky of the kept block, whose gauge directions
    # hold only the 1e-7 regularization, fails on most sequences in both
    # packages: the prior comes out NaN and later solves accept no step.
    # The bootstrap prior is f64 and the streamed megastep's QR
    # marginalization is in the solve dtype either way
    marg_on_host: bool = True
    # streaming pipeline: after `stream_warmup` synchronous frames (f64
    # marginalization through the bootstrap transient), one device call a
    # frame with no host read; summaries reach the host mirror `stream_lag`
    # frames later, every `stream_consume_every`-th one pulled
    # asynchronously (the mirror needs only the newest)
    stream: bool = False
    stream_lag: int = 6
    stream_consume_every: int = 3
    stream_warmup: int = 40
    # normal equations: "chunked" accumulation (`ne_chunk` factor slots at a
    # time, None = all at once) or "dense" rows (≙ CTRLVIO_NE / _NE_CHUNK)
    ne_mode: str = "chunked"
    ne_chunk: Optional[int] = None
    # compacted subset caps (obs, imu, lm) of the square-root
    # marginalization (bootstrap and stream); None = marginalize.marg_caps
    # defaults (≙ CTRLVIO_MARG_{OBS,IMU,LM})
    marg_caps: Optional[Tuple[int, int, int]] = None
    # IMU capacity policy: "raise" or "subsample"
    imu_overflow: str = "raise"
    # a frame is solved once the IMU buffer covers t + 0.04 s by this margin
    imu_lookahead: float = 0.06
    # print the per-factor-type residual report after every frame
    # (≙ ResidualSummary, `trajectory_estimator.cpp:69-95`); a streamed
    # frame prints the RMS its megastep summary carries, when consumed
    debug_residual_summary: bool = False
    # a self-bootstrap is rejected (and retried on a later window) when the
    # first-window f64 BA ends above this RMS weighted residual per image
    # observation coordinate (1.0 = residuals at the measurement sigma)
    init_max_rms: float = 3.0


@dataclass
class KeyframePose:
    """Final estimate of a keyframe as it leaves the window."""

    t_ns: int
    q: np.ndarray
    p: np.ndarray


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


# ---------------------------------------------------------------------------
# the synchronous path's programs (≙ `_ba_fused`, `_blob_pack`,
# `_blob_unpack`, `_build_prior_cpu` / `_build_prior_dev` and
# `_solve_predict` of `ctrlvio_tpu/estimator/odometry.py`)
# ---------------------------------------------------------------------------


def blob_pack(img: ImageFactors, imu: ImuFactors, bias: BiasFactors, kq, kp,
              bg, ba, dinv, ld, knots, dtype, tail=()) -> np.ndarray:
    """Every host-produced input of a window program in one flat buffer
    (one upload): the factors, the window parameters, a (KW,) knot mask
    (the fixed knots of a solve, the dropped ones of a prior build) and
    `tail`, further values. Integers and booleans are float-encoded (all
    values << 2^24, exact in f32). The prior stays on the device and is
    not packed, unlike the JAX package's blob."""
    parts = [np.asarray(f, dtype).ravel() for t in (img, imu, bias)
             for f in t]
    parts += [np.asarray(a, dtype).ravel() for a in (kq, kp, bg, ba, dinv)]
    parts += [np.asarray([ld], dtype), np.asarray(knots, dtype),
              np.asarray(tail, dtype)]
    return np.concatenate(parts)


def blob_unpack(blob: torch.Tensor, cfg: WindowConfig):
    """Inverse of `blob_pack` on the device, at static offsets: (img, imu,
    bias, WindowParams, the knot mask, the tail)."""
    OBS, M, NB, KW, LM = cfg.OBS, cfg.MIMU, cfg.NB, cfg.KW, cfg.LM
    o = [0]

    def take(shape, dt=None):
        n = int(np.prod(shape))
        x = blob[o[0] : o[0] + n].reshape(shape)
        o[0] += n
        if dt is torch.bool:
            return x != 0
        return x if dt is None else x.to(dt)

    i64, b = torch.int64, torch.bool
    img = ImageFactors(
        i0_i=take((OBS,), i64), f_i=take((OBS,)), row_i=take((OBS,)),
        pt_i=take((OBS, 3)), i0_j=take((OBS,), i64), f_j=take((OBS,)),
        row_j=take((OBS,)), pt_j=take((OBS, 3)),
        lm_idx=take((OBS,), i64), valid=take((OBS,), b),
        marg_drop=take((OBS,), b))
    imu = ImuFactors(
        i0=take((M,), i64), u=take((M,)), gyro=take((M, 3)),
        accel=take((M, 3)), bias_idx=take((M,), i64),
        valid=take((M,), b), marg_drop=take((M,), b))
    bias = BiasFactors(sqrt_info=take((NB - 1, 6)),
                       valid=take((NB - 1,), b))
    params = WindowParams(knots_q=take((KW, 4)), knots_p=take((KW, 3)),
                          bg=take((NB, 3)), ba=take((NB, 3)),
                          dinv=take((LM,)), ld=take(()))
    knots = take((KW,), b)
    return img, imu, bias, params, knots, blob[o[0]:]


def window_solve(blob, prior: PriorFactor, ext, gravity, imu_info,
                 sqrt_info_img, *, cfg: WindowConfig, opts: SolveOptions,
                 ne_mode: str, chunk: Optional[int], restore: bool):
    """The synchronous window solve as one program (≙ `_ba_fused`): the
    blob's factors and parameters, `opts.max_iters` LM iterations that
    freeze once converged and that a captured program skips from then on
    (`lm.solve_window_fixed`, equal to the host-exit loop), with `restore`
    the 4-DoF gauge restore; one flat vector out
    [knots_q, knots_p, bg, ba, dinv, ld, cost0, cost, accepted, iters]
    (`unpack_solved`)."""
    img, imu, bias, params, fixed, _ = blob_unpack(blob, cfg)
    p_out, stats = lm.solve_window_fixed(
        params, img, imu, bias, prior, fixed, ext, gravity, imu_info,
        sqrt_info_img, cfg, opts, ne_mode=ne_mode, chunk=chunk)
    q_new, p_new = p_out.knots_q, p_out.knots_p
    if restore:
        q_new, p_new = gauge.restore_gauge(q_new, p_new, params.knots_q[0],
                                           params.knots_p[0], 0, 0)
    return torch.cat([
        q_new.reshape(-1), p_new.reshape(-1), p_out.bg.reshape(-1),
        p_out.ba.reshape(-1), p_out.dinv, p_out.ld.reshape(1),
        torch.stack([stats.cost0, stats.cost,
                     stats.accepted.to(q_new.dtype),
                     stats.iters.to(q_new.dtype)])])


def unpack_solved(host, cfg: WindowConfig) -> dict:
    """`window_solve`'s vector split into views: numpy views of the
    vector pulled to the host, or tensor views of it on the device."""
    K, B, L = cfg.KW, cfg.NB, cfg.LM
    o = np.cumsum([0, 4 * K, 3 * K, 3 * B, 3 * B, L, 1, 1, 1, 1, 1])
    return dict(knots_q=host[o[0]:o[1]].reshape(K, 4),
                knots_p=host[o[1]:o[2]].reshape(K, 3),
                bg=host[o[2]:o[3]].reshape(B, 3),
                ba=host[o[3]:o[4]].reshape(B, 3), dinv=host[o[4]:o[5]],
                ld=host[o[5]], cost0=host[o[6]], cost=host[o[7]],
                accepted=host[o[8]], iters=host[o[9]])


def iters_histogram(iters) -> dict:
    """{iteration count: solves} of a list of LM iteration counts, the
    counts as strings (JSON keys), in increasing order."""
    vals, n = np.unique(np.asarray(iters, np.int64), return_counts=True)
    return {str(v): int(c) for v, c in zip(vals, n)}


def marg_prior(blob, old_prior: PriorFactor, ext, imu_info, sqrt_info_img,
               *, cfg: WindowConfig, opts: SolveOptions) -> PriorFactor:
    """A MARGIN_OLD frame's normal-equation prior as one program (≙
    `_build_prior_cpu` / `_build_prior_dev`), in the blob's dtype: the
    compacted marg subset and the linearization point from the blob, whose
    knot mask is the dropped knots and whose tail is [gravity (3),
    knot_shift, bias_shift], so the shifts are device tensors and one
    program serves every shift; ext, imu_info and sqrt_info_img are cast
    to the blob's dtype inside."""
    dt = blob.dtype
    img, imu, bias, params, drop, tail = blob_unpack(blob, cfg)
    return marginalize.build_prior(
        params, img, imu, bias, old_prior, drop, to_dtype(ext, dt),
        tail[:3], imu_info.to(dt), sqrt_info_img.to(dt), cfg, opts,
        knot_shift=tail[3].to(torch.int64),
        bias_shift=tail[4].to(torch.int64))


class CtrlVIO:
    """Sliding-window continuous-time rolling-shutter VIO. Runs its solves
    on `device` (the card by default; pass device='cpu' to run on the
    CPU).

    `counts` tallies what ran: "sync_solve" (window solves of the
    synchronous schedule), "sync_solve_after_handoff", "megastep" (this
    instance's streamed frames, alone or as a lane of a batched call),
    "bootstrap_static" / "bootstrap_visual" (initial states produced),
    "bootstrap_rejected", "marg_overflow" (the bootstrap prior and stream
    summaries reporting a marginalization cap overflow) and, with
    `check_dispatch_syncs` set on a CUDA device, "megastep_syncs":
    synchronizing CUDA calls inside the streamed dispatch
    (`torch.cuda.set_sync_debug_mode("warn")`), whose messages collect in
    `sync_warnings`.

    `timing` holds each host phase's cumulative seconds, timed by spans
    (`utils/spans.py`: "process_frame" and "process_imu" a call, and the
    phases inside them); `trace(True)` also records each span and stamps
    each streamed megastep's device phases, read by `trace_record`."""

    def __init__(self, cfg: VIOConfig, q_CtoI, p_CinI, device="cuda"):
        self.device = resolve_device(device)
        pin_f32_matmuls()
        if cfg.bootstrap not in ("external", "static", "visual"):
            raise ValueError(f"unknown bootstrap {cfg.bootstrap!r}")
        self.cfg = cfg
        wc = cfg.window_config
        self.wc = wc
        self.use_native = cfg.use_native
        self.traj = Trajectory(cfg.knot_dt, cfg.ld_init, cfg.fix_ld,
                               cfg.ld_lower, cfg.ld_upper)
        self.features = self._new_feature_table()
        self.q_CtoI = np.asarray(q_CtoI, dtype=np.float64)
        self.p_CinI = np.asarray(p_CinI, dtype=np.float64)

        self.imu_t_ns = np.zeros(0, np.int64)
        self.imu_gyro = np.zeros((0, 3))
        self.imu_accel = np.zeros((0, 3))

        self.kf_t_ns = np.zeros(wc.NB, np.int64)
        self.bg = np.zeros((wc.NB, 3))
        self.ba = np.zeros((wc.NB, 3))
        self.gravity = np.array([0.0, 0.0, cfg.gravity_mag])

        # host spans: `timing` holds each phase's cumulative seconds
        self._spans = spans.Recorder(frame_root="process_frame")
        self._span = self._spans.span
        self.timing = self._spans.timing
        # device stamps and their clock (`trace`)
        self._stamps: Optional[spans.StampRing] = None
        self._stamping = False
        self._clock = spans.Clock()
        # solve kind -> each solve's LM iteration count, in order: an int,
        # or a streamed summary's device scalar not read yet (`lm_iters`)
        self._iters_log = defaultdict(list)
        self.counts = defaultdict(int)
        self.check_dispatch_syncs = False
        self.sync_warnings: List[str] = []
        self.initialized = False
        self.frame_count = 0
        self.data_start_ns: Optional[int] = None
        self.prior: Optional[PriorFactor] = None   # solve dtype
        self._prior64: Optional[PriorFactor] = None  # f64 marg chain
        self._init_prior: Optional[PriorFactor] = None  # stream handoff seed
        self.win_knot0 = 0
        self.marg_flag = MARGIN_OLD
        self.keyframes: List[KeyframePose] = []
        self.last_solve_stats = None
        self._pending_frames: deque = deque()
        self.tracker = None

        # self-bootstrap state; recent frames replay into a fresh
        # initializer when a bootstrap is rejected
        self._static_init: Optional[StaticInitializer] = None
        self._active_init: Optional[ActiveInitializer] = None
        self._pending_init: Optional[InitialState] = None
        self._vio_init = None
        self._recent_frames: deque = deque(maxlen=wc.NB + 4)

        # streaming state
        self._stream_frame_no = 0
        self._stream_pending: deque = deque()
        self._dev_state: Optional[stream.DevState] = None
        self._prev_slot_fids: dict = {}
        self._dev_knot_hi = 0  # global knot index the device has seeds through
        self._dispatch_no = -1
        self._mirror_solved_hi: Optional[int] = None
        # batched serving (`parallel.stream_batch.BatchedStream`): with a
        # hook set, a streamed dispatch hands (self, blob, host_seeds, meta)
        # to the coordinator, which owns the device state of every lane
        self._dispatch_hook = None
        self._dev_dispatched = False

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
            ld_upper=cfg.ld_upper, tol=cfg.ba_tol, solver=cfg.solver,
            cg_iters=cfg.cg_iters)
        self._init_opts = self._ba_opts._replace(
            max_iters=cfg.init_ba_iters, tol=0.0, solver="chol")
        self._predict_opts = SolveOptions(
            max_iters=cfg.predict_iters, lock_bias=True, fix_ld=True)
        # the IMU-only predict touches no image factors or landmarks
        self._predict_cfg = wc._replace(OBS=8, LM=8)
        self._predict_img = _empty_image_factors(self._predict_cfg,
                                                 _np_dtype(jdt))
        self._predict_bias = BiasFactors(
            sqrt_info=np.zeros((wc.NB - 1, 6), _np_dtype(jdt)),
            valid=np.zeros(wc.NB - 1, bool))
        self._predict_prior = empty_prior(self._predict_cfg, jdt, self.device)
        # the streamed megastep's programs (their state is this estimator's)
        self._programs = graphs.ProgramCache()
        # the marg subset keeps its image factors but compacts landmarks
        # into dense slots
        self._marg_cfg = wc._replace(OBS=min(wc.OBS, 512),
                                     MIMU=max(wc.MIMU // 4, 64), LM=96)

    # ------------------------------------------------------------------
    def _t(self, x, dtype=None):
        return tensor(x, self.device, dtype)

    def _dev(self, nt, dtype=None):
        return from_numpy(nt, self.device, dtype)

    def _new_feature_table(self):
        if self.use_native:
            from .native import NativeFeatureTable

            return NativeFeatureTable(self.wc.NB - 1, self.cfg.min_parallax)
        return FeatureTable(self.wc.NB - 1, self.cfg.min_parallax)

    def _sync_program(self, fn, *args, label=None, **static):
        """`fn(*args, **static)` as the process's shared program of that key
        on this estimator's device (eager on the CPU), named `label` in the
        records if given; returns its output, which the program's next
        call overwrites."""
        return _SYNC_PROGRAMS.get(fn, args, self.device, static,
                                  label=label)(*args)

    def lm_iters(self) -> dict:
        """Every solve's LM iteration count (the iteration at which it was
        done, or its `max_iters`), in order, by kind: "predict" and
        "bootstrap" (the first window's IMU-only fit and f64 BA), "sync"
        (window solves of the synchronous schedule) and "stream" (the
        streamed frames whose summaries were consumed). Reads the counts of
        summaries that were not pulled: call it between frames."""
        out = {}
        for kind, log in self._iters_log.items():
            dev = [i for i, v in enumerate(log) if torch.is_tensor(v)]
            if dev:
                vals = torch.stack([log[i] for i in dev]).cpu().tolist()
                for i, v in zip(dev, vals):
                    log[i] = v
            out[kind] = [int(v) for v in log]
        return out

    def lm_iters_record(self) -> dict:
        """`lm_iters` as a histogram a kind (`iters_histogram`), beside each
        kind's `max_iters`: what a run's stats report."""
        its, cfg = self.lm_iters(), self.cfg
        most = dict(predict=cfg.predict_iters, bootstrap=cfg.init_ba_iters,
                    sync=cfg.ba_iters, stream=cfg.ba_iters)
        return {"hist": {k: iters_histogram(v) for k, v in its.items()},
                "max_iters": {k: most[k] for k in its}}

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def process_imu(self, t_ns: int, gyro, accel, quat=None):
        """quat (wxyz, optional): the IMU message's own attitude estimate,
        which the static bootstrap takes when its stillness test cannot
        pass (≙ `sensor_msgs/Imu.orientation` in ActiveInitialIMUState)."""
        with self._span("process_imu"):
            self._process_imu(t_ns, gyro, accel, quat)

    def _process_imu(self, t_ns: int, gyro, accel, quat):
        if self.data_start_ns is None and self.cfg.bootstrap != "external":
            self._boot_feed_imu(int(t_ns), gyro, accel, quat)
        if self.data_start_ns is not None:
            t_ns = int(t_ns) - self.data_start_ns
        self.imu_t_ns = np.append(self.imu_t_ns, np.int64(t_ns))
        self.imu_gyro = np.vstack([self.imu_gyro, np.asarray(gyro)[None]])
        self.imu_accel = np.vstack([self.imu_accel, np.asarray(accel)[None]])
        if self.initialized:
            self._drain_pending_frames()

    # ------------------------------------------------------------------
    # self-bootstrap (≙ the init state machine in ProcessVIOData,
    # `odometry_manager.cpp:178-247`)
    # ------------------------------------------------------------------
    def _boot_feed_imu(self, t_ns, gyro, accel, quat=None):
        cfg = self.cfg
        if cfg.bootstrap == "static":
            if self._static_init is None:
                self._static_init = StaticInitializer(
                    excite_threshold=0.5, gravity_mag=cfg.gravity_mag)
                self._active_init = ActiveInitializer(
                    gravity_mag=cfg.gravity_mag)
            # static first, then the orientation-based fallback
            # (≙ IMUInitializer::InitialIMUState)
            st = self._static_init.feed(t_ns, gyro, accel)
            if st is None and quat is not None:
                st = self._active_init.feed(t_ns, quat)
            if st is not None:
                self._pending_init = st
        elif cfg.bootstrap == "visual":
            if self._vio_init is None:
                from .vio_init import VIOInitializer

                self._vio_init = VIOInitializer(
                    self.q_CtoI, self.p_CinI, gravity_mag=cfg.gravity_mag,
                    window_size=self.wc.NB - 1,
                    excite_threshold=cfg.excite_threshold)
            with self._span("vio_init"):
                self._vio_init.feed_imu(t_ns, gyro, accel)

    def _boot_feed_frame(self, t_ns, ids, pts) -> bool:
        """True once the bootstrap produced an initial state (and
        set_initial_state was applied)."""
        st = None
        if self.cfg.bootstrap == "static":
            st = self._pending_init
            if st is not None:
                st.t_ns = t_ns  # anchor at this frame
        elif self.cfg.bootstrap == "visual" and self._vio_init is not None:
            with self._span("vio_init"):
                st = self._vio_init.feed_frame(t_ns, ids, pts)
        if st is None:
            return False
        self.counts["bootstrap_" + self.cfg.bootstrap] += 1
        self.set_initial_state(st.t_ns, st.q, st.p, st.bg, st.ba, st.gravity,
                               v0=st.v)
        return True

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
    def attach_frontend(self, camera, image_shape, tracker_cfg=None,
                        fused: bool = True):
        """Attach the KLT front end, on this estimator's device, so that raw
        images can be fed. fused=True without `tracker_cfg.reject_wf` gives
        the slot-identity `FusedTracker` with gyro-predicted initial flow
        from this estimator's own IMU buffer and gyro-bias estimate;
        otherwise the classic multi-dispatch `FeatureTracker`, which runs
        the F-RANSAC gate on published frames (the JAX package's routing)."""
        from ctrlvio_tpu_torch.frontend.fused import FusedTracker
        from ctrlvio_tpu_torch.frontend.tracker import (FeatureTracker,
                                                        TrackerConfig)

        tcfg = tracker_cfg or TrackerConfig()
        if fused and not tcfg.reject_wf:
            self.tracker = FusedTracker(tcfg, camera, image_shape,
                                        device=self.device)
        else:
            self.tracker = FeatureTracker(tcfg, camera, image_shape,
                                          device=self.device)
        self._prev_img_t_ns = None
        self._img_first_t_ns = None
        self._img_pub = 0

    def process_image(self, t_ns: int, img):
        """Feed one raw image: CLAHE -> pyramidal KLT (gyro-predicted with
        the fused tracker) -> undistort -> feature frame -> per-frame
        estimation. Returns the pose like process_frame, or None for
        rate-gated frames / pre-init."""
        if self.tracker is None:
            raise RuntimeError("call attach_frontend(camera, image_shape) first")
        from ctrlvio_tpu_torch.frontend.fused import (FusedTracker,
                                                      rotation_flow)

        if not isinstance(self.tracker, FusedTracker):
            out = self.tracker.process(int(t_ns), img)  # rate-gated inside
            if out is None:
                return None
            return self.process_frame(out["t_ns"], out["ids"], out["pts"],
                                      out["rows"])
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
        with self._span("process_frame"):
            return self._process_frame(t_ns, ids, pts, rows)

    def _process_frame(self, t_ns: int, ids, pts, rows):
        boot = self.cfg.bootstrap != "external"
        if boot and not self.initialized:
            # absolute times: a rejected bootstrap replays these into a
            # fresh initializer
            self._recent_frames.append(
                (int(t_ns), np.asarray(ids).copy(), np.asarray(pts).copy(),
                 np.asarray(rows).copy()))
        if self.data_start_ns is None:
            if not boot:
                raise RuntimeError("call set_initial_state first")
            if not self._boot_feed_frame(int(t_ns), ids, pts):
                return None
            # this frame becomes the first window frame
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
        stream_active = False
        if self.cfg.stream:
            self._stream_frame_no += 1
            stream_active = self._stream_frame_no > self.cfg.stream_warmup
        if stream_active:
            with self._span("consume"):
                self._consume_due()

        with self._span("add_frame"):
            is_kf = self.features.add_frame(wc.NB - 1, ids, pts, rows)
            self.marg_flag = MARGIN_OLD if is_kf else MARGIN_SECOND_NEW
            self.kf_t_ns[wc.NB - 1] = t_ns
            self.bg[wc.NB - 1] = self.bg[wc.NB - 2]
            self.ba[wc.NB - 1] = self.ba[wc.NB - 2]

        with self._span("predict"):
            self._extend_and_predict(t_ns)
        with self._span("triangulate"):
            self._triangulate()

        if stream_active:
            with self._span("dispatch"):
                self._stream_dispatch()
            with self._span("slide"):
                self._slide_window(record_keyframe=False)
            # online forecast: raw IMU integrated from the newest solved
            # spline state to t_ns (the spline's extrapolated tip carries
            # the dead-reckon seeds' representation error)
            with self._span("forecast"):
                return self._forecast_pose(t_ns)

        with self._span("ba"):
            self._solve_window_ba()
        with self._span("slide"):
            self._slide_window()
        if self.cfg.debug_residual_summary:
            print(self.residual_summary().report(), file=sys.stderr)
        q, p = self.traj.pose(t_ns)
        return q[0], p[0]

    def _consume_due(self):
        """Consume the summaries that are due (lagged host mirror); the lag
        ramps open over the first streamed frames so the mirror stays
        fresh right after the warmup handoff."""
        since = self._stream_frame_no - self.cfg.stream_warmup
        lag = min(self.cfg.stream_lag, max(0, since - 5))
        n_before = len(self._stream_pending)
        self._consume_summaries(lag)
        if len(self._stream_pending) < n_before:
            # re-integrate the mirror's dead-reckoned tail from the
            # freshly solved end, or the tip knots chain off stale
            # states and the online estimate random-walks
            with self._span("consume_dr"):
                hi = self._mirror_solved_hi
                if hi < self.traj.n:
                    self._deadreckon_extension(
                        int((hi - 3) * self.traj.dt_ns), hi - 1,
                        self.traj.max_time_ns)

    def flush(self):
        """End of stream (call before reading final poses, keyframes or
        the line delay): solve the frames still queued behind the
        IMU-coverage check, then drain every in-flight stream summary into
        the host mirror, and with recording on every queued stamp row
        (one wait)."""
        q = self._pending_frames
        last_imu = int(self.imu_t_ns[-1]) if len(self.imu_t_ns) else -1
        while q and q[0][0] <= last_imu:
            self._process_frame_ready(*q.popleft())
        while self._stream_pending:
            batch = [self._stream_pending.popleft()]
            # extend to the next fetched entry (or the very end)
            while self._stream_pending and not batch[-1][2]:
                batch.append(self._stream_pending.popleft())
            self._apply_summary_batch(batch)
        if self._stamps is not None:
            self._stamps.poll(wait=True)

    # ------------------------------------------------------------------
    def residual_summary(self):
        """Per-factor-type residual statistics at the current estimate
        (≙ the reference's per-solve ResidualSummary,
        `trajectory_estimator.cpp:69-95`, its de-facto regression signal).
        Re-packs the current window and linearizes it in f64 on the device
        at the host-mirror state; a diagnostic path, off the hot loop."""
        from ctrlvio_tpu_torch.solver import assemble
        from ctrlvio_tpu_torch.utils.summary import ResidualSummary

        self.flush()
        wc, f64 = self.wc, torch.float64
        win0 = self.traj.ctrl_idx(self.kf_t_ns[0])
        kq, kp, _ = self.traj.window(win0, wc.KW, np.float64)
        if self.use_native:
            img, dinv0, _ = self.features.pack_image_factors(
                self.kf_t_ns, self.traj.dt, win0, wc, np.float64)
        else:
            img, dinv0, _ = packing.pack_image_factors(
                list(self.features.tracks.values()), self.kf_t_ns,
                self.traj.dt, win0, wc, np.float64)
        imu = packing.pack_imu_factors(
            self.imu_t_ns, self.imu_gyro, self.imu_accel, self.kf_t_ns,
            win0 * int(self.traj.dt_ns), self.traj.max_time_ns, self.traj.dt,
            win0, wc, np.float64, on_overflow="subsample")
        bias = packing.bias_sqrt_info(self.imu_t_ns, self.kf_t_ns,
                                      self.cfg.sigma_bg, self.cfg.sigma_ba,
                                      wc, np.float64)
        prior = self.prior
        if self.cfg.stream and self._dev_state is not None:
            prior = self._dev_state.prior
        prior = (empty_prior(wc, f64, self.device) if prior is None
                 else to_dtype(prior, f64))
        params = WindowParams(
            knots_q=self._t(kq, f64), knots_p=self._t(kp, f64),
            bg=self._t(self.bg, f64), ba=self._t(self.ba, f64),
            dinv=self._t(dinv0, f64), ld=self._t(self.traj.line_delay, f64))
        lin = assemble.linearize(
            params, self._dev(img, f64), self._dev(imu, f64),
            self._dev(bias, f64), prior, to_dtype(self._ext, f64),
            self._t(self.gravity, f64), self._imu_info.to(f64),
            self._sqrt_info_img.to(f64), wc, self._ba_opts)
        return ResidualSummary.from_linearization(lin, wc)

    def _forecast_pose(self, t_ns: int):
        """Online pose at t_ns: midpoint IMU integration from the newest
        image-constrained spline state."""
        dt_ns = int(self.traj.dt_ns)
        hi = (self.traj.n if self._mirror_solved_hi is None
              else self._mirror_solved_hi)
        # the last ~3 knots before hi are weakly constrained; anchor below
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
        with self._span("boot_predict"):
            self._extend_and_predict(t_ns, from_start=True)
        self._triangulate()
        n_img_obs = self._init_solve_f64()
        # quality gate in measurement units: the RMS weighted residual per
        # image-observation coordinate (1.0 = residuals at the configured
        # sigma); a solve stuck outside the basin sits at many sigma
        cost = float(self.last_solve_stats.cost)
        rms = np.sqrt(2.0 * cost / max(2 * n_img_obs, 1))
        if self.cfg.bootstrap != "external":
            verdict = ("rejected" if rms > self.cfg.init_max_rms
                       else "accepted")
            print(f"[ctrlvio] bootstrap {verdict} (init BA residual RMS "
                  f"{rms:.2f} sigma, limit {self.cfg.init_max_rms}, cost "
                  f"{cost:.1f} over {n_img_obs} obs)", file=sys.stderr)
            if rms > self.cfg.init_max_rms:
                # retry with a later window (≙ the reference's init retried
                # every frame, `vio_initial.cpp:42-56`)
                self.counts["bootstrap_rejected"] += 1
                self._reset_bootstrap()
                return None
        self._slide_window()
        self.initialized = True
        q, p = self.traj.pose(t_ns)
        return q[0], p[0]

    # ------------------------------------------------------------------
    def _reset_bootstrap(self):
        """Roll back a rejected initialization and re-arm the bootstrap.
        Buffered IMU and the recent feature frames replay into a fresh
        initializer so the retry uses the newest window."""
        shift = self.data_start_ns
        self.data_start_ns = None
        self.imu_t_ns = self.imu_t_ns + shift  # back to absolute time
        self.frame_count = 0
        self.kf_t_ns[:] = 0
        self.bg[:] = 0.0
        self.ba[:] = 0.0
        self.prior = None
        self._prior64 = None
        self._init_prior = None
        self._stream_frame_no = 0
        self._dev_knot_hi = 0
        self.traj = Trajectory(self.cfg.knot_dt, self.cfg.ld_init,
                               self.cfg.fix_ld, self.cfg.ld_lower,
                               self.cfg.ld_upper)
        self.features = self._new_feature_table()
        self._static_init = self._active_init = None
        self._pending_init = None
        self._vio_init = None
        if self.cfg.bootstrap == "visual":
            for k in range(len(self.imu_t_ns)):
                self._boot_feed_imu(int(self.imu_t_ns[k]), self.imu_gyro[k],
                                    self.imu_accel[k])
            for (t_abs, ids, pts, rows) in list(self._recent_frames):
                if self.data_start_ns is not None:
                    break  # a replayed window already re-initialized
                self._boot_feed_frame(t_abs, ids, pts)

    # ------------------------------------------------------------------
    def _pack_window(self, dtype):
        """Image, IMU and bias factors of the current window (numpy); the
        python table also returns its candidate tracks (None for the native
        one)."""
        wc, cfg = self.wc, self.cfg
        if self.use_native:
            img, dinv0, _ = self.features.pack_image_factors(
                self.kf_t_ns, self.traj.dt, self.win_knot0, wc, dtype)
            # the library packs f32; the solve takes its own dtype
            img = ImageFactors(*(f.astype(dtype) if f.dtype.kind == "f"
                                 else f for f in img))
            cands = None
        else:
            img, dinv0, cands = packing.pack_image_factors(
                list(self.features.tracks.values()), self.kf_t_ns,
                self.traj.dt, self.win_knot0, wc, dtype)
        t_lo = self.win_knot0 * int(self.traj.dt_ns)
        imu = packing.pack_imu_factors(
            self.imu_t_ns, self.imu_gyro, self.imu_accel, self.kf_t_ns,
            t_lo, self.traj.max_time_ns, self.traj.dt, self.win_knot0, wc,
            dtype, on_overflow=cfg.imu_overflow)
        bias = packing.bias_sqrt_info(self.imu_t_ns, self.kf_t_ns,
                                      cfg.sigma_bg, cfg.sigma_ba, wc, dtype)
        return img, dinv0, cands, imu, bias

    def _set_depths(self, dinv, cands):
        """Solved inverse depths (pack slot order) into the feature table."""
        if self.use_native:
            self.features.set_depths(np.asarray(dinv, np.float32))
        else:
            self.features.set_depths(dinv, cands)

    def _init_solve_f64(self):
        """One-time f64 bootstrap BA + square-root marginalization prior on
        the device (≙ the first UpdateTrajectory after SetInitialState).
        The solve is one program (`window_solve` in f64, `init_ba_iters`
        iterations at tol 0, so no iteration is skipped), replayed by a
        retried bootstrap; the prior is built eagerly from its output on
        the device. Returns the number of image observations of the
        window. Times "boot_solve" and "boot_prior"."""
        with self._span("boot_solve"):
            wc, cfg = self.wc, self.cfg
            f64 = torch.float64
            self.win_knot0 = self.traj.ctrl_idx(self.kf_t_ns[0])
            kq, kp, n_active = self.traj.window(self.win_knot0, wc.KW,
                                                np.float64)
            img, dinv0, _, imu, bias = self._pack_window(np.float64)
            fixed = np.ones(wc.KW, bool)
            fixed[:n_active] = False
            ext64 = F.CamExtrinsics(q_CtoI=self._t(self.q_CtoI, f64),
                                    p_CinI=self._t(self.p_CinI, f64))
            grav64 = self._t(self.gravity, f64)
            info64 = self._imu_info.to(f64)
            w64 = self._sqrt_info_img.to(f64)
            opts = self._init_opts
            blob = blob_pack(img, imu, bias, kq, kp, self.bg, self.ba, dinv0,
                             self.traj.line_delay, fixed, np.float64)
            # a copy: the prior keeps views of it as its linearization point,
            # and another estimator's bootstrap replays the same program
            solved = unpack_solved(self._sync_program(
                window_solve, self._upload(blob), empty_prior(wc, f64,
                                                              self.device),
                ext64, grav64, info64, w64, cfg=wc, opts=opts,
                ne_mode=cfg.ne_mode, chunk=cfg.ne_chunk, restore=True,
                label="window_solve(bootstrap, float64)").clone(), wc)
            p_out = WindowParams(*(solved[k] for k in WindowParams._fields))
            host = {k: v.cpu().numpy() for k, v in solved.items()}
            self._iters_log["bootstrap"].append(int(host["iters"]))

        with self._span("boot_prior"):
            k1 = self.traj.ctrl_idx(self.kf_t_ns[1]) - self.win_knot0
            drop = np.zeros(wc.KW, bool)
            drop[:k1] = True
            prior64, ovf = marginalize.build_prior_sqrt(
                p_out, self._dev(img, f64), self._dev(imu, f64),
                self._dev(bias, f64), empty_prior(wc, f64, self.device),
                self._t(drop), ext64, grav64, info64, w64, wc,
                opts._replace(cauchy_c=1.0), knot_shift=k1, bias_shift=1,
                return_overflow=True, caps=cfg.marg_caps, n_drop_knots=k1)
            self._count_marg_overflow(ovf.cpu().numpy())

        self.last_solve_stats = SimpleNamespace(
            cost0=float(host["cost0"]), cost=float(host["cost"]),
            accepted=float(host["accepted"]), iters=float(host["iters"]))
        self.traj.write_back(self.win_knot0, host["knots_q"],
                             host["knots_p"], n_active)
        self.bg = host["bg"].astype(np.float64)
        self.ba = host["ba"].astype(np.float64)
        if not cfg.fix_ld:
            self.traj.line_delay = float(np.clip(
                float(host["ld"]), cfg.ld_lower, cfg.ld_upper))
        dinv_np = host["dinv"].astype(np.float64)
        if self.use_native:
            self.features.set_depths(dinv_np.astype(np.float32))
        else:
            self.features.set_depths_by_id(self.features.slot_fids(wc.LM),
                                           dinv_np[: wc.LM])
        # the f64 prior seeds the per-frame f64 marg chain; the solve-dtype
        # copy rides in the window solves and, with no warmup, seeds the
        # device stream state
        self._prior64 = prior64
        self.prior = to_dtype(prior64, self.jdt)
        if cfg.stream:
            self._init_prior = self.prior
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
            with self._span("predict_dr"):
                self._deadreckon_extension(max_bef_ns, max_bef_idx,
                                           max_aft_ns)
            return

        pc = self._predict_cfg
        npdt = _np_dtype(self.jdt)
        kq, kp, n_active = self.traj.window(self.win_knot0, pc.KW, np.float64)
        imu = packing.pack_imu_factors(
            self.imu_t_ns, self.imu_gyro, self.imu_accel, self.kf_t_ns,
            0, max_aft_ns, self.traj.dt, self.win_knot0, pc,
            npdt, on_overflow=self.cfg.imu_overflow)
        fixed = np.ones(wc.KW, bool)
        fixed[4:n_active] = False
        blob = blob_pack(self._predict_img, imu, self._predict_bias, kq, kp,
                         self.bg, self.ba, np.full(pc.LM, 0.2),
                         self.traj.line_delay, fixed, npdt)
        host = self._sync_program(
            window_solve, self._upload(blob), self._predict_prior, self._ext,
            self._gravity_j, self._imu_info, self._sqrt_info_img, cfg=pc,
            opts=self._predict_opts, ne_mode=self.cfg.ne_mode,
            chunk=self.cfg.ne_chunk, restore=False).cpu().numpy()
        s = unpack_solved(host, pc)
        self._iters_log["predict"].append(int(s["iters"]))
        self.traj.write_back(self.win_knot0, s["knots_q"], s["knots_p"],
                             n_active)

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
        self.counts["sync_solve"] += 1
        if self._dev_state is not None or self._dev_dispatched:
            self.counts["sync_solve_after_handoff"] += 1
        with self._span("ba_pack"):
            wc, cfg = self.wc, self.cfg
            jdt = self.jdt
            npdt = _np_dtype(jdt)
            self.win_knot0 = self.traj.ctrl_idx(self.kf_t_ns[0])
            span = self.traj.n - self.win_knot0
            if span > wc.KW:
                raise RuntimeError(
                    f"window spans {span} knots > KW={wc.KW}: keyframe gaps "
                    f"too large for the configured knot capacity; raise "
                    f"WindowConfig.KW")
            kq, kp, n_active = self.traj.window(self.win_knot0, wc.KW,
                                                np.float64)
            img, dinv0, cands, imu, bias = self._pack_window(npdt)
            # no knot is hard-fixed: LM damping spans the 4-DoF gauge null
            # space and the post-solve restore re-anchors yaw + position
            fixed = np.ones(wc.KW, bool)
            fixed[:n_active] = False
            blob = blob_pack(img, imu, bias, kq, kp, self.bg, self.ba, dinv0,
                             self.traj.line_delay, fixed, npdt)
            prior = self.prior if self.prior is not None else \
                empty_prior(wc, jdt, self.device)

        # [5+6] the solve and the gauge restore as one program: one upload,
        # one pull (≙ `_ba_fused`)
        with self._span("ba_solve"):
            host = self._sync_program(
                window_solve, self._upload(blob), prior, self._ext,
                self._gravity_j, self._imu_info, self._sqrt_info_img, cfg=wc,
                opts=self._ba_opts, ne_mode=cfg.ne_mode, chunk=cfg.ne_chunk,
                restore=True).cpu().numpy().astype(np.float64)
        s = unpack_solved(host, wc)
        kq_np, kp_np, bg_np, ba_np = (s["knots_q"], s["knots_p"], s["bg"],
                                      s["ba"])
        dinv_np, ld_np = s["dinv"], s["ld"]
        self.last_solve_stats = SimpleNamespace(
            cost0=s["cost0"], cost=s["cost"], accepted=s["accepted"],
            iters=s["iters"])
        self._iters_log["sync"].append(int(s["iters"]))

        with self._span("ba_writeback"):
            self.traj.write_back(self.win_knot0, kq_np, kp_np, n_active)
            if not cfg.fix_ld:
                self.traj.line_delay = float(ld_np)
            self.bg = bg_np.copy()
            self.ba = ba_np.copy()
            self._set_depths(dinv_np, cands)

        # [7] marginalization prior at the gauge-restored state, pre-rolled
        # into the post-slide layout: in f64 on the device (the Schur
        # complement spans too much dynamic range for f32) or, with
        # marg_on_host=False, in the solve dtype; a program of its own,
        # one per dtype, the shifts riding in its upload
        if self.marg_flag != MARGIN_OLD:
            return
        with self._span("prior"):
            k1 = self.traj.ctrl_idx(self.kf_t_ns[1]) - self.win_knot0
            drop = np.zeros(wc.KW, bool)
            drop[:k1] = True
            mc = self._marg_cfg
            img_m = _compact_factors(img, img.valid & img.marg_drop, mc.OBS)
            imu_m = _compact_factors(imu, imu.valid & imu.marg_drop, mc.MIMU)
            img_m, dinv_m = _compact_landmarks(img_m, dinv_np, mc.LM)
            knot_shift = (self.traj.ctrl_idx(self.kf_t_ns[1])
                          - self.traj.ctrl_idx(self.kf_t_ns[0]))
            # marg_on_host=False: the chain stays in the solve dtype (the old
            # prior is the solve-dtype one) and the f64 chain ends
            dt = torch.float64 if cfg.marg_on_host else jdt
            old = self._prior64 if cfg.marg_on_host else None
            if old is None:
                old = to_dtype(prior, dt)
            blob = blob_pack(img_m, imu_m, bias, kq_np, kp_np, bg_np, ba_np,
                             dinv_m, ld_np, drop, _np_dtype(dt),
                             tail=(*self.gravity, knot_shift, 1))
            built = graphs.clone(self._sync_program(
                marg_prior, self._upload(blob), old, self._ext, self._imu_info,
                self._sqrt_info_img, cfg=mc,
                opts=self._ba_opts._replace(cauchy_c=1.0)))
            self._prior64 = built if cfg.marg_on_host else None
            self.prior = to_dtype(built, jdt)

    # ------------------------------------------------------------------
    def _slide_window(self, record_keyframe: bool = True):
        wc = self.wc
        nb = wc.NB
        if self.marg_flag == MARGIN_OLD:
            if record_keyframe:
                # the keyframe leaving the window (the stream records it
                # when its summary is consumed, where the pose is final)
                q, p = self.traj.pose(self.kf_t_ns[0])
                self.keyframes.append(
                    KeyframePose(int(self.kf_t_ns[0]), q[0], p[0]))
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

    # ------------------------------------------------------------------
    # streaming pipeline (device-resident state; see estimator/stream.py)
    # ------------------------------------------------------------------
    def _stream_dispatch(self):
        """Pack this frame's inputs into one blob and chain the device
        megastep, with no host read (steps 5-8 on the device)."""
        with self._span("pack"):
            blob, host_seeds, meta = self._stream_pack()
        if self._dispatch_hook is not None:
            # the coordinator runs one batched megastep for every lane in
            # lockstep and hands this lane's summary to _stream_complete
            self._dev_dispatched = True
            self._dispatch_hook(self, blob, host_seeds, meta)
            return
        with self._span("megastep"):
            self._stream_megastep(blob, host_seeds, meta)

    def _stream_pack(self):
        """This frame's blob, whether its knot seeds come from the host,
        and what the host keeps of it until its summary is consumed."""
        wc = self.wc
        npdt = _np_dtype(self.jdt)
        self.win_knot0 = self.traj.ctrl_idx(self.kf_t_ns[0])
        span = self.traj.n - self.win_knot0
        if span > wc.KW:
            raise RuntimeError(
                f"window spans {span} knots > KW={wc.KW}; raise WindowConfig.KW")
        kq, kp, n_active = self.traj.window(self.win_knot0, wc.KW, np.float64)
        img, dinv0, _, imu, bias = self._pack_window(npdt)
        slot_fids = self.features.slot_fids(wc.LM)
        fixed = np.ones(wc.KW, bool)
        fixed[:n_active] = False

        # knot seeds: only knots appended since the last dispatch. On the
        # first dispatch (warmup handoff) the host mirror is authoritative
        # and uploads values; afterwards the seeds are dead-reckoned on the
        # device from its own spline end (`stream._extend_inertial`), which
        # also re-seeds the weakly constrained last 3 knots. A hooked lane
        # never holds a device state of its own: its first dispatch is the
        # handoff
        hooked = self._dispatch_hook is not None
        host_seeds = (not self._dev_dispatched if hooked
                      else self._dev_state is None)
        seed_mask = np.zeros(wc.KW, bool)
        lo_rel = 0 if host_seeds else max(self._dev_knot_hi - self.win_knot0, 0)
        seed_lo = lo_rel if host_seeds else max(lo_rel - 3, 4, 0)
        seed_mask[seed_lo:n_active] = True
        self._dev_knot_hi = self.win_knot0 + n_active

        # landmark slot permutation: current slot -> previous dispatch's
        # slot (the device's dinv holds for persisting landmarks; fresh
        # slots take the host seed)
        perm = np.full(wc.LM, -1, np.int32)
        if not host_seeds:
            prev = self._prev_slot_fids
            for i, fid in enumerate(slot_fids):
                perm[i] = prev.get(int(fid), -1)
        self._prev_slot_fids = {int(f): i for i, f in enumerate(slot_fids)}

        marg_old = self.marg_flag == MARGIN_OLD
        k1 = self.traj.ctrl_idx(self.kf_t_ns[1]) - self.win_knot0
        drop = np.zeros(wc.KW, bool)
        knot_shift = 0
        if marg_old:
            drop[:k1] = True
            knot_shift = k1
        g0i, g0f = packing.grid_of(self.kf_t_ns[0:1], self.traj.dt,
                                   self.win_knot0)
        g1i, g1f = packing.grid_of(self.kf_t_ns[1:2], self.traj.dt,
                                   self.win_knot0)
        blob = stream.pack_stream_blob(
            img, imu, bias, fixed, kq, kp, seed_mask, perm, dinv0, drop,
            marg_old, knot_shift, (g0i[0], g0f[0]), (g1i[0], g1f[0]),
            old_hi=lo_rel, new_hi=n_active, host_seeds=host_seeds,
            dtype=npdt)
        meta = dict(win_knot0=self.win_knot0, n_active=n_active,
                    kf0_t_ns=int(self.kf_t_ns[0]), marg_old=marg_old,
                    slot_fids=slot_fids)
        return blob, host_seeds, meta

    def _stream_megastep(self, blob, host_seeds: bool, meta):
        """Chain this estimator's megastep on `blob`, and queue its
        summary (and, recording, its stamp row)."""
        cfg = self.cfg
        if self._dev_state is None:
            # warmup handoff: the synchronous warmup's f64 prior (cast,
            # post-slide) seeds the device chain
            self._dev_state = self._initial_dev_state()
        with self._span("upload"):
            blob = self._upload(blob)
        # one program a slide branch and seed source, the window roll read
        # from the blob on the device; captured (first use) before the
        # check, which counts the host reads of staging and replay;
        # recording, a stamped program of its own
        args = (self._dev_state, blob, self._ext, self._gravity_j,
                self._imu_info, self._sqrt_info_img)
        static = dict(cfg=self.wc, opts=self._ba_opts,
                      marg_old=meta["marg_old"], host_seeds=host_seeds,
                      caps=cfg.marg_caps, ne_mode=cfg.ne_mode,
                      chunk=cfg.ne_chunk)
        if self._stamping:
            static["stamps"] = self._stamps
        step = self._programs.get(stream.megastep, args, self.device,
                                  static, carry=True)
        with self._sync_check():
            with self._span("replay"):
                self._dev_state, summary = step(*args)
            with self._span("enqueue_summary"):
                self._enqueue_summary(meta, summary)
            if self._stamping:
                self._stamps.queue(self._spans.frame(), meta["marg_old"])
        self.counts["megastep"] += 1

    def trace(self, on: bool = True):
        """Record host spans and device stamps from now on, or stop
        (`utils/spans.py`; `trace_record` gives what was recorded). Call
        it before the first capture: a stamped streamed megastep is a
        program of its own (an unstamped one holds no stamp node), so
        switching later captures it then. Starting and stopping each
        calibrate the stamps' clock against the host's (~20 synchronized
        stamps); stopping waits once for the stamp rows still queued.
        Recording adds no host read to a frame."""
        if on:
            if self._stamps is None:
                self._stamps = spans.StampRing(self.device,
                                               self._ba_opts.max_iters - 1)
            self._clock.calibrate(self.device)
            self._spans.start()
        elif self._spans.on:
            self._stamps.poll(wait=True)
            self._clock.calibrate(self.device)
            self._spans.stop()
        self._stamping = on

    def trace_record(self) -> dict:
        """What recording gathered: `spans` (`spans.Recorder.record`: the
        host spans on `time.time_ns()`), `megasteps` (`spans.StampRing.
        record`: each stamped megastep's row, on the host's clock),
        `clock` (the calibrations: host ns, offset ns, error ns) and
        `clock_error_ns` (the largest error)."""
        return {"spans": self._spans.record(),
                "megasteps": (None if self._stamps is None
                              else self._stamps.record(self._clock)),
                "clock": list(self._clock.calibrations),
                "clock_error_ns": self._clock.error_ns()}

    @contextlib.contextmanager
    def _sync_check(self):
        """With `check_dispatch_syncs` on a CUDA device: count the
        synchronizing CUDA calls made inside (sync debug mode "warn")."""
        with recorded_syncs(self.check_dispatch_syncs
                            and self.device.type == "cuda") as msgs:
            yield
        self.counts["megastep_syncs"] += len(msgs)
        self.sync_warnings.extend(msgs)

    def _upload(self, blob: np.ndarray) -> torch.Tensor:
        """A blob as a program takes it: on the card a fresh pinned host
        buffer, which the program copies into its static buffer without
        waiting (the caching host allocator does not hand the buffer out
        again before that copy has completed); on the CPU the tensor."""
        src = torch.from_numpy(blob)
        if self.device.type != "cuda":
            return src.to(self.device)
        buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return buf

    def _initial_dev_state(self) -> stream.DevState:
        """Device-resident state for the first dispatch (a batched-serving
        coordinator stacks those of its lanes)."""
        wc, jdt = self.wc, self.jdt
        p0 = empty_params(wc, jdt, self.device)._replace(
            bg=self._t(self.bg, jdt), ba=self._t(self.ba, jdt),
            ld=self._t(self.traj.line_delay, jdt))
        prior0 = self.prior if self.prior is not None else self._init_prior
        if prior0 is None:
            prior0 = empty_prior(wc, jdt, self.device)
        return stream.DevState(params=p0, prior=to_dtype(prior0, jdt))

    def _enqueue_summary(self, meta, summary):
        """Queue a copy of a dispatched frame's summary (the program's
        output, or a lane's row of the batched one, is overwritten by the
        next replay); every k-th is copied to pinned host memory right
        away, without waiting (it has landed long before it is
        consumed), the others on the device."""
        self._dispatch_no += 1
        fetch = (self._dispatch_no % max(self.cfg.stream_consume_every, 1)
                 == 0)
        if fetch and summary.device.type == "cuda":
            host = torch.empty(summary.shape, dtype=summary.dtype,
                               pin_memory=True)
            host.copy_(summary, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            obj = (host, done)
        else:
            obj = summary.clone()
        self._stream_pending.append((meta, obj, fetch))

    def _stream_complete(self, summary, meta):
        """Batched-serving path: the coordinator hands back this lane's
        summary (its row of the batched megastep's output, which
        `_enqueue_summary` copies)."""
        self.counts["megastep"] += 1
        self._enqueue_summary(meta, summary)

    def _consume_summaries(self, max_pending: int):
        """Apply the newest consumable summary (the last fetched one among
        the entries past the lag) to the host mirror; earlier entries are
        dropped without a transfer."""
        n_over = len(self._stream_pending) - max_pending
        if n_over <= 0:
            return
        last = -1
        for i in range(n_over):
            if self._stream_pending[i][2]:
                last = i
        if last < 0:
            return  # the next fetched summary is not past the lag yet
        batch = [self._stream_pending.popleft() for _ in range(last + 1)]
        self._apply_summary_batch(batch)

    def _apply_summary_batch(self, batch):
        """Write the batch's newest summary into the host mirror; record
        keyframes for every marg_old frame of the batch from the mirror
        (their slide-out times are still inside the knot window)."""
        meta, obj, _ = batch[-1]
        with self._span("consume_fetch"):
            if isinstance(obj, tuple):
                host, done = obj
                done.synchronize()
            else:
                host = obj.cpu()  # a CPU run, or an unfetched tail at flush()
            host = host.numpy().astype(np.float64)
        with self._span("consume_apply"):
            self._apply_summary(batch, host)

    def _apply_summary(self, batch, host: np.ndarray):
        """`_apply_summary_batch` once the newest summary is on the host."""
        meta = batch[-1][0]
        s = stream.unpack_summary(host, self.wc)
        self.traj.write_back(meta["win_knot0"], s["knots_q"], s["knots_p"],
                             meta["n_active"])
        self._mirror_solved_hi = meta["win_knot0"] + meta["n_active"]
        nb = self.wc.NB
        # the freshest converged biases drive the host dead-reckoning
        self.bg[:] = s["bg"][nb - 1]
        self.ba[:] = s["ba"][nb - 1]
        if not self.cfg.fix_ld:
            self.traj.line_delay = float(
                np.clip(s["ld"], self.cfg.ld_lower, self.cfg.ld_upper))
        fids = meta["slot_fids"]
        if len(fids):
            self.features.set_depths_by_id(
                fids, s["dinv"][: len(fids)].astype(np.float32))
        self.last_solve_stats = SimpleNamespace(
            cost0=s["cost0"], cost=s["cost"], accepted=s["accepted"],
            iters=s["iters"],
            rms=s["rms"])  # per type [image, imu, bias, prior]
        # every frame's count: the pulled summaries' on the host, the
        # others' (dropped unread) as device scalars, read by `lm_iters`
        log = self._iters_log["stream"]
        for _, o, _ in batch[:-1]:
            log.append(o[0][-1].item() if isinstance(o, tuple) else o[-1])
        log.append(s["iters"])
        self._count_marg_overflow(s["marg_ovf"])
        if self.cfg.debug_residual_summary:
            r = s["rms"]
            print(f"[ResidualSummary/stream] image={r[0]:.3f} imu={r[1]:.3f}"
                  f" bias={r[2]:.3f} prior={r[3]:.3f}", file=sys.stderr)
        for m, _, _ in batch:
            if m["marg_old"]:
                q, p = self.traj.pose(m["kf0_t_ns"])
                self.keyframes.append(KeyframePose(m["kf0_t_ns"], q[0], p[0]))

    def _count_marg_overflow(self, ovf):
        """Count and warn when a square-root marginalization (the
        bootstrap prior or a streamed frame's) exceeded its compacted caps:
        `ovf` holds the excess [obs, imu, lm], whose factors were dropped
        from the prior."""
        if float(np.sum(ovf)) <= 0:
            return
        self.counts["marg_overflow"] += 1
        what = ", ".join(f"{n}+{int(v)}" for n, v in
                         zip(("OBS", "IMU", "LM"), ovf) if v > 0)
        caps = self.cfg.marg_caps or marginalize.marg_caps(self.wc)
        warnings.warn(
            f"marginalization subset overflowed its caps ({what}; "
            f"marg_caps={tuple(caps)}); the excess factors were dropped "
            "from the prior: raise VIOConfig.marg_caps", RuntimeWarning,
            stacklevel=3)


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
