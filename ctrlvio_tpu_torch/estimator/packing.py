"""Host-side packing: ragged window observations -> static-shape factor arrays
(the port's numpy copy of `ctrlvio_tpu/estimator/packing.py`).

The reference walks `std::list<FeaturePerId>` and calls AddResidualBlock per
observation (`trajectory_manager.cpp:360-451`). Here the host packs numpy
arrays once per frame and the device consumes fixed-capacity buffers; slots
beyond the real counts are invalid-masked. int64-ns time arithmetic happens
here (exactly), producing the (segment, fraction) grid coordinates the
kernels use.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ctrlvio_tpu_torch.solver.layout import (BiasFactors, ImageFactors, ImuFactors,
                                       WindowConfig)

S_TO_NS = 1_000_000_000


def auto_landmark_slots(max_cnt: int, floor: int = 256, align: int = 128) -> int:
    """Landmark slot count sized from the tracker's per-frame feature cap.

    Candidate tracks alive in an 11-keyframe window are bounded by the
    per-frame cap plus turnover churn; 3x the cap covers the churn seen on
    textured imagery with margin (the reference simply reserves
    NUM_OF_F = 2000 slots for max_cnt = 150, `parameters.h:10` — a 13x
    blanket; slots cost solver time here, so size to need and fail loudly
    on overflow instead)."""
    need = 3 * int(max_cnt)
    return max(floor, ((need + align - 1) // align) * align)


def grid_of(t_ns: np.ndarray, dt: float, win_knot0: int):
    """int64 ns -> (window-relative segment int32, fraction f64)."""
    dt_ns = np.int64(round(dt * S_TO_NS))
    t_ns = np.asarray(t_ns, dtype=np.int64)
    i0 = (t_ns // dt_ns).astype(np.int64) - win_knot0
    f = (t_ns % dt_ns).astype(np.float64) / float(dt_ns)
    return i0.astype(np.int32), f


class FeatureTrack:
    """One landmark's observations across window frames
    (≙ FeaturePerId, `visual_struct.h:63-96`)."""

    __slots__ = ("feature_id", "start_frame", "pts", "rows", "estimated_depth",
                 "solve_ok")

    def __init__(self, feature_id: int, start_frame: int):
        self.feature_id = feature_id
        self.start_frame = start_frame
        self.pts: List[np.ndarray] = []   # normalized (x, y)
        self.rows: List[float] = []
        self.estimated_depth = -1.0
        self.solve_ok = False

    @property
    def end_frame(self):
        return self.start_frame + len(self.pts) - 1

    def is_candidate(self, window_size: int) -> bool:
        """≙ FeatureManager::isLandmarkCandidate (`feature_manager.h:58-65`)."""
        return len(self.pts) >= 2 and self.start_frame < window_size - 2


def pack_image_factors(tracks: Sequence[FeatureTrack], kf_t_ns: np.ndarray,
                       dt: float, win_knot0: int, cfg: WindowConfig,
                       dtype=np.float32) -> Tuple[ImageFactors, np.ndarray, List[FeatureTrack]]:
    """Build reprojection pair factors for all candidate tracks.

    Returns (factors, dinv_init (LM,), candidates list in slot order).
    Pair structure ≙ the i=start_frame vs j loops in
    `trajectory_manager.cpp:360-385`.
    """
    OBS, LM = cfg.OBS, cfg.LM
    i0_i = np.zeros(OBS, np.int32); f_i = np.zeros(OBS); row_i = np.zeros(OBS)
    pt_i = np.zeros((OBS, 3)); i0_j = np.zeros(OBS, np.int32); f_j = np.zeros(OBS)
    row_j = np.zeros(OBS); pt_j = np.zeros((OBS, 3))
    lm_idx = np.zeros(OBS, np.int32)
    valid = np.zeros(OBS, bool)
    marg_drop = np.zeros(OBS, bool)
    dinv = np.full(LM, 0.2)

    candidates = [t for t in tracks if t.is_candidate(cfg.NB - 1)]
    if len(candidates) > LM:
        # loud failure: dropping whole landmarks silently degrades accuracy
        # (the reference holds NUM_OF_F = 2000 slots, `parameters.h:10`).
        # Size LM >= ~3 * max_cnt (see auto_landmark_slots) for headroom.
        import logging

        logging.getLogger(__name__).warning(
            "landmark capacity LM=%d exceeded (%d candidate tracks): "
            "dropping %d landmarks. Raise WindowConfig.LM "
            "(auto_landmark_slots(max_cnt) sizes it from the tracker cap).",
            LM, len(candidates), len(candidates) - LM)
        candidates = candidates[:LM]
    n = 0
    overflow = False
    for slot, tr in enumerate(candidates):
        fi = tr.start_frame
        gi, ff = grid_of(kf_t_ns[fi], dt, win_knot0)
        dinv[slot] = 1.0 / tr.estimated_depth if tr.estimated_depth > 0 else 0.2
        marg = tr.start_frame == 0 and tr.estimated_depth > 0
        for k in range(1, len(tr.pts)):
            j = fi + k
            if n >= OBS:
                overflow = True
                break
            gj, fj_ = grid_of(kf_t_ns[j], dt, win_knot0)
            i0_i[n] = gi; f_i[n] = ff; row_i[n] = tr.rows[0]
            pt_i[n] = (tr.pts[0][0], tr.pts[0][1], 1.0)
            i0_j[n] = gj; f_j[n] = fj_; row_j[n] = tr.rows[k]
            pt_j[n] = (tr.pts[k][0], tr.pts[k][1], 1.0)
            lm_idx[n] = slot
            valid[n] = True
            marg_drop[n] = marg
            n += 1
    if overflow:
        import logging

        logging.getLogger(__name__).warning(
            "image factor capacity OBS=%d exceeded; extra observations dropped", OBS)

    fa = ImageFactors(
        i0_i=i0_i, f_i=f_i.astype(dtype), row_i=row_i.astype(dtype),
        pt_i=pt_i.astype(dtype), i0_j=i0_j, f_j=f_j.astype(dtype),
        row_j=row_j.astype(dtype), pt_j=pt_j.astype(dtype),
        lm_idx=lm_idx, valid=valid, marg_drop=marg_drop,
    )
    return fa, dinv.astype(dtype), candidates


def pack_imu_factors(imu_t_ns: np.ndarray, gyro: np.ndarray, accel: np.ndarray,
                     kf_t_ns: np.ndarray, t_min_ns: int, t_max_ns: int,
                     dt: float, win_knot0: int, cfg: WindowConfig,
                     dtype=np.float32, on_overflow: str = "raise") -> ImuFactors:
    """Pack IMU samples in [t_min, t_max); bias interval selection
    ≙ `trajectory_manager.cpp:395-414`; marg_drop for t < ts[1]
    ≙ `trajectory_manager.cpp:239-253`.

    The reference uses EVERY sample in the window
    (`trajectory_manager.cpp:388-416`); exceeding the static capacity
    therefore fails loudly by default — size MIMU as
    imu_rate * window_span * margin. on_overflow="subsample" opts into
    uniform decimation (with a warning) instead."""
    M = cfg.MIMU
    sel = (imu_t_ns >= t_min_ns) & (imu_t_ns < t_max_ns)
    ts = imu_t_ns[sel]
    gy = gyro[sel]
    ac = accel[sel]
    if len(ts) > M:
        if on_overflow != "subsample":
            raise RuntimeError(
                f"IMU factor capacity MIMU={M} exceeded ({len(ts)} samples "
                f"in window): the estimator would silently lose "
                f"measurements the reference keeps. Raise WindowConfig.MIMU "
                f"(>= imu_rate * window_span * 1.25) or set "
                f"imu_overflow='subsample' to opt into decimation.")
        import logging

        logging.getLogger(__name__).warning(
            "IMU factor capacity MIMU=%d exceeded (%d samples); "
            "uniform subsampling applied", M, len(ts))
        keep = np.linspace(0, len(ts) - 1, M).astype(int)
        ts, gy, ac = ts[keep], gy[keep], ac[keep]
    n = len(ts)

    i0 = np.zeros(M, np.int32)
    u = np.zeros(M)
    gyro_a = np.zeros((M, 3)); accel_a = np.zeros((M, 3))
    bias_idx = np.zeros(M, np.int32)
    valid = np.zeros(M, bool)
    marg_drop = np.zeros(M, bool)

    gi, f = grid_of(ts, dt, win_knot0)
    i0[:n] = gi
    u[:n] = f
    gyro_a[:n] = gy
    accel_a[:n] = ac
    valid[:n] = True
    # bias interval
    NB = cfg.NB
    bidx = np.searchsorted(kf_t_ns, ts, side="right") - 1
    bidx = np.clip(bidx, 0, NB - 1)
    bias_idx[:n] = bidx
    marg_drop[:n] = ts < kf_t_ns[1]

    return ImuFactors(
        i0=i0, u=u.astype(dtype), gyro=gyro_a.astype(dtype),
        accel=accel_a.astype(dtype), bias_idx=bias_idx, valid=valid,
        marg_drop=marg_drop,
    )


def bias_sqrt_info(imu_t_ns: np.ndarray, kf_t_ns: np.ndarray, sigma_wb: float,
                   sigma_ab: float, cfg: WindowConfig, dtype=np.float32) -> BiasFactors:
    """Random-walk information between consecutive keyframes
    ≙ the covariance integration loop `trajectory_manager.cpp:420-451`."""
    NB = cfg.NB
    si = np.zeros((NB - 1, 6))
    valid = np.zeros(NB - 1, bool)
    for i in range(NB - 1):
        lo, hi = kf_t_ns[i], kf_t_ns[i + 1]
        m = (imu_t_ns[1:] < hi) & (imu_t_ns[:-1] >= lo)
        dts = (imu_t_ns[1:][m] - imu_t_ns[:-1][m]) * 1e-9
        var_g = np.sum(dts**2) * sigma_wb**2
        var_a = np.sum(dts**2) * sigma_ab**2
        if var_g > 0:
            # cap the information: the raw 1/sigma values reach ~1e6 (H
            # entries ~1e12), which destroys f32 normal equations; 1e4 still
            # pins the biases to ~1e-4-level random walk per keyframe
            si[i, :3] = min(1.0 / np.sqrt(var_g), 1e4)
            si[i, 3:] = min(1.0 / np.sqrt(var_a), 1e4)
            valid[i] = True
    return BiasFactors(sqrt_info=si.astype(dtype), valid=valid)
