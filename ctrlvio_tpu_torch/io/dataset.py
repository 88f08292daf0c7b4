"""Sequence dataset format: npz replay files (the rosbag replacement; the
port's own copy of `ctrlvio_tpu/io/dataset.py`, same npz layout, so a file
written by either package loads in the other).

The reference replays rosbags (`OdometryManager::LoadBag/RunBag`,
`odometry_manager.cpp:97-165`). Here a sequence is one `.npz` with:

  imu_t_ns   (M,)  int64      IMU timestamps
  gyro       (M,3) f64        rad/s
  accel      (M,3) f64        m/s^2
  frame_t_ns (F,)  int64      image timestamps
  images     (F,H,W) u8       (optional — raw-image sequences)
  # or pre-extracted features (feature-sequence files):
  feat_ptr   (F+1,) int64     CSR offsets into the arrays below
  feat_ids   (sum,) int64
  feat_pts   (sum,2) f64      normalized undistorted coords
  feat_rows  (sum,) f64       pixel row (v) for the RS time model

`save_feature_sequence` / `load_sequence` round-trip these;
`from_sim` converts a synthetic SimData; a TUM-RSVI rosbag converter can
produce the same layout offline (no ROS in this environment).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Sequence:
    imu_t_ns: np.ndarray
    gyro: np.ndarray
    accel: np.ndarray
    frame_t_ns: np.ndarray
    feat_ids: List[np.ndarray]
    feat_pts: List[np.ndarray]
    feat_rows: List[np.ndarray]
    images: Optional[np.ndarray] = None


def from_sim(sim) -> Sequence:
    return Sequence(
        imu_t_ns=sim.imu_t_ns,
        gyro=sim.gyro,
        accel=sim.accel,
        frame_t_ns=np.asarray([f.t_ns for f in sim.frames], dtype=np.int64),
        feat_ids=[f.ids for f in sim.frames],
        feat_pts=[f.pts for f in sim.frames],
        feat_rows=[f.rows for f in sim.frames],
    )


def save_feature_sequence(path: str, seq: Sequence):
    ptr = np.zeros(len(seq.feat_ids) + 1, dtype=np.int64)
    for i, ids in enumerate(seq.feat_ids):
        ptr[i + 1] = ptr[i] + len(ids)
    np.savez_compressed(
        path,
        imu_t_ns=seq.imu_t_ns, gyro=seq.gyro, accel=seq.accel,
        frame_t_ns=seq.frame_t_ns, feat_ptr=ptr,
        feat_ids=np.concatenate(seq.feat_ids) if seq.feat_ids else np.zeros(0, np.int64),
        feat_pts=np.concatenate(seq.feat_pts) if seq.feat_pts else np.zeros((0, 2)),
        feat_rows=np.concatenate(seq.feat_rows) if seq.feat_rows else np.zeros(0),
    )


def load_sequence(path: str) -> Sequence:
    z = np.load(path, allow_pickle=False)
    ptr = z["feat_ptr"]
    ids, pts, rows = [], [], []
    for i in range(len(ptr) - 1):
        s, e = ptr[i], ptr[i + 1]
        ids.append(z["feat_ids"][s:e])
        pts.append(z["feat_pts"][s:e])
        rows.append(z["feat_rows"][s:e])
    return Sequence(
        imu_t_ns=z["imu_t_ns"], gyro=z["gyro"], accel=z["accel"],
        frame_t_ns=z["frame_t_ns"], feat_ids=ids, feat_pts=pts, feat_rows=rows,
        images=z["images"] if "images" in z.files else None,
    )


def replay(seq: Sequence, vio, bootstrap=None, frame_s=None):
    """Drive a CtrlVIO instance through a sequence (≙ RunBag). Returns the
    list of (t_ns, q, p) pose outputs. A list passed as `frame_s` receives
    each frame's host seconds (its IMU feed and its process call)."""
    out = []
    imu_idx = 0
    if bootstrap is not None:
        for k in range(len(seq.imu_t_ns)):
            vio.process_imu(seq.imu_t_ns[k], seq.gyro[k], seq.accel[k])
        imu_idx = len(seq.imu_t_ns)
        vio.set_initial_state(bootstrap.t_ns, bootstrap.q, bootstrap.p,
                              bootstrap.bg, bootstrap.ba, bootstrap.gravity,
                              v0=bootstrap.v)
    use_images = seq.images is not None and getattr(vio, "tracker", None) \
        is not None
    # feed IMU ahead of each frame by the pairing lookahead so the frame
    # solves immediately (≙ the reference's coverage check queueing frames
    # behind IMU, `odometry_manager.cpp:375-383`); CtrlVIO itself defers
    # frames internally if a driver can't feed ahead
    ahead_ns = int(0.25e9)
    for f in range(len(seq.frame_t_ns)):
        t0 = time.perf_counter()
        t = int(seq.frame_t_ns[f])
        while imu_idx < len(seq.imu_t_ns) and seq.imu_t_ns[imu_idx] <= t + ahead_ns:
            vio.process_imu(seq.imu_t_ns[imu_idx], seq.gyro[imu_idx],
                            seq.accel[imu_idx])
            imu_idx += 1
        if use_images:
            # raw-image path: in-process tracker (≙ img_callback from the
            # bag loop, `odometry_manager.h:70-73`)
            r = vio.process_image(t, seq.images[f])
        else:
            r = vio.process_frame(t, seq.feat_ids[f], seq.feat_pts[f],
                                  seq.feat_rows[f])
        if r is not None:
            out.append((t, r[0], r[1]))
        if frame_s is not None:
            frame_s.append(time.perf_counter() - t0)
    if hasattr(vio, "flush"):
        vio.flush()
    return out
