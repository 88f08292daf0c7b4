"""Trajectory export + state checkpointing (the port's counterpart of
`ctrlvio_tpu/utils/export.py`).

The reference publishes rviz topics (OdometryViewer, C20) and has no
checkpoint/resume. Here: TUM-format trajectory export (consumable by evo /
rpg_trajectory_evaluation, the external tools the reference's users
evaluate with) and an npz checkpoint of the full estimator state for
resume. The npz keys are the JAX package's, so checkpoints written by
either package load in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ctrlvio_tpu_torch.solver.layout import PriorFactor


def export_tum(path: str, stamps_ns, quats_wxyz, positions):
    """Write a TUM-format trajectory file: `t x y z qx qy qz qw` per line."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, q, p in zip(stamps_ns, quats_wxyz, positions):
            f.write(f"{t * 1e-9:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")


def export_vio_trajectory(path: str, vio, sample_dt: float = 0.02):
    """Densely sample the current spline (≙ PublishSplineTrajectory's 20 ms
    sampling, `odometry_viewer.h:89`) and write TUM format. Samples the
    host mirror: a streaming run needs its `flush()` first (`dataset.replay`
    does it)."""
    t_max = vio.traj.max_time_ns
    ts = np.arange(0, t_max - int(vio.traj.dt_ns), int(sample_dt * 1e9),
                   dtype=np.int64)
    q, p = vio.traj.pose(ts)
    t0 = vio.data_start_ns or 0
    export_tum(path, ts + t0, q, p)


def save_checkpoint(path: str, vio):
    """Snapshot the full estimator state (trajectory knots, biases, IMU
    buffer, keyframe times, line delay, prior) for resume."""
    prior_arrs = {}
    if vio.prior is not None:
        for k, v in vio.prior._asdict().items():
            prior_arrs[f"prior_{k}"] = v.detach().cpu().numpy()
    np.savez_compressed(
        path,
        knots_q=vio.traj.knots_q[: vio.traj.n],
        knots_p=vio.traj.knots_p[: vio.traj.n],
        line_delay=vio.traj.line_delay,
        kf_t_ns=vio.kf_t_ns,
        bg=vio.bg, ba=vio.ba,
        gravity=vio.gravity,
        imu_t_ns=vio.imu_t_ns, imu_gyro=vio.imu_gyro, imu_accel=vio.imu_accel,
        data_start_ns=vio.data_start_ns or -1,
        win_knot0=vio.win_knot0,
        initialized=vio.initialized,
        **prior_arrs,
    )


def load_checkpoint(path: str, vio):
    """Restore estimator state saved by save_checkpoint (either package's).
    The prior becomes tensors on `vio.device` in the solve dtype and seeds
    the next marginalization. Feature tracks are not persisted (≙ a tracker
    restart: the window repopulates within a few frames)."""
    z = np.load(path)
    n = len(z["knots_q"])
    vio.traj._ensure(n)
    vio.traj.knots_q[:n] = z["knots_q"]
    vio.traj.knots_p[:n] = z["knots_p"]
    vio.traj.n = n
    vio.traj.line_delay = float(z["line_delay"])
    vio.kf_t_ns = z["kf_t_ns"].copy()
    vio.bg = z["bg"].copy()
    vio.ba = z["ba"].copy()
    vio.gravity = z["gravity"].copy()
    vio._gravity_j = vio._t(vio.gravity, vio.jdt)
    vio.imu_t_ns = z["imu_t_ns"].copy()
    vio.imu_gyro = z["imu_gyro"].copy()
    vio.imu_accel = z["imu_accel"].copy()
    ds = int(z["data_start_ns"])
    vio.data_start_ns = None if ds < 0 else ds
    vio.win_knot0 = int(z["win_knot0"])
    vio.initialized = bool(z["initialized"])
    if "prior_J" in z.files:
        vio.prior = PriorFactor(*(
            torch.tensor(z[f"prior_{k}"], device=vio.device).to(vio.jdt)
            for k in PriorFactor._fields))
        vio._prior64 = None
    return vio
