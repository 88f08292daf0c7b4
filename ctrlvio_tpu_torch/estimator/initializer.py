"""System initialization: gravity-aligned initial state (the port's copy of
`ctrlvio_tpu/estimator/initializer.py`).

- `StaticInitializer` ≙ IMUInitializer::StaticInitialIMUState
  (`inertial/inertial_initializer.cpp:93-163`):
  a 1-second stationary IMU window yields the gravity direction (-> initial
  roll/pitch, yaw zeroed), gyro bias, and accel bias.
- `bootstrap_from_sim`: test/bench bootstrap from simulation ground truth
  (stands in for the VINS-Mono visual-inertial SfM bootstrap C19, which is a
  separate milestone — see PARITY.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import torch

from ctrlvio_tpu_torch.ops import so3, so3np

S_TO_NS = 1_000_000_000


@dataclass
class InitialState:
    t_ns: int
    q: np.ndarray          # (4,) IMU-to-world, gravity-aligned, yaw-zeroed
    p: np.ndarray
    bg: np.ndarray
    ba: np.ndarray
    gravity: np.ndarray    # (3,) world gravity (0, 0, +g)
    v: np.ndarray = None   # (3,) initial velocity (zero for static init)

    def __post_init__(self):
        if self.v is None:
            self.v = np.zeros(3)


def dead_reckon_poses(t_out_ns, imu_t_ns, gyro, accel, state: InitialState):
    """Midpoint IMU integration (≙ the dead-reckoning in
    `visual_odometry.cpp:137-172` / IntegrationBase) producing poses at
    requested times. Times are relative to state.t_ns=origin 0.

    Returns (q (T,4), p (T,3)). Used to initialize the first window's knots
    (far better conditioned than the reference's flat init + LM)."""
    return _dead_reckon_impl(t_out_ns, imu_t_ns, gyro, accel, state)


def _dead_reckon_impl(t_out_ns, imu_t_ns, gyro, accel, state):
    """Fully vectorized midpoint integration: per-step delta quaternions,
    a Hillis–Steele prefix quaternion product (log2(N) vectorized passes),
    batched world-accel rotation, and cumsum velocity/position — replaces a
    per-sample Python loop that cost ~30 ms/frame."""
    q0 = np.asarray(state.q, dtype=np.float64)
    p0 = np.asarray(state.p, dtype=np.float64)
    v0 = np.asarray(state.v, dtype=np.float64)
    g = state.gravity
    bg, ba = state.bg, state.ba

    t_out = np.asarray(t_out_ns, dtype=np.int64)
    out_q = np.zeros((len(t_out), 4))
    out_p = np.zeros((len(t_out), 3))

    sel = imu_t_ns >= 0
    ts = np.asarray(imu_t_ns)[sel]
    gy = np.asarray(gyro)[sel]
    ac = np.asarray(accel)[sel]
    N = len(ts)

    # negative times: constant-velocity backward extrapolation from the
    # initial state (needed because knot P_0 carries the pose at -dt)
    neg = t_out < 0
    if np.any(neg):
        w0 = (gy[0] - bg) if N else np.zeros(3)
        dtb = (t_out[neg] * 1e-9)[:, None]
        out_p[neg] = p0[None] + v0[None] * dtb
        out_q[neg] = so3np.boxplus(np.broadcast_to(q0, (int(neg.sum()), 4)),
                                   w0[None] * dtb)

    if N == 0:
        out_q[~neg] = q0
        out_p[~neg] = p0
        return out_q, out_p

    dt = (np.diff(ts) * 1e-9)[:, None]                   # (N-1, 1)
    w_mid = 0.5 * (gy[:-1] + gy[1:]) - bg                # (N-1, 3)
    dq = so3np.quat_exp(w_mid * dt)                      # (N-1, 4)
    # inclusive prefix products P[k] = dq[0] * ... * dq[k]
    P = dq.copy()
    s = 1
    while s < len(P):
        P[s:] = so3np.quat_mul(P[:-s], P[s:])
        s *= 2
    q_all = np.concatenate(
        [q0[None], so3np.quat_normalize(so3np.quat_mul(q0[None], P))])
    # world-frame acceleration at each sample (matches the midpoint scheme:
    # step k uses R(q_k)(a_k - ba) and R(q_{k+1})(a_{k+1} - ba))
    a_w = so3np.quat_rotate(q_all, ac - ba) - g          # (N, 3)
    a_mid = 0.5 * (a_w[:-1] + a_w[1:])                   # (N-1, 3)
    dv = a_mid * dt
    v_all = np.concatenate([v0[None], v0[None] + np.cumsum(dv, 0)])
    dp = v_all[:-1] * dt + 0.5 * a_mid * dt * dt
    p_all = np.concatenate([p0[None], p0[None] + np.cumsum(dp, 0)])

    # output at t = state at sample k where t ∈ (ts[k-1], ts[k]]; before the
    # first sample -> initial state; beyond the last -> last state
    pos = ~neg
    idx = np.clip(np.searchsorted(ts, t_out[pos], side="left"), 0, N - 1)
    out_q[pos] = q_all[idx]
    out_p[pos] = p_all[idx]
    return out_q, out_p


class StaticInitializer:
    """Accumulates IMU; succeeds once a stationary window is seen."""

    def __init__(self, window_length: float = 0.75,
                 excite_threshold: float = 0.5, gravity_mag: float = 9.80766):
        self.window_ns = int(window_length * S_TO_NS)
        self.thresh = excite_threshold
        self.g = np.array([0.0, 0.0, gravity_mag])
        self.t = []
        self.gyro = []
        self.accel = []

    def feed(self, t_ns: int, gyro, accel) -> Optional[InitialState]:
        self.t.append(int(t_ns))
        self.gyro.append(np.asarray(gyro, dtype=np.float64))
        self.accel.append(np.asarray(accel, dtype=np.float64))
        if self.t[-1] - self.t[0] < self.window_ns:
            return None

        t = np.asarray(self.t)
        sel = t >= t[-1] - self.window_ns
        acc = np.stack(self.accel)[sel]
        gyr = np.stack(self.gyro)[sel]
        acc_avg = acc.mean(0)
        gyr_avg = gyr.mean(0)
        acc_var = np.sqrt(((acc - acc_avg) ** 2).sum(-1).sum() / (len(acc) - 1))
        if acc_var >= self.thresh:
            return None  # moving; keep waiting (≙ "Dont Move!" warning)

        # world z from measured gravity; x via Gram-Schmidt on e1; yaw zeroed
        z_axis = acc_avg / np.linalg.norm(acc_avg)
        e1 = np.array([1.0, 0.0, 0.0])
        x_axis = e1 - z_axis * (z_axis @ e1)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        Rot = np.stack([x_axis, y_axis, z_axis], axis=1)  # I0 -> "gravity frame"
        g_inI0 = Rot @ self.g
        R_I0toG = Rot.T
        # zero the yaw
        yaw = np.arctan2(R_I0toG[1, 0], R_I0toG[0, 0])
        cy, sy = np.cos(-yaw), np.sin(-yaw)
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
        R_I0toG = Rz @ R_I0toG

        q = so3.matrix_to_quat(torch.as_tensor(R_I0toG)).numpy()
        return InitialState(
            t_ns=int(t[-1]), q=q, p=np.zeros(3),
            bg=gyr_avg, ba=acc_avg - g_inI0, gravity=self.g.copy(),
        )


class ActiveInitializer:
    """Orientation-based IMU init (≙ ActiveInitialIMUState,
    `inertial_initializer.cpp:60-91`): when the IMU stream carries an
    attitude estimate, gravity-align from it directly — yaw zeroed, biases
    start at zero. Succeeds on the first sample with a non-identity
    orientation, so a moving start (where the static init's stillness test
    never passes) can still bootstrap."""

    def __init__(self, gravity_mag: float = 9.80766):
        self.g = np.array([0.0, 0.0, gravity_mag])

    def feed(self, t_ns: int, quat_wxyz) -> Optional[InitialState]:
        q = np.asarray(quat_wxyz, dtype=np.float64)
        # the reference treats x == 0 as "no attitude in the message"
        if abs(q[1]) <= 1e-9:
            return None
        R_I0toG = so3np.quat_to_matrix(q[None])[0]
        yaw = np.arctan2(R_I0toG[1, 0], R_I0toG[0, 0])
        cy, sy = np.cos(-yaw), np.sin(-yaw)
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
        R_I0toG = Rz @ R_I0toG
        qn = so3.matrix_to_quat(torch.as_tensor(R_I0toG)).numpy()
        return InitialState(t_ns=int(t_ns), q=qn, p=np.zeros(3),
                            bg=np.zeros(3), ba=np.zeros(3),
                            gravity=self.g.copy())


def bootstrap_from_sim(sim, t0_ns: Optional[int] = None) -> InitialState:
    """Ground-truth bootstrap for synthetic sequences (replaces the visual
    SfM init during bench/tests)."""
    if t0_ns is None:
        t0_ns = sim.frames[0].t_ns
    q, p = sim.pose_at(t0_ns * 1e-9)
    # ground-truth velocity at t0: f64 central difference of the exact GT
    # evaluator (family-agnostic — GT need not be an estimator-grid spline)
    h = 1e-4
    t0 = t0_ns * 1e-9
    v = (sim.pose_at(t0 + h)[1] - sim.pose_at(t0 - h)[1]) / (2 * h)
    return InitialState(
        t_ns=int(t0_ns), q=np.asarray(q), p=np.asarray(p),
        bg=sim.bg.copy(), ba=sim.ba.copy(), gravity=sim.gravity_vec.copy(),
        v=v,
    )
