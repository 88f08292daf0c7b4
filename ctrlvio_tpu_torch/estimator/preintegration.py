"""IMU pre-integration between keyframes (midpoint rule; the port's numpy copy
of `ctrlvio_tpu/estimator/preintegration.py`).

≙ IntegrationBase (`visual_odometry/integration_base.h`)
— used by the visual-inertial initializer (gyro-bias least squares and the
linear alignment need the deltas and d(delta_q)/d(bg)); the continuous-time
solver itself never uses pre-integration factors (the reference's
pre-integration *factor* is declared but dead, SURVEY §2.1 C16). The 15x15
covariance propagation (`integration_base.h:100-180`) is carried for parity
and for downstream consumers that weight pre-integration residuals.

Host-side numpy (runs once per init attempt over ~1 s of IMU).
"""

from __future__ import annotations

import numpy as np

from ctrlvio_tpu_torch.ops import so3np

# state order ≙ VINS: [δp 0:3, δθ 3:6, δv 6:9, δba 9:12, δbg 12:15]
# noise order: [n_a0, n_w0, n_a1, n_w1, n_ba, n_bg] (18)


class PreIntegration:
    """Delta pose/velocity between two keyframes with bias Jacobians and
    15x15 covariance propagation (midpoint, ≙ `integration_base.h:100-180`)."""

    def __init__(self, bg=None, ba=None, acc_n: float = 8e-2,
                 gyr_n: float = 4e-3, acc_w: float = 4e-4,
                 gyr_w: float = 2e-5):
        self.bg = np.zeros(3) if bg is None else np.asarray(bg)
        self.ba = np.zeros(3) if ba is None else np.asarray(ba)
        self.noise = np.zeros((18, 18))
        for i, s in enumerate([acc_n, gyr_n, acc_n, gyr_n, acc_w, gyr_w]):
            self.noise[3 * i : 3 * i + 3, 3 * i : 3 * i + 3] = s * s * np.eye(3)
        self.reset()

    def reset(self):
        self.dq = np.array([1.0, 0, 0, 0])
        self.dp = np.zeros(3)
        self.dv = np.zeros(3)
        self.sum_dt = 0.0
        self.jacobian = np.eye(15)       # d state / d [state0; biases]
        self.covariance = np.zeros((15, 15))
        self._buf = []  # (dt, acc0, gyr0, acc1, gyr1)
        self._last = None

    @property
    def J_q_bg(self):
        """Right-tangent d log(delta_q) / d bg (the block the gyro-bias
        least squares uses, ≙ jacobian.block<3,3>(O_R, O_BG))."""
        return self.jacobian[3:6, 12:15]

    def push(self, dt, acc, gyr):
        if self._last is None:
            self._last = (np.asarray(acc), np.asarray(gyr))
            return
        acc0, gyr0 = self._last
        self._buf.append((dt, acc0, gyr0, np.asarray(acc), np.asarray(gyr)))
        self._last = (np.asarray(acc), np.asarray(gyr))
        self._step(dt, acc0, gyr0, acc, gyr)

    def _step(self, dt, acc0, gyr0, acc1, gyr1):
        w = 0.5 * (gyr0 + gyr1) - self.bg
        dq_new = so3np.boxplus(self.dq, w * dt)
        R0 = so3np.quat_to_matrix(self.dq[None])[0]
        R1 = so3np.quat_to_matrix(dq_new[None])[0]
        a0b = acc0 - self.ba
        a1b = acc1 - self.ba
        a = 0.5 * (R0 @ a0b + R1 @ a1b)

        # ---- midpoint error-state transition (≙ integration_base.h:140-172)
        I3 = np.eye(3)
        wx = _skew(w)
        a0x = _skew(a0b)
        a1x = _skew(a1b)
        Rwth = I3 - wx * dt                   # d θ' / d θ
        # d(midpoint accel)/dθ: first term rotates with R0 (no θ dep in the
        # error-state convention used by VINS for the left factor), second
        # with R1 whose θ' depends on θ via Rwth
        dadth = -0.25 * (R0 @ a0x) * dt - 0.25 * (R1 @ a1x @ Rwth) * dt

        F = np.eye(15)
        F[0:3, 3:6] = dadth * dt
        F[0:3, 6:9] = I3 * dt
        F[0:3, 9:12] = -0.25 * (R0 + R1) * dt * dt
        F[0:3, 12:15] = 0.25 * (R1 @ a1x) * dt * dt * dt
        F[3:6, 3:6] = Rwth
        F[3:6, 12:15] = -I3 * dt
        F[6:9, 3:6] = -0.5 * (R0 @ a0x) * dt - 0.5 * (R1 @ a1x @ Rwth) * dt
        F[6:9, 9:12] = -0.5 * (R0 + R1) * dt
        F[6:9, 12:15] = 0.5 * (R1 @ a1x) * dt * dt

        V = np.zeros((15, 18))
        V[0:3, 0:3] = 0.25 * R0 * dt * dt
        V[0:3, 3:6] = -0.125 * (R1 @ a1x) * dt * dt * dt
        V[0:3, 6:9] = 0.25 * R1 * dt * dt
        V[0:3, 9:12] = V[0:3, 3:6]
        V[3:6, 3:6] = 0.5 * I3 * dt
        V[3:6, 9:12] = 0.5 * I3 * dt
        V[6:9, 0:3] = 0.5 * R0 * dt
        V[6:9, 3:6] = -0.25 * (R1 @ a1x) * dt * dt
        V[6:9, 6:9] = 0.5 * R1 * dt
        V[6:9, 9:12] = V[6:9, 3:6]
        V[9:12, 12:15] = I3 * dt
        V[12:15, 15:18] = I3 * dt

        self.jacobian = F @ self.jacobian
        self.covariance = F @ self.covariance @ F.T + V @ self.noise @ V.T

        self.dp = self.dp + self.dv * dt + 0.5 * a * dt * dt
        self.dv = self.dv + a * dt
        self.dq = dq_new
        self.sum_dt += dt

    def repropagate(self, bg, ba=None):
        """Re-integrate with new biases (≙ IntegrationBase::repropagate)."""
        self.bg = np.asarray(bg)
        if ba is not None:
            self.ba = np.asarray(ba)
        buf = self._buf
        self.reset()
        self._buf = buf
        for dt, a0, g0, a1, g1 in buf:
            self._step(dt, a0, g0, a1, g1)


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0.0]])
