"""Host-side trajectory: the unbounded knot store + window views (the port's
numpy copy of `ctrlvio_tpu/models/trajectory.py`).

≙ `Trajectory`/`Se3Spline` (`spline/trajectory.h:38-117`,
`se3_spline.h`) — but the device never sees this: it is the numpy system of
record from which fixed-shape *window views* are cut for each solve and into
which results are written back. Time is int64 nanoseconds exactly, knot 0 at
t=0 (data start time is subtracted at ingest, like the reference's
`GetDataStartTime`).
"""

from __future__ import annotations

import numpy as np

from ctrlvio_tpu_torch.ops import so3np

S_TO_NS = 1_000_000_000


class Trajectory:
    def __init__(self, knot_dt: float, line_delay: float = 0.0,
                 fix_ld: bool = False, ld_lower: float = 0.0,
                 ld_upper: float = 3.5e-5):
        self.dt = float(knot_dt)
        self.dt_ns = np.int64(round(knot_dt * S_TO_NS))
        cap = 256
        self.knots_q = np.zeros((cap, 4))
        self.knots_q[:, 0] = 1.0
        self.knots_p = np.zeros((cap, 3))
        self.n = 4  # a valid spline needs N knots (covers [0, dt))
        self.line_delay = float(line_delay)
        self.fix_ld = fix_ld
        self.ld_lower = ld_lower
        self.ld_upper = ld_upper

    # -- capacity ---------------------------------------------------------
    def _ensure(self, n):
        while n > len(self.knots_q):
            self.knots_q = np.concatenate([self.knots_q, np.zeros_like(self.knots_q)])
            self.knots_p = np.concatenate([self.knots_p, np.zeros_like(self.knots_p)])

    # -- reference-equivalent queries ------------------------------------
    @property
    def max_time_ns(self) -> int:
        """≙ `so3_spline.h:140-143`: start + (knots - N + 1) * dt."""
        return int((self.n - 3) * self.dt_ns)

    def ctrl_idx(self, t_ns: int) -> int:
        """Segment (first control point) index of time t, ≙ computeTIndexNs."""
        return int(np.int64(t_ns) // self.dt_ns)

    def extend_to(self, t_ns: int):
        """Append copies of the last knot until max_time_ns >= t_ns
        (≙ `extendKnotsTo`, `se3_spline.h:201-207`)."""
        need = int(np.ceil(t_ns / self.dt_ns)) + 3
        if need > self.n:
            self._ensure(need)
            self.knots_q[self.n : need] = self.knots_q[self.n - 1]
            self.knots_p[self.n : need] = self.knots_p[self.n - 1]
            self.n = need

    def set_flat(self, q0, p0, upto_ns: int):
        """Flat-initialize all knots to a constant pose
        (≙ SetInitialState's flat init of the first window)."""
        self.extend_to(upto_ns)
        self.knots_q[: self.n] = np.asarray(q0)
        self.knots_p[: self.n] = np.asarray(p0)

    # -- window views -----------------------------------------------------
    def window(self, win_knot0: int, KW: int, dtype=np.float32):
        """Cut a KW-knot window view starting at global knot win_knot0.
        Returns (knots_q (KW,4), knots_p (KW,3), n_active)."""
        hi = min(self.n, win_knot0 + KW)
        q = np.zeros((KW, 4)); q[:, 0] = 1.0
        p = np.zeros((KW, 3))
        q[: hi - win_knot0] = self.knots_q[win_knot0:hi]
        p[: hi - win_knot0] = self.knots_p[win_knot0:hi]
        # pad with the last valid knot so out-of-horizon gathers stay sane
        if hi - win_knot0 < KW and hi > win_knot0:
            q[hi - win_knot0 :] = self.knots_q[hi - 1]
            p[hi - win_knot0 :] = self.knots_p[hi - 1]
        return q.astype(dtype), p.astype(dtype), hi - win_knot0

    def write_back(self, win_knot0: int, knots_q, knots_p, n_active: int):
        hi = win_knot0 + n_active
        self.knots_q[win_knot0:hi] = np.asarray(knots_q[:n_active], dtype=np.float64)
        self.knots_p[win_knot0:hi] = np.asarray(knots_p[:n_active], dtype=np.float64)

    # -- pose queries (host, f64) ----------------------------------------
    def pose(self, t_ns):
        """IMU pose at int64-ns times (scalar or array). Returns (q, p).
        Pure numpy — called per frame on the host."""
        t_ns = np.atleast_1d(np.asarray(t_ns, dtype=np.int64))
        i0 = np.clip((t_ns // self.dt_ns).astype(np.int64), 0, self.n - 4)
        u = (t_ns % self.dt_ns).astype(np.float64) / float(self.dt_ns)
        idx = i0[:, None] + np.arange(4)
        q4 = self.knots_q[idx]
        p4 = self.knots_p[idx]
        q = so3np.so3_eval(q4, u)
        p = so3np.rd_eval(p4, u, 1.0 / self.dt, 0)
        return q, p

    def camera_pose(self, t_ns, q_CtoI, p_CinI):
        """≙ `Trajectory::GetCameraPose` (`trajectory.h:90`)."""
        q, p = self.pose(t_ns)
        qc = so3np.quat_mul(q, np.asarray(q_CtoI)[None])
        pc = p + so3np.quat_rotate(q, np.asarray(p_CinI)[None])
        return qc, pc
