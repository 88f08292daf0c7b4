"""Visual-inertial initialization: SfM bootstrap + alignment (the port's
numpy copy of `ctrlvio_tpu/estimator/vio_init.py`).

≙ VIOInitialization / MotionEstimator / GlobalSFM / VisualIMUAlignment
(`visual_odometry/vio_initial.cpp`,
`initial/{solve_5pts,initial_sfm,initial_aligment}.cpp`):

1. excitation check (IMU accel variance over the window)
2. relative pose between a past frame l and the newest frame
   (essential matrix from normalized correspondences + cheirality)
3. global SfM: triangulate l<->newest, PnP chain to the remaining frames,
   triangulate the rest, full bundle adjustment
4. visual-inertial alignment: gyro-bias least squares against SfM
   rotations, linear solve for scale / per-frame velocities / gravity,
   gravity-norm refinement on the 2-DoF tangent basis
5. rotate everything into the gravity-aligned world, rescale

Host-side numpy/f64 — this runs once. Accuracy matters, speed does not
(the reference runs the same algorithms through OpenCV/Ceres).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .initializer import InitialState
from .preintegration import PreIntegration


# ---------------------------------------------------------------------------
# geometry helpers (pure numpy)
# ---------------------------------------------------------------------------


def _quat_to_R(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _R_to_quat(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = np.argmax(np.diag(R))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[i + 1] = 0.25 * s
        q[j + 1] = (R[j, i] + R[i, j]) / s
        q[k + 1] = (R[k, i] + R[i, k]) / s
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def essential_from_correspondences(pts1, pts2, iters=200, thresh=3e-3, rng=None):
    """RANSAC 8-point essential matrix on normalized coords.

    ≙ MotionEstimator::solveRelativeRT's cv::findFundamentalMat(RANSAC)
    (`solve_5pts.cpp:8-40`, threshold 0.3/460 on normalized coords).
    """
    n = len(pts1)
    if n < 15:
        return None, None
    rng = rng or np.random.default_rng(0)
    P1 = np.concatenate([pts1, np.ones((n, 1))], axis=1)
    P2 = np.concatenate([pts2, np.ones((n, 1))], axis=1)

    def eight_point(idx):
        A = np.einsum("ni,nj->nij", P2[idx], P1[idx]).reshape(len(idx), 9)
        _, _, Vt = np.linalg.svd(A)
        E = Vt[-1].reshape(3, 3)
        # enforce essential singular values (1, 1, 0)
        U, S, Vt2 = np.linalg.svd(E)
        return U @ np.diag([1.0, 1.0, 0.0]) @ Vt2

    def sampson(E):
        Ex1 = P1 @ E.T
        Etx2 = P2 @ E
        num = np.sum(P2 * (P1 @ E.T), axis=1) ** 2
        den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        return num / np.maximum(den, 1e-12)

    best_E, best_in = None, 0
    for _ in range(iters):
        idx = rng.choice(n, 8, replace=False)
        try:
            E = eight_point(idx)
        except np.linalg.LinAlgError:
            continue
        inl = sampson(E) < thresh**2
        if inl.sum() > best_in:
            best_in, best_E, best_inl = inl.sum(), E, inl
    if best_E is None or best_in < 12:
        return None, None
    # refit on inliers
    E = eight_point(np.nonzero(best_inl)[0])
    return E, best_inl


def recover_pose(E, pts1, pts2):
    """Decompose E into (R, t) with cheirality voting
    (≙ the custom decomposeEssentialMat/recoverPose, `solve_5pts.cpp:42-120`).
    Returns (R, t) mapping frame-1 coords into frame-2: x2 ~ R x1 + t."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    cands = [(U @ W @ Vt, U[:, 2]), (U @ W @ Vt, -U[:, 2]),
             (U @ W.T @ Vt, U[:, 2]), (U @ W.T @ Vt, -U[:, 2])]

    def count_front(R, t):
        P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
        P2 = np.hstack([R, t[:, None]])
        good = 0
        for a, b in zip(pts1, pts2):
            X = _triangulate_point(P1, P2, a, b)
            x1 = X[:3] / X[3]
            x2 = R @ x1 + t
            if x1[2] > 0 and x2[2] > 0:
                good += 1
        return good

    best = max(cands, key=lambda c: count_front(*c))
    return best


def _triangulate_point(P1, P2, x1, x2):
    A = np.stack([
        x1[0] * P1[2] - P1[0],
        x1[1] * P1[2] - P1[1],
        x2[0] * P2[2] - P2[0],
        x2[1] * P2[2] - P2[1],
    ])
    _, _, Vt = np.linalg.svd(A)
    return Vt[-1]


def _pnp(obj_pts, img_pts, R0, t0, iters=10):
    """Gauss-Newton PnP refinement from an initial guess
    (≙ cv::solvePnP with useExtrinsicGuess=1 in `initial_sfm.cpp:122-191`).
    Pose maps world -> camera: x_c = R X + t. Returns (R, t, ok); ok=False
    when the system went non-finite/singular (degenerate geometry — the
    caller fails the SfM attempt, and the bootstrap retries later)."""
    R, t = R0.copy(), t0.copy()
    for _ in range(iters):
        J_rows, r_rows = [], []
        for X, x in zip(obj_pts, img_pts):
            Xc = R @ X + t
            z = max(Xc[2], 1e-6)
            pred = Xc[:2] / z
            r = pred - x
            Jp = np.array([[1 / z, 0, -Xc[0] / z**2],
                           [0, 1 / z, -Xc[1] / z**2]])
            JR = -Jp @ R @ _skew(X)
            Jt = Jp
            J_rows.append(np.hstack([JR, Jt]))
            r_rows.append(r)
        J = np.vstack(J_rows)
        r = np.concatenate(r_rows)
        H = J.T @ J + 1e-9 * np.eye(6)
        g = -J.T @ r
        if not (np.isfinite(H).all() and np.isfinite(g).all()):
            return R, t, False
        try:
            dx = np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            return R, t, False
        R = R @ _expm(dx[:3])
        t = t + dx[3:]
    return R, t, np.isfinite(t).all()


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0.0]])


def _expm(phi):
    th = np.linalg.norm(phi)
    if th < 1e-12:
        return np.eye(3) + _skew(phi)
    a = phi / th
    K = _skew(a)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


# ---------------------------------------------------------------------------
# global SfM
# ---------------------------------------------------------------------------


@dataclass
class SfMResult:
    # camera poses: world(=frame l) -> camera; R[i] x_w + t[i] = x_ci
    R: np.ndarray          # (F, 3, 3)
    t: np.ndarray          # (F, 3)
    points: Dict[int, np.ndarray]  # feature_id -> 3D point in world


def global_sfm(n_frames: int, tracks, l: int, R_rel, t_rel) -> Optional[SfMResult]:
    """Triangulate + PnP chain + refinement.

    tracks: list of (feature_id, start_frame, [normalized xy per frame]).
    Frame l is the world origin; the newest frame pose comes from (R_rel,
    t_rel). ≙ GlobalSFM::construct_orignal (`initial_sfm.cpp:195-330`).
    """
    F = n_frames
    R = np.tile(np.eye(3), (F, 1, 1))
    t = np.zeros((F, 3))
    known = np.zeros(F, bool)
    known[l] = True
    R[F - 1] = R_rel
    t[F - 1] = t_rel
    known[F - 1] = True

    obs = {}  # (feature_id, frame) -> normalized xy
    for fid, s, pts in tracks:
        for k, p in enumerate(pts):
            obs[(fid, s + k)] = np.asarray(p[:2])

    points: Dict[int, np.ndarray] = {}

    def good_point(X, Pa, Pb):
        """Dehomogenize + sanity gates: finite, positive bounded depth in
        BOTH views (≙ the cheirality/depth gates the reference inherits from
        cv::triangulatePoints usage) — near-infinity points otherwise
        poison the PnP chain with overflow."""
        if abs(X[3]) < 1e-8:
            return None
        Xw = X[:3] / X[3]
        h = np.append(Xw, 1.0)
        if not np.isfinite(Xw).all():
            return None
        za, zb = Pa[2] @ h, Pb[2] @ h
        if not (0.05 < za < 1e3 and 0.05 < zb < 1e3):
            return None
        return Xw

    def triangulate_frame_pair(fa, fb):
        Pa = np.hstack([R[fa], t[fa][:, None]])
        Pb = np.hstack([R[fb], t[fb][:, None]])
        for fid, s, pts in tracks:
            if fid in points:
                continue
            if (fid, fa) in obs and (fid, fb) in obs:
                X = _triangulate_point(Pa, Pb, obs[(fid, fa)], obs[(fid, fb)])
                Xw = good_point(X, Pa, Pb)
                if Xw is not None:
                    points[fid] = Xw

    def pnp_frame(f, f_ref):
        o, i = [], []
        for fid, X in points.items():
            if (fid, f) in obs:
                o.append(X)
                i.append(obs[(fid, f)])
        if len(o) < 10:
            return False
        R[f], t[f], ok = _pnp(np.asarray(o), np.asarray(i), R[f_ref].copy(),
                              t[f_ref].copy())
        known[f] = ok
        return ok

    # [1] l <-> newest, then chain l..newest forward
    triangulate_frame_pair(l, F - 1)
    for f in range(l + 1, F - 1):
        if not pnp_frame(f, f - 1 if known[f - 1] else F - 1):
            return None
        triangulate_frame_pair(f, F - 1)
    # [2] chain l-1..0 backward
    for f in range(l - 1, -1, -1):
        if not pnp_frame(f, f + 1):
            return None
        triangulate_frame_pair(f, l)
    # [3] triangulate remaining points from any two observing frames
    for fid, s, pts in tracks:
        if fid in points or len(pts) < 2:
            continue
        fa, fb = s, s + len(pts) - 1
        if known[fa] and known[fb]:
            Pa = np.hstack([R[fa], t[fa][:, None]])
            Pb = np.hstack([R[fb], t[fb][:, None]])
            X = _triangulate_point(Pa, Pb, obs[(fid, fa)], obs[(fid, fb)])
            Xw = good_point(X, Pa, Pb)
            if Xw is not None:
                points[fid] = Xw

    # [4] full bundle adjustment (poses l fixed; ≙ the autodiff BA
    # `initial_sfm.cpp:261-330`)
    _sfm_ba(R, t, points, obs, l, F)
    return SfMResult(R=R, t=t, points=points)


def _sfm_ba(R, t, points, obs, l, F, iters=12):
    fids = sorted(points.keys())
    fid_idx = {f: i for i, f in enumerate(fids)}
    n_pose = F
    n_pt = len(fids)

    for _ in range(iters):
        rows_J, rows_r, row_meta = [], [], []
        H = np.zeros((6 * n_pose + 3 * n_pt,) * 2)
        g = np.zeros(6 * n_pose + 3 * n_pt)
        cost = 0.0
        for (fid, f), x in obs.items():
            if fid not in fid_idx:
                continue
            X = points[fid]
            Xc = R[f] @ X + t[f]
            if Xc[2] < 1e-3:
                continue
            z = Xc[2]
            r = Xc[:2] / z - x
            # Huber robustification: rolling-shutter skew makes fast-motion
            # observations outliers for the GS model used here
            rn = np.linalg.norm(r)
            w = 1.0 if rn < 0.01 else np.sqrt(0.01 / rn)
            r = r * w
            cost += r @ r
            Jp = w * np.array([[1 / z, 0, -Xc[0] / z**2], [0, 1 / z, -Xc[1] / z**2]])
            JR = -Jp @ R[f] @ _skew(X)
            Jt = Jp
            JX = Jp @ R[f]
            pi = 6 * f
            xi = 6 * n_pose + 3 * fid_idx[fid]
            Jrow = np.zeros((2, 6 * n_pose + 3 * n_pt))
            Jrow[:, pi : pi + 3] = JR
            Jrow[:, pi + 3 : pi + 6] = Jt
            Jrow[:, xi : xi + 3] = JX
            H += Jrow.T @ Jrow
            g += Jrow.T @ r
        # gauge: fix pose l and the translation scale via pose F-1's t norm —
        # freeze pose l entirely and t of frame F-1 along its direction
        fix = list(range(6 * l, 6 * l + 6))
        for i in fix:
            H[i, :] = 0; H[:, i] = 0; H[i, i] = 1.0; g[i] = 0
        H += 1e-6 * np.eye(len(H))
        dx = np.linalg.solve(H, -g)
        for f in range(F):
            R[f] = R[f] @ _expm(dx[6 * f : 6 * f + 3])
            t[f] = t[f] + dx[6 * f + 3 : 6 * f + 6]
        for fid in fids:
            points[fid] = points[fid] + dx[6 * n_pose + 3 * fid_idx[fid]:][:3]


# ---------------------------------------------------------------------------
# visual-inertial alignment
# ---------------------------------------------------------------------------


def solve_gyro_bias(q_imu: np.ndarray, preints: List[PreIntegration]):
    """LSQ gyro bias from SfM rotations vs pre-integrated rotations
    (≙ solveGyroscopeBias, `initial_aligment.cpp:5-45`). q_imu: (F, 4)
    IMU-frame orientations from SfM."""
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for i in range(len(preints)):
        pre = preints[i]
        if pre is None:
            continue
        qi, qj = q_imu[i], q_imu[i + 1]
        # residual: log( dq^-1 * (qi^-1 qj) )
        q_ij = _quat_mul(_quat_conj(pre.dq), _quat_mul(_quat_conj(qi), qj))
        # dq(bg) ~ dq(0) * exp(J_q_bg bg)  =>  J bg = log(dq0^-1 q_ij)
        r = 2.0 * q_ij[1:] * np.sign(q_ij[0])
        J = pre.J_q_bg
        A += J.T @ J
        b += J.T @ r
    return np.linalg.solve(A + 1e-12 * np.eye(3), b)


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_conj(q):
    return q * np.array([1.0, -1, -1, -1])


def linear_alignment(R_imu, p_cam, preints, p_CinI, gravity_mag):
    """Solve per-frame velocities, gravity vector, and metric scale.

    ≙ LinearAlignment + RefineGravity (`initial_aligment.cpp:64-223`).
    R_imu: (F,3,3) IMU-to-"cam world"; p_cam: (F,3) camera positions in the
    SfM (unscaled) world; preints: F-1 pre-integrations.
    Returns (velocities (F,3) in body frames, g_w (3,), scale) or None.
    """
    F = len(R_imu)
    n_state = 3 * F + 3 + 1
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)

    for i in range(F - 1):
        pre = preints[i]
        dt = pre.sum_dt
        H = np.zeros((6, 10))
        z = np.zeros(6)
        Ri = R_imu[i].T  # world -> body i
        # position rows
        H[:3, :3] = -dt * np.eye(3)
        H[:3, 6:9] = 0.5 * Ri @ np.eye(3) * dt * dt
        H[:3, 9] = Ri @ (p_cam[i + 1] - p_cam[i])
        z[:3] = pre.dp + Ri @ R_imu[i + 1] @ p_CinI - p_CinI
        # velocity rows
        H[3:6, :3] = -np.eye(3)
        H[3:6, 3:6] = Ri @ R_imu[i + 1]
        H[3:6, 6:9] = Ri @ np.eye(3) * dt
        z[3:6] = pre.dv
        # scatter into (vi, vi+1, g, s)
        idx = np.r_[3 * i : 3 * i + 3, 3 * (i + 1) : 3 * (i + 1) + 3,
                    3 * F : 3 * F + 3, 3 * F + 3]
        # columns of H map to [vi(3), vi+1(3), g(3), s(1)]
        Hfull = np.zeros((6, n_state))
        Hfull[:, idx[:3]] = H[:, :3]
        Hfull[:, idx[3:6]] = H[:, 3:6]
        Hfull[:, idx[6:9]] = H[:, 6:9]
        Hfull[:, idx[9]] = H[:, 9]
        A += Hfull.T @ Hfull
        b += Hfull.T @ z

    A *= 1000.0
    b *= 1000.0
    x = np.linalg.solve(A + 1e-10 * np.eye(n_state), b)
    s = x[-1]
    g = x[3 * F : 3 * F + 3]
    if s <= 0 or abs(np.linalg.norm(g) - gravity_mag) > 1.0:
        return None

    # gravity refinement on the 2-DoF tangent basis (4 rounds,
    # ≙ RefineGravity)
    g0 = g / np.linalg.norm(g) * gravity_mag
    for _ in range(4):
        bx, by = _tangent_basis(g0)
        n2 = 3 * F + 2 + 1
        A2 = np.zeros((n2, n2))
        b2 = np.zeros(n2)
        for i in range(F - 1):
            pre = preints[i]
            dt = pre.sum_dt
            Ri = R_imu[i].T
            lxly = np.stack([bx, by], axis=1)  # (3,2)
            Hp_v = -dt * np.eye(3)
            Hp_g = 0.5 * Ri @ lxly * dt * dt
            Hp_s = (Ri @ (p_cam[i + 1] - p_cam[i]))[:, None]
            zp = pre.dp + Ri @ R_imu[i + 1] @ p_CinI - p_CinI - 0.5 * Ri @ g0 * dt * dt
            Hv_vi = -np.eye(3)
            Hv_vj = Ri @ R_imu[i + 1]
            Hv_g = Ri @ lxly * dt
            zv = pre.dv - Ri @ g0 * dt
            Hfull = np.zeros((6, n2))
            Hfull[:3, 3 * i : 3 * i + 3] = Hp_v
            Hfull[:3, 3 * F : 3 * F + 2] = Hp_g
            Hfull[:3, -1:] = Hp_s
            Hfull[3:, 3 * i : 3 * i + 3] = Hv_vi
            Hfull[3:, 3 * (i + 1) : 3 * (i + 1) + 3] = Hv_vj
            Hfull[3:, 3 * F : 3 * F + 2] = Hv_g
            z6 = np.concatenate([zp, zv])
            A2 += Hfull.T @ Hfull
            b2 += Hfull.T @ z6
        x2 = np.linalg.solve(A2 * 1000.0 + 1e-10 * np.eye(n2), b2 * 1000.0)
        dg = x2[3 * F : 3 * F + 2]
        g0 = g0 + bx * dg[0] + by * dg[1]
        g0 = g0 / np.linalg.norm(g0) * gravity_mag
        s = x2[-1]
    if s <= 0:
        return None
    v = x2[: 3 * F].reshape(F, 3)
    return v, g0, s


def _tangent_basis(g):
    a = g / np.linalg.norm(g)
    tmp = np.array([0.0, 0.0, 1.0])
    if abs(a @ tmp) > 0.99:
        tmp = np.array([1.0, 0.0, 0.0])
    bx = tmp - a * (a @ tmp)
    bx /= np.linalg.norm(bx)
    by = np.cross(a, bx)
    return bx, by


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


class VIOInitializer:
    """Accumulates frames + IMU; attempts the full visual-inertial bootstrap
    once the init window fills (≙ VIOInitialization::ProcessImage /
    InitialStructure / VisualInitialAlign, `vio_initial.cpp:21-268`).

    feed_frame returns an InitialState (at the *newest* frame's time) once
    initialization succeeds, else None.
    """

    def __init__(self, q_CtoI, p_CinI, gravity_mag=9.80766, window_size=10,
                 excite_threshold=0.25, min_parallax=30.0 / 460.0):
        self.R_CtoI = _quat_to_R(np.asarray(q_CtoI, dtype=np.float64))
        self.p_CinI = np.asarray(p_CinI, dtype=np.float64)
        self.g_mag = gravity_mag
        self.W = window_size
        self.excite = excite_threshold
        self.min_par = min_parallax
        self.frames = []   # list of (t_ns, {fid: (x, y)})
        self.preints: List[Optional[PreIntegration]] = []
        self._imu_t: List[int] = []
        self._imu: List = []

    def feed_imu(self, t_ns, gyro, accel):
        self._imu_t.append(int(t_ns))
        self._imu.append((np.asarray(gyro, np.float64),
                          np.asarray(accel, np.float64)))

    def feed_frame(self, t_ns, ids, pts) -> Optional[InitialState]:
        obs = {int(i): np.asarray(p[:2], np.float64) for i, p in zip(ids, pts)}
        if self.frames:
            pre = PreIntegration()
            t_prev = self.frames[-1][0]
            for k in range(len(self._imu_t)):
                if self._imu_t[k] < t_prev or self._imu_t[k] > t_ns:
                    continue
                dt = 0.0
                if pre._last is not None:
                    dt = (self._imu_t[k] - self._imu_t[k - 1]) * 1e-9
                pre.push(dt, self._imu[k][1], self._imu[k][0])
            self.preints.append(pre)
        self.frames.append((int(t_ns), obs))

        if len(self.frames) <= self.W:
            return None
        if len(self.frames) > self.W + 1:
            self.frames.pop(0)
            self.preints.pop(0)

        out = self._try_initialize()
        return out

    # ------------------------------------------------------------------
    def _try_initialize(self) -> Optional[InitialState]:
        F = len(self.frames)
        # [1] excitation: variance of pre-integrated mean accelerations
        gs = [p.dv / max(p.sum_dt, 1e-6) for p in self.preints if p.sum_dt > 0]
        if len(gs) < F - 2:
            return None
        gs = np.stack(gs)
        if np.sqrt(np.mean(np.sum((gs - gs.mean(0)) ** 2, axis=1))) < self.excite:
            return None  # "Dont move" — not enough excitation

        # [2] find reference frame l with parallax + correspondences to newest
        tracks = self._build_tracks()
        l_pick = None
        for l in range(F - 1):
            c1, c2 = [], []
            for fid, s, pts in tracks:
                if s <= l and s + len(pts) - 1 >= F - 1:
                    c1.append(pts[l - s])
                    c2.append(pts[F - 1 - s])
            if len(c1) < 20:
                continue
            par = np.mean(np.linalg.norm(np.asarray(c1) - np.asarray(c2), axis=1))
            if par > self.min_par:
                l_pick = (l, np.asarray(c1), np.asarray(c2))
                break
        if l_pick is None:
            return None
        l, c1, c2 = l_pick

        E, inl = essential_from_correspondences(c1, c2)
        if E is None:
            return None
        R_rel, t_rel = recover_pose(E, c1[inl], c2[inl])

        # [3] SfM (world = camera frame l)
        sfm = global_sfm(F, tracks, l, R_rel, t_rel)
        if sfm is None:
            return None
        # quality gate: mean reprojection error (RS-distorted fast-motion
        # windows fail here and we retry on the next frame, ≙ the
        # retry-every-frame behavior of `vio_initial.cpp:42-56`)
        errs = []
        for (fid, f), x in ((k, v) for k, v in _iter_obs(tracks) if k[0] in sfm.points):
            Xc = sfm.R[f] @ sfm.points[fid] + sfm.t[f]
            if Xc[2] > 1e-3:
                errs.append(np.linalg.norm(Xc[:2] / Xc[2] - x))
        if not errs or np.mean(errs) > 0.02:
            return None

        # camera poses in world: R_c2w, p_c
        R_c2w = np.transpose(sfm.R, (0, 2, 1))
        p_c = -np.einsum("nij,nj->ni", R_c2w, sfm.t)
        # IMU orientations in world
        R_i2w = np.einsum("nij,kj->nik", R_c2w, self.R_CtoI)

        # [4] gyro bias + repropagate
        q_imu = np.stack([_R_to_quat(R_i2w[i]) for i in range(F)])
        bg = solve_gyro_bias(q_imu, self.preints)
        if np.linalg.norm(bg) > 0.2:  # implausible gyro bias -> bad SfM
            return None
        for p in self.preints:
            p.repropagate(bg)

        # [5] linear alignment: velocities, gravity (in world=cam l), scale
        out = linear_alignment(R_i2w, p_c, self.preints, self.p_CinI, self.g_mag)
        if out is None:
            return None
        v_body, g_w, s = out

        # [6] gravity-align the world (≙ VisualInitialAlign rotation logic)
        # R0 rotates world so g maps to +z; zero the yaw of frame 0
        R0 = _rot_between(g_w, np.array([0.0, 0.0, self.g_mag]))
        R00 = R0 @ R_i2w[0]
        yaw = np.arctan2(R00[1, 0], R00[0, 0])
        R0 = _rot_z(-yaw) @ R0

        R_i2g = np.einsum("ij,njk->nik", R0, R_i2w)
        # IMU position: p_cam = p_imu + R_i2w p_CinI  =>  p_imu = s*p_c - R p_CinI
        p_imu = s * p_c - np.einsum("nij,j->ni", R_i2w, self.p_CinI)
        p_imu = np.einsum("ij,nj->ni", R0, p_imu)
        p_imu = p_imu - p_imu[0]
        v_world = np.einsum("nij,nj->ni", R_i2g, v_body)

        t_last = self.frames[-1][0]
        return InitialState(
            t_ns=t_last,
            q=_R_to_quat(R_i2g[F - 1]),
            p=p_imu[F - 1],
            bg=bg,
            ba=np.zeros(3),
            gravity=np.array([0.0, 0.0, self.g_mag]),
            v=v_world[F - 1],
        )

    def _build_tracks(self):
        """Contiguous tracks across the current init window."""
        F = len(self.frames)
        first = {}
        for f in range(F):
            for fid in self.frames[f][1]:
                first.setdefault(fid, f)
        tracks = []
        for fid, s in first.items():
            pts = []
            for f in range(s, F):
                if fid in self.frames[f][1]:
                    pts.append(self.frames[f][1][fid])
                else:
                    break
            if len(pts) >= 2:
                tracks.append((fid, s, pts))
        return tracks


def _iter_obs(tracks):
    for fid, s, pts in tracks:
        for k, p in enumerate(pts):
            yield (fid, s + k), np.asarray(p[:2])


def _rot_between(a, b):
    """Rotation taking direction a to direction b."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = a @ b
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    K = _skew(v)
    return np.eye(3) + K + K @ K * (1 / (1 + c))


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
