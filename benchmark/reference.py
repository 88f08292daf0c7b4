"""The plain reference that decides `correct`: numpy, nothing of the port.

From the generator's draws it works out the ground truth again (the
lissajous poses at each frame time, the true line delay), evaluates the
estimator's final spline from its knots with its own cumulative B-spline,
and compares each lane's answers with the truth.

The judged poses are cut into consecutive stretches of `SEGMENT_S` (30 s)
of frame time, counted from the window's first judged frame; a last
stretch shorter than half of that joins the one before, so a window of
less than 45 s is one stretch. Each stretch is aligned to the truth on its
own, in yaw and translation (the directions visual-inertial odometry
cannot observe): the numbers measure the drift over a fixed stretch of the
rig's path, not over however many frames the window held. Every judged
pose lies in exactly one stretch, and for each lane:

- `ate_online_cm`: RMS position error of the poses the timed calls
  returned, over all of them, each under its stretch's alignment;
- `pose_err_max_cm`, `rot_err_max_deg`: the worst single returned pose, in
  position and in rotation, so that one wrong answer shows;
- `ate_posthoc_cm`: RMS position error of the final spline at the same
  times, its stretches aligned alike;
- `ld_err_us`: the line delay's error.

Over lanes each number is the worst lane's. Beside them come the numbers
of the float64 check of a sample of the window's solves (`solve_ref`,
`solve_numbers`). A number that is not finite fails. Each limit is set in
the cell's file from readings written down in `PERF.md`.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.sequence import POS_AMP, POS_HZ, ROT_AMP, ROT_HZ

NUMBERS = ("ate_online_cm", "pose_err_max_cm", "rot_err_max_deg",
           "ate_posthoc_cm", "ld_err_us")
SOLVE_NUMBERS = ("solve_rot_urad", "solve_ba_ums2", "prior_info",
                 "prior_grad", "input_faults", "marg_overflows")
# the length of frame time each alignment to the truth spans
SEGMENT_S = 30.0


def qexp(phi):
    t = np.linalg.norm(phi, axis=-1, keepdims=True)
    small = t < 1e-10
    ts = np.where(small, 1.0, t)
    k = np.where(small, 0.5 - t * t / 48.0, np.sin(0.5 * ts) / ts)
    w = np.where(small, 1.0 - t * t / 8.0, np.cos(0.5 * ts))
    return np.concatenate([w, k * phi], -1)


def qlog(q):
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)
    v = q[..., 1:]
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    ang = 2.0 * np.arctan2(n, q[..., :1])
    return np.where(n < 1e-12, 2.0 * v, v * ang / np.where(n < 1e-12, 1, n))


def qmul(a, b):
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    return np.concatenate([aw * bw - (av * bv).sum(-1, keepdims=True),
                           aw * bv + bw * av + np.cross(av, bv)], -1)


def qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def clock(pause: dict, t):
    """The rig's clock: t less the time its one pause (a sin^2 dip of the
    rate) held it back."""
    x = np.clip((t - pause["at_s"]) / pause["len_s"], 0.0, 1.0)
    return t - pause["depth"] * pause["len_s"] * (
        x / 2 - np.sin(2 * math.pi * x) / (4 * math.pi))


def truth(phases, speed, pause, t_s):
    """Ground-truth IMU pose (q, p) at times `t_s` (seconds)."""
    t = clock(pause, np.asarray(t_s, np.float64))[:, None]
    w = 2 * math.pi * np.array(POS_HZ) * speed
    wr = 2 * math.pi * np.array(ROT_HZ) * speed
    p = np.array(POS_AMP) * np.sin(w * t + phases[:3])
    q = qexp(np.array(ROT_AMP) * np.sin(wr * t + phases[3:]))
    return q, p


def spline(knots_q, knots_p, dt_ns, t_ns):
    """Uniform cubic B-spline on SO(3) x R^3: cumulative on the rotation,
    the standard basis on the position; knot i at time i * dt_ns."""
    t_ns = np.asarray(t_ns, np.int64)
    i0 = np.clip(t_ns // dt_ns, 0, len(knots_q) - 4)
    u = ((t_ns - i0 * dt_ns) / dt_ns)[:, None]
    idx = i0[:, None] + np.arange(4)
    q4, p4 = knots_q[idx], knots_p[idx]
    B = np.concatenate([(1 - u) ** 3, 3 * u ** 3 - 6 * u ** 2 + 4,
                        -3 * u ** 3 + 3 * u ** 2 + 3 * u + 1, u ** 3], -1) / 6
    p = (B[..., None] * p4).sum(1)
    lam = np.concatenate([5 + 3 * u - 3 * u ** 2 + u ** 3,
                          1 + 3 * u + 3 * u ** 2 - 2 * u ** 3, u ** 3], -1) / 6
    q = q4[:, 0]
    for j in range(3):
        d = qlog(qmul(qconj(q4[:, j]), q4[:, j + 1]))
        q = qmul(q, qexp(lam[:, j:j + 1] * d))
    return q / np.linalg.norm(q, axis=-1, keepdims=True), p


def align_yaw(est, gt):
    """Yaw angle and translation that best map `est` onto `gt` (least
    squares)."""
    e, g = est - est.mean(0), gt - gt.mean(0)
    yaw = math.atan2(float((e[:, 0] * g[:, 1] - e[:, 1] * g[:, 0]).sum()),
                     float((e[:, 0] * g[:, 0] + e[:, 1] * g[:, 1]).sum()))
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return yaw, R, gt.mean(0) - R @ est.mean(0)


def pose_errors(q, p, q_gt, p_gt):
    """Per-pose position (m) and rotation (rad) errors after the yaw
    alignment of the positions."""
    yaw, R, t = align_yaw(p, p_gt)
    dp = np.linalg.norm(p @ R.T + t - p_gt, axis=-1)
    q_yaw = np.array([math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)])
    dq = qmul(qconj(q_gt), qmul(np.broadcast_to(q_yaw, q.shape), q))
    ang = 2 * np.arctan2(np.linalg.norm(dq[:, 1:], axis=-1), np.abs(dq[:, 0]))
    return dp, ang


def stretches(t_ns):
    """The stretch of each judged pose at frame times `t_ns`: how many whole
    `SEGMENT_S` lie between it and the first judged frame. A last stretch
    whose last frame comes less than `SEGMENT_S / 2` after its start is
    counted in the one before."""
    t = np.asarray(t_ns, np.int64)
    seg = round(SEGMENT_S * 1e9)
    t = t - t.min()
    k = t // seg
    last = int(k.max())
    if last and t.max() - last * seg < seg // 2:
        k[k == last] = last - 1
    return k


def stretch_errors(q, p, q_gt, p_gt, k):
    """`pose_errors` of each stretch (`k`, as `stretches` gives it) under its
    own alignment, in the poses' order."""
    dp, ang = np.empty(len(p)), np.empty(len(p))
    for s in np.unique(k):
        m = k == s
        dp[m], ang[m] = pose_errors(q[m], p[m], q_gt[m], p_gt[m])
    return dp, ang


def lane_numbers(lane: dict, line_delay: float) -> dict:
    q_gt, p_gt = truth(lane["phases"], lane["speed"], lane["pause"],
                       lane["t_ns"] * 1e-9)
    q, p = lane["q"], lane["p"]
    if not (np.isfinite(q).all() and np.isfinite(p).all()):
        return {k: math.nan for k in NUMBERS}
    k = stretches(lane["t_ns"])
    dp, ang = stretch_errors(q / np.linalg.norm(q, axis=-1, keepdims=True),
                             p, q_gt, p_gt, k)
    qs, ps = spline(lane["knots_q"], lane["knots_p"], lane["dt_ns"],
                    lane["t_ns"] - lane["start_ns"])
    dp_post, _ = stretch_errors(qs, ps, q_gt, p_gt, k)
    return {"ate_online_cm": float(np.sqrt(np.mean(dp ** 2)) * 100),
            "pose_err_max_cm": float(dp.max() * 100),
            "rot_err_max_deg": float(np.degrees(ang.max())),
            "ate_posthoc_cm": float(np.sqrt(np.mean(dp_post ** 2)) * 100),
            "ld_err_us": abs(lane["line_delay"] - line_delay) * 1e6}


def solve_numbers(solves, overflows: int) -> dict:
    """The float64 check of the sampled calls (`solve_ref`): over them, the
    median of the largest rotation gap between the port's solved knots and
    the reference's and of the accelerometer biases' gap,
    and where a call marginalized the oldest keyframe, the median gaps of
    the prior it left (information and gradient, in the reference's
    standard deviations); the packed values that were not the
    generator's; the marginalizations that dropped factors (the
    estimator's count and the sampled summaries'). A median: a precision
    fault moves every solve, while one solve that stopped early on a tie
    at float32 rounding moves its own (a wrong answer shows in
    `pose_err_max_cm`)."""
    if not solves:
        return {k: math.nan for k in SOLVE_NUMBERS}

    def med(k, scale=1.0):
        v = [s[k] * scale for s in solves if k in s]
        return float(np.median(v)) if v else math.nan

    return {"solve_rot_urad": med("rot_urad"),
            "solve_ba_ums2": med("ba", 1e6),
            "prior_info": med("prior_info"), "prior_grad": med("prior_grad"),
            "input_faults": float(sum(s["faults"] for s in solves)),
            "marg_overflows": float(overflows + sum(
                s["overflow"] > 0 for s in solves))}


def judge(lanes, line_delay: float, limits: dict, solves, overflows: int):
    """(correct, {name: {"value", "limit"}}, per-lane numbers): every
    number of the worst lane, and of the solve check, within its limit."""
    per_lane = [lane_numbers(lane, line_delay) for lane in lanes]
    checks = {}
    for k in NUMBERS:
        vals = [n[k] for n in per_lane]
        v = math.nan if any(math.isnan(x) for x in vals) else max(vals)
        checks[k] = {"value": v, "limit": limits[k]}
    for k, v in solve_numbers(solves, overflows).items():
        checks[k] = {"value": v, "limit": limits[k]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks, per_lane
