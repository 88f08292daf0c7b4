"""The judge's stretches (`reference.stretches`, `lane_numbers`): each
`SEGMENT_S` of frame time aligned to the truth on its own, so that a drift
reads the same over a longer window; a window under 45 s judged by one
alignment as before; never above one alignment's RMS over the same poses;
one bad pose still shows; every pose in exactly one stretch."""

import math

import numpy as np
import pytest

from benchmark import reference

FRAME_NS = 100_000_000  # 10 Hz, as both cells' frames
KNOT_NS = 50_000_000
PAUSE = {"at_s": 6.4, "len_s": 0.3, "depth": 1.0}
T0_NS = 3_000_000_000


def frame_times(seconds: float):
    return T0_NS + np.arange(round(seconds * 1e9 / FRAME_NS),
                             dtype=np.int64) * FRAME_NS


def lane_of(seconds: float, moved, seed: int = 0):
    """A lane of 10 Hz frames over `seconds`: the truth's poses and spline
    knots, their positions moved by `moved(t_s, rng)` (an (n, 3) offset in
    metres at times `t_s`), then all of it turned by a yaw and shifted."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0, 2 * math.pi, 6)
    t_ns = frame_times(seconds)
    q, p = reference.truth(phases, 1.0, PAUSE, t_ns * 1e-9)
    # knot i at time i * KNOT_NS: the spline there is near knot i + 1
    kt_s = (np.arange((int(t_ns[-1]) + 4 * KNOT_NS) // KNOT_NS) - 1) \
        * KNOT_NS * 1e-9
    kq, kp = reference.truth(phases, 1.0, PAUSE, kt_s)
    p = p + moved(t_ns * 1e-9, rng)
    kp = kp + moved(kt_s, rng)
    yaw = rng.uniform(-math.pi, math.pi)
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    shift = rng.normal(size=3)
    q_yaw = np.array([math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)])
    turn = lambda qq: reference.qmul(  # noqa: E731
        np.broadcast_to(q_yaw, qq.shape), qq)
    return dict(t_ns=t_ns, q=turn(q), p=p @ R.T + shift, knots_q=turn(kq),
                knots_p=kp @ R.T + shift, dt_ns=KNOT_NS, start_ns=0,
                line_delay=3e-5, phases=phases, speed=1.0, pause=PAUSE)


def one_alignment(lane: dict) -> dict:
    """The numbers of one yaw-and-translation alignment over every judged
    pose (the judge before stretches)."""
    q_gt, p_gt = reference.truth(lane["phases"], lane["speed"],
                                 lane["pause"], lane["t_ns"] * 1e-9)
    q = lane["q"]
    dp, ang = reference.pose_errors(
        q / np.linalg.norm(q, axis=-1, keepdims=True), lane["p"], q_gt, p_gt)
    qs, ps = reference.spline(lane["knots_q"], lane["knots_p"],
                              lane["dt_ns"], lane["t_ns"] - lane["start_ns"])
    dp_post, _ = reference.pose_errors(qs, ps, q_gt, p_gt)
    return {"ate_online_cm": float(np.sqrt(np.mean(dp ** 2)) * 100),
            "pose_err_max_cm": float(dp.max() * 100),
            "rot_err_max_deg": float(np.degrees(ang.max())),
            "ate_posthoc_cm": float(np.sqrt(np.mean(dp_post ** 2)) * 100),
            "ld_err_us": 0.0}


def drift(t_s, rng):
    out = np.zeros((len(t_s), 3))
    out[:, 0] = 0.01 * t_s  # 1 cm/s
    return out


def noise(t_s, rng):
    # a random walk of 2 cm/sqrt(s) and 1 cm of white noise
    steps = rng.normal(scale=0.02 * math.sqrt(0.1), size=(len(t_s), 3))
    return np.cumsum(steps, 0) + rng.normal(scale=0.01, size=(len(t_s), 3))


@pytest.mark.parametrize("number", ["ate_online_cm", "ate_posthoc_cm"])
def test_a_drift_reads_the_same_over_a_longer_window(number):
    short, long = lane_of(60, drift), lane_of(240, drift)
    assert (one_alignment(long)[number]
            >= 1.5 * one_alignment(short)[number])
    a = reference.lane_numbers(short, 3e-5)[number]
    b = reference.lane_numbers(long, 3e-5)[number]
    assert abs(b - a) <= 0.05 * a


@pytest.mark.parametrize("seconds", [0.5, 10, 29.9, 30, 44.9])
def test_a_window_under_45_s_is_judged_by_one_alignment(seconds):
    lane = lane_of(seconds, noise, seed=3)
    assert (reference.stretches(lane["t_ns"]) == 0).all()
    assert reference.lane_numbers(lane, 3e-5) == one_alignment(lane)


@pytest.mark.parametrize("seed", range(6))
def test_never_above_one_alignment_over_the_same_poses(seed):
    rng = np.random.default_rng(100 + seed)
    lane = lane_of(float(rng.uniform(45, 200)), noise, seed=seed)
    got, one = reference.lane_numbers(lane, 3e-5), one_alignment(lane)
    assert reference.stretches(lane["t_ns"]).max() >= 1
    for k in ("ate_online_cm", "ate_posthoc_cm"):
        assert got[k] <= one[k] * (1 + 1e-12), (k, got[k], one[k])


@pytest.mark.parametrize("at", [0, 299, 300, 1000, -1])
def test_one_pose_moved_by_a_metre_shows(at):
    lane = lane_of(110, noise, seed=5)
    assert reference.lane_numbers(lane, 3e-5)["pose_err_max_cm"] < 20
    lane["p"] = lane["p"].copy()
    lane["p"][at, 0] += 1.0
    assert reference.lane_numbers(lane, 3e-5)["pose_err_max_cm"] >= 90


# `seconds` of 10 Hz frames: the last frame comes 0.1 s before their end
@pytest.mark.parametrize("seconds, n", [(20, 1), (45, 1), (45.1, 2), (60, 2),
                                        (75, 2), (75.1, 3), (240, 8),
                                        (255, 8), (255.1, 9)])
def test_every_pose_in_one_stretch_and_a_short_last_one_merged(seconds, n):
    t_ns = frame_times(seconds)
    k = reference.stretches(t_ns)
    assert k.shape == t_ns.shape and k[0] == 0
    # consecutive stretches, each pose in exactly one
    assert (np.diff(k) >= 0).all() and set(np.unique(k)) == set(range(n))
    seg = round(reference.SEGMENT_S * 1e9)
    for s in range(n):
        t = t_ns[k == s] - t_ns[0]
        assert t.min() >= s * seg
        span = t.max() - s * seg
        if s < n - 1:
            assert span < seg
        elif n > 1:
            # the last: at least half a stretch, and at most one and a half
            assert seg // 2 <= span < seg + seg // 2
    # the same boundaries for the same frames in another order
    order = np.random.default_rng(0).permutation(len(t_ns))
    assert (reference.stretches(t_ns[order]) == k[order]).all()
