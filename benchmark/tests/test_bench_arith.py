"""The benchmark's arithmetic: the window's rate, the tail and its count,
the kernels' byte counts, and the reference's spline and alignment."""

import math

import numpy as np
import pytest

from benchmark import reference, roofline, stats

E2E_WINDOW = {"KW": 32, "NB": 11, "LM": 256, "OBS": 768, "MIMU": 256}


def test_rate_counts_the_closing_sync():
    # ten calls of 10 ms, then a flush and synchronize of 100 ms: the
    # window is 0.2 s, not the calls' 0.1 s
    calls = [0.010] * 10
    t_open = 5.0
    t_close = t_open + sum(calls) + 0.100
    assert stats.rate(len(calls), t_open, t_close) == pytest.approx(50.0)


def test_p95_and_the_samples_beyond_it():
    xs = list(range(1, 201))
    p95, beyond = stats.percentile(xs, 95)
    assert (p95, beyond) == (190, 10)
    p95, beyond = stats.percentile([3.0, 1.0, 2.0], 95)
    assert (p95, beyond) == (3.0, 0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_kernel_bytes_at_the_e2e_window():
    k2 = roofline.k2_bytes(E2E_WINDOW, 4)
    k3 = roofline.k3_bytes(E2E_WINDOW, 4)
    assert round(k2 / 1e6, 2) == 1.66
    assert round(k3 / 1e6, 2) == 1.61
    # eight lanes in one vmapped launch read the shared constants once
    assert roofline.k2_bytes(E2E_WINDOW, 4, 8) == 8 * k2 - 7 * 8 * 4
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.k2_bound_s(E2E_WINDOW, "float32", 1, kind) \
        == pytest.approx(0.495e-6, rel=0.01)


def test_reference_spline_matches_the_ports_trajectory():
    from ctrlvio_tpu_torch.models.trajectory import Trajectory

    rng = np.random.default_rng(0)
    tr = Trajectory(0.05)
    tr.extend_to(int(1.0e9))
    tr.knots_q[:tr.n] = reference.qexp(rng.normal(size=(tr.n, 3)) * 0.4)
    tr.knots_p[:tr.n] = rng.normal(size=(tr.n, 3))
    t = np.array([0, 7, 49_999_999, 50_000_000, 333_333_333, 899_999_999],
                 np.int64)
    q, p = tr.pose(t)
    q2, p2 = reference.spline(tr.knots_q[:tr.n], tr.knots_p[:tr.n],
                              int(tr.dt_ns), t)
    sign = np.sign((q * q2).sum(-1, keepdims=True))
    np.testing.assert_allclose(q2 * sign, q, atol=1e-12)
    np.testing.assert_allclose(p2, p, atol=1e-12)


def test_yaw_alignment_undoes_a_yaw_and_a_shift():
    rng = np.random.default_rng(1)
    gt = rng.normal(size=(50, 3))
    q_gt = reference.qexp(rng.normal(size=(50, 3)))
    yaw = 0.7
    q_yaw = np.array([math.cos(-yaw / 2), 0, 0, math.sin(-yaw / 2)])
    c, s = math.cos(-yaw), math.sin(-yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = gt @ R.T + np.array([1.0, -2.0, 0.5])
    q_est = reference.qmul(np.broadcast_to(q_yaw, q_gt.shape), q_gt)
    dp, ang = reference.pose_errors(q_est, est, q_gt, gt)
    assert dp.max() < 1e-12 and ang.max() < 1e-7


def test_judge_fails_a_nan_and_a_number_over_its_limit():
    pause = {"at_s": 0.4, "len_s": 0.2, "depth": 0.5}
    lane = dict(t_ns=np.arange(5, dtype=np.int64) * 100_000_000 + 300_000_000,
                phases=np.zeros(6), speed=1.0, pause=pause, dt_ns=50_000_000,
                start_ns=0, line_delay=3e-5)
    q, p = reference.truth(lane["phases"], 1.0, pause, lane["t_ns"] * 1e-9)
    n = 40
    kt = np.arange(n) * 0.05
    kq, kp = reference.truth(lane["phases"], 1.0, pause, kt)
    lane.update(q=q, p=p, knots_q=kq, knots_p=kp)
    limits = {k: 1e9 for k in reference.NUMBERS + reference.SOLVE_NUMBERS}
    limits.update(input_faults=0, marg_overflows=0)
    solves = [dict(rot_urad=0.1 * i, pos_um=0.5, ba=1e-7, faults=0,
                   overflow=0.0, prior_info=1e-5, prior_grad=1e-4)
              for i in range(1, 4)]
    ok, checks, _ = reference.judge([lane], 3e-5, limits, solves, 0)
    assert ok and checks["ate_online_cm"]["value"] < 1e-9
    assert abs(checks["solve_rot_urad"]["value"] - 0.2) < 1e-12  # median
    ok, checks, _ = reference.judge([lane], 3e-5, dict(limits, ld_err_us=0.0),
                                    solves, 0)
    assert ok  # an exact line delay meets a limit of 0
    ok, _, _ = reference.judge([lane], 2e-5, dict(limits, ld_err_us=5.0),
                               solves, 0)
    assert not ok
    ok, _, _ = reference.judge([lane], 3e-5, limits, solves, 1)
    assert not ok  # a marginalization that dropped factors
    ok, _, _ = reference.judge([lane], 3e-5, limits,
                               solves[:2] + [dict(solves[2], faults=1)], 0)
    assert not ok  # a packed value that is not the generator's
    ok, checks, _ = reference.judge([lane], 3e-5, limits, [], 0)
    assert not ok and math.isnan(checks["solve_rot_urad"]["value"])
    lane["p"] = p.copy()
    lane["p"][2, 0] = np.nan
    ok, checks, _ = reference.judge([lane], 3e-5, limits, solves, 0)
    assert not ok and math.isnan(checks["pose_err_max_cm"]["value"])
