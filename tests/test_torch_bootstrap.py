"""Parity of the port's self-bootstraps with the JAX package, float64 on
the CPU: the visual-inertial initializer (`estimator/vio_init.py`, SfM +
gyro bias + alignment) on `tests/test_vio_init.py`'s sequence, the static
bootstrap of `CtrlVIO` (a still IMU) with its fallback to the IMU's own
attitude when the IMU moves, and the visual bootstrap's reject-and-retry
in `CtrlVIO` with a low `init_max_rms` (the port alone, and beside the
JAX package in a slow test). Tolerances: the initial states to 1e-9
relative to the reference's largest entry (numpy on both sides); the
first-window solves to 1e-4 (see the slow test)."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import vio_init as jvio_init
from ctrlvio_tpu.estimator.odometry import CtrlVIO as JCtrlVIO
from ctrlvio_tpu.estimator.odometry import VIOConfig as JVIOConfig
from ctrlvio_tpu.solver.layout import WindowConfig as JWindowConfig
from ctrlvio_tpu_torch.estimator import vio_init as tvio_init
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO as TCtrlVIO
from ctrlvio_tpu_torch.estimator.odometry import VIOConfig as TVIOConfig
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig as TWindowConfig
from tests.torch_parity import close, one_torch_thread  # noqa: F401

WINDOW = dict(KW=24, NB=6, LM=96, OBS=384, MIMU=192)
STATE_FIELDS = ("q", "p", "v", "bg", "ba", "gravity")


def same_state(a, b, rtol=1e-9):
    assert a.t_ns == b.t_ns
    for k in STATE_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            close(x, y, rtol)


def make(side, sim, **kw):
    q_CtoI = so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64))
    p_CinI = np.array(sim.cfg.ext_pos)
    if side == "jax":
        cfg = JVIOConfig(window_config=JWindowConfig(**WINDOW),
                         dtype=np.float64, use_native=False, **kw)
        return JCtrlVIO(cfg, q_CtoI, p_CinI)
    cfg = TVIOConfig(window_config=TWindowConfig(**WINDOW),
                     dtype=torch.float64, **kw)
    return TCtrlVIO(cfg, q_CtoI, p_CinI, device="cpu")


def test_vio_initializer_matches_jax():
    sim = synthetic.generate(synthetic.SimConfig(
        duration=4.0, n_landmarks=200, seed=21, line_delay=1e-7,
        gyro_bias=0.01))
    q_CtoI = so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64))
    p_CinI = np.array(sim.cfg.ext_pos)
    inits = [mod.VIOInitializer(q_CtoI, p_CinI, gravity_mag=sim.cfg.gravity)
             for mod in (jvio_init, tvio_init)]
    imu_idx = 0
    for i, fr in enumerate(sim.frames):
        while imu_idx < len(sim.imu_t_ns) and \
                sim.imu_t_ns[imu_idx] <= fr.t_ns:
            for ini in inits:
                ini.feed_imu(sim.imu_t_ns[imu_idx], sim.gyro[imu_idx],
                             sim.accel[imu_idx])
            imu_idx += 1
        ref, out = (ini.feed_frame(fr.t_ns, fr.ids, fr.pts) for ini in inits)
        assert (ref is None) == (out is None), i
        if out is not None:
            break
    assert out is not None, "initialization never succeeded"
    same_state(ref, out)
    np.testing.assert_allclose(out.bg, sim.bg, atol=2e-3)


def still_imu(rng, n, t0_ns, moving):
    """n IMU samples at 200 Hz of a body at rest, tilted, gravity measured
    with noise; `moving` shakes the accelerometer past the stillness test.
    Also the IMU's own attitude estimate (wxyz) of each sample."""
    q = so3np.quat_exp(np.array([[0.1, -0.2, 0.7]]))[0]
    R = so3np.quat_to_matrix(q[None])[0]
    g = np.array([0.0, 0.0, 9.80766])
    t = t0_ns + np.arange(n, dtype=np.int64) * 5_000_000
    gyro = np.array([0.01, -0.02, 0.005]) + 1e-3 * rng.normal(size=(n, 3))
    accel = R.T @ g + np.array([0.05, 0.02, -0.03]) \
        + (1.5 if moving else 0.01) * rng.normal(size=(n, 3))
    return t, gyro, accel, np.tile(q, (n, 1))


@pytest.mark.parametrize("moving", [False, True],
                         ids=["static", "attitude_fallback"])
def test_static_bootstrap_matches_jax(moving):
    """Still IMU without an attitude: the static initializer's state,
    anchored at the next frame. Shaken IMU with an attitude: the
    fallback's state (taken on any sample the stillness test fails)."""
    sim = synthetic.generate(synthetic.SimConfig(duration=2.0,
                                                 n_landmarks=60, seed=2))
    rng = np.random.default_rng(4)
    t, gyro, accel, quat = still_imu(rng, 300, sim.frames[0].t_ns, moving)
    vios = [make(side, sim, bootstrap="static") for side in ("jax", "torch")]
    frames = iter(sim.frames[1:])
    fr = next(frames)
    for k in range(len(t)):
        for v in vios:
            v.process_imu(t[k], gyro[k], accel[k],
                          quat=quat[k] if moving else None)
        if t[k] >= fr.t_ns:
            for v in vios:
                v.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
            if vios[1].data_start_ns is not None:
                break
            fr = next(frames)
    ref, out = vios
    assert out.data_start_ns is not None
    assert out.data_start_ns == ref.data_start_ns == fr.t_ns
    assert out.counts["bootstrap_static"] == 1
    same_state(ref._init_state, out._init_state)
    if moving:  # the attitude, yaw removed; biases zero
        close(np.zeros(3), out._init_state.bg)
    else:
        np.testing.assert_allclose(out._init_state.bg, [0.01, -0.02, 0.005],
                                   rtol=0, atol=1e-3)
    np.testing.assert_array_equal(out.imu_t_ns, ref.imu_t_ns)


def drive_reject_then_retry(sides):
    """Feed the noisy sequence to one estimator per side (visual bootstrap,
    `init_max_rms` below the sequence's first-window RMS) until the port
    initializes; the limit is raised to 3.0 after the second rejection.
    Returns the estimators, the (cost, image observations, first window
    time) of every first-window solve, and per frame the pose each
    returned."""
    sim = synthetic.generate(synthetic.reference_noise(
        duration=4.0, n_landmarks=300, seed=3))
    vios = [make(side, sim, bootstrap="visual", fix_ld=False, ld_init=0.0,
                 init_max_rms=0.5, init_ba_iters=10) for side in sides]
    costs = [[] for _ in sides]
    for v, c in zip(vios, costs):
        solve = v._init_solve_f64

        def record(solve=solve, v=v, c=c):
            n = solve()
            c.append((float(v.last_solve_stats.cost), n, v.data_start_ns))
            return n

        v._init_solve_f64 = record
    outs = []
    imu_idx = 0
    for fr in sim.frames:
        while imu_idx < len(sim.imu_t_ns) and \
                sim.imu_t_ns[imu_idx] <= fr.t_ns:
            for v in vios:
                v.process_imu(sim.imu_t_ns[imu_idx], sim.gyro[imu_idx],
                              sim.accel[imu_idx])
            imu_idx += 1
        outs.append([v.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
                     for v in vios])
        if len(costs[-1]) == 2:
            for v in vios:
                v.cfg.init_max_rms = 3.0
        if outs[-1][-1] is not None:
            break
    return vios, costs, outs


def test_visual_bootstrap_reject_then_retry():
    """The port alone: two first windows above the limit are rejected,
    each retry starts from a later window, and the third is accepted."""
    (vio,), (costs,), outs = drive_reject_then_retry(["torch"])
    assert vio.initialized
    assert vio.counts["bootstrap_rejected"] == 2
    assert vio.counts["bootstrap_visual"] == 3
    assert len(costs) == 3
    rms = [np.sqrt(c / n) for c, n, _ in costs]
    assert min(rms[:2]) > 0.5 and rms[2] < 3.0, rms
    starts = [t for _, _, t in costs]
    assert starts[0] < starts[1] < starts[2] == vio.data_start_ns
    # nothing is returned before the accepting frame
    assert all(o[0] is None for o in outs[:-1])
    assert np.isfinite(np.concatenate(outs[-1][0])).all()
    assert 0 <= vio.imu_t_ns[0]  # rebased to the accepted window
    assert np.isfinite(vio.traj.knots_p[: vio.traj.n]).all()


@pytest.mark.slow
def test_visual_bootstrap_reject_then_retry_matches_jax():
    """`test_visual_bootstrap_reject_then_retry` beside the JAX `CtrlVIO`
    fed the same: both reject and accept at the same frames, with the same
    first-window costs, and reach the same first window. Marked slow: the
    JAX package compiles its f64 first-window solves for about two
    minutes on the CPU. The f64 chains (IMU-only fit, SVD triangulation,
    10 unconverged LM iterations) of the two packages agree to 1e-4
    relative."""
    (ref, out), costs, outs = drive_reject_then_retry(["jax", "torch"])
    for o in outs:
        assert (o[0] is None) == (o[1] is None)
    close(np.concatenate(outs[-1][0]), np.concatenate(outs[-1][1]), 1e-4)
    assert ref.initialized and out.initialized
    assert len(costs[0]) == len(costs[1]) == 3
    for (cj, nj, tj), (ct, nt, tt) in zip(*costs):
        assert (nj, tj) == (nt, tt)
        close(cj, ct, 1e-4)
    assert out.data_start_ns == ref.data_start_ns
    assert out.traj.n == ref.traj.n
    np.testing.assert_array_equal(out.kf_t_ns, ref.kf_t_ns)
    # the window's keyframe poses (the spline's tip knots, past the last
    # IMU sample, are extrapolations that the solve barely constrains)
    for a, b in zip(ref.traj.pose(ref.kf_t_ns), out.traj.pose(out.kf_t_ns)):
        close(a, b, 1e-4)
    close(ref.bg, out.bg, 1e-4)
    assert abs(ref.traj.line_delay - out.traj.line_delay) < 1e-8
