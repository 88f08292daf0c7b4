"""The port's out-of-class ground-truth families (`sim/synthetic.py`
`gt_family`, `gt_knot_dt`), against the JAX package's `synthetic.generate`
on the same `SimConfig` (both numpy): the Lissajous and fine-knot sequences
are internally consistent (IMU = pose derivatives) and equal the
reference's bit for bit, and the default family is left unchanged. The
full pipeline through the port's `CtrlVIO` on these families is a slow
test, with the reference test's gates (`tests/test_gt_families.py`)."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu.sim import synthetic as jsynthetic
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from tests.torch_parity import one_torch_thread  # noqa: F401


def finite_diff_check(sim, n=40):
    """IMU channels equal pose derivatives: w_body vs dq/dt and accel vs
    d2p/dt2 (f64 central differences of the exact ground truth)."""
    ts = np.linspace(0.5, sim.cfg.duration - 0.5, n)
    q, p, w, acc = sim.poses_at(ts)
    h = 1e-4
    _, p_hi, _, _ = sim.poses_at(ts + h)
    _, p_lo, _, _ = sim.poses_at(ts - h)
    acc_fd = (p_hi - 2 * p + p_lo) / h**2
    assert np.max(np.abs(acc_fd - acc)) < 5e-3, "accel != d2p/dt2"
    dq = (sim.poses_at(ts + h)[0] - sim.poses_at(ts - h)[0]) / (2 * h)
    w_fd = 2.0 * so3np.quat_mul(so3np.quat_conj(q), dq)[:, 1:]
    assert np.max(np.abs(w_fd - w)) < 5e-4, "w_body != 2 vec(q* dq/dt)"


def same_sim(a, b):
    """Two SimData equal bit for bit: knots, IMU and every frame."""
    for k in ("knots_q", "knots_p", "imu_t_ns", "gyro", "accel"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    assert len(a.frames) == len(b.frames)
    for fa, fb in zip(a.frames, b.frames):
        assert fa.t_ns == fb.t_ns
        np.testing.assert_array_equal(fa.ids, fb.ids)
        np.testing.assert_array_equal(fa.pts, fb.pts)
        np.testing.assert_array_equal(fa.rows, fb.rows)


def both(**kw):
    """The same SimConfig through the port and the JAX package."""
    return (synthetic.generate(synthetic.SimConfig(**kw)),
            jsynthetic.generate(jsynthetic.SimConfig(**kw)))


def test_lissajous_consistency_matches_jax():
    sim, ref = both(duration=4.0, n_landmarks=250, seed=2,
                    gt_family="lissajous")
    finite_diff_check(sim)
    same_sim(sim, ref)
    # dynamics in the handheld envelope (render/visibility assumptions)
    assert np.linalg.norm(sim.gyro, axis=1).max() < 4.0
    assert np.linalg.norm(sim.accel, axis=1).max() < 30.0
    assert all(len(f.ids) > 10 for f in sim.frames)


def test_fine_knot_consistency_matches_jax():
    sim, ref = both(duration=4.0, n_landmarks=80, seed=2, gt_knot_dt=0.01)
    finite_diff_check(sim)
    same_sim(sim, ref)
    assert np.linalg.norm(sim.accel, axis=1).max() < 30.0
    assert len(sim.knots_q) > 4.0 / 0.012  # knots on the fine grid


def test_default_family_unchanged_matches_jax():
    """gt_knot_dt=None keeps the historical generator: the explicit
    spline family equals the default, in the port and in the reference."""
    a, ref = both(duration=2.0, n_landmarks=40, seed=7)
    b = synthetic.generate(synthetic.SimConfig(
        duration=2.0, n_landmarks=40, seed=7, gt_family="spline",
        gt_knot_dt=None, speed=1.0))
    same_sim(a, b)
    same_sim(a, ref)


@pytest.mark.slow
@pytest.mark.parametrize("kw", [dict(gt_family="lissajous"),
                                dict(gt_knot_dt=0.01)])
def test_e2e_out_of_class_gt(kw):
    """The port's full pipeline on out-of-model-class ground truth
    (noiseless, f64 on the CPU): ATE stays sub-cm though the basis cannot
    represent the ground truth."""
    from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
    from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
    from ctrlvio_tpu_torch.solver.layout import WindowConfig
    from ctrlvio_tpu_torch.utils.ate import ate_rmse

    sim = synthetic.generate(synthetic.SimConfig(
        duration=5.0, n_landmarks=250, seed=11, **kw))
    cfg = VIOConfig(
        window_config=WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256),
        fix_ld=False, ld_init=0.0, dtype=torch.float64)
    vio = CtrlVIO(cfg, so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64)),
                  np.array(sim.cfg.ext_pos), device="cpu")
    init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    est, gt = [], []
    for fr in sim.frames:
        out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        if out is not None:
            est.append(out[1])
            gt.append(sim.pose_at(fr.t_ns * 1e-9)[1])
    err = ate_rmse(np.asarray(est)[10:], np.asarray(gt)[10:], align="yaw")
    assert err < 0.01, f"ATE {err * 100:.2f} cm on out-of-class GT"
    assert abs(vio.traj.line_delay - sim.cfg.line_delay) < 1.5e-6
