"""End-to-end sliding-window replay through the port's `CtrlVIO` on the
CPU in float64 (the port of `tests/test_e2e.py`): predict, triangulate,
BA, gauge, marginalization and slide must track the ground truth and
calibrate the line delay online, under the JAX test's own gates, and
follow the JAX package's trajectory on the same sequence. Slow, like the
originals: each case runs both packages' whole pipelines."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig
from ctrlvio_tpu_torch.utils.ate import ate_rmse
from tests.torch_parity import one_torch_thread  # noqa: F401

# the port's trajectory against the JAX package's, both f64 and
# synchronous: two chains of the same solves, apart by rounding only
JAX_GAP_M = 1e-3


def _vio(sim, **kw):
    cfg = VIOConfig(
        window_config=WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256),
        dtype=torch.float64, **kw)
    return CtrlVIO(cfg, so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64)),
                   np.array(sim.cfg.ext_pos), device="cpu")


def run_pipeline(duration=6.0, fix_ld=False, ld_init=0.0, seed=11):
    """`tests/test_e2e.py::run_pipeline` through the port: ground-truth
    bootstrap, every IMU sample first, then every frame."""
    sim = synthetic.generate(synthetic.SimConfig(
        duration=duration, n_landmarks=250, seed=seed))
    vio = _vio(sim, fix_ld=fix_ld, ld_init=ld_init)
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
    return sim, vio, np.asarray(est), np.asarray(gt)


def jax_gap(est, jax_est):
    assert est.shape == jax_est.shape, (est.shape, jax_est.shape)
    return float(np.linalg.norm(est - jax_est, axis=1).max())


@pytest.mark.slow
def test_e2e_tracks_and_calibrates_ld():
    """6 s, the line delay calibrated online from 0: >= 45 solved frames,
    ATE < 3 cm (yaw-aligned, from the 11th frame), line-delay error
    < 1.5 us; within 1 mm of the JAX package's estimates."""
    from tests.test_e2e import run_pipeline as jax_pipeline

    sim, vio, est, gt = run_pipeline(duration=6.0, fix_ld=False, ld_init=0.0)
    assert len(est) >= 45
    err = ate_rmse(est[10:], gt[10:], align="yaw")
    assert err < 0.03, f"ATE {err:.4f} m"
    assert abs(vio.traj.line_delay - sim.cfg.line_delay) < 1.5e-6
    _, jvio, jest, _ = jax_pipeline(duration=6.0, fix_ld=False, ld_init=0.0)
    assert jax_gap(est, jest) < JAX_GAP_M
    assert abs(vio.traj.line_delay - jvio.traj.line_delay) < 1e-8


@pytest.mark.slow
def test_e2e_fixed_ld_gs_mode():
    """Line delay fixed at the truth: ATE < 3 cm from the 6th frame, the
    line delay unchanged; within 1 mm of the JAX package's estimates."""
    from tests.test_e2e import run_pipeline as jax_pipeline

    kw = dict(duration=4.0, fix_ld=True, ld_init=29.4737e-6, seed=13)
    sim, vio, est, gt = run_pipeline(**kw)
    err = ate_rmse(est[5:], gt[5:], align="yaw")
    assert err < 0.03, f"ATE {err:.4f} m"
    assert vio.traj.line_delay == 29.4737e-6
    _, _, jest, _ = jax_pipeline(**kw)
    assert jax_gap(est, jest) < JAX_GAP_M


def run_visual(vio_of_sim, seed=17):
    """`tests/test_e2e.py::test_e2e_visual_bootstrap`'s run: reference-level
    sensor noise, gentle motion, the visual bootstrap, IMU fed up to each
    frame, through the estimator `vio_of_sim(sim)` makes."""
    sim = synthetic.generate(synthetic.reference_noise(
        duration=6.0, n_landmarks=250, seed=seed, rot_excite=0.05,
        pos_excite=0.04))
    vio = vio_of_sim(sim)
    est, gt, k = [], [], 0
    for fr in sim.frames:
        while k < len(sim.imu_t_ns) and sim.imu_t_ns[k] <= fr.t_ns:
            vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
            k += 1
        out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        if out is not None:
            est.append(out[1])
            gt.append(sim.pose_at(fr.t_ns * 1e-9)[1])
    return sim, vio, np.asarray(est), np.asarray(gt)


@pytest.mark.slow
def test_e2e_visual_bootstrap():
    """No ground-truth hint, reference-level noise: the visual-inertial
    bootstrap starts the run; >= 20 tracked frames, ATE < 8 cm
    (yaw-aligned, from the 9th), line-delay error < 3 us; the JAX
    package's run bootstraps on the same frame and its estimates are
    within 1 mm."""
    from ctrlvio_tpu.estimator import odometry as jodometry
    from ctrlvio_tpu.solver import layout as jlayout

    sim, vio, est, gt = run_visual(
        lambda sim: _vio(sim, fix_ld=False, ld_init=0.0, bootstrap="visual"))
    assert len(est) >= 20, f"only {len(est)} tracked frames"
    err = ate_rmse(est[8:], gt[8:], align="yaw")
    assert err < 0.08, f"ATE {err:.4f} m"
    assert abs(vio.traj.line_delay - sim.cfg.line_delay) < 3e-6

    def jax_vio(sim):
        cfg = jodometry.VIOConfig(
            window_config=jlayout.WindowConfig(KW=32, NB=11, LM=256, OBS=768,
                                               MIMU=256),
            fix_ld=False, ld_init=0.0, dtype=np.float64, bootstrap="visual")
        return jodometry.CtrlVIO(
            cfg, so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64)),
            np.array(sim.cfg.ext_pos))

    _, _, jest, _ = run_visual(jax_vio)
    assert jax_gap(est, jest) < JAX_GAP_M
