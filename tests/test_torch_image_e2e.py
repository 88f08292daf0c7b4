"""Image-driven end-to-end through the port on the CPU (the port of
`tests/test_image_e2e.py`): rendered rolling-shutter frames through
CLAHE, the pyramidal KLT (K1's plain version on the CPU), undistortion
and the sliding-window BA with online line-delay calibration, under the
JAX test's gates, and against the JAX package's trajectory on the same
frames. Slow, like the original."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig
from ctrlvio_tpu_torch.models.cameras import Pinhole
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import render, synthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig
from ctrlvio_tpu_torch.utils.ate import ate_rmse
from tests.torch_parity import one_torch_thread  # noqa: F401

H, W, FX, CX, CY = 256, 320, 200.0, 160.0, 128.0
# the line delay scaled so the total readout (H * ld ~ 29 ms) matches the
# TUM-RSVI sensor's at this reduced resolution
LD = 1.15e-4


def run(sim, imgs, vio):
    """Ground-truth bootstrap, every IMU sample first, then every image;
    returns (estimates, ground truth, live features a frame)."""
    init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    est, gt, nfeat = [], [], []
    for i, fr in enumerate(sim.frames):
        out = vio.process_image(fr.t_ns, imgs[i])
        nfeat.append(int((np.asarray(vio.tracker.ids) >= 0).sum()))
        if out is not None:
            est.append(out[1])
            gt.append(sim.pose_at(fr.t_ns * 1e-9)[1])
    return np.asarray(est), np.asarray(gt), nfeat


@pytest.mark.slow
def test_image_pipeline_tracks_and_calibrates():
    """4 s of 320x256 frames: >= 20 solved frames, >= 40 live features
    from the third frame on, ATE < 15 cm (yaw-aligned, from the 9th),
    line-delay error < 10 us; the JAX package's run on the same frames
    solves as many frames and its estimates are within 1 cm."""
    from ctrlvio_tpu.estimator import odometry as jodometry
    from ctrlvio_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
    from ctrlvio_tpu.models.cameras import Pinhole as JPinhole
    from ctrlvio_tpu.solver import layout as jlayout

    sim = synthetic.generate(synthetic.SimConfig(
        duration=4.0, n_landmarks=600, seed=5, line_delay=LD,
        image_h=H, image_w=W, fx=FX, fy=FX, cx=CX, cy=CY))
    imgs = render.render_sequence(sim, H, W, FX, FX, CX, CY, seed=1)
    q_CtoI = so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64))
    p_CinI = np.array(sim.cfg.ext_pos)
    window = dict(KW=32, NB=11, LM=192, OBS=768, MIMU=256)
    tracker = dict(max_cnt=110, min_dist=12, freq=11.0)

    vio = CtrlVIO(VIOConfig(window_config=WindowConfig(**window),
                            fix_ld=False, ld_init=0.0, ld_upper=2e-4,
                            dtype=torch.float64), q_CtoI, p_CinI,
                  device="cpu")
    vio.attach_frontend(Pinhole(FX, FX, CX, CY), (H, W),
                        TrackerConfig(**tracker))
    est, gt, nfeat = run(sim, imgs, vio)
    assert len(est) >= 20
    assert min(nfeat[2:]) >= 40, nfeat
    err = ate_rmse(est[8:], gt[8:], align="yaw")
    assert err < 0.15, f"ATE {err:.3f} m"
    assert abs(vio.traj.line_delay - LD) < 1e-5, vio.traj.line_delay

    jvio = jodometry.CtrlVIO(jodometry.VIOConfig(
        window_config=jlayout.WindowConfig(**window), fix_ld=False,
        ld_init=0.0, ld_upper=2e-4, dtype=np.float64), q_CtoI, p_CinI)
    jvio.attach_frontend(JPinhole(FX, FX, CX, CY), (H, W),
                         JTrackerConfig(**tracker))
    jest, _, _ = run(sim, imgs, jvio)
    assert jest.shape == est.shape
    assert np.linalg.norm(est - jest, axis=1).max() < 0.01
