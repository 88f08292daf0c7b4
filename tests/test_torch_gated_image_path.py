"""The estimator's raw-image path with the F-RANSAC gate on the CPU, the
port against the JAX package: the port's `attach_frontend(gated, lag)`,
`process_image` and `flush` (the gate in the fused tracker's step, K7's
plain version), and the JAX package's gated `FusedTracker(lag)` driven by
hand into its synchronous `CtrlVIO.process_frame` (its own
`attach_frontend` gives the classic tracker to a gated config), on the
lagged tests' scene with its moving quad, at lag 0 and 1.

Tolerances: ids exactly; poses within 1e-4 m and 1e-4 in the quaternion,
as `tests/test_torch_slice.py` holds the synchronous image path. The JAX
side spends about a minute on its first window's f64 bootstrap (run op by
op) on the CPU."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import initializer as jinit
from ctrlvio_tpu.estimator.odometry import CtrlVIO as JCtrlVIO
from ctrlvio_tpu.estimator.odometry import VIOConfig as JVIOConfig
from ctrlvio_tpu.frontend.fused import FusedTracker as JFusedTracker
from ctrlvio_tpu.frontend.fused import rotation_flow
from ctrlvio_tpu.frontend.klt import KLTConfig as JKLTConfig
from ctrlvio_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
from ctrlvio_tpu.models import cameras as jcam
from ctrlvio_tpu.solver.layout import WindowConfig as JWindowConfig
from ctrlvio_tpu_torch.estimator import initializer as tinit
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO as TCtrlVIO
from ctrlvio_tpu_torch.estimator.odometry import VIOConfig as TVIOConfig
from ctrlvio_tpu_torch.frontend.fused import FusedTracker as TFusedTracker
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig as TTrackerConfig
from ctrlvio_tpu_torch.models import cameras as tcam
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.solver.layout import WindowConfig as TWindowConfig
from tests.test_torch_frontend_lagged import scene  # noqa: F401
from tests.test_torch_frontend_lagged import CAM, TRACKER, WINDOW, H, W
from tests.torch_parity import one_torch_thread  # noqa: F401

POSE_TOL = 1e-4        # m, per solved frame (`tests/test_torch_slice.py`)
# the scene's first 11 images: the window fills at the 6th (NB), and the
# gate fires from the 2nd on
FRAMES = 11


def image_path(side, sim, imgs, lag):
    """The lagged tests' scene (its first FRAMES images) through one
    package's synchronous f64 estimator from the ground-truth bootstrap,
    the IMU fed 0.25 s ahead of each image. The port: `attach_frontend(
    gated, lag)`, `process_image`, `flush`. The JAX package: its gated
    `FusedTracker(lag)` driven by hand (the flow from the estimator's own
    IMU buffer and gyro bias, as its `process_image` takes it) into
    `process_frame`, each published frame at its own time, the held one
    after the last image. Returns each frame handed to `process_frame` as
    (t_ns, ids, pose or None), and the tracker."""
    q_CtoI = so3np.quat_exp(np.asarray(sim.cfg.ext_rot, np.float64))
    p_CinI = np.asarray(sim.cfg.ext_pos)
    cfg = dict(fix_ld=False, ld_upper=5e-4, use_native=False, ba_iters=4,
               init_ba_iters=4, predict_iters=4)
    if side == "jax":
        vio = JCtrlVIO(JVIOConfig(window_config=JWindowConfig(**WINDOW),
                                  dtype=np.float64, **cfg), q_CtoI, p_CinI)
        tcfg = dict(TRACKER)
        klt = tcfg.pop("klt")
        tracker = JFusedTracker(JTrackerConfig(
            **tcfg, klt=JKLTConfig(pred_levels=klt.pred_levels)),
            jcam.Equidistant(**CAM), (H, W), lag=lag)
        init = jinit.bootstrap_from_sim(sim)
    else:
        vio = TCtrlVIO(TVIOConfig(window_config=TWindowConfig(**WINDOW),
                                  dtype=torch.float64, **cfg), q_CtoI, p_CinI,
                       device="cpu")
        vio.attach_frontend(tcam.Equidistant(**CAM), (H, W),
                            TTrackerConfig(**TRACKER), lag=lag)
        tracker = vio.tracker
        init = tinit.bootstrap_from_sim(sim)
    k = 0

    def feed(t_ns):
        nonlocal k
        while k < len(sim.imu_t_ns) and sim.imu_t_ns[k] <= t_ns:
            vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
            k += 1

    feed(init.t_ns + 250_000_000)
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    handed = []
    inner = vio.process_frame

    def catch(t_ns, ids, pts, rows):
        out = inner(t_ns, ids, pts, rows)
        handed.append((int(t_ns), np.array(ids),
                       None if out is None else np.concatenate(out)))
        return out

    vio.process_frame = catch
    R_ic = so3np.quat_to_matrix(q_CtoI[None])[0]
    prev = None
    for i, fr in enumerate(sim.frames[:FRAMES]):
        feed(fr.t_ns + 250_000_000)
        if side == "torch":
            vio.process_image(fr.t_ns, imgs[i])
            continue
        base = vio.data_start_ns or 0
        M = None if prev is None else rotation_flow(
            vio.imu_t_ns, vio.imu_gyro, prev - base, fr.t_ns - base, R_ic,
            bg=vio.bg[-1])
        prev = fr.t_ns
        out = tracker.step(fr.t_ns, imgs[i], R_rel=M)
        if out is not None:
            vio.process_frame(out["t_ns"], out["ids"], out["pts"],
                              out["rows"])
    if side == "torch":
        vio.flush()
    else:
        out = tracker.flush()
        if out is not None:
            vio.process_frame(out["t_ns"], out["ids"], out["pts"],
                              out["rows"])
    return handed, tracker


@pytest.mark.parametrize("lag", [0, 1])
def test_gated_image_path_matches_jax(scene, lag):
    """Every image handed on at its own time (the publish rate lets each
    through), the same ids, a pose on the same frames within 1e-4; the
    gate fires, with the same rejections in both."""
    sim, _, imgs = scene
    ref, jtr = image_path("jax", sim, imgs, lag)
    out, ttr = image_path("torch", sim, imgs, lag)
    assert type(ttr) is TFusedTracker and ttr.lag == lag
    assert [h[0] for h in out] == [h[0] for h in ref] == \
        [fr.t_ns for fr in sim.frames[:FRAMES]]
    solved = 0
    for (_, ids_r, pose_r), (_, ids, pose) in zip(ref, out):
        np.testing.assert_array_equal(ids, ids_r)
        assert (pose is None) == (pose_r is None)
        if pose is not None:
            np.testing.assert_allclose(pose, pose_r, rtol=0, atol=POSE_TOL)
            solved += 1
    assert solved == FRAMES - WINDOW["NB"] + 1
    assert ttr.n_rejected == jtr.n_rejected > 0
