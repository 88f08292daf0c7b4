"""The port's image-in main path as a whole, on the CPU: rendered
rolling-shutter frames through `CtrlVIO.process_image` (CLAHE ->
gyro-predicted pyramidal KLT -> Shi-Tomasi refill -> undistortion ->
ground-truth bootstrap -> sliding-window BA with online line-delay
calibration -> f64 marginalization), against the JAX package's `CtrlVIO`
fed the same frames and IMU; plus the rule that the port imports neither
JAX nor the JAX package.

The JAX side of the parity run spends about two minutes compiling its
solves on the CPU, so that test is marked slow; the port's own run of the
same path, checked against ground truth, is not."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import initializer as jinit
from ctrlvio_tpu.estimator.odometry import CtrlVIO as JCtrlVIO
from ctrlvio_tpu.estimator.odometry import VIOConfig as JVIOConfig
from ctrlvio_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
from ctrlvio_tpu.models.cameras import Pinhole as JPinhole
from ctrlvio_tpu.sim import render, synthetic
from ctrlvio_tpu.solver.layout import WindowConfig as JWindowConfig
from ctrlvio_tpu_torch.estimator import initializer as tinit
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO as TCtrlVIO
from ctrlvio_tpu_torch.estimator.odometry import VIOConfig as TVIOConfig
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig as TTrackerConfig
from ctrlvio_tpu_torch.models.cameras import Pinhole as TPinhole
from ctrlvio_tpu_torch.ops import lk, so3np
from ctrlvio_tpu_torch.sim import render as trender
from ctrlvio_tpu_torch.sim import synthetic as tsynthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig as TWindowConfig
from ctrlvio_tpu_torch.utils.ate import ate_rmse
from tests.torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
H, W, FX, CX, CY = 128, 160, 100.0, 80.0, 64.0
# the total readout (H * LD ~ 29 ms) of the TUM-RSVI sensor at this height
LD = 2.3e-4
WINDOW = dict(KW=24, NB=6, LM=96, OBS=384, MIMU=192)
TRACKER = dict(max_cnt=60, min_dist=10, freq=11.0)
POSE_TOL = 1e-4        # m, per solved frame
PX_TOL = 1e-3          # px, published points


def make_sequence(duration, sim_mod=synthetic, render_mod=render):
    sim = sim_mod.generate(sim_mod.SimConfig(
        duration=duration, n_landmarks=500, seed=5, line_delay=LD,
        image_h=H, image_w=W, fx=FX, fy=FX, cx=CX, cy=CY))
    imgs = render_mod.render_sequence(sim, H, W, FX, FX, CX, CY, seed=1,
                                      big_every=6)
    return sim, imgs


def run_image_path(side, sim, imgs):
    """Drive one package's CtrlVIO image path in f64. Returns per frame
    (ids, published points in px, pose or None), and the estimator."""
    q_CtoI = so3np.quat_exp(np.asarray(sim.cfg.ext_rot, np.float64))
    p_CinI = np.asarray(sim.cfg.ext_pos)
    if side == "jax":
        vio = JCtrlVIO(JVIOConfig(window_config=JWindowConfig(**WINDOW),
                                  fix_ld=False, ld_upper=5e-4,
                                  dtype=np.float64, use_native=False),
                       q_CtoI, p_CinI)
        vio.attach_frontend(JPinhole(FX, FX, CX, CY), (H, W),
                            JTrackerConfig(**TRACKER))
        init = jinit.bootstrap_from_sim(sim)
    else:
        vio = TCtrlVIO(TVIOConfig(window_config=TWindowConfig(**WINDOW),
                                  fix_ld=False, ld_upper=5e-4,
                                  dtype=torch.float64, use_native=False),
                       q_CtoI, p_CinI, device="cpu")
        vio.attach_frontend(TPinhole(FX, FX, CX, CY), (H, W),
                            TTrackerConfig(**TRACKER))
        init = tinit.bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    frames = []
    for i, fr in enumerate(sim.frames):
        out = vio.process_image(fr.t_ns, imgs[i])
        tr = vio.tracker
        frames.append((tr.ids[tr.prev_live].copy(),
                       tr.prev_norm[tr.prev_live] * FX,
                       None if out is None else np.concatenate(out)))
    return frames, vio


@pytest.mark.slow
def test_image_path_matches_jax():
    """Same ids and published points every frame, and the same pose on
    the first 12 solved frames, through both packages."""
    sim, imgs = make_sequence(2.2)
    ref, jvio = run_image_path("jax", sim, imgs)
    out, tvio = run_image_path("torch", sim, imgs)
    solved = 0
    for (ids_r, px_r, pose_r), (ids, px, pose) in zip(ref, out):
        np.testing.assert_array_equal(ids, ids_r)
        np.testing.assert_allclose(px, px_r, rtol=0, atol=PX_TOL)
        assert (pose is None) == (pose_r is None)
        if pose is not None and solved < 12:
            np.testing.assert_allclose(pose[4:], pose_r[4:], rtol=0,
                                       atol=POSE_TOL)
            np.testing.assert_allclose(pose[:4], pose_r[:4], rtol=0,
                                       atol=POSE_TOL)
            solved += 1
    assert solved == 12
    assert abs(tvio.traj.line_delay - jvio.traj.line_delay) < 1e-8


def test_image_path_port_on_cpu():
    """The port alone on the same path (the plain LK version, as CPU
    tensors take): it bootstraps, solves every frame, keeps tracks alive
    and follows the ground truth."""
    sim, imgs = make_sequence(1.6, tsynthetic, trender)
    calls = lk.lk_level_plain.calls
    frames, vio = run_image_path("torch", sim, imgs)
    # pred_levels levels x (forward + backward), every frame
    per_frame = 2 * vio.tracker.cfg.klt.pred_levels
    assert lk.lk_level_plain.calls - calls == per_frame * len(sim.frames)
    poses = [(i, f[2]) for i, f in enumerate(frames) if f[2] is not None]
    assert len(poses) == len(frames) - WINDOW["NB"] + 1
    assert poses[0][0] == WINDOW["NB"] - 1  # bootstrap once the window fills
    for ids, px, _ in frames[1:]:
        assert len(ids) >= 30 and len(set(ids.tolist())) == len(ids)
        assert np.isfinite(px).all()
    est = np.stack([p[4:] for _, p in poses])
    gt = np.stack([sim.pose_at(sim.frames[i].t_ns * 1e-9)[1]
                   for i, _ in poses])
    assert np.isfinite(est).all()
    assert ate_rmse(est, gt, align="yaw") < 0.15
    assert abs(vio.traj.line_delay - LD) < 5e-5


def test_estimator_entry_point_defaults_to_the_card():
    """No card and no explicit CPU request: the entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TCtrlVIO(TVIOConfig(), np.array([1.0, 0, 0, 0]), np.zeros(3))


def forbidden_imports(source: str):
    """Modules imported by `source` that are `jax`/`jaxlib` or the JAX
    package (`ctrlvio_tpu` and its submodules, not `ctrlvio_tpu_torch`)."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in ("jax", "jaxlib", "ctrlvio_tpu"):
                bad.append(name)
    return bad


@pytest.mark.parametrize("source,bad", [
    ("import jax", ["jax"]),
    ("import jax.numpy as jnp", ["jax.numpy"]),
    ("from jax import lax", ["jax"]),
    ("import ctrlvio_tpu", ["ctrlvio_tpu"]),
    ("from ctrlvio_tpu.ops import so3np", ["ctrlvio_tpu.ops"]),
    ("def f():\n    import ctrlvio_tpu.sim.render", ["ctrlvio_tpu.sim.render"]),
    ("import ctrlvio_tpu_torch.ops.lk", []),
    ("from ctrlvio_tpu_torch.ops import so3np", []),
    ("from . import klt", []),
])
def test_forbidden_imports_matcher(source, bad):
    assert forbidden_imports(source) == bad


def test_port_imports_neither_jax_nor_ctrlvio_tpu():
    files = sorted((REPO / "ctrlvio_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    # the gpu-marked tests run where JAX is absent
    files += [REPO / "tests" / n for n in (
        "test_torch_kernels.py", "test_torch_stream_gpu.py",
        "torch_stream_case.py")]
    assert len(files) > 30
    found = {str(f.relative_to(REPO)): forbidden_imports(f.read_text())
             for f in files}
    assert not {k: v for k, v in found.items() if v}
