"""The port's textured image path on the CPU: the ray-cast textured world
renderer against the JAX package, and the slice as a whole (textured
frames through `FusedTracker(reject_wf=True, lag=1)` into the streaming
`CtrlVIO`); the trackers alone are in `tests/test_torch_tracker.py`, the
F-RANSAC gate in `tests/test_torch_fgate.py`.

Tolerances: the renderer is host numpy in both packages and must agree
bit for bit; in the whole slice, ids agree exactly and tracked
points to 1e-3 px (the plain LK sums its 441 patch terms in another order
than JAX, and the differences compound over frames). The JAX side of the
whole-slice comparison compiles its solves and megastep for minutes on the
CPU, so that test is marked slow; the port's own run, checked against
ground truth, is not."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import initializer as jinit
from ctrlvio_tpu.estimator.odometry import CtrlVIO as JCtrlVIO
from ctrlvio_tpu.estimator.odometry import VIOConfig as JVIOConfig
from ctrlvio_tpu.frontend.fused import FusedTracker as JFusedTracker
from ctrlvio_tpu.frontend.fused import rotation_flow as jrotation_flow
from ctrlvio_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
from ctrlvio_tpu.models import cameras as jcam
from ctrlvio_tpu.sim import render as jrender
from ctrlvio_tpu.sim import synthetic
from ctrlvio_tpu.solver.layout import WindowConfig as JWindowConfig
from ctrlvio_tpu_torch.estimator import initializer as tinit
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO as TCtrlVIO
from ctrlvio_tpu_torch.estimator.odometry import VIOConfig as TVIOConfig
from ctrlvio_tpu_torch.frontend.fused import FusedTracker as TFusedTracker
from ctrlvio_tpu_torch.frontend.fused import rotation_flow as trotation_flow
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig as TTrackerConfig
from ctrlvio_tpu_torch.models import cameras as tcam
from ctrlvio_tpu_torch.ops import lk, so3np
from ctrlvio_tpu_torch.sim import render as trender
from ctrlvio_tpu_torch.sim import synthetic as tsynthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig as TWindowConfig
from ctrlvio_tpu_torch.utils.ate import ate_rmse
from tests.torch_parity import one_torch_thread  # noqa: F401

PX_TOL = 1e-3          # px, published points
POSE_TOL = 1e-4        # m, per synchronous solved frame

# pinhole, and Kannala-Brandt with `cam_tumrs.yaml`'s distortion at a
# focal length that fits the small image
SMALL = dict(H=64, W=80)
CAMERAS = {
    "Pinhole": dict(fx=50.0, fy=49.0, cx=40.0, cy=32.0, k1=-0.2, k2=0.05,
                    p1=1e-3, p2=-5e-4),
    "Equidistant": dict(mu=37.0, mv=37.0, u0=39.3, v0=32.6,
                        k2=0.019327620961435945, k3=0.006784242994724914,
                        k4=-0.008658628531456217, k5=0.0051893686731546585),
}


def small_sim(mod, duration=0.6, seed=4):
    return mod.generate(mod.SimConfig(
        duration=duration, n_landmarks=40, seed=seed, line_delay=4e-4,
        image_h=SMALL["H"], image_w=SMALL["W"]))


def planted_quad(sim, world):
    """A textured quad 2.5 m ahead of the mid-sequence camera, sweeping
    sideways at 0.6 m/s (`tests/test_textured.py`'s planted outlier)."""
    R_CtoI = so3np.quat_to_matrix(
        so3np.quat_exp(np.asarray(sim.cfg.ext_rot))[None])[0]
    q, p = sim.pose_at(sim.frames[len(sim.frames) // 2].t_ns * 1e-9)
    R = so3np.quat_to_matrix(q if q.ndim == 2 else q[None])[0]
    cw = ((p[0] if p.ndim == 2 else p) + R @ np.asarray(sim.cfg.ext_pos))
    Rc = (R @ R_CtoI).astype(np.float32)
    c = cw.astype(np.float32) + Rc @ np.array([0.0, 0.0, 2.5], np.float32)
    world.add_quad(c, Rc @ np.array([1.0, 0, 0]), Rc @ np.array([0, 1.0, 0]),
                   (0.6, 0.6), vel=Rc @ np.array([0.6, 0.0, 0.0]))
    return Rc, cw.astype(np.float32)


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_textured_renderer_matches_jax(name):
    """Frames, unprojected rays and the moving-occluder mask of both
    packages, bit for bit: a world with moving occluders and a planted
    moving quad, photometric drift and pixel noise on."""
    H, W = SMALL["H"], SMALL["W"]
    sims = [small_sim(synthetic), small_sim(tsynthetic)]
    np.testing.assert_array_equal(sims[0].knots_p, sims[1].knots_p)
    out = []
    for sim, mod, cams in ((sims[0], jrender, jcam), (sims[1], trender,
                                                       tcam)):
        cam = getattr(cams, name)(**CAMERAS[name])
        world = mod.make_world(sim, seed=2, n_occluders=3,
                               occluder_speed=0.4)
        Rc, cw = planted_quad(sim, world)
        frames = mod.render_textured_sequence(sim, H, W, cam, world=world,
                                              seed=2, photometric=True,
                                              pixel_noise=2.0, row_chunk=16)
        dirs = mod._unproject_np(cam, H, W)
        d_w = (dirs.reshape(-1, 3) @ Rc.T).astype(np.float32)
        mask = world.occluder_mask(cw, d_w, 0.3)
        out.append((frames, dirs, mask))
    (f_j, d_j, m_j), (f_t, d_t, m_t) = out
    assert f_t.dtype == np.uint8 and f_t.shape == (len(sims[0].frames), H, W)
    assert f_t.std() > 10.0  # texture, not a flat image
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(m_t, m_j)
    assert m_t.any()  # the planted quad is in view


def test_make_world_and_default_renderer_match_jax():
    """`render_textured_sequence` building its own world (make_world from
    the seed, static occluders) gives the same frames in both packages."""
    H, W = SMALL["H"], SMALL["W"]
    sim_j, sim_t = small_sim(synthetic, 0.3, 6), small_sim(tsynthetic, 0.3, 6)
    kw = dict(seed=5, n_occluders=2, occluder_speed=0.0)
    f_j = jrender.render_textured_sequence(
        sim_j, H, W, jcam.Pinhole(**CAMERAS["Pinhole"]), **kw)
    f_t = trender.render_textured_sequence(
        sim_t, H, W, tcam.Pinhole(**CAMERAS["Pinhole"]), **kw)
    np.testing.assert_array_equal(f_t, f_j)
    w_j = jrender.make_world(sim_j, seed=5, n_occluders=2)
    w_t = trender.make_world(sim_t, seed=5, n_occluders=2)
    for a, b in zip(w_j.tex_faces + [q["tex"] for q in w_j.occ],
                    w_t.tex_faces + [q["tex"] for q in w_t.occ]):
        np.testing.assert_array_equal(b, a)


# the whole slice at a reduced size: 256x320 pinhole with the TUM-RSVI
# readout (H * SLD ~ 29 ms); the F-gate's threshold is the chip phase's
# 1.0 virtual px at fx = 739 (cam_tumrs.yaml), the same 1.6 image pixels,
# scaled to this focal length
SH, SW, SFX = 256, 320, 200.0
SLD = 1.15e-4
WINDOW = dict(KW=24, NB=6, LM=96, OBS=384, MIMU=192)
SLICE_TRACKER = dict(max_cnt=70, min_dist=8, reject_wf=True,
                     f_threshold=1.0 * 739.1654756101043 / SFX)
STREAM = dict(stream=True, stream_warmup=6, stream_lag=3)


def slice_sequence(duration, sim_mod=synthetic, render_mod=jrender,
                   seed=5):
    """The chip phase's world (seed 1, four occluders, the even ones
    moving at 0.4 m/s) at the reduced size, with `planted_quad` in view
    so that the gate meets outliers within the short run."""
    sim = sim_mod.generate(sim_mod.SimConfig(
        duration=duration, n_landmarks=50, seed=seed, line_delay=SLD,
        image_h=SH, image_w=SW, fx=SFX, fy=SFX, cx=SW / 2, cy=SH / 2))
    cam = (jcam if render_mod is jrender else tcam).Pinhole(
        SFX, SFX, SW / 2, SH / 2)
    world = render_mod.make_world(sim, seed=1, n_occluders=4,
                                  occluder_speed=0.4)
    planted_quad(sim, world)
    imgs = render_mod.render_textured_sequence(sim, SH, SW, cam, world=world,
                                               seed=1)
    return sim, imgs


def run_slice(side, sim, imgs):
    """`bench.py --mode image`'s loop in f64: per frame rotation_flow, the
    lagged F-gated step, process_frame; tracker.flush() and vio.flush() at
    the end. Returns per consumed frame (t_ns, ids, points in px, pose or
    None), the estimator and the tracker."""
    q_CtoI = so3np.quat_exp(np.asarray(sim.cfg.ext_rot, np.float64))
    R_CtoI = so3np.quat_to_matrix(q_CtoI[None])[0]
    p_CinI = np.asarray(sim.cfg.ext_pos)
    if side == "jax":
        vio = JCtrlVIO(JVIOConfig(window_config=JWindowConfig(**WINDOW),
                                  fix_ld=False, ld_upper=5e-4,
                                  dtype=np.float64, use_native=False,
                                  **STREAM), q_CtoI, p_CinI)
        tracker = JFusedTracker(JTrackerConfig(**SLICE_TRACKER),
                                jcam.Pinhole(SFX, SFX, SW / 2, SH / 2),
                                (SH, SW), lag=1)
        init = jinit.bootstrap_from_sim(sim)
        rotation_flow = jrotation_flow
    else:
        vio = TCtrlVIO(TVIOConfig(window_config=TWindowConfig(**WINDOW),
                                  fix_ld=False, ld_upper=5e-4,
                                  dtype=torch.float64, use_native=False,
                                  **STREAM), q_CtoI, p_CinI, device="cpu")
        tracker = TFusedTracker(TTrackerConfig(**SLICE_TRACKER),
                                tcam.Pinhole(SFX, SFX, SW / 2, SH / 2),
                                (SH, SW), lag=1, device="cpu")
        init = tinit.bootstrap_from_sim(sim)
        rotation_flow = trotation_flow
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    frames, prev = [], None

    def estimate(feat):
        out = None
        if feat is not None and len(feat["ids"]) >= 8:
            out = vio.process_frame(feat["t_ns"], feat["ids"], feat["pts"],
                                    feat["rows"])
        if feat is not None:
            frames.append((feat["t_ns"], feat["ids"], feat["uv"],
                           None if out is None else np.concatenate(out)))

    for i, fr in enumerate(sim.frames):
        M = None if prev is None else rotation_flow(
            sim.imu_t_ns, sim.gyro, prev, fr.t_ns, R_CtoI)
        prev = fr.t_ns
        estimate(tracker.step(fr.t_ns, imgs[i], R_rel=M))
    estimate(tracker.flush())
    vio.flush()
    return frames, vio, tracker


def test_textured_slice_port_on_cpu():
    """The port alone on the chip phase's path at a reduced size: it
    bootstraps from ground truth, streams after its warmup, publishes 30 or
    more unique ids a frame, the gate fires, and the run follows the ground
    truth (bench.py's ATE < 0.15 m from the 11th solved frame; its
    line-delay gate of 5 us at 1024 rows scaled to 256)."""
    sim, imgs = slice_sequence(3.0, tsynthetic, trender)
    calls = lk.lk_track_plain.calls, lk.lk_level_plain.calls
    frames, vio, tracker = run_slice("torch", sim, imgs)
    n = len(sim.frames)
    # one plain track a frame over pred_levels levels
    assert lk.lk_track_plain.calls - calls[0] == n
    assert lk.lk_level_plain.calls - calls[1] == 2 * 2 * n
    assert len(frames) == n
    for _, ids, uv, _ in frames[1:]:
        assert len(ids) >= 30 and len(set(ids.tolist())) == len(ids)
        assert np.isfinite(uv).all()
    assert tracker.n_rejected > 0
    assert vio.counts["megastep"] > 0
    assert vio.counts["sync_solve_after_handoff"] == 0
    poses = [(t, p) for t, _, _, p in frames if p is not None]
    est = np.stack([p[4:] for _, p in poses])
    gt = np.stack([sim.pose_at(t * 1e-9)[1] for t, _ in poses])
    assert np.isfinite(est).all()
    assert ate_rmse(est[10:], gt[10:], align="yaw") < 0.15
    assert abs(vio.traj.line_delay - SLD) < 5e-6 * 1024 / SH


@pytest.mark.slow
def test_textured_slice_matches_jax():
    """The same run through both packages' CtrlVIO: equal ids and points
    every frame, poses within 1e-4 m on the synchronous frames, then the
    stream's tolerances of `tests/test_torch_stream.py`'s whole-run test
    (online estimates within 1 cm, the final trajectory within 5 mm, the
    line delay within 1e-8 s)."""
    sim, imgs = slice_sequence(3.0)
    ref, jvio, jtr = run_slice("jax", sim, imgs)
    out, tvio, ttr = run_slice("torch", sim, imgs)
    assert len(out) == len(ref)
    n_sync = solved = 0
    t_on, j_on = [], []
    for (ta, ids_r, uv_r, pose_r), (tb, ids, uv, pose) in zip(ref, out):
        assert ta == tb
        np.testing.assert_array_equal(ids, ids_r)
        np.testing.assert_allclose(uv, uv_r, rtol=0, atol=PX_TOL)
        assert (pose is None) == (pose_r is None)
        if pose is None:
            continue
        solved += 1
        if solved <= STREAM["stream_warmup"]:
            n_sync += 1
            np.testing.assert_allclose(pose, pose_r, rtol=0, atol=POSE_TOL)
        t_on.append(pose[4:])
        j_on.append(pose_r[4:])
    assert n_sync == STREAM["stream_warmup"]
    assert ttr.n_rejected == jtr.n_rejected > 0
    assert tvio.counts["megastep"] > 0
    assert np.linalg.norm(np.asarray(t_on) - np.asarray(j_on), axis=1).max() \
        < 0.01
    ts = [t for t, _, _, p in out if p is not None]
    tb, jb = tvio.data_start_ns or 0, jvio.data_start_ns or 0
    t_final = np.stack([tvio.traj.pose(t - tb)[1][0] for t in ts])
    j_final = np.stack([np.asarray(jvio.traj.pose(t - jb)[1])[0] for t in ts])
    assert np.linalg.norm(t_final - j_final, axis=1).max() < 0.005
    assert abs(tvio.traj.line_delay - jvio.traj.line_delay) < 1e-8
