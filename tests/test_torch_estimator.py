"""Parity of the PyTorch port's host-side modules with the JAX package on
the CPU: the synthetic sequence and its rendering, the trajectory store,
packing, the feature table, pre-integration, the initializers, and the
parts of the camera, spline, SO(3), layout and sim modules that the image
path does not reach. Most of these are numpy copies, held to the JAX
package's output exactly or to float64 rounding (1e-9 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import features as jfeatures
from ctrlvio_tpu.estimator import initializer as jinit
from ctrlvio_tpu.estimator import packing as jpacking
from ctrlvio_tpu.estimator import preintegration as jpre
from ctrlvio_tpu.models import cameras as jcam
from ctrlvio_tpu.models import trajectory as jtraj
from ctrlvio_tpu.ops import so3 as jso3
from ctrlvio_tpu.ops import spline as jspline
from ctrlvio_tpu.sim import render as jrender
from ctrlvio_tpu.sim import synthetic as jsyn
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu_torch.estimator import features as tfeatures
from ctrlvio_tpu_torch.estimator import initializer as tinit
from ctrlvio_tpu_torch.estimator import packing as tpacking
from ctrlvio_tpu_torch.estimator import preintegration as tpre
from ctrlvio_tpu_torch.models import cameras as tcam
from ctrlvio_tpu_torch.models import trajectory as ttraj
from ctrlvio_tpu_torch.ops import so3 as tso3
from ctrlvio_tpu_torch.ops import spline as tspline
from ctrlvio_tpu_torch.sim import render as trender
from ctrlvio_tpu_torch.sim import synthetic as tsyn
from ctrlvio_tpu_torch.solver import layout as tlayout
from tests.torch_parity import close, one_torch_thread  # noqa: F401

CFG = dict(KW=24, NB=6, LM=64, OBS=320, MIMU=192, dt=0.05)
H, W, FX, CX, CY = 96, 128, 80.0, 64.0, 48.0


def sim_config(mod, **kw):
    return mod.SimConfig(duration=1.2, n_landmarks=300, seed=4,
                         line_delay=2.0e-4, image_h=H, image_w=W, fx=FX,
                         fy=FX, cx=CX, cy=CY, **{**jsyn.REFERENCE_NOISE, **kw})


@pytest.fixture(scope="module")
def sims():
    return jsyn.generate(sim_config(jsyn)), tsyn.generate(sim_config(tsyn))


def test_synthetic_generate_matches_jax(sims):
    a, b = sims
    for name in ("knots_q", "knots_p", "imu_t_ns", "gyro", "accel",
                 "landmarks", "gravity_vec"):
        close(getattr(a, name), getattr(b, name))
    assert len(a.frames) == len(b.frames)
    for fa, fb in zip(a.frames, b.frames):
        assert fa.t_ns == fb.t_ns
        np.testing.assert_array_equal(fa.ids, fb.ids)
        close(fa.pts, fb.pts)
        close(fa.rows, fb.rows)
    t = np.linspace(0.1, 1.0, 7)
    for x, y in zip(a.poses_at(t), b.poses_at(t)):
        close(x, y)


def test_render_sequence_matches_jax(sims):
    a, b = sims
    cam_j = jcam.Equidistant(mu=FX, mv=FX, u0=CX, v0=CY, k2=0.01)
    cam_t = tcam.Equidistant(mu=FX, mv=FX, u0=CX, v0=CY, k2=0.01)
    ia = jrender.render_sequence(a, H, W, camera=cam_j, seed=1, big_every=6,
                                 texture=6.0)
    ib = trender.render_sequence(b, H, W, camera=cam_t, seed=1, big_every=6,
                                 texture=6.0)
    assert ia.shape == ib.shape and ia.dtype == ib.dtype
    # uint8 after clipping: float64 rounding may move a pixel by one level
    assert np.abs(ia.astype(int) - ib.astype(int)).max() <= 1
    assert (ia != ib).mean() < 1e-4


def test_reference_noise_and_grid_coords():
    assert tsyn.reference_noise(seed=2) == tsyn.SimConfig(
        **{k: v for k, v in jsyn.reference_noise(seed=2).__dict__.items()})
    for t in (0.0, 0.37, 1.2499999, 3.05):
        assert tsyn.grid_coords(t, 0.05) == jsyn.grid_coords(t, 0.05)


def window_tracks(sim, mod, nb):
    """Feature tracks over the first nb frames, as
    `test_torch_solver.py::build_problem` builds them, in `mod`'s types."""
    tracks = {}
    for fidx, fr in enumerate(sim.frames[:nb]):
        for k, lid in enumerate(fr.ids):
            tr = tracks.get(lid)
            if tr is None:
                tr = tracks[lid] = mod.FeatureTrack(int(lid), fidx)
            elif tr.end_frame != fidx - 1:
                continue
            tr.pts.append(fr.pts[k])
            tr.rows.append(float(fr.rows[k]))
            tr.estimated_depth = 2.0 + 0.01 * lid
    return list(tracks.values())


def test_packing_matches_jax(sims):
    sim = sims[0]
    jc, tc = jlayout.WindowConfig(**CFG), tlayout.WindowConfig(**CFG)
    kf = np.array([f.t_ns for f in sim.frames[: jc.NB]], np.int64)
    img_j, dinv_j, cand_j = jpacking.pack_image_factors(
        window_tracks(sim, jpacking, jc.NB), kf, jc.dt, 0, jc, np.float64)
    img_t, dinv_t, cand_t = tpacking.pack_image_factors(
        window_tracks(sim, tpacking, tc.NB), kf, tc.dt, 0, tc, np.float64)
    assert [c.feature_id for c in cand_j] == [c.feature_id for c in cand_t]
    close(dinv_j, dinv_t)
    for x, y in zip(img_j, img_t):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    t_hor = int(kf[-1] + 0.04e9)
    args = (sim.imu_t_ns, sim.gyro, sim.accel, kf, 0, t_hor, jc.dt, 0)
    for x, y in zip(jpacking.pack_imu_factors(*args, jc, np.float64),
                    tpacking.pack_imu_factors(*args, tc, np.float64)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(
            jpacking.bias_sqrt_info(sim.imu_t_ns, kf, 2e-5, 4e-4, jc,
                                    np.float64),
            tpacking.bias_sqrt_info(sim.imu_t_ns, kf, 2e-5, 4e-4, tc,
                                    np.float64)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert (tpacking.auto_landmark_slots(150)
            == jpacking.auto_landmark_slots(150))


def drive_trajectory(mod, sim):
    tr = mod.Trajectory(0.05, line_delay=1e-5)
    q0, p0 = sim.pose_at(0.0)
    tr.set_flat(q0, p0, int(0.3e9))
    tr.extend_to(int(0.9e9))
    n = tr.n
    tr.knots_q[:n] = sim.knots_q[:n]
    tr.knots_p[:n] = sim.knots_p[:n]
    kq, kp, n_active = tr.window(2, 16, np.float64)
    tr.write_back(2, kq, kp + 0.01, n_active)
    t = np.array([int(0.12e9), int(0.5e9), int(0.83e9)], np.int64)
    return (tr.max_time_ns, tr.ctrl_idx(int(0.5e9)), n_active, kq, kp,
            *tr.pose(t), *tr.camera_pose(t, q0, np.array([0.01, 0.0, 0.02])))


def test_trajectory_matches_jax(sims):
    a = drive_trajectory(jtraj, sims[0])
    b = drive_trajectory(ttraj, sims[0])
    assert a[:3] == b[:3]
    for x, y in zip(a[3:], b[3:]):
        close(x, y)


def drive_features(mod, sim, nb):
    """Keyframe decisions, slots and triangulated depths of a window (the
    IMU poses stand in for the camera poses), then one slide."""
    table = mod.FeatureTable(nb - 1)
    kfs = []
    for fidx, fr in enumerate(sim.frames[:nb]):
        kfs.append(table.add_frame(fidx, fr.ids, fr.pts, fr.rows))
    q, p, _, _ = sim.poses_at(np.array([f.t_ns * 1e-9
                                        for f in sim.frames[:nb]]))
    table.triangulate(q, p)
    ids = table.slot_fids(64)
    depths = [table.tracks[i].estimated_depth for i in sorted(table.tracks)]
    R = np.asarray(jso3.quat_to_matrix(jnp.asarray(q[:2])))
    table.slide_old(R[0], p[0], R[1], p[1])
    after = {i: (t.start_frame, t.estimated_depth)
             for i, t in table.tracks.items()}
    return kfs, ids, np.asarray(depths, np.float64), after


def test_feature_table_matches_jax(sims):
    a = drive_features(jfeatures, sims[0], 6)
    b = drive_features(tfeatures, sims[0], 6)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    close(a[2], b[2])
    assert a[3].keys() == b[3].keys()
    for k in a[3]:
        assert a[3][k][0] == b[3][k][0]
        close(a[3][k][1], b[3][k][1])


def test_preintegration_matches_jax():
    dt, n = 0.005, 40
    t = np.arange(n) * dt
    gyr = np.stack([0.4 * np.sin(3 * t), 0.3 * np.cos(2 * t), 0.2 + 0 * t], 1)
    acc = np.stack([0.5 * np.sin(t), 9.8 + 0.2 * np.cos(4 * t),
                    0.3 + 0 * t], 1)
    pj, pt = jpre.PreIntegration(), tpre.PreIntegration()
    for k in range(n):
        pj.push(dt, acc[k], gyr[k])
        pt.push(dt, acc[k], gyr[k])
    bg = np.array([1e-3, -2e-3, 5e-4])
    for p in (pj, pt):
        p.repropagate(bg)
    for name in ("dq", "dp", "dv", "jacobian", "covariance", "J_q_bg"):
        close(getattr(pj, name), getattr(pt, name))
    assert pj.sum_dt == pt.sum_dt


def test_initializers_match_jax(sims):
    sim = sims[0]
    sj, st = jinit.StaticInitializer(), tinit.StaticInitializer()
    rng = np.random.default_rng(2)
    g = np.array([0.0, 0.0, 9.80766])
    out_j = out_t = None
    for k in range(300):
        gy, ac = rng.normal(0, 1e-3, 3), g + rng.normal(0, 1e-2, 3)
        out_j = sj.feed(k * 5_000_000, gy, ac) or out_j
        out_t = st.feed(k * 5_000_000, gy, ac) or out_t
    aj, at = jinit.ActiveInitializer(), tinit.ActiveInitializer()
    q = jso3.quat_exp(jnp.asarray([0.1, -0.2, 0.7]))
    act = (aj.feed(7, np.asarray(q)), at.feed(7, np.asarray(q)))
    boot = (jinit.bootstrap_from_sim(sim), tinit.bootstrap_from_sim(sim))
    for a, b in ((out_j, out_t), act, boot):
        assert a is not None and b is not None and a.t_ns == b.t_ns
        for name in ("q", "p", "bg", "ba", "gravity", "v"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None)
            if x is not None:
                close(x, y)
    t_out = np.array([0, int(0.2e9), int(0.45e9)], np.int64)
    close(jinit.dead_reckon_poses(t_out, sim.imu_t_ns, sim.gyro, sim.accel,
                                  boot[0])[1],
          tinit.dead_reckon_poses(t_out, sim.imu_t_ns, sim.gyro, sim.accel,
                                  boot[1])[1])


def test_scaramuzza_and_yaml_factory_match_jax():
    poly = (-216.9657, 0.0, 1.797e-3, 2.779e-7, 5.05e-10)
    inv_j = jcam.fit_inv_poly(poly, rho_max=320.0)
    inv_t = tcam.fit_inv_poly(poly, rho_max=320.0)
    close(inv_j, inv_t)
    kw = dict(poly=poly, inv_poly=inv_j, c=1.0005, d=1.2e-4, e=-0.8e-4,
              cx=321.5, cy=243.2)
    cj, ct = jcam.Scaramuzza(**kw), tcam.Scaramuzza(**kw)
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-1.2, 1.2, 64), rng.uniform(-0.9, 0.9, 64),
                  np.ones(64)], 1) * rng.uniform(2, 8, (64, 1))
    uv = np.asarray(cj.project(jnp.asarray(X)))
    close(uv, ct.project(torch.as_tensor(X)))
    close(np.asarray(cj.lift(jnp.asarray(uv))), ct.lift(torch.as_tensor(uv)))
    for d in (
        {"model_type": "KANNALA_BRANDT", "projection_parameters": dict(
            mu=739.2, mv=739.1, u0=625.9, v0=517.3, k2=0.0034, k3=0.0007,
            k4=-0.0015, k5=0.0005)},
        {"model_type": "PINHOLE",
         "projection_parameters": dict(fx=460.0, fy=458.0, cx=367.2,
                                       cy=248.4),
         "distortion_parameters": dict(k1=-0.28, k2=0.07)},
        {"model_type": "MEI", "mirror_parameters": dict(xi=1.8),
         "projection_parameters": dict(gamma1=1200.0, gamma2=1198.0,
                                       u0=640.0, v0=512.0)},
        {"model_type": "SCARAMUZZA",
         "poly_parameters": {f"p{i}": v for i, v in enumerate(poly)},
         "inv_poly_parameters": {f"p{i}": v for i, v in enumerate(inv_j)},
         "affine_parameters": dict(ac=1.0005, ad=1.2e-4, ae=-0.8e-4,
                                   cx=321.5, cy=243.2)},
    ):
        a, b = jcam.from_yaml_dict(d), tcam.from_yaml_dict(d)
        assert type(a).__name__ == type(b).__name__
        assert a.__dict__ == b.__dict__
    with pytest.raises(ValueError):
        tcam.from_yaml_dict({"model_type": "FOV"})


def test_spline_se3_refloor_and_identity_match_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(16, 4, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = rng.normal(size=(16, 4, 3))
    u = rng.uniform(0, 1, 16)
    for x, y in zip(jspline.se3_eval(jnp.asarray(q), jnp.asarray(p),
                                     jnp.asarray(u), 20.0),
                    tspline.se3_eval(torch.as_tensor(q), torch.as_tensor(p),
                                     torch.as_tensor(u), 20.0)):
        close(x, y)
    i0 = np.array([0, 3, 5, 7])
    uu = np.array([0.5, 1.25, -0.5, 2.0])
    a = jspline.refloor(jnp.asarray(i0), jnp.asarray(uu))
    b = tspline.refloor(torch.as_tensor(i0), torch.as_tensor(uu))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(np.asarray(jso3.quat_identity()),
                                  tso3.quat_identity().numpy())


def test_layout_columns_match_jax():
    jc, tc = jlayout.WindowConfig(**CFG), tlayout.WindowConfig(**CFG)
    assert (jc.C, jc.n_rows, jc.col_ld) == (tc.C, tc.n_rows, tc.col_ld)
    for k in (0, 5, CFG["KW"] - 1):
        assert jc.col_so3(k) == tc.col_so3(k)
        assert jc.col_pos(k) == tc.col_pos(k)
    for b in (0, CFG["NB"] - 1):
        assert jc.col_bg(b) == tc.col_bg(b)
        assert jc.col_ba(b) == tc.col_ba(b)
