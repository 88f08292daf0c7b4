"""Parity of the port's trackers with the JAX package on the CPU: the
slot-identity `FusedTracker` with the epipolar F-RANSAC gate (lag 0 and 1)
on textured frames with a planted moving quad, the classic multi-dispatch
`FeatureTracker` with and without the gate, and `attach_frontend`'s choice
between them.

Tolerances: ids and F-gate rejection counts exactly; published points
within 1e-3 px (the plain LK sums its 441 patch terms in another order
than JAX, and the differences compound over frames), normalized points and
velocities to the same 1e-3 px through the focal length and the frame
interval."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator.odometry import CtrlVIO as JCtrlVIO
from ctrlvio_tpu.estimator.odometry import VIOConfig as JVIOConfig
from ctrlvio_tpu.frontend import tracker as jtracker
from ctrlvio_tpu.frontend.fused import FusedTracker as JFusedTracker
from ctrlvio_tpu.frontend.fused import rotation_flow
from ctrlvio_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
from ctrlvio_tpu.models import cameras as jcam
from ctrlvio_tpu.sim import render as jrender
from ctrlvio_tpu.sim import synthetic
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO as TCtrlVIO
from ctrlvio_tpu_torch.estimator.odometry import VIOConfig as TVIOConfig
from ctrlvio_tpu_torch.frontend import tracker as ttracker
from ctrlvio_tpu_torch.frontend.fused import FusedTracker as TFusedTracker
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig as TTrackerConfig
from ctrlvio_tpu_torch.models import cameras as tcam
from ctrlvio_tpu_torch.ops import lk, so3np
from tests.test_frontend import make_texture, shift_image
from tests.test_torch_textured import planted_quad
from tests.torch_parity import one_torch_thread  # noqa: F401

PX_TOL = 1e-3          # px, published points


H, W, FX, CX, CY = 256, 320, 200.0, 160.0, 128.0
LD = 1.15e-4  # total readout H * LD ~ 29 ms, the TUM-RSVI scale
TRACKER = dict(max_cnt=110, min_dist=12, freq=100.0, reject_wf=True,
               f_threshold=1.0)


@pytest.fixture(scope="module")
def gated_sequence():
    """`tests/test_textured.py`'s planted-outlier scene: a 256x320 textured
    room, two occluders and a quad sweeping through the view, 2 s."""
    sim = synthetic.generate(synthetic.SimConfig(
        duration=2.0, n_landmarks=50, seed=5, line_delay=LD,
        image_h=H, image_w=W, fx=FX, fy=FX, cx=CX, cy=CY))
    world = jrender.make_world(sim, seed=2, n_occluders=2)
    planted_quad(sim, world)
    imgs = jrender.render_textured_sequence(
        sim, H, W, jcam.Pinhole(FX, FX, CX, CY), world=world, seed=2)
    R = so3np.quat_to_matrix(
        so3np.quat_exp(np.asarray(sim.cfg.ext_rot))[None])[0]
    return sim, imgs, R


def drive(tracker, sim, imgs, R):
    """Every frame through `step` with the gyro-predicted rotation, then
    `flush`. Returns the published dicts and n_rejected after each."""
    outs, prev = [], None
    for i, fr in enumerate(sim.frames):
        M = None if prev is None else rotation_flow(
            sim.imu_t_ns, sim.gyro, prev, fr.t_ns, R)
        prev = fr.t_ns
        out = tracker.step(fr.t_ns, imgs[i], R_rel=M)
        if out is not None:
            outs.append((out, tracker.n_rejected))
    out = tracker.flush()
    if out is not None:
        outs.append((out, tracker.n_rejected))
    return outs


@pytest.mark.parametrize("lag", [0, 1])
def test_f_gated_tracker_matches_jax(gated_sequence, lag):
    """Per frame: the same ids, points within 1e-3 px, the same velocities
    to 1e-3 px over the frame interval, and the same running count of F-gate
    rejections; the gate fires."""
    sim, imgs, R = gated_sequence
    ref = drive(JFusedTracker(JTrackerConfig(**TRACKER),
                              jcam.Pinhole(FX, FX, CX, CY), (H, W), lag=lag),
                sim, imgs, R)
    out = drive(TFusedTracker(TTrackerConfig(**TRACKER),
                              tcam.Pinhole(FX, FX, CX, CY), (H, W), lag=lag,
                              device="cpu"), sim, imgs, R)
    assert len(out) == len(ref) == len(sim.frames)
    for (a, na), (b, nb) in zip(ref, out):
        assert b["t_ns"] == a["t_ns"]
        np.testing.assert_array_equal(b["ids"], a["ids"])
        np.testing.assert_allclose(b["uv"], a["uv"], rtol=0, atol=PX_TOL)
        np.testing.assert_allclose(b["pts"], a["pts"], rtol=0,
                                   atol=PX_TOL / FX)
        np.testing.assert_allclose(b["vel"], a["vel"], rtol=0,
                                   atol=PX_TOL / FX * 10.0)
        assert nb == na
    assert out[-1][1] > 0  # the planted quad made the gate fire


def test_lag1_delays_lag0_by_one_frame(gated_sequence):
    """Without the gate, lag=1 publishes exactly lag=0's frames one step
    later (with the gate it may not: a kill found while consuming frame k
    frees its slot one dispatch later with lag=1)."""
    sim, imgs, R = gated_sequence
    cfg = TTrackerConfig(**{**TRACKER, "reject_wf": False})
    cam = tcam.Pinhole(FX, FX, CX, CY)
    outs = []
    for lag in (0, 1):
        tr = TFusedTracker(cfg, cam, (H, W), lag=lag, device="cpu")
        seq, prev = [], None
        for i, fr in enumerate(sim.frames[:8]):
            M = None if prev is None else rotation_flow(
                sim.imu_t_ns, sim.gyro, prev, fr.t_ns, R)
            prev = fr.t_ns
            seq.append(tr.step(fr.t_ns, imgs[i], R_rel=M))
        seq.append(tr.flush())
        outs.append(seq)
    lag0, lag1 = outs
    assert lag1[0] is None and lag0[-1] is None
    for a, b in zip(lag0[:-1], lag1[1:]):
        assert a["t_ns"] == b["t_ns"]
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_array_equal(a["uv"], b["uv"])
        np.testing.assert_array_equal(a["vel"], b["vel"])


def assert_same_frame(a, b, fx, dt=0.1):
    """Published dicts a (JAX) and b (port) of one frame."""
    assert b["t_ns"] == a["t_ns"]
    np.testing.assert_array_equal(b["ids"], a["ids"])
    np.testing.assert_allclose(b["uv"], a["uv"], rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(b["rows"], a["rows"], rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(b["pts"], a["pts"], rtol=0, atol=PX_TOL / fx)
    np.testing.assert_allclose(b["vel"], a["vel"], rtol=0,
                               atol=PX_TOL / fx / dt)


@pytest.mark.parametrize("reject_wf", [False, True])
def test_feature_tracker_matches_jax_on_a_shift(reject_wf):
    """`tests/test_frontend.py`'s end-to-end id case: a texture, then the
    same texture shifted by (2.0, -1.5) px; with the gate on, it runs on
    the second frame's tracks."""
    kw = dict(max_cnt=80, min_dist=12, freq=1000.0, reject_wf=reject_wf)
    cam = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0)
    jt = jtracker.FeatureTracker(jtracker.TrackerConfig(**kw),
                                 jcam.Pinhole(**cam), (240, 320))
    tt = ttracker.FeatureTracker(ttracker.TrackerConfig(**kw),
                                 tcam.Pinhole(**cam), (240, 320),
                                 device="cpu")
    img0 = make_texture(seed=9)
    img1 = shift_image(img0, 2.0, -1.5)
    for t_ns, img in ((0, img0), (100_000_000, img1)):
        a, b = jt.process(t_ns, img), tt.process(t_ns, img)
        assert len(a["ids"]) > 30
        assert_same_frame(a, b, cam["fx"])
    common = np.intersect1d(a["ids"], np.arange(80))
    assert len(common) > 20  # tracked, not refilled


@pytest.mark.parametrize("reject_wf", [False, True])
def test_feature_tracker_matches_jax_on_textured_frames(gated_sequence,
                                                        reject_wf):
    """Every frame of the planted-quad sequence through both classic
    trackers: the same published frames, ids and points; on the CPU the
    port runs the plain LK track once a frame over all 4 levels."""
    sim, imgs, _ = gated_sequence
    kw = {**TRACKER, "reject_wf": reject_wf}
    jt = jtracker.FeatureTracker(jtracker.TrackerConfig(**kw),
                                 jcam.Pinhole(FX, FX, CX, CY), (H, W))
    tt = ttracker.FeatureTracker(ttracker.TrackerConfig(**kw),
                                 tcam.Pinhole(FX, FX, CX, CY), (H, W),
                                 device="cpu")
    assert tt.cfg.klt.levels == 4
    calls = lk.lk_track_plain.calls, lk.lk_level_plain.calls
    n_tracked = 0
    for i, fr in enumerate(sim.frames):
        a, b = jt.process(fr.t_ns, imgs[i]), tt.process(fr.t_ns, imgs[i])
        assert a is not None and b is not None
        assert_same_frame(a, b, FX)
        n_tracked += int((tt.track_cnt > 1).sum())
    n = len(sim.frames)
    # from the second frame on: one plain track of 2 passes x 4 levels
    assert lk.lk_track_plain.calls - calls[0] == n - 1
    assert lk.lk_level_plain.calls - calls[1] == 8 * (n - 1)
    assert n_tracked > 20 * n


@pytest.mark.parametrize("fused,reject_wf", [(True, False), (True, True),
                                             (False, False), (False, True)])
def test_attach_frontend_routes_as_jax(fused, reject_wf):
    """fused without the gate gives the slot-identity FusedTracker; the
    gate or fused=False gives the classic FeatureTracker, in both
    packages."""
    q, p = np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3)
    cfg = dict(max_cnt=40, reject_wf=reject_wf)
    jv = JCtrlVIO(JVIOConfig(use_native=False), q, p)
    jv.attach_frontend(jcam.Pinhole(FX, FX, CX, CY), (H, W),
                       JTrackerConfig(**cfg), fused=fused)
    tv = TCtrlVIO(TVIOConfig(use_native=False), q, p, device="cpu")
    tv.attach_frontend(tcam.Pinhole(FX, FX, CX, CY), (H, W),
                       TTrackerConfig(**cfg), fused=fused)
    want = "FusedTracker" if fused and not reject_wf else "FeatureTracker"
    assert type(jv.tracker).__name__ == type(tv.tracker).__name__ == want
    assert isinstance(tv.tracker, TFusedTracker if want == "FusedTracker"
                      else ttracker.FeatureTracker)
    assert tv.tracker.device == torch.device("cpu")


def test_feature_tracker_defaults_to_the_card():
    """No card and no explicit CPU request: the entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ttracker.FeatureTracker(ttracker.TrackerConfig(),
                                tcam.Pinhole(FX, FX, CX, CY), (H, W))
