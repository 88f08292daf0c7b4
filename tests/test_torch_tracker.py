"""Parity of the port's `FusedTracker` with the JAX package's on the CPU,
with and without the epipolar F-RANSAC gate: on textured frames with a
planted moving quad (lag 0 and 1) and on a shifted texture; and the
tracker `attach_frontend` gives for every config (the estimator's whole
image path with the gated tracker is in
`tests/test_torch_gated_image_path.py`).

Tolerances: ids and F-gate rejection counts exactly; published points
within 1e-3 px (the plain LK sums its 441 patch terms in another order
than JAX, and the differences compound over frames), normalized points and
velocities to the same 1e-3 px through the focal length and the frame
interval."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu.frontend.fused import FusedTracker as JFusedTracker
from ctrlvio_tpu.frontend.fused import rotation_flow
from ctrlvio_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
from ctrlvio_tpu.models import cameras as jcam
from ctrlvio_tpu.sim import render as jrender
from ctrlvio_tpu.sim import synthetic
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO as TCtrlVIO
from ctrlvio_tpu_torch.estimator.odometry import VIOConfig as TVIOConfig
from ctrlvio_tpu_torch.frontend.fused import FusedTracker as TFusedTracker
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig as TTrackerConfig
from ctrlvio_tpu_torch.models import cameras as tcam
from ctrlvio_tpu_torch.ops import so3np
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


@pytest.mark.parametrize("lag,reject_wf", [
    pytest.param(0, True, id="0"), pytest.param(1, True, id="1"),
    pytest.param(0, False, id="0-ungated"),
    pytest.param(1, False, id="1-ungated")])
def test_f_gated_tracker_matches_jax(gated_sequence, lag, reject_wf):
    """Per frame: the same ids, points within 1e-3 px, the same velocities
    to 1e-3 px over the frame interval, and the same running count of F-gate
    rejections; with the gate on it fires, with it off it rejects
    nothing."""
    sim, imgs, R = gated_sequence
    kw = {**TRACKER, "reject_wf": reject_wf}
    ref = drive(JFusedTracker(JTrackerConfig(**kw),
                              jcam.Pinhole(FX, FX, CX, CY), (H, W), lag=lag),
                sim, imgs, R)
    out = drive(TFusedTracker(TTrackerConfig(**kw),
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
    # the planted quad makes the gate fire
    assert (out[-1][1] > 0) == reject_wf


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
def test_fused_tracker_matches_jax_on_a_shift(reject_wf):
    """`tests/test_frontend.py`'s end-to-end id case: a texture, then the
    same texture shifted by (2.0, -1.5) px, through both packages'
    `FusedTracker`; with the gate on, it runs on the second frame's
    tracks."""
    kw = dict(max_cnt=80, min_dist=12, freq=1000.0, reject_wf=reject_wf)
    cam = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0)
    jt = JFusedTracker(JTrackerConfig(**kw), jcam.Pinhole(**cam), (240, 320))
    tt = TFusedTracker(TTrackerConfig(**kw), tcam.Pinhole(**cam), (240, 320),
                       device="cpu")
    img0 = make_texture(seed=9)
    img1 = shift_image(img0, 2.0, -1.5)
    for t_ns, img in ((0, img0), (100_000_000, img1)):
        a, b = jt.step(t_ns, img), tt.step(t_ns, img)
        assert len(a["ids"]) > 30
        assert_same_frame(a, b, cam["fx"])
    common = np.intersect1d(a["ids"], np.arange(80))
    assert len(common) > 20  # tracked, not refilled
    assert tt.n_rejected == jt.n_rejected
    assert tt.counts["gated"] == int(reject_wf)


@pytest.mark.parametrize("lag", [0, 1])
@pytest.mark.parametrize("reject_wf", [False, True],
                         ids=["ungated", "gated"])
def test_attach_frontend_routes_as_jax(reject_wf, lag):
    """The port's own route, gated or not (the name is the test's old
    one: the JAX package still sends a gated config to its classic
    tracker, so the two no longer route alike; the gated route is held
    against the JAX package in `tests/test_torch_gated_image_path.py`):
    every config gets the slot-identity `FusedTracker`, at the asked lag,
    on the estimator's device, with the F-gate's sample table only where
    the config asks for the gate."""
    q, p = np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3)
    cfg = dict(max_cnt=40, reject_wf=reject_wf)
    tv = TCtrlVIO(TVIOConfig(use_native=False), q, p, device="cpu")
    tv.attach_frontend(tcam.Pinhole(FX, FX, CX, CY), (H, W),
                       TTrackerConfig(**cfg), lag=lag)
    assert type(tv.tracker) is TFusedTracker
    assert tv.tracker.lag == lag and tv.tracker.cfg.reject_wf == reject_wf
    assert tv.tracker.device == torch.device("cpu")
    assert (tv.tracker._table is not None) == reject_wf
    if reject_wf:
        assert tv.tracker._table.shape == (41, 200, 8)
