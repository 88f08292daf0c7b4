"""The fused front end's captured programs (`FusedTracker._preprocess`
and `_step`, ≙ the JAX package's `_jit_pre` and `_jit_step`) on the CPU,
through the test-only replay stand-in (`tests/torch_graph_standin.py`),
against the eager tracker: equal bit for bit, with the plain LK's calls
counted through replays as K1's launches are on the card."""

import numpy as np
import pytest

from ctrlvio_tpu_torch.frontend.fused import FusedTracker, rotation_flow
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig
from ctrlvio_tpu_torch.models import cameras
from ctrlvio_tpu_torch.ops import lk, so3np
from ctrlvio_tpu_torch.sim import render, synthetic
from ctrlvio_tpu_torch.utils import graphs
from tests.torch_graph_standin import replayed_programs
from tests.torch_parity import one_torch_thread  # noqa: F401

H, W, FX = 128, 160, 100.0


@pytest.fixture(scope="module")
def frames():
    s = synthetic.generate(synthetic.SimConfig(
        duration=1.0, n_landmarks=50, seed=5, image_h=H, image_w=W, fx=FX,
        fy=FX, cx=W / 2, cy=H / 2))
    cam = cameras.Pinhole(FX, FX, W / 2, H / 2)
    imgs = render.render_textured_sequence(s, H, W, cam, seed=2)
    R = so3np.quat_to_matrix(
        so3np.quat_exp(np.asarray(s.cfg.ext_rot))[None])[0]
    return s, imgs, cam, R


def track(frames, lag):
    """Every frame through a fused tracker (restarted half-way), then
    `flush`. Returns the published dicts and the plain LK's call count."""
    s, imgs, cam, R = frames
    tracker = FusedTracker(TrackerConfig(max_cnt=40, min_dist=8, freq=100.0),
                           cam, (H, W), lag=lag, device="cpu")
    outs, prev = [], None
    lk.reset_counts()
    for i, fr in enumerate(s.frames):
        M = None if prev is None else rotation_flow(
            s.imu_t_ns, s.gyro, prev, fr.t_ns, R)
        prev = fr.t_ns
        if i == len(s.frames) // 2:
            tracker.restart()
        outs.append(tracker.step(fr.t_ns, imgs[i], R_rel=M))
    outs.append(tracker.flush())
    return [o for o in outs if o is not None], lk.lk_track_plain.calls


@pytest.mark.parametrize("lag", [0, 1])
def test_fused_tracker_replayed_equals_eager(frames, lag):
    """Every published frame of the fused tracker, replayed, equals the
    eager tracker's bit for bit; the restart half-way drops the carried
    state, which the next step copies in afresh. The plain LK (the CPU's
    K1) counts once a frame through replays, plus the one warm-up run
    before the step's capture."""
    eager, calls_e = track(frames, lag)
    with replayed_programs():
        got, calls_r = track(frames, lag)
        st = graphs.stats()
    assert len(got) == len(eager) > 5
    for a, b in zip(got, eager):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    n = len(frames[0].frames)
    assert calls_e == n
    assert st["launches_replayed"]["lk_track_plain"] == n
    assert st["launches_warm_up"]["lk_track_plain"] == 1
    assert calls_r == n + 1
    assert sorted(c["key"] for c in st["graphs_captured"]) == [
        "_preprocess()", "_step()"]
