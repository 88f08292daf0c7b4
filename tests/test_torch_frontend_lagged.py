"""The F-gated front end on the estimator's normal path
(`CtrlVIO.attach_frontend`, `process_image`, `flush`), one image behind
(`lag=1`, as the image cell runs it) and unlagged, and its spans, stamps
and counters in the estimator's records.

On the CPU at 80x64 (Kannala-Brandt with `cam_tumrs.yaml`'s distortion at
a focal length that fits the small image), a seeded textured world with a
moving quad planted in view: the normal path publishes the same frames
and returns the same poses as the side path that `bench.py --mode image`
drives (`FusedTracker.step` then `process_frame`, the flow from the
estimator's own IMU buffer and gyro bias); the default lag is 0, and a
gated config gets the gated tracker. This file imports neither JAX nor
the JAX package.
"""

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.frontend.fused import FusedTracker, rotation_flow
from ctrlvio_tpu_torch.frontend.klt import KLTConfig
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig
from ctrlvio_tpu_torch.models.cameras import Equidistant
from ctrlvio_tpu_torch.ops import lk, so3np
from ctrlvio_tpu_torch.sim import render, synthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig
from ctrlvio_tpu_torch.utils import spans
from torch_parity import one_torch_thread  # noqa: F401

H, W = 64, 80
CAM = dict(mu=37.0, mv=37.0, u0=39.3, v0=32.6, k2=0.019327620961435945,
           k3=0.006784242994724914, k4=-0.008658628531456217,
           k5=0.0051893686731546585)
WINDOW = dict(KW=24, NB=6, LM=96, OBS=384, MIMU=192)
STREAM = dict(stream=True, stream_warmup=3, stream_lag=2, ba_iters=4,
              init_ba_iters=4, predict_iters=4)
# `cam_tumrs.yaml`'s tracker block at the small image: the cap and the
# spacing scaled down, the F-gate's threshold in the virtual image's px
TRACKER = dict(max_cnt=40, min_dist=6, reject_wf=True, f_threshold=1.0,
               klt=KLTConfig(pred_levels=3))
LINE_DELAY = 4e-4


@pytest.fixture(scope="module")
def scene():
    """2 s at 10 Hz of the textured world (seed 1, four occluders, the
    even ones moving) with a quad sweeping sideways 2.5 m ahead of the
    mid-sequence camera."""
    sim = synthetic.generate(synthetic.SimConfig(
        duration=2.0, n_landmarks=40, seed=4, line_delay=LINE_DELAY,
        image_h=H, image_w=W))
    cam = Equidistant(**CAM)
    world = render.make_world(sim, seed=1, n_occluders=4,
                              occluder_speed=0.4)
    R_CtoI = so3np.quat_to_matrix(
        so3np.quat_exp(np.asarray(sim.cfg.ext_rot))[None])[0]
    q, p = sim.pose_at(sim.frames[len(sim.frames) // 2].t_ns * 1e-9)
    R = so3np.quat_to_matrix(q if q.ndim == 2 else q[None])[0]
    cw = (p[0] if p.ndim == 2 else p) + R @ np.asarray(sim.cfg.ext_pos)
    Rc = (R @ R_CtoI).astype(np.float32)
    c = cw.astype(np.float32) + Rc @ np.array([0.0, 0.0, 2.5], np.float32)
    world.add_quad(c, Rc @ np.array([1.0, 0, 0]), Rc @ np.array([0, 1.0, 0]),
                   (0.6, 0.6), vel=Rc @ np.array([0.6, 0.0, 0.0]))
    imgs = render.render_textured_sequence(sim, H, W, cam, world=world,
                                           seed=1)
    return sim, cam, imgs


def new_vio(sim, **kw):
    """A streamed f64 CtrlVIO on the CPU from the ground-truth bootstrap,
    the IMU fed up to the first frame."""
    vio = CtrlVIO(VIOConfig(window_config=WindowConfig(**WINDOW),
                            fix_ld=False, ld_upper=5e-4, dtype=torch.float64,
                            **{**STREAM, **kw}),
                  so3np.quat_exp(np.asarray(sim.cfg.ext_rot)),
                  np.asarray(sim.cfg.ext_pos), device="cpu")
    init = bootstrap_from_sim(sim)
    return vio, init


class Feed:
    """Hands an estimator the IMU samples up to a time (0.25 s ahead of
    each image, as the benchmark's feed does)."""

    def __init__(self, vio, sim):
        self.vio, self.sim, self.k = vio, sim, 0

    def until(self, t_ns):
        s = self.sim
        while self.k < len(s.imu_t_ns) and s.imu_t_ns[self.k] <= t_ns:
            self.vio.process_imu(s.imu_t_ns[self.k], s.gyro[self.k],
                                 s.accel[self.k])
            self.k += 1


AHEAD_NS = 250_000_000


def started(sim, **kw):
    vio, init = new_vio(sim, **kw)
    feed = Feed(vio, sim)
    feed.until(init.t_ns + AHEAD_NS)
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    return vio, feed


def normal_path(sim, cam, imgs, lag=1, record=False, frames=None):
    """The estimator's entry points only: process_imu, process_image,
    flush. Returns the estimator, each call's pose (None or (q, p)) and
    each frame handed to process_frame."""
    vio, feed = started(sim)
    vio.attach_frontend(cam, (H, W), TrackerConfig(**TRACKER), lag=lag)
    if record:
        vio.trace(True)
    handed = []
    inner = vio.process_frame

    def catch(t_ns, ids, pts, rows):
        handed.append((int(t_ns), np.array(ids), np.array(pts),
                       np.array(rows)))
        return inner(t_ns, ids, pts, rows)

    vio.process_frame = catch
    poses = []
    for i, fr in enumerate(sim.frames[:frames]):
        feed.until(fr.t_ns + AHEAD_NS)
        poses.append(vio.process_image(fr.t_ns, imgs[i]))
    vio.flush()
    if record:
        vio.trace(False)
    return vio, poses, handed


def side_path(sim, cam, imgs, lag=1):
    """`bench.py --mode image`'s loop: the F-gated FusedTracker beside the
    estimator, the flow from the estimator's own IMU buffer and gyro bias,
    each published frame into process_frame."""
    vio, feed = started(sim)
    tracker = FusedTracker(TrackerConfig(**TRACKER), cam, (H, W), lag=lag,
                           device="cpu")
    R_ic = so3np.quat_to_matrix(vio.q_CtoI[None])[0]
    poses, handed, prev = [], [], None

    def estimate(feat):
        if feat is None:
            return None
        handed.append((int(feat["t_ns"]), feat["ids"], feat["pts"],
                       feat["rows"]))
        return vio.process_frame(feat["t_ns"], feat["ids"], feat["pts"],
                                 feat["rows"])

    for i, fr in enumerate(sim.frames):
        feed.until(fr.t_ns + AHEAD_NS)
        base = vio.data_start_ns or 0
        M = None if prev is None else rotation_flow(
            vio.imu_t_ns, vio.imu_gyro, prev - base, fr.t_ns - base, R_ic,
            bg=vio.bg[-1])
        prev = fr.t_ns
        poses.append(estimate(tracker.step(fr.t_ns, imgs[i], R_rel=M)))
    estimate(tracker.flush())
    vio.flush()
    return vio, poses, handed, tracker


@pytest.fixture(scope="module")
def runs_at(scene):
    """Both paths at a lag, recorded on the normal path; each lag run
    once for the module."""
    sim, cam, imgs = scene
    done = {}

    def at(lag):
        if lag not in done:
            calls = lk.lk_track_plain.calls
            normal = normal_path(sim, cam, imgs, lag=lag, record=True)
            n_plain = lk.lk_track_plain.calls - calls
            done[lag] = normal, side_path(sim, cam, imgs, lag=lag), n_plain
        return done[lag]

    return at


@pytest.fixture(scope="module")
def runs(runs_at):
    return runs_at(1)


@pytest.mark.parametrize("lag", [0, 1])
def test_normal_path_equals_the_side_path(runs_at, scene, lag):
    sim = scene[0]
    (vio, poses, handed), (svio, sposes, shanded, tracker), n_plain = \
        runs_at(lag)
    n = len(sim.frames)
    # one plain 3-level track an image (the CPU's K1), every frame handed
    # on (with lag 1 one image late, the last by flush)
    assert n_plain == n
    assert isinstance(vio.tracker, FusedTracker) and vio.tracker.lag == lag
    assert len(handed) == len(shanded) == n
    assert [h[0] for h in handed] == [fr.t_ns for fr in sim.frames]
    for (t, ids, pts, rows), (st, sids, spts, srows) in zip(handed, shanded):
        assert t == st
        np.testing.assert_array_equal(ids, sids)
        np.testing.assert_array_equal(pts, spts)
        np.testing.assert_array_equal(rows, srows)
    if lag:
        assert poses[0] is None and sposes[0] is None
    assert len(poses) == len(sposes) == n
    for a, b in zip(poses, sposes):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.concatenate(a),
                                          np.concatenate(b))
    assert vio.counts["megastep"] == svio.counts["megastep"] > 0
    np.testing.assert_array_equal(vio.traj.knots_p[: vio.traj.n],
                                  svio.traj.knots_p[: svio.traj.n])
    assert vio.traj.line_delay == svio.traj.line_delay
    assert vio.tracker.n_rejected == tracker.n_rejected > 0


def test_the_default_route_is_unchanged(scene):
    """The default lag's route (the name is the test's old one; the route
    itself changed: a gated config no longer goes to a tracker of its
    own): a gated config at the default lag gets the gated
    `FusedTracker`, unlagged; a lag other than 0 or 1 raises."""
    sim, cam, _ = scene
    vio, _ = new_vio(sim)
    vio.attach_frontend(cam, (H, W), TrackerConfig(**TRACKER))
    tr = vio.tracker
    assert type(tr) is FusedTracker and tr.lag == 0 and tr.cfg.reject_wf
    assert tr._table is not None and tr.device == vio.device
    assert not tr.timing and "frontend.dispatch" not in vio.timing
    with pytest.raises(ValueError):
        vio.attach_frontend(cam, (H, W), TrackerConfig(**TRACKER), lag=2)


# ---------------------------------------------------------------------------
# spans, stamps and counters
# ---------------------------------------------------------------------------

FRONTEND_TREE = {"frontend.flow": "process_image",
                 "frontend.dispatch": "process_image",
                 "frontend.consume": "process_image",
                 "frontend.pull_wait": "frontend.consume",
                 "frontend.fgate": "frontend.consume",
                 "process_frame": "process_image",
                 "frontend.device.track": "process_image",
                 "frontend.device.refill": "process_image"}


@pytest.mark.parametrize("lag", [0, 1])
def test_frontend_spans_nest_under_process_image(runs_at, scene, lag):
    vio = runs_at(lag)[0][0]
    n = len(scene[0].frames)
    got = vio.trace_record()["spans"]
    names, rows = got["names"], got["rows"]
    name = [names[r[spans.NAME]] for r in rows]
    roots = [i for i, x in enumerate(name) if x == "process_image"]
    # one a call, and flush()'s
    assert len(roots) == n + 1
    assert [rows[i, spans.FRAME] for i in roots] == list(range(n + 1))
    seen = set()
    for i, x in enumerate(name):
        if x not in FRONTEND_TREE:
            continue
        p = rows[i, spans.PARENT]
        assert name[p] == FRONTEND_TREE[x], (x, name[p])
        assert rows[i, spans.FRAME] == rows[p, spans.FRAME] >= 0
        if not x.startswith("frontend.device."):
            assert rows[p, spans.START] <= rows[i, spans.START]
            assert rows[i, spans.END] <= rows[p, spans.END]
        seen.add(x)
    assert seen == set(FRONTEND_TREE)
    # the process_frame of a call estimates its image (lag 0) or the
    # previous one (lag 1, the last in flush()'s)
    frames = [rows[i, spans.FRAME] for i, x in enumerate(name)
              if x == "process_frame"]
    assert frames == list(range(lag, n + lag))


def test_frontend_stamps_each_step(runs, scene):
    vio = runs[0][0]
    n = len(scene[0].frames)
    fe = vio.trace_record()["frontend"]
    assert fe["tags"] == spans.FRONTEND_TAGS
    st = fe["stamps"]
    assert len(st) == n and list(fe["seq"]) == list(range(n))
    assert list(fe["frame"]) == list(range(n))
    assert (st > 0).all() and (np.diff(st, axis=1) >= 0).all()


def test_timing_keys_keep_their_meaning(runs, scene):
    vio = runs[0][0]
    tracker = vio.tracker
    # the tracker's own keys, as a standalone tracker has them
    assert set(tracker.timing) == {"dispatch", "consume", "pull_wait",
                                   "fgate"}
    for k, v in tracker.timing.items():
        assert vio.timing["frontend." + k] == v > 0
    # the estimator's "dispatch" and "consume" hold its own spans alone
    got = vio.trace_record()["spans"]
    names, rows = got["names"], got["rows"]
    for key in ("dispatch", "consume"):
        total = sum((r[spans.END] - r[spans.START]) * 1e-9 for r in rows
                    if names[r[spans.NAME]] == key)
        assert total == pytest.approx(vio.timing[key], rel=1e-9)
    # a features-only run has the keys it had
    sim = scene[0]
    fvio, feed = started(sim)
    for fr in sim.frames[:8]:
        feed.until(fr.t_ns + AHEAD_NS)
        fvio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
    fvio.flush()
    assert not any(k.startswith("frontend.") or k == "process_image"
                   for k in fvio.timing)
    assert {"process_frame", "add_frame", "predict"} <= set(fvio.timing)
    assert fvio.trace_record()["frontend"] is None


def test_tracker_counters_add_up(runs):
    (vio, _, handed), (_, _, shanded, tracker), _ = runs
    for t, hs in ((vio.tracker, handed), (tracker, shanded)):
        c = t.counts
        assert c["frames"] == len(hs)
        assert c["features"] == sum(len(h[1]) for h in hs)
        assert c["rejected"] == t.n_rejected > 0
        # every id first published is a refilled slot
        ids = np.concatenate([h[1] for h in hs])
        assert c["refilled"] >= len(np.unique(ids))
