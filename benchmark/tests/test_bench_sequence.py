"""The benchmark's generator: the vectorized frames against a frame-by-frame
loop over the same draws, its ground truth against the reference's numpy
copy, and the same seed giving the same sequence."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark import reference, sequence

HERE = Path(__file__).resolve().parents[1]
TRAFFIC = json.loads((HERE / "traffic" / "features.json").read_text())
RIG = json.loads((HERE / "configs" / "tumrs_single.json").read_text())["rig"]
N_FRAMES = 12
SEED = 2 ** 31 + 12345


def loop_frames(traffic, rig, n_frames, seed):
    """The frames as `sim/synthetic.py` makes them: one frame at a time,
    its fixed point, its rows, its noisy pixels undistorted, on the same
    draws, and the tracker's cap over the frames."""
    d = sequence.draw(traffic, n_frames, seed, "cpu")
    gt = sequence.Lissajous(d.phases, traffic["speed"], traffic["pause"])
    cam = sequence.Camera(rig, traffic, "cpu")
    lm = sequence.landmarks(gt, d, traffic, n_frames)
    t_ns, tf = sequence.frame_times(traffic, n_frames, "cpu")
    px = traffic["pixel_noise_px"]
    seen, pts, rows_all = [], [], []
    for f in range(n_frames):
        t = torch.full((1, lm.shape[0]), float(tf[f]), dtype=torch.float64)
        for _ in range(sequence.RS_ITERS):
            u, v, vis = cam.project(gt, lm, t)
            t = torch.where(vis, tf[f] + v.clamp(0, cam.h - 1) * cam.ld,
                            tf[f])
        rows = torch.round(v.clamp(0, cam.h - 1))
        u, v2, vis2 = cam.project(gt, lm, tf[f] + rows * cam.ld)
        seen.append((vis2 & vis & ((v2 - rows).abs() < 3.0))[0].numpy())
        xn, yn = cam.lift(u[0] + d.pix[f, :, 0] * px,
                          v2[0] + d.pix[f, :, 1] * px)
        pts.append(torch.stack([xn, yn], -1).numpy())
        rows_all.append(rows[0].numpy())
    kept = sequence.track(np.stack(seen), d.lm_rank.numpy(),
                          traffic["max_cnt"])
    out = []
    for f in range(n_frames):
        ids = np.nonzero(kept[f])[0]
        out.append((int(t_ns[f]), ids, pts[f][ids], rows_all[f][ids]))
    return out


def test_vectorized_frames_equal_the_loop():
    seq = sequence.generate(TRAFFIC, RIG, N_FRAMES, SEED, "cpu")
    ref = loop_frames(TRAFFIC, RIG, N_FRAMES, SEED)
    assert len(seq.frames) == N_FRAMES
    for (t, ids, pts, rows), (t2, ids2, pts2, rows2) in zip(seq.frames, ref):
        assert t == t2
        np.testing.assert_array_equal(ids, ids2)
        np.testing.assert_array_equal(rows, rows2)
        # elementwise float64 arithmetic in another batch shape: within
        # a few ulps of coordinates of order 1
        np.testing.assert_allclose(pts, pts2, rtol=0, atol=1e-13)
    # the fisheye sees more than the cap: every frame holds max_cnt
    assert all(len(f[1]) == TRAFFIC["max_cnt"] for f in seq.frames)


def test_fisheye_lift_inverts_its_projection():
    cam = sequence.Camera(RIG, TRAFFIC, "cpu")
    g = torch.Generator().manual_seed(5)
    X = torch.randn(4000, 3, generator=g, dtype=torch.float64)
    X[:, 2] = X[:, 2].abs() + 0.2
    th = torch.atan2(X[:, :2].norm(dim=-1), X[:, 2])
    X = X[th < 1.2]
    r = X[:, :2].norm(dim=-1)
    s = cam.theta_d(torch.atan2(r, X[:, 2])) / r
    u = cam.mu * s * X[:, 0] + cam.u0
    v = cam.mv * s * X[:, 1] + cam.v0
    xn, yn = cam.lift(u, v)
    np.testing.assert_allclose(xn.numpy(), (X[:, 0] / X[:, 2]).numpy(),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(yn.numpy(), (X[:, 1] / X[:, 2]).numpy(),
                               rtol=1e-10, atol=1e-12)


def test_tracker_cap_keeps_tracks_first_and_refills_by_rank():
    keep = np.array([[1, 1, 1, 1, 0],
                     [1, 1, 1, 1, 1],
                     [0, 1, 1, 1, 1],
                     [1, 1, 1, 1, 1]], bool)
    rank = np.array([0.5, 0.1, 0.9, 0.3, 0.2])
    kept = sequence.track(keep, rank, 2)
    # frame 0: the two best ranked in view (1, 3); frame 1: both still in
    # view, kept; frame 2: the same; frame 3: the same, 0 and 4 not taken
    np.testing.assert_array_equal(kept, [[0, 1, 0, 1, 0]] * 4)
    kept = sequence.track(keep, rank, 3)
    # frame 0: 1, 3, 0; frame 2: 0 lost, refilled by 4 (rank 0.2)
    np.testing.assert_array_equal(
        kept, [[1, 1, 0, 1, 0], [1, 1, 0, 1, 0], [0, 1, 0, 1, 1],
               [0, 1, 0, 1, 1]])


def test_truth_matches_the_reference_copy():
    seq = sequence.generate(TRAFFIC, RIG, N_FRAMES, SEED, "cpu")
    gt = sequence.Lissajous(torch.from_numpy(seq.phases), seq.speed,
                            seq.pause)
    ts = np.linspace(0.3, 9.4, 230)
    q, p = gt.pose(torch.from_numpy(ts))
    q2, p2 = reference.truth(seq.phases, seq.speed, seq.pause, ts)
    np.testing.assert_allclose(q.numpy(), q2, rtol=0, atol=1e-14)
    np.testing.assert_allclose(p.numpy(), p2, rtol=0, atol=1e-14)
    assert seq.init["t_ns"] == seq.frames[0][0]
    np.testing.assert_allclose(seq.init["p"], p2[0], atol=1e-14)


def test_imu_covers_every_frame_and_its_look_ahead():
    seq = sequence.generate(TRAFFIC, RIG, N_FRAMES, SEED, "cpu")
    ahead = int(TRAFFIC["imu_ahead_s"] * 1e9)
    assert seq.imu_t_ns[-1] >= seq.frames[-1][0] + ahead
    assert np.all(np.diff(seq.imu_t_ns) == 5_000_000)


def test_same_seed_same_sequence_other_seed_other():
    a = sequence.generate(TRAFFIC, RIG, 4, SEED, "cpu")
    b = sequence.generate(TRAFFIC, RIG, 4, SEED, "cpu")
    c = sequence.generate(TRAFFIC, RIG, 4, SEED + 1, "cpu")
    np.testing.assert_array_equal(a.gyro, b.gyro)
    np.testing.assert_array_equal(a.frames[3][2], b.frames[3][2])
    assert not np.array_equal(a.phases, c.phases)
