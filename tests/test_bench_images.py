"""The image cell's own pieces on the CPU: the card's renderer
(`benchmark/render.py`) against the port's host renderer, the front end's
published tracks against the plain track reference
(`benchmark/track_ref.py`), and the cell's three per-layer metrics.

The tracks are the lagged, F-gated `FusedTracker` of the cell's
configuration on eight full-size frames of the cell's scene (one seed),
with a quad sweeping sideways 2.5 m ahead of the camera so that the gate
meets outliers; the faults the bounds must catch (a one-level track, the
forward-backward check off, the F-gate off) run on the same frames. This
file imports neither JAX nor the JAX package.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, render, roofline, roofline_k1, sequence
from benchmark import trace as btrace
from benchmark import track_ref
from benchmark.drivers import images
from ctrlvio_tpu_torch.frontend.fused import FusedTracker, rotation_flow
from ctrlvio_tpu_torch.models.cameras import Equidistant
from ctrlvio_tpu_torch.sim import render as host_render
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TRAFFIC = json.loads((ROOT / "benchmark/traffic/textured.json").read_text())
CONFIG = json.loads((ROOT / "benchmark/configs/tumrs_images.json")
                    .read_text())
RIG = CONFIG["rig"]
SEED = 2**31 + 5
KB = ("mu", "mv", "u0", "v0", "k2", "k3", "k4", "k5")

# Bounds on the published tracks of `test_tracks_against_the_scene`
# (sound readings: median 0.25 px, gross 0.45 %, tracked 87 %, moving
# 0.56 %). KLT's sub-pixel error on a bilinearly sampled texture with 2 grey
# levels of pixel noise is a few tenths of a pixel: the median bound.
MEDIAN_PX = 0.4
# a track more than 2 px off converged elsewhere; the forward-backward
# check drops those (without it 2.4 %, a one-level track 2.7 %)
GROSS_SHARE = 1.0
# a one-level track loses most tracks to the check (29 % kept)
TRACKED_SHARE = 60.0
# the F-gate drops tracks on the moving quad (without it 2.4 %)
MOVING_SHARE = 1.2


def small_camera(scale):
    c = TRAFFIC["camera"]
    return dict(c, **{k: c[k] / scale for k in ("mu", "mv", "u0", "v0")})


def the_truth(n, first_s=5.0):
    tr = dict(TRAFFIC, first_frame_s=first_s)
    seq, gt, t_ns = images.truth(tr, n, SEED, "cpu")
    return tr, seq, gt, t_ns


def test_world_is_drawn_as_the_host_renderer_draws_it():
    _, _, gt, t_ns = the_truth(4)
    path = render.path_points(gt, t_ns[-1] * 1e-9 + 0.1, 0.05)
    w = render.world_for(TRAFFIC["scene"], path, SEED)
    sc = TRAFFIC["scene"]
    ref = host_render.TexturedWorld(
        path.min(0) - sc["margin_m"], path.max(0) + sc["margin_m"],
        seed=SEED, n_occluders=sc["n_occluders"],
        occluder_speed=sc["occluder_speed"], keepout_path=path)
    for a, b in zip(w.tex_faces, ref.tex_faces):
        np.testing.assert_array_equal(a, b)
    assert len(w.occ) == len(ref.occ) == 4
    for a, b in zip(w.occ, ref.occ):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert sum(bool(np.any(q["vel"])) for q in w.occ) == 2


@pytest.mark.parametrize("photometric", [False, True])
def test_renderer_matches_the_host_renderer(photometric):
    """The same world and poses, the noise off: rounded grey levels equal
    at >= 99.9 % of pixels, off by at most 1 elsewhere."""
    H, W, scale = 128, 160, 8
    _, _, gt, t_ns = the_truth(6)
    cam = small_camera(scale)
    path = render.path_points(gt, t_ns[-1] * 1e-9 + 0.1, 0.05)
    world = render.world_for(TRAFFIC["scene"], path, SEED)
    mine = render.Renderer(world, cam, RIG, H, W, "cpu",
                           photometric=photometric, pixel_noise=0.0,
                           seed=SEED).frames(gt, t_ns).numpy()
    sc = TRAFFIC["scene"]
    ref_world = host_render.TexturedWorld(
        world.lo, world.hi, seed=SEED, n_occluders=sc["n_occluders"],
        occluder_speed=sc["occluder_speed"], keepout_path=path)

    def poses_at(ts):
        q, p = gt.pose(torch.as_tensor(np.asarray(ts), dtype=torch.float64))
        return q.numpy(), p.numpy(), None, None

    sim = SimpleNamespace(
        frames=[SimpleNamespace(t_ns=t) for t in t_ns], poses_at=poses_at,
        cfg=SimpleNamespace(ext_rot=RIG["ext_rot"], ext_pos=RIG["ext_pos"],
                            line_delay=RIG["line_delay"]))
    ref = host_render.render_textured_sequence(
        sim, H, W, Equidistant(**{k: cam[k] for k in KB}), world=ref_world,
        seed=SEED, photometric=photometric, pixel_noise=0.0)
    assert mine.dtype == np.uint8 and mine.shape == ref.shape
    diff = np.abs(mine.astype(np.int64) - ref.astype(np.int64))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
    assert mine.std() > 20  # textured, not flat


def test_pixel_noise_is_seeded():
    _, _, gt, t_ns = the_truth(2)
    cam = small_camera(16)
    path = render.path_points(gt, t_ns[-1] * 1e-9 + 0.1, 0.05)
    world = render.world_for(TRAFFIC["scene"], path, SEED)

    def frames(seed):
        return render.Renderer(world, cam, RIG, 64, 80, "cpu",
                               pixel_noise=2.0, seed=seed).frames(gt, t_ns)

    a, b, c = frames(SEED), frames(SEED), frames(SEED + 1)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# the published tracks against the scene
# ---------------------------------------------------------------------------

N_FRAMES = 8


@pytest.fixture(scope="module")
def scene():
    """Eight full-size frames of the cell's scene from 5 s on, a textured
    quad 2.5 m ahead of the first frame's camera sweeping sideways at
    0.6 m/s, and the IMU."""
    tr, seq, gt, t_ns = the_truth(N_FRAMES)
    W, H = tr["image_size"]
    path = render.path_points(gt, t_ns[-1] * 1e-9 + 0.1, 0.05)
    world = render.world_for(tr["scene"], path, SEED)
    probe = track_ref.Scene(world, RIG, tr["camera"], "cpu")
    R, c = probe.camera_pose(gt, torch.tensor([t_ns[0] * 1e-9],
                                              dtype=torch.float64))
    R, c = R[0].numpy(), c[0].numpy()
    vel = R @ np.array([0.6, 0.0, 0.0])
    world.add_quad(c + R @ np.array([0.0, 0.0, 2.5]) - vel * t_ns[0] * 1e-9,
                   R @ np.array([1.0, 0, 0]), R @ np.array([0, 1.0, 0]),
                   (0.6, 0.6), vel=vel)
    imgs = render.Renderer(world, tr["camera"], RIG, H, W, "cpu",
                           pixel_noise=tr["scene"]["pixel_noise"],
                           seed=SEED).frames(gt, t_ns)
    return tr, seq, gt, t_ns, world, imgs


def tracks(scene, **change):
    """The cell's tracker (lag 1, the F-gate) over the frames, the flow
    from the IMU less its bias; `change` alters its configuration block
    (`fb_thresh`: the forward-backward gate's distance)."""
    tr, seq, gt, t_ns, world, imgs = scene
    W, H = tr["image_size"]
    fb = change.pop("fb_thresh", None)
    cfg = images.tracker_config({**CONFIG["tracker"], **change})
    if fb is not None:
        cfg.klt = cfg.klt._replace(fb_thresh=fb)
    trk = FusedTracker(cfg, Equidistant(**{k: tr["camera"][k] for k in KB}),
                       (H, W), lag=1, device="cpu")
    R_CtoI = sequence.quat_matrix(sequence.quat_exp(
        torch.tensor(RIG["ext_rot"], dtype=torch.float64))).numpy()
    frames, prev = [], None

    def keep(out):
        o = np.argsort(out["ids"])
        frames.append((out["t_ns"], out["ids"][o], out["pts"][o],
                       out["rows"][o]))

    for k, t in enumerate(t_ns):
        M = None if prev is None else rotation_flow(
            seq.imu_t_ns, seq.gyro, prev, t, R_CtoI, bg=seq.bg)
        prev = t
        out = trk.step(t, imgs[k], R_rel=M)
        if out is not None:
            keep(out)
    keep(trk.flush())
    got = track_ref.check(frames, world, gt, RIG, tr["camera"], H, W, "cpu")
    return got, trk


def passes(got):
    return (got["err_px_median"] <= MEDIAN_PX
            and got["gross_share"] <= GROSS_SHARE
            and got["tracked_share"] >= TRACKED_SHARE
            and got["moving_share"] <= MOVING_SHARE)


def test_tracks_against_the_scene(scene):
    got, trk = tracks(scene)
    assert got["static"] >= 600 and trk.n_rejected > 0
    assert got["err_px_median"] <= MEDIAN_PX, got
    assert got["gross_share"] <= GROSS_SHARE, got
    assert got["tracked_share"] >= TRACKED_SHARE, got
    assert got["moving_share"] <= MOVING_SHARE, got


@pytest.mark.parametrize("fault", ["one_level", "no_fb_check", "no_f_gate"])
def test_the_bounds_catch_front_end_faults(scene, fault):
    change = {"one_level": {"pred_levels": 1},
              "no_fb_check": {"fb_thresh": 1e9},
              "no_f_gate": {"reject_wf": False}}[fault]
    got, _ = tracks(scene, **change)
    assert not passes(got), got
    if fault == "no_f_gate":
        assert got["moving_share"] > MOVING_SHARE


# ---------------------------------------------------------------------------
# the cell's per-layer metrics
# ---------------------------------------------------------------------------

METRICS = ("frontend_host_ms.images", "fgate_ms.images", "k1_roofline")
H100 = "NVIDIA H100 80GB HBM3"


def metric(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def made_up_ctx(driver="images", kernel="lk_kernel<true, 3>"):
    timing = {"frontend.flow": 0.02, "frontend.dispatch": 0.5,
              "frontend.consume": 2.0, "frontend.pull_wait": 0.3,
              "frontend.fgate": 1.5, "dispatch": 7.0, "consume": 9.0}
    # by name: (launches, their seconds in all)
    reading = btrace.Reading(
        calls=10, window_s=1.0, busy_s=0.5, device_s=0.5, ops=40, outside=0,
        by_name={f"void (anonymous namespace)::{kernel}(Args)": (10, 2e-3),
                 "image_rows_kernel": (10, 3e-5)})
    k1 = lambda n3: {"by_levels": {3: n3}, "plain": 0, "n": 150,  # noqa
                     "iters": 10}
    return dict(driver=driver, lanes=1, calls=100, timing=timing,
                trace=reading, c1={"k1": k1(200)}, c_tr={"k1": k1(210)},
                kind=H100)


def test_metrics_read_a_made_up_ctx():
    ctx = made_up_ctx()
    assert metric("frontend_host_ms.images").read(ctx) == pytest.approx(
        (0.02 + 0.5 + 2.0) / 100 * 1e3)
    assert metric("fgate_ms.images").read(ctx) == pytest.approx(15.0)
    bound = roofline_k1.track_bound_s(150, 3, 10, H100)
    assert metric("k1_roofline").read(ctx) == pytest.approx(
        bound / 2e-4 * 100)
    # 2 x 3 level-passes of 150 features, bound by their operations
    assert bound == pytest.approx(
        6 * 150 * 441 * (91 + 10 * 22)
        / roofline.PEAKS[H100]["float32_flop_per_s"])


def test_metrics_read_nothing_outside_their_cell():
    single = dict(made_up_ctx(driver="single"), c1={}, c_tr={},
                  timing={"dispatch": 7.0, "consume": 9.0})
    untraced = dict(made_up_ctx(), timing=None, trace=None, c1=None,
                    c_tr=None)
    no_k1 = made_up_ctx(kernel="image_rows_kernel")
    for name in METRICS:
        for ctx in (single, untraced):
            assert metric(name).read(ctx) is None, (name, ctx["driver"])
    assert metric("k1_roofline").read(no_k1) is None
    assert metric("k1_roofline").read(dict(made_up_ctx(), kind="cpu")) \
        is None
    # a parent without the front end's spans
    bare = dict(made_up_ctx(), timing={"dispatch": 7.0})
    assert metric("frontend_host_ms.images").read(bare) is None
    assert metric("fgate_ms.images").read(bare) is None


ESTIMATOR = ("host_busy_ms.images", "device_wait_ms.images",
             "lm_iters_per_solve.images")


def estimator_ctx(driver="images"):
    counts = lambda megasteps, k4: {"megasteps": megasteps,  # noqa: E731
                                    "lm": {"lm_accept": k4}}
    return dict(driver=driver, calls=100, call_s=[0.02] * 100,
                timing={"consume_fetch": 0.3, "dispatch": 7.0},
                c0=counts(50, 400), c1=counts(150, 1300))


def test_estimator_metrics_read_the_image_cell():
    ctx = estimator_ctx()
    assert metric("host_busy_ms.images").read(ctx) == pytest.approx(17.0)
    assert metric("device_wait_ms.images").read(ctx) == pytest.approx(3.0)
    assert metric("lm_iters_per_solve.images").read(ctx) == \
        pytest.approx(9.0)
    untraced = dict(ctx, timing=None, c1=None)
    for name in ESTIMATOR:
        assert metric(name).read(estimator_ctx("single")) is None, name
        assert metric(name).read(untraced) is None, name


def test_the_cell_loads_with_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, "tumrs_images.textured")
    assert cell.config["driver"] == "images"
    assert cell.config["reduced"] == ["cam_rate"]
    assert cell.traffic["cam_rate"] == cell.config["cam_rate"] == 10.0
    assert set(METRICS + ESTIMATOR) | {"captures_in_window", "capture_s",
                                       "k2_roofline", "k3_roofline"} == \
        set(cell.wanted(True))
    assert {"frames_per_s", "frame_latency_ms_p95", "setup_s"} == set(
        cell.wanted(False))
    single = json.loads((ROOT / "benchmark/configs/tumrs_single.json")
                        .read_text())
    for k in ("rig", "estimator", "warmup"):
        assert cell.config[k] == single[k]
