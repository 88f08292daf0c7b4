"""Parity of the PyTorch port's image front end with the JAX package on the
CPU: the plain version of the LK kernel K1, pyramidal tracking, CLAHE,
Shi-Tomasi detection, the camera models and the slot-identity tracker.
Inputs come from seeded numpy generators and go through both packages.

Tolerances: front-end values are float32, so positions agree to 1e-4 px
and other values to 1e-5 relative (the two packages sum the 441 patch
terms in different orders); the camera models run in float64 to 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.frontend import clahe as jclahe
from ctrlvio_tpu.frontend import corners as jcorners
from ctrlvio_tpu.frontend import klt as jklt
from ctrlvio_tpu.frontend.fused import FusedTracker as JFusedTracker
from ctrlvio_tpu.frontend.fused import rotation_flow as jrotation_flow
from ctrlvio_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
from ctrlvio_tpu.models import cameras as jcam
from ctrlvio_tpu.ops import so3np as jso3np
from ctrlvio_tpu.sim import render, synthetic
from ctrlvio_tpu_torch.frontend import clahe as tclahe
from ctrlvio_tpu_torch.frontend import corners as tcorners
from ctrlvio_tpu_torch.frontend import klt as tklt
from ctrlvio_tpu_torch.frontend.fused import FusedTracker as TFusedTracker
from ctrlvio_tpu_torch.frontend.fused import rotation_flow as trotation_flow
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig as TTrackerConfig
from ctrlvio_tpu_torch.models import cameras as tcam
from ctrlvio_tpu_torch.ops import lk
from tests.test_frontend import make_texture, shift_image
from tests.torch_parity import one_torch_thread  # noqa: F401

PX_TOL = 1e-4
REL_TOL = 1e-5


def f32(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def jf32(x):
    return jnp.asarray(np.asarray(x), jnp.float32)


def lk_pair(seed=9, dx=1.3, dy=0.8, n=40):
    img0 = make_texture(h=200, w=320, seed=seed)
    img1 = shift_image(img0, dx, dy)
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(20, 300, n), rng.uniform(20, 180, n)], 1)
    guess = pts + rng.normal(size=pts.shape)
    return img0, img1, pts.astype(np.float32), guess.astype(np.float32)


def test_lk_level_plain_matches_jax_track_level():
    img0, img1, pts, guess = lk_pair()
    cfg = jklt.KLTConfig()
    a, b = jf32(img0), jf32(img1)
    g_ref, e_ref = jax.vmap(lambda p, q: jklt._track_level(a, b, p, q, cfg))(
        jf32(pts), jf32(guess))
    calls = lk.lk_level_plain.calls
    g, e = tklt.track_level(f32(img0), f32(img1), f32(pts), f32(guess),
                            tklt.KLTConfig())
    assert lk.lk_level_plain.calls == calls + 1  # CPU tensors: plain version
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0,
                               atol=PX_TOL)
    e_ref = np.asarray(e_ref)
    np.testing.assert_allclose(e.numpy(), e_ref, rtol=0,
                               atol=REL_TOL * np.abs(e_ref).max())


def test_lk_level_border_clamps_index_not_weight():
    """Patches that hang over the image edge sample as `klt._bilinear`
    does: the corner index is clamped, the weight is not."""
    img0, img1, _, _ = lk_pair(seed=3)
    pts = np.array([[0.3, 5.0], [318.7, 199.2], [-2.5, 100.0],
                    [160.0, -1.25]], np.float32)
    guess = pts + np.float32(0.4)
    cfg = jklt.KLTConfig(iters=4)
    a, b = jf32(img0), jf32(img1)
    g_ref, e_ref = jax.vmap(lambda p, q: jklt._track_level(a, b, p, q, cfg))(
        jf32(pts), jf32(guess))
    g, e = lk.lk_level(f32(img0), f32(img1), f32(pts), f32(guess), iters=4)
    scale = max(np.abs(np.asarray(g_ref)).max(), 1.0)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0,
                               atol=REL_TOL * scale)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=REL_TOL,
                               atol=1e-6)


def test_lk_level_recovers_known_shift():
    img0 = make_texture(h=200, w=320, seed=4)
    dx, dy = 2.4, -1.7
    img1 = shift_image(img0, dx, dy)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(70, 250, 24), rng.uniform(50, 150, 24)], 1)
    out, eig = lk.lk_level(f32(img0), f32(img1), f32(pts), f32(pts), iters=12)
    med = np.median(out.numpy() - pts, axis=0)
    np.testing.assert_allclose(med, [dx, dy], atol=0.15)
    assert eig.min() > 0


def test_pyramid_matches_jax():
    img = make_texture(h=200, w=320, seed=2)
    ref = jklt.pyramid(jf32(img), 4)
    out = tklt.pyramid(f32(img), 4)
    assert len(ref) == len(out) == 4
    for r, o in zip(ref, out):
        assert tuple(r.shape) == tuple(o.shape)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=REL_TOL * 255)


@pytest.mark.parametrize("with_init", [False, True])
def test_track_matches_jax_track(with_init):
    img0 = make_texture(h=200, w=320, seed=9)
    img1 = shift_image(img0, 3.1, -2.2)
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(5, 315, 48), rng.uniform(5, 195, 48)], 1)
    pts = pts.astype(np.float32)
    init = (pts + np.array([2.5, -2.0], np.float32)) if with_init else None
    cfg = jklt.KLTConfig(pred_levels=3)
    pj0, pj1 = jklt.pyramid(jf32(img0), 4), jklt.pyramid(jf32(img1), 4)
    o_ref, ok_ref = jklt.track(pj0, pj1, jf32(pts), cfg, use_pallas=False,
                               init=None if init is None else jf32(init))
    pt0, pt1 = tklt.pyramid(f32(img0), 4), tklt.pyramid(f32(img1), 4)
    o, ok = tklt.track(pt0, pt1, f32(pts), tklt.KLTConfig(pred_levels=3),
                       init=None if init is None else f32(init))
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    assert ok_ref.sum() >= 30
    np.testing.assert_allclose(o.numpy()[ok_ref], np.asarray(o_ref)[ok_ref],
                               rtol=0, atol=PX_TOL)


def test_clahe_matches_jax():
    rng = np.random.default_rng(3)
    img = np.clip(make_texture(h=128, w=160, seed=3) * 0.6
                  + rng.normal(0, 8, (128, 160)) + 30, 0, 255)
    img = img.astype(np.uint8).astype(np.float32)
    ref = np.asarray(jclahe.clahe(jf32(img)))
    out = tclahe.clahe(f32(img)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=REL_TOL * 255)


def test_corners_detect_matches_jax():
    img = make_texture(h=200, w=320, seed=5)
    exclude = np.array([[50.0, 60.0], [120.0, 200.0], [-1.0, -1.0]],
                       np.float32)
    p_ref, v_ref = jcorners.detect(jf32(img), max_corners=40, min_dist=12,
                                   exclude_yx=jf32(exclude))
    p, v = tcorners.detect(f32(img), max_corners=40, min_dist=12,
                           exclude_yx=f32(exclude))
    v_ref = np.asarray(v_ref)
    np.testing.assert_array_equal(v.numpy(), v_ref)
    assert v_ref.sum() >= 20
    np.testing.assert_array_equal(p.numpy()[v_ref], np.asarray(p_ref)[v_ref])


CAMERAS = {
    "Pinhole": dict(fx=200.0, fy=198.0, cx=160.0, cy=120.0, k1=-0.2,
                    k2=0.05, p1=1e-3, p2=-5e-4),
    "Equidistant": dict(mu=739.1654756101043, mv=739.1438452683457,
                        u0=625.826167006398, v0=517.3370973594253,
                        k2=0.019327620961435945, k3=0.006784242994724914,
                        k4=-0.008658628531456217, k5=0.0051893686731546585),
    "Mei": dict(xi=0.9, fx=300.0, fy=300.0, cx=320.0, cy=240.0, k1=-0.1,
                k2=0.01, p1=1e-4, p2=1e-4),
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_project_lift_match_jax(name):
    rng = np.random.default_rng(11)
    X = np.concatenate([rng.normal(size=(64, 2)) * 0.5,
                        rng.uniform(1.0, 3.0, (64, 1))], 1)
    jc = getattr(jcam, name)(**CAMERAS[name])
    tc = getattr(tcam, name)(**CAMERAS[name])
    uv_ref = np.asarray(jc.project(jnp.asarray(X)))
    uv = tc.project(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(uv, uv_ref, rtol=1e-9, atol=1e-9)
    xy_ref = np.asarray(jc.lift(jnp.asarray(uv_ref)))
    xy = tc.lift(torch.as_tensor(uv_ref)).numpy()
    np.testing.assert_allclose(xy, xy_ref, rtol=1e-9, atol=1e-9)


H, W, FX, CX, CY = 128, 160, 100.0, 80.0, 64.0


@pytest.fixture(scope="module")
def sequence():
    sim = synthetic.generate(synthetic.SimConfig(
        duration=1.2, n_landmarks=500, seed=5, line_delay=2.3e-4,
        image_h=H, image_w=W, fx=FX, fy=FX, cx=CX, cy=CY))
    imgs = render.render_sequence(sim, H, W, FX, FX, CX, CY, seed=1,
                                  big_every=6)
    q = jso3np.quat_exp(np.asarray(sim.cfg.ext_rot, np.float64))
    return sim, imgs, jso3np.quat_to_matrix(q[None])[0]


def test_rotation_flow_matches_jax(sequence):
    sim, _, R = sequence
    t0, t1 = sim.frames[2].t_ns, sim.frames[3].t_ns
    bg = np.array([1e-3, -2e-3, 5e-4])
    np.testing.assert_array_equal(
        trotation_flow(sim.imu_t_ns, sim.gyro, t0, t1, R, bg=bg),
        jrotation_flow(sim.imu_t_ns, sim.gyro, t0, t1, R, bg=bg))


def test_fused_tracker_matches_jax(sequence):
    """The slot-identity tracker over rendered rolling-shutter frames with
    gyro-predicted flow: same ids, published points within 1e-3 px (after
    several frames of tracking the float32 differences compound)."""
    sim, imgs, R = sequence
    kw = dict(max_cnt=60, min_dist=10)
    jt = JFusedTracker(JTrackerConfig(**kw), jcam.Pinhole(FX, FX, CX, CY),
                       (H, W))
    tt = TFusedTracker(TTrackerConfig(**kw), tcam.Pinhole(FX, FX, CX, CY),
                       (H, W), device="cpu")
    prev = None
    n_tracked = 0
    for i, fr in enumerate(sim.frames):
        M = None if prev is None else jrotation_flow(
            sim.imu_t_ns, sim.gyro, prev, fr.t_ns, R)
        prev = fr.t_ns
        a = jt.step(fr.t_ns, imgs[i], R_rel=M)
        b = tt.step(fr.t_ns, imgs[i], R_rel=M)
        np.testing.assert_array_equal(b["ids"], a["ids"])
        np.testing.assert_allclose(b["uv"], a["uv"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(b["pts"], a["pts"], rtol=0, atol=1e-3 / FX)
        n_tracked += int((tt.track_cnt > 1).sum())
    assert n_tracked > 0


def test_frontend_entry_points_default_to_the_card():
    """No card and no explicit CPU request: the entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TFusedTracker(TTrackerConfig(), tcam.Pinhole(FX, FX, CX, CY), (H, W))
