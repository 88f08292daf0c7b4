"""The port's native feature table (`estimator/native.py` over its own copy
of `csrc/feature_table.cpp`) against the port's python `FeatureTable` with
`packing.pack_image_factors`, and against the JAX package's native table,
on the same frames: a sliding window over a synthetic sequence with both
slides (keyframe: marginalize the oldest; otherwise drop the second
newest), triangulation from ground-truth camera poses, packing, depth
write-back by slot and by feature id, and failure removal. Integer fields
and flags are compared exactly. Against the python table, points to 1e-6
and triangulated inverse depths to 2e-3 relative (an SVD in each
language); against the JAX package's library (the same C++ built with
other flags), floats to 1e-6 relative. Also: a build that fails raises,
and `CtrlVIO(use_native=True)` fails with it."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import native as jnative
from ctrlvio_tpu_torch.estimator import native, odometry, packing
from ctrlvio_tpu_torch.estimator.features import FeatureTable
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig
from tests.torch_parity import one_torch_thread  # noqa: F401

CFG = WindowConfig(KW=40, NB=11, LM=128, OBS=1024, MIMU=256)
N_FRAMES = 30


@pytest.fixture(scope="module")
def sim():
    # slow motion: some frames add too little parallax to be keyframes
    return synthetic.generate(synthetic.SimConfig(
        duration=3.0, n_landmarks=400, seed=5, speed=0.2))


def camera_poses(sim, kf_t_ns):
    q_CtoI = so3np.quat_exp(np.array(sim.cfg.ext_rot))
    qs, ps = [], []
    for t in kf_t_ns:
        q, p = sim.pose_at(t * 1e-9)
        qs.append(so3np.quat_mul(q[None], q_CtoI[None])[0])
        ps.append(p + so3np.quat_to_matrix(q[None])[0] @ sim.cfg.ext_pos)
    return np.stack(qs), np.stack(ps)


def same_factors(a, b, n, float_rtol):
    for name in ("i0_i", "i0_j", "lm_idx", "valid", "marg_drop"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    for name in ("f_i", "row_i", "pt_i", "f_j", "row_j", "pt_j"):
        x, y = getattr(a, name)[:n], getattr(b, name)[:n]
        np.testing.assert_allclose(y, x, rtol=float_rtol, atol=1e-6,
                                   err_msg=name)


def test_native_table_matches_python_and_jax(sim):
    """Frame by frame, through the window's fill and 16 slides."""
    nb = CFG.NB
    dt_ns = int(round(CFG.dt * 1e9))
    py = FeatureTable(nb - 1)
    nat = native.NativeFeatureTable(nb - 1)
    ref = jnative.NativeFeatureTable(nb - 1)
    assert jnative.available()
    kf_t = np.zeros(nb, np.int64)
    n_slides = {True: 0, False: 0}
    rng = np.random.default_rng(0)
    for i, fr in enumerate(sim.frames[:N_FRAMES]):
        slot = min(i, nb - 1)
        is_kf = [t.add_frame(slot, fr.ids, fr.pts, fr.rows)
                 for t in (py, nat, ref)]
        assert is_kf[1] == is_kf[0] == is_kf[2], i
        assert nat.n_tracks == len(py.tracks) == ref.n_tracks
        assert nat.last_track_num == py.last_track_num == ref.last_track_num
        kf_t[slot] = fr.t_ns
        if i < nb - 1:
            continue

        cam_q, cam_p = camera_poses(sim, kf_t)
        for t in (py, nat, ref):
            t.triangulate(cam_q, cam_p)
        w0 = int(kf_t[0] // dt_ns)
        img_p, dinv_p, cands = packing.pack_image_factors(
            list(py.tracks.values()), kf_t, CFG.dt, w0, CFG, np.float32)
        img_n, dinv_n, n_n = nat.pack_image_factors(kf_t, CFG.dt, w0, CFG)
        img_r, dinv_r, n_r = ref.pack_image_factors(kf_t, CFG.dt, w0, CFG)
        assert n_n == n_r == len(cands) > 20
        n_obs = int(img_p.valid.sum())
        assert n_obs > 50
        same_factors(img_p, img_n, n_obs, 1e-6)
        same_factors(img_r, img_n, CFG.OBS, 1e-6)
        np.testing.assert_allclose(dinv_n[:n_n], dinv_p[:n_n], rtol=2e-3)
        np.testing.assert_allclose(dinv_n, dinv_r, rtol=1e-6)
        fids = nat.slot_fids(CFG.LM)
        np.testing.assert_array_equal(fids, py.slot_fids(CFG.LM))
        np.testing.assert_array_equal(fids, ref.slot_fids(CFG.LM))

        # a solve's write-back: by slot on even frames, by feature id on
        # odd ones; a few depths fail (negative) and are removed
        dinv = (dinv_p * rng.uniform(0.9, 1.1, CFG.LM)).astype(np.float32)
        dinv[rng.integers(0, n_n, 2)] = -0.1
        if i % 2 == 0:
            py.set_depths(dinv.astype(np.float64), cands)
            nat.set_depths(dinv)
            ref.set_depths(dinv)
        else:
            for t in (py, nat, ref):
                t.set_depths_by_id(fids, dinv[: len(fids)])
        if is_kf[0]:
            R = so3np.quat_to_matrix(cam_q)
            for t in (py, nat, ref):
                t.slide_old(R[0], cam_p[0], R[1], cam_p[1])
            kf_t[:-1] = kf_t[1:]
        else:
            for t in (py, nat, ref):
                t.remove_failures()
                t.slide_second_new(nb - 1)
            kf_t[nb - 2] = kf_t[nb - 1]
        n_slides[bool(is_kf[0])] += 1
        assert nat.n_tracks == len(py.tracks) == ref.n_tracks
    assert n_slides[True] >= 5 and n_slides[False] >= 2, n_slides


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "feature_table.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="building feature_table.cpp"):
        native.build()
    # the estimator with the native table does not fall back to python
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building feature_table.cpp"):
        odometry.CtrlVIO(odometry.VIOConfig(use_native=True),
                         np.array([1.0, 0, 0, 0]), np.zeros(3), device="cpu")
    vio = odometry.CtrlVIO(odometry.VIOConfig(use_native=False),
                           np.array([1.0, 0, 0, 0]), np.zeros(3),
                           device="cpu")
    assert isinstance(vio.features, FeatureTable)


def test_library_builds_into_build_host():
    path = native.build()
    assert path.parent.name == "host" and path.parent.parent.name == "build"
    assert path.name.startswith("libfeature_table-") and path.exists()
    assert isinstance(odometry.CtrlVIO(odometry.VIOConfig(),
                                       np.array([1.0, 0, 0, 0]), np.zeros(3),
                                       device="cpu").features,
                      native.NativeFeatureTable)
    assert torch.get_num_threads() == 1
