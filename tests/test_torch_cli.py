"""The port's command line, `python -m ctrlvio_tpu_torch` (on the CPU with
`--device cpu`), against the JAX package's `python -m ctrlvio_tpu`:
`convert` writes the same npz from the same rosbag; `viz` writes the HTML
replay (and the PNG); `run` raises without a card unless the CPU is asked
for, and on the CPU turns `tests/test_cli.py`'s config and a feature
sequence into a TUM trajectory with its stats line. Slow: the same run
through both packages gives the same TUM file (positions within 2e-6 m,
twice the file's printed resolution, quaternions within 2e-9; both solve
in float64 with the synchronous pipeline), and the port of
`test_lz4_bag_convert_run_roundtrip` (an lz4 rosbag of raw rolling-shutter
images through `convert` and `run` with the in-process front end)."""

import json

import numpy as np
import pytest
import torch

from ctrlvio_tpu.__main__ import main as jmain
from ctrlvio_tpu_torch.__main__ import main
from ctrlvio_tpu_torch.io import dataset
from ctrlvio_tpu_torch.sim import synthetic
from tests.test_cli import _write_config
from tests.test_rosbag import _image_msg, _imu_msg, write_bag, \
    write_bag_chunks
from tests.torch_parity import one_torch_thread  # noqa: F401


def feature_sequence(tmp_path, duration=3.0):
    sim = synthetic.generate(synthetic.SimConfig(
        duration=duration, n_landmarks=250, seed=11, ext_rot=(0.0, 0.0, 0.0),
        ext_pos=(0.007, -0.057, -0.042)))
    path = tmp_path / "seq.npz"
    dataset.save_feature_sequence(str(path), dataset.from_sim(sim))
    return sim, str(path)


def run_stats(err: str) -> dict:
    line = [ln for ln in err.splitlines() if ln.startswith("[run] stats ")]
    assert len(line) == 1
    return json.loads(line[0][len("[run] stats "):])


def check_tum(path, n_min):
    data = np.loadtxt(path)
    assert data.shape[0] > n_min and data.shape[1] == 8
    assert np.all(np.diff(data[:, 0]) > 0)
    assert np.allclose(np.linalg.norm(data[:, 4:8], axis=1), 1.0, atol=1e-6)
    return data


def test_convert_cli_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    msgs = []
    for k in range(40):
        t = int(1e9 + k * 5_000_000)
        msgs.append((0, "/imu", "sensor_msgs/Imu", t,
                     _imu_msg(t, rng.normal(0, 1, 3), rng.normal(0, 1, 3))))
    for k in range(4):
        t = int(1e9 + k * 50_000_000)
        img = rng.integers(0, 255, (24, 32), dtype=np.uint8)
        msgs.append((1, "/cam0/image_raw", "sensor_msgs/Image", t,
                     _image_msg(t, img)))
    msgs.sort(key=lambda m: m[3])
    bag = tmp_path / "t.bag"
    write_bag(str(bag), msgs)
    flags = ["--imu-topic", "/imu", "--image-topic", "/cam0/image_raw",
             "--t-end", "0.16", "--stride", "2"]
    main(["convert", str(bag), str(tmp_path / "t.npz"), *flags])
    jmain(["convert", str(bag), str(tmp_path / "j.npz"), *flags])
    a, b = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], k)
    assert a["images"].shape == (2, 24, 32) and len(a["imu_t_ns"]) == 33


def test_viz_cli(tmp_path):
    from ctrlvio_tpu_torch.utils.export import export_tum

    t = np.arange(50) * 0.1
    p = np.stack([np.cos(t), np.sin(t), 0.1 * t], axis=1)
    f = tmp_path / "a.tum"
    export_tum(str(f), (t * 1e9).astype(np.int64), np.tile([1.0, 0, 0, 0],
                                                           (50, 1)), p)
    out = tmp_path / "a.html"
    main(["viz", str(f), "--gt", str(f), "-o", str(out),
          "--png", str(tmp_path / "a.png")])
    s = out.read_text()
    assert s.startswith("<!DOCTYPE html>") and '"est": [[' in s
    assert (tmp_path / "a.png").read_bytes()[1:4] == b"PNG"
    main(["viz", str(f)])  # default output beside the trajectory
    assert (tmp_path / "a.html").exists()


def test_run_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    _, seq = feature_sequence(tmp_path, duration=1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["run", _write_config(tmp_path), seq])


def test_run_cli_on_cpu(tmp_path, capsys):
    """Visual bootstrap and the synchronous f64 solves on the CPU: a TUM
    trajectory and a stats line that account for every frame."""
    _, seq = feature_sequence(tmp_path)
    out = tmp_path / "traj.tum"
    main(["run", _write_config(tmp_path), seq, "--out", str(out),
          "--device", "cpu"])
    check_tum(out, 50)
    st = run_stats(capsys.readouterr().err)
    c = st["counts"]
    assert st["device"] == "cpu" and st["stream"] is False
    assert c["bootstrap_visual"] == 1 and "megastep" not in c
    assert st["poses"] == st["frames"] - st["init_frame"] == \
        c["sync_solve"] + 1
    assert st["k1_track_launches"] == st["plain_lk_track_calls"] == 0
    assert 2e-5 < st["line_delay_s"] < 3.5e-5


@pytest.mark.slow
def test_run_cli_matches_jax(tmp_path):
    _, seq = feature_sequence(tmp_path)
    cfg = _write_config(tmp_path)
    main(["run", cfg, seq, "--out", str(tmp_path / "t.tum"),
          "--device", "cpu"])
    jmain(["run", cfg, seq, "--out", str(tmp_path / "j.tum")])
    a, b = check_tum(tmp_path / "t.tum", 50), check_tum(tmp_path / "j.tum", 50)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], rtol=0, atol=2e-6)
    np.testing.assert_allclose(a[:, 4:], b[:, 4:], rtol=0, atol=2e-9)


@pytest.mark.slow
def test_lz4_bag_convert_run_roundtrip(tmp_path, capsys):
    """The reference's full operating mode through the port on the CPU: an
    lz4-compressed rosbag of raw rolling-shutter images + IMU -> `convert`
    -> `run` (the fused tracker in-process, the plain LK version on CPU
    tensors) -> TUM trajectory."""
    from ctrlvio_tpu_torch.sim import render

    H, W, FX = 256, 320, 200.0
    sim = synthetic.generate(synthetic.SimConfig(
        duration=5.0, n_landmarks=500, seed=5, line_delay=1.15e-4,
        rot_excite=0.05, pos_excite=0.04,
        image_h=H, image_w=W, fx=FX, fy=FX, cx=W / 2, cy=H / 2,
        ext_rot=(0.0, 0.0, 0.0), ext_pos=(0.007, -0.057, -0.042)))
    imgs = render.render_sequence(sim, H, W, FX, FX, W / 2, H / 2, seed=1,
                                  big_every=6, texture=6.0)
    t0 = 1_500_000_000_000_000_000
    msgs = [(0, "/imu0", "sensor_msgs/Imu", t0 + int(sim.imu_t_ns[k]),
             _imu_msg(t0 + int(sim.imu_t_ns[k]), sim.gyro[k], sim.accel[k]))
            for k in range(len(sim.imu_t_ns))]
    msgs += [(1, "/cam0/image_raw", "sensor_msgs/Image",
              t0 + int(fr.t_ns), _image_msg(t0 + int(fr.t_ns), imgs[i]))
             for i, fr in enumerate(sim.frames)]
    msgs.sort(key=lambda m: m[3])
    n = len(msgs)
    bag = tmp_path / "seq.bag"
    write_bag_chunks(str(bag), [msgs[: n // 3], msgs[n // 3 : 2 * n // 3],
                                msgs[2 * n // 3 :]], compression=b"lz4")

    npz = tmp_path / "seq.npz"
    main(["convert", str(bag), str(npz)])
    assert dataset.load_sequence(str(npz)).images.shape == \
        (len(sim.frames), H, W)
    cfg = _write_config(tmp_path, ld_upper=2e-4)
    (tmp_path / "cam.yaml").write_text(f"""%YAML:1.0
---
model_type: PINHOLE
image_width: {W}
image_height: {H}
projection_parameters:
   fx: {FX}
   fy: {FX}
   cx: {W / 2}
   cy: {H / 2}
max_cnt: 110
min_dist: 12
freq: 11
""")
    out = tmp_path / "traj.tum"
    capsys.readouterr()
    main(["run", cfg, str(npz), "--out", str(out), "--bootstrap", "visual",
          "--device", "cpu"])
    check_tum(out, 20)
    st = run_stats(capsys.readouterr().err)
    # one plain forward-backward track a frame (CPU tensors), no launch
    assert st["plain_lk_track_calls"] == len(sim.frames)
    assert st["k1_track_launches"] == st["k1_level_launches"] == 0
