"""Parity of the port's I/O with the JAX package (both pure Python and
numpy, on the CPU; every comparison is exact): the LZ4 codec on
`tests/test_lz4.py`'s vectors, the rosbag reader and converter on bags
written by `tests/test_rosbag.py`'s writers with each chunk compression,
the npz sequence format written by either package and read by the other,
the three-file YAML config (`tests/test_cli.py`'s, and a cam_tumrs.yaml
style Kannala-Brandt one), and the bag writer of `chip_smoke.py` through
both readers."""

from dataclasses import fields

import numpy as np
import pytest

from ctrlvio_tpu.io import config as jconfig
from ctrlvio_tpu.io import dataset as jdataset
from ctrlvio_tpu.io import lz4 as jlz4
from ctrlvio_tpu.io import rosbag as jrosbag
from ctrlvio_tpu.sim import synthetic as jsynthetic
from ctrlvio_tpu_torch.io import config as tconfig
from ctrlvio_tpu_torch.io import dataset as tdataset
from ctrlvio_tpu_torch.io import lz4 as tlz4
from ctrlvio_tpu_torch.io import rosbag as trosbag
from tests.test_cli import _write_config
from tests.test_rosbag import _image_msg, _imu_msg, write_bag_chunks

LZ4_DATA = [
    b"",
    b"short",
    b"a" * 1000,                                  # overlapping match (RLE)
    b"the quick brown fox " * 64,                 # periodic
    np.random.default_rng(0).bytes(5000),         # incompressible
    np.random.default_rng(1).bytes(200_000),      # multi-block frame
    (b"0123456789abcdef" * 5000)[:70_001],        # compressible multi-block
]


@pytest.mark.parametrize("data", LZ4_DATA,
                         ids=[f"data{i}" for i in range(len(LZ4_DATA))])
def test_lz4_matches_jax(data):
    for seed in (0, 1):
        assert tlz4.xxh32(data, seed=seed) == jlz4.xxh32(data, seed=seed)
    blk, frm = tlz4.compress_block(data), tlz4.compress_frame(data)
    assert blk == jlz4.compress_block(data)
    assert frm == jlz4.compress_frame(data)
    assert tlz4.decompress_block(blk) == jlz4.decompress_block(blk) == data
    assert tlz4.decompress_frame(frm) == jlz4.decompress_frame(frm) == data


def test_lz4_handcrafted_block_and_corruption_match_jax():
    blk = bytes([0x44]) + b"abcd" + bytes([0x04, 0x00]) + bytes([0x50]) \
        + b"xyzzy"
    assert tlz4.decompress_block(blk) == jlz4.decompress_block(blk)
    f = bytearray(tlz4.compress_frame(b"hello world, hello world, hello"))
    f[12] ^= 0xFF
    for mod in (tlz4, jlz4):
        with pytest.raises(ValueError):
            mod.decompress_frame(bytes(f))


def bag_messages(rng, n_chunks=3):
    """IMU at 200 Hz and a 24x32 mono8 image every 0.1 s, absolute
    stamps, split into chunks the way rosbag record splits them."""
    t0 = 1_500_000_000_000_000_000
    chunks = []
    for c in range(n_chunks):
        msgs = []
        for k in range(20):
            t = t0 + int(5e6) * (20 * c + k)
            msgs.append((0, "/imu0", "sensor_msgs/Imu", t,
                         _imu_msg(t, rng.normal(size=3),
                                  rng.normal(size=3) + [0, 0, 9.8])))
        ti = t0 + int(1e8) * c
        msgs.append((1, "/cam0/image_raw", "sensor_msgs/Image", ti,
                     _image_msg(ti, rng.integers(0, 255, (24, 32),
                                                 dtype=np.uint8))))
        msgs.sort(key=lambda m: m[3])
        chunks.append(msgs)
    return chunks


@pytest.mark.parametrize("compression", [b"none", b"bz2", b"lz4"])
def test_rosbag_matches_jax(tmp_path, compression):
    path = str(tmp_path / "seq.bag")
    write_bag_chunks(path, bag_messages(np.random.default_rng(0)),
                     compression=compression)
    got = list(trosbag.read_messages(path))
    ref = list(jrosbag.read_messages(path))
    assert len(got) == len(ref) == 63
    for (tt, tn, traw, tc), (jt, jn, jraw, jc) in zip(got, ref):
        assert (tt, tn, traw) == (jt, jn, jraw)
        assert (tc.topic, tc.msg_type, tc.md5sum) == \
            (jc.topic, jc.msg_type, jc.md5sum)
        if tt == "/imu0":
            a, b = trosbag.parse_imu(traw), jrosbag.parse_imu(jraw)
            assert a.t_ns == b.t_ns
            for k in ("gyro", "accel", "orientation"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        else:
            a, b = trosbag.parse_image(traw), jrosbag.parse_image(jraw)
            assert a.t_ns == b.t_ns
            np.testing.assert_array_equal(a.image, b.image)
    seq = trosbag.bag_to_sequence(path, "/imu0", "/cam0/image_raw",
                                  t_start=0.05, image_stride=2)
    seq_j = jrosbag.bag_to_sequence(path, "/imu0", "/cam0/image_raw",
                                    t_start=0.05, image_stride=2)
    for k in ("imu_t_ns", "gyro", "accel", "frame_t_ns", "images"):
        np.testing.assert_array_equal(getattr(seq, k), getattr(seq_j, k))
    assert seq.images.shape == (1, 24, 32)


def same_sequence(a, b):
    for k in ("imu_t_ns", "gyro", "accel", "frame_t_ns"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert (a.images is None) == (b.images is None)
    if a.images is not None:
        np.testing.assert_array_equal(a.images, b.images)
    assert len(a.feat_ids) == len(b.feat_ids)
    for k in ("feat_ids", "feat_pts", "feat_rows"):
        for x, y in zip(getattr(a, k), getattr(b, k)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sequence_npz_interchanges(tmp_path, writer):
    """A feature npz and a raw-image npz written by one package load equal
    in both."""
    sim = jsynthetic.generate(jsynthetic.SimConfig(duration=1.5,
                                                   n_landmarks=50, seed=2))
    w_ds, w_bag = ((jdataset, jrosbag) if writer == "jax"
                   else (tdataset, trosbag))
    feat = str(tmp_path / "feat.npz")
    w_ds.save_feature_sequence(feat, w_ds.from_sim(sim))
    same_sequence(tdataset.load_sequence(feat), jdataset.load_sequence(feat))
    same_sequence(tdataset.load_sequence(feat), jdataset.from_sim(sim))
    bag = str(tmp_path / "seq.bag")
    write_bag_chunks(bag, bag_messages(np.random.default_rng(1), 2))
    raw = str(tmp_path / "raw.npz")
    w_bag.bag_to_npz(bag, raw)
    a, b = tdataset.load_sequence(raw), jdataset.load_sequence(raw)
    assert a.images.shape == (2, 24, 32)
    same_sequence(a, b)


def write_tumrs_config(tmp_path):
    """A cam_tumrs.yaml style three-file config: OpenCV FileStorage camera
    with the Kannala-Brandt model and the tracker's knobs, an
    !!opencv-matrix extrinsic in the main file."""
    (tmp_path / "cam.yaml").write_text("""%YAML:1.0
---
model_type: KANNALA_BRANDT
camera_name: camera
image_width: 1280
image_height: 1024
projection_parameters:
   k2: 0.019327620961435945
   k3: 0.006784242994724914
   k4: -0.008658628531456217
   k5: 0.0051893686731546585
   mu: 739.1654756101043
   mv: 739.1438452683457
   u0: 625.826167006398
   v0: 517.3370973594253
max_cnt: 150
min_dist: 25
freq: 10
F_threshold: 1.0
equalize: 1
reject_wf: 0
""")
    (tmp_path / "imu.yaml").write_text("%YAML:1.0\n---\ngravity_mag: 9.81\n")
    (tmp_path / "main.yaml").write_text(f"""%YAML:1.0
---
config_path: {tmp_path}/
imu_yaml: /imu.yaml
camera_yaml: /cam.yaml
knot_distance: 0.05
image_weight: 800
gyroscope_noise_density: 0.0002
gyroscope_random_walk: 2.0e-06
accelerometer_noise_density: 0.0028
accelerometer_random_walk: 0.00086
fix_ld: 0
ld_upper: 3.5e-5
T_CtoI: !!opencv-matrix
   rows: 4
   cols: 4
   dt: d
   data: [ -0.0138, -0.9993, 0.0347, 0.0215,
           0.9998, -0.0140, -0.0050, -0.0608,
           0.0055, 0.0346, 0.9994, -0.0117,
           0.0, 0.0, 0.0, 1.0 ]
""")
    return str(tmp_path / "main.yaml")


@pytest.mark.parametrize("which", ["cli_pinhole", "tumrs_kannala_brandt"])
def test_load_config_matches_jax(tmp_path, which):
    main = (_write_config(tmp_path) if which == "cli_pinhole"
            else write_tumrs_config(tmp_path))
    cfg_t, cam_t, q_t, p_t, raw_t = tconfig.load_config(main)
    cfg_j, cam_j, q_j, p_j, raw_j = jconfig.load_config(main)
    for f in fields(cfg_j):
        if f.name == "dtype" or not hasattr(cfg_t, f.name):
            continue
        a, b = getattr(cfg_t, f.name), getattr(cfg_j, f.name)
        assert (tuple(a) if f.name == "window_config" else a) == \
            (tuple(b) if f.name == "window_config" else b), f.name
    assert type(cam_t).__name__ == type(cam_j).__name__
    assert vars(cam_t) == vars(cam_j)
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(p_t, p_j)
    assert raw_t == raw_j
    if which == "tumrs_kannala_brandt":
        assert cfg_t.gravity_mag == 9.81 and cfg_t.fix_ld is False
        assert raw_t["_camera_dict"]["max_cnt"] == 150


def test_chip_smoke_bag_writer_reads_back(tmp_path):
    """The rosbag writer of `chip_smoke.py`'s cli phase (uncompressed
    chunks, raw mono8 images, absolute stamps) through both readers."""
    import chip_smoke

    rng = np.random.default_rng(2)
    base = chip_smoke.CLI_T0_S * 1_000_000_000
    imu_t = base + np.arange(30, dtype=np.int64) * 5_000_000
    gyro, accel = rng.normal(size=(30, 3)), rng.normal(size=(30, 3))
    imgs = rng.integers(0, 255, (3, 16, 24), dtype=np.uint8)
    msgs = [(0, "/imu0", "sensor_msgs/Imu", int(t),
             chip_smoke.imu_message(int(t), g, a))
            for t, g, a in zip(imu_t, gyro, accel)]
    msgs += [(1, "/cam0/image_raw", "sensor_msgs/Image", base + k * 50_000_000,
              chip_smoke.image_message(base + k * 50_000_000, imgs[k]))
             for k in range(3)]
    msgs.sort(key=lambda m: m[3])
    path = str(tmp_path / "w.bag")
    chip_smoke.write_bag(path, [msgs[:10], msgs[10:]])
    for mod in (trosbag, jrosbag):
        seq = mod.bag_to_sequence(path, "/imu0", "/cam0/image_raw")
        np.testing.assert_array_equal(seq.imu_t_ns, imu_t)
        np.testing.assert_array_equal(seq.gyro, gyro)
        np.testing.assert_array_equal(seq.accel, accel)
        np.testing.assert_array_equal(seq.images, imgs)
        assert seq.frame_t_ns[0] == base
