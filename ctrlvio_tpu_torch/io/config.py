"""Configuration loading: the reference's three-file YAML hierarchy (the
port's counterpart of `ctrlvio_tpu/io/config.py`, returning the port's
`VIOConfig` and camera models).

≙ `config/ct_odometry_tumrs.yaml` + `config/tumrs/cam_tumrs.yaml` (OpenCV
FileStorage format) + `config/tumrs/imu_tumrs.yaml`, loaded via yaml-cpp /
cv::FileStorage in the reference (`odometry_manager.cpp:30-95`,
`yaml_utils.h:28-63`). A single loader builds VIOConfig + camera +
extrinsics from the same file layout, so a reference user's configs port
directly.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Tuple

import numpy as np
import yaml

from ctrlvio_tpu_torch.estimator.odometry import VIOConfig
from ctrlvio_tpu_torch.estimator.vio_init import _R_to_quat
from ctrlvio_tpu_torch.models import cameras


def _load_yaml(path: str) -> dict:
    """Tolerant loader: accepts plain YAML and OpenCV FileStorage files
    (leading '%YAML:1.0' directive and '!!opencv' tags)."""
    with open(path) as f:
        txt = f.read()
    lines = [l for l in txt.splitlines()
             if not l.startswith("%YAML") and l.strip() != "---"]
    txt = "\n".join(lines).replace("!!opencv-matrix", "")
    return yaml.safe_load(txt)


def load_config(main_yaml: str) -> Tuple[VIOConfig, object, np.ndarray, np.ndarray, dict]:
    """Load the main odometry YAML (reference schema).

    Returns (vio_config, camera, q_CtoI, p_CinI, raw_dict).
    """
    d = _load_yaml(main_yaml)
    base = os.path.dirname(os.path.abspath(main_yaml))
    config_path = d.get("config_path", base + "/")

    cfg = VIOConfig()
    cfg = replace(
        cfg,
        knot_dt=float(d.get("knot_distance", 0.05)),
        image_weight=float(d.get("image_weight", 800.0)),
        sigma_gyro=float(d.get("gyroscope_noise_density", cfg.sigma_gyro)),
        sigma_bg=float(d.get("gyroscope_random_walk", cfg.sigma_bg)),
        sigma_accel=float(d.get("accelerometer_noise_density", cfg.sigma_accel)),
        sigma_ba=float(d.get("accelerometer_random_walk", cfg.sigma_ba)),
        ld_init=float(d.get("ld_init", 0.0)),
        fix_ld=bool(d.get("fix_ld", False)),
        ld_lower=float(d.get("ld_lower", 0.0)),
        ld_upper=float(d.get("ld_upper", 3.5e-5)),
    )

    # IMU yaml (gravity magnitude)
    imu_yaml = d.get("imu_yaml")
    if imu_yaml:
        imu_d = _load_yaml(os.path.join(config_path, imu_yaml.lstrip("/")))
        cfg = replace(cfg, gravity_mag=float(imu_d.get("gravity_mag", cfg.gravity_mag)))

    # camera yaml
    cam = None
    cam_yaml = d.get("camera_yaml") or d.get("cam_yaml")
    if cam_yaml:
        cam_d = _load_yaml(os.path.join(config_path, cam_yaml.lstrip("/")))
        cam = cameras.from_yaml_dict(cam_d)
        d["_camera_dict"] = cam_d  # tracker knobs (max_cnt, freq, ...)

    # camera-IMU extrinsics (≙ ParamManager/ExtrinsicParam):
    # main yaml carries T_CtoI / extrinsic rotation+translation
    q_CtoI = np.array([1.0, 0, 0, 0])
    p_CinI = np.zeros(3)
    if "T_CtoI" in d:
        T = np.asarray(d["T_CtoI"]["data"], dtype=np.float64).reshape(4, 4)
        q_CtoI = _R_to_quat(T[:3, :3])
        p_CinI = T[:3, 3]
    return cfg, cam, q_CtoI, p_CinI, d
