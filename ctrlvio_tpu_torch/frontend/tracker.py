"""The front end's settings (PyTorch port of the `TrackerConfig` of
`ctrlvio_tpu/frontend/tracker.py`; ≙ the tracker block of the reference's
`cam_tumrs.yaml`). The tracker itself is `frontend/fused.py::FusedTracker`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .klt import KLTConfig


@dataclass
class TrackerConfig:
    max_cnt: int = 150          # ≙ MAX_CNT (`cam_tumrs.yaml:23`)
    min_dist: int = 25          # ≙ MIN_DIST
    use_clahe: bool = True      # ≙ EQUALIZE
    fb_check: bool = True       # ≙ flow_back
    freq: float = 10.0          # publish rate (`cam_tumrs.yaml:25`)
    reject_wf: bool = False     # ≙ reject_wf: the epipolar F-RANSAC gate
    f_threshold: float = 1.0    # ≙ F_THRESHOLD, virtual pixels
    klt: KLTConfig = field(default_factory=KLTConfig)
