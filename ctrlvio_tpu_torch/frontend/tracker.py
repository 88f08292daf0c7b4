"""Feature tracker: KLT pipeline with id lifecycle and refill (PyTorch port
of `ctrlvio_tpu/frontend/tracker.py`).

≙ FeatureTracker + FeatureTrackerNode of the reference's visual front end
(`feature_tracker.{h,cpp}`, `feature_tracker_node.cpp`): CLAHE ->
pyramidal LK over every pyramid level with the forward-backward check
(kernel K1 on the card, one launch a frame) -> optional epipolar F-RANSAC
gate -> Shi-Tomasi refill of free slots to max_cnt -> undistortion to the
normalized plane -> per-feature velocity; publishes (id, normalized xy,
pixel uv, velocity) per frame at a controlled rate.

This is the classic multi-dispatch tracker: each stage runs on the
tracker's device and returns to the host, where the id bookkeeping and the
fill loop are numpy. `frontend/fused.py::FusedTracker` is the
single-dispatch front end.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ctrlvio_tpu_torch.utils.device import resolve_device
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls

from . import clahe as clahe_mod
from . import corners, klt
from .fransac import reject_with_f
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


class FeatureTracker:
    """Feed images with `process(t_ns, img)`; it returns the published
    feature dict (ids, pts (normalized), uv, vel, rows, t_ns), or None on a
    rate-gated frame."""

    def __init__(self, cfg: TrackerConfig, camera, image_shape,
                 device="cuda"):
        self.device = resolve_device(device)
        pin_f32_matmuls()
        self.cfg = cfg
        self.camera = camera
        self.H, self.W = image_shape
        N = cfg.max_cnt
        self.pts = np.full((N, 2), -1.0, dtype=np.float64)   # pixel x,y
        self.ids = np.full((N,), -1, dtype=np.int64)
        self.track_cnt = np.zeros((N,), dtype=np.int64)
        self.prev_norm = np.zeros((N, 2))
        self.prev_ids = np.zeros((0,), dtype=np.int64)
        self.prev_t_ns: Optional[int] = None
        self.next_id = 0
        self.prev_pyr = None
        self._pub_count = 0
        self._first_t_ns = None
        self._norm_full = None

    def _preprocess(self, img):
        img = torch.as_tensor(img, device=self.device).to(torch.float32)
        if self.cfg.use_clahe:
            img = clahe_mod.clahe(img)
        return klt.pyramid(img, self.cfg.klt.levels)

    # ------------------------------------------------------------------
    def process(self, t_ns: int, img):
        """Feed one image (numpy or tensor). Returns None (rate-gated
        frame) or the feature dict of a published frame."""
        # stream-discontinuity restart (≙ `feature_tracker_node.cpp:65-76`:
        # >1 s gap or backwards time -> reset all tracks)
        if self.prev_t_ns is not None and (
                t_ns < self.prev_t_ns or t_ns - self.prev_t_ns > 1_000_000_000):
            self.restart()

        pyr = self._preprocess(img)

        live = self.ids >= 0
        if self.prev_pyr is not None and live.any():
            pts_in = np.where(live[:, None], self.pts, 0.0)
            new_pts, ok = klt.track(
                self.prev_pyr, pyr,
                torch.as_tensor(pts_in, dtype=torch.float32,
                                device=self.device), self.cfg.klt)
            new_pts = new_pts.cpu().numpy().astype(np.float64)
            ok = ok.cpu().numpy() & live
            self.pts = np.where(ok[:, None], new_pts, -1.0)
            self.ids = np.where(ok, self.ids, -1)
            self.track_cnt = np.where(ok, self.track_cnt + 1, 0)
        self.prev_pyr = pyr

        # publish-rate gate (≙ `feature_tracker_node.cpp:80-93`)
        if self._first_t_ns is None:
            self._first_t_ns = t_ns
        elapsed = (t_ns - self._first_t_ns) * 1e-9
        if elapsed > 0 and self._pub_count / elapsed > self.cfg.freq:
            return None
        self._pub_count += 1
        if self.cfg.reject_wf:
            self._reject_with_f()
        self._refill(pyr)
        return self._emit(t_ns)

    # ------------------------------------------------------------------
    def _reject_with_f(self):
        """Epipolar RANSAC outlier gate on surviving tracks (≙ rejectWithF,
        `feature_tracker.cpp:201-235`; runs only on published frames)."""
        live = self.ids >= 0
        tracked = live & (self.track_cnt > 1)  # has a previous observation
        if tracked.sum() < 8 or self._norm_full is None:
            return
        cur_norm = self._lift_full()
        idx = np.nonzero(tracked)[0]
        mask = reject_with_f(self._norm_full[idx], cur_norm[idx],
                             thresh_px=self.cfg.f_threshold,
                             seed=int(self._pub_count))
        drop = idx[~mask]
        self.pts[drop] = -1.0
        self.ids[drop] = -1
        self.track_cnt[drop] = 0

    def _lift_full(self) -> np.ndarray:
        """Normalized coords of ALL slots, in float64 (dead slots give
        values that are never read)."""
        uv = np.where(self.ids[:, None] >= 0, self.pts, 0.0)
        return self.camera.lift(torch.as_tensor(
            uv, dtype=torch.float64, device=self.device)).cpu().numpy()

    # ------------------------------------------------------------------
    def restart(self):
        """Drop all state (discontinuity recovery)."""
        self.pts[:] = -1.0
        self.ids[:] = -1
        self.track_cnt[:] = 0
        self.prev_pyr = None
        self.prev_t_ns = None
        self._pub_count = 0
        self._first_t_ns = None
        self._norm_full = None

    # ------------------------------------------------------------------
    def _refill(self, pyr):
        """Detect new corners in free slots, min-dist away from live tracks
        (the host fill loop: the k-th accepted candidate goes to the k-th
        free slot)."""
        n_live = int((self.ids >= 0).sum())
        if n_live >= self.cfg.max_cnt:
            return
        exclude = np.full((self.cfg.max_cnt, 2), -1.0)
        live = self.ids >= 0
        exclude[: live.sum()] = self.pts[live][:, ::-1]  # (y, x)
        cand, cand_ok = corners.detect(
            pyr[0], max_corners=self.cfg.max_cnt, min_dist=self.cfg.min_dist,
            exclude_yx=torch.as_tensor(exclude, dtype=torch.float32,
                                       device=self.device))
        cand = cand.cpu().numpy().astype(np.float64)
        cand_ok = cand_ok.cpu().numpy()
        free = np.nonzero(~live)[0]
        k = 0
        for ci in range(len(cand)):
            if k >= len(free) or not cand_ok[ci]:
                continue
            slot = free[k]
            self.pts[slot] = cand[ci]
            self.ids[slot] = self.next_id
            self.track_cnt[slot] = 1
            self.next_id += 1
            k += 1

    # ------------------------------------------------------------------
    def _emit(self, t_ns: int):
        live = self.ids >= 0
        norm_full = self._lift_full()
        uv = self.pts[live]
        ids = self.ids[live]
        norm = norm_full[live]
        # velocities in the normalized plane, matched by id
        # (≙ undistortedPoints velocity)
        vel = np.zeros_like(norm)
        if self.prev_t_ns is not None:
            dt = (t_ns - self.prev_t_ns) * 1e-9
            if dt > 0:
                prev_map = {i: self.prev_norm[k]
                            for k, i in enumerate(self.prev_ids)}
                for k, i in enumerate(ids):
                    if i in prev_map:
                        vel[k] = (norm[k] - prev_map[i]) / dt
        self.prev_t_ns = t_ns
        self.prev_ids = ids.copy()
        self.prev_norm = norm.copy()
        self._norm_full = norm_full
        return dict(t_ns=t_ns, ids=ids, pts=norm, uv=uv, vel=vel,
                    rows=uv[:, 1])
