"""Sliding-window feature table: track lifecycle, parallax keyframe decision,
window slide, depth bookkeeping (the port's numpy copy of
`ctrlvio_tpu/estimator/features.py`).

≙ FeatureManager (`visual_odometry/feature_manager.{h,cpp}`)
+ the window slide paths of VisualOdometry
(`visual_odometry.cpp:195-308`). Host-side: O(150 tracks x 11 frames) per
frame — bookkeeping, not compute.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ctrlvio_tpu_torch.ops import so3np

from .packing import FeatureTrack

INIT_DEPTH = 5.0  # ≙ parameters.cpp INIT_DEPTH


class FeatureTable:
    def __init__(self, window_size: int = 10, min_parallax: float = 10.0 / 460.0):
        self.window_size = window_size  # WINDOW_SIZE (NB-1)
        self.min_parallax = min_parallax
        self.tracks: Dict[int, FeatureTrack] = {}
        self.last_track_num = 0

    # ------------------------------------------------------------------
    def add_frame(self, frame_count: int, ids, pts, rows) -> bool:
        """Insert observations of frame `frame_count`; return True if the
        frame is a keyframe (-> MARGIN_OLD), ≙ addFeatureCheckParallax
        (`feature_manager.cpp:28-87`)."""
        self.last_track_num = 0
        for k, fid in enumerate(ids):
            fid = int(fid)
            tr = self.tracks.get(fid)
            if tr is None:
                tr = FeatureTrack(fid, frame_count)
                self.tracks[fid] = tr
            elif tr.end_frame != frame_count - 1:
                # non-contiguous re-observation: treat as a new track id slot
                # (the reference's tracker ids never resume, KLT restarts them)
                continue
            else:
                self.last_track_num += 1
            tr.pts.append(np.asarray(pts[k], dtype=np.float64))
            tr.rows.append(float(rows[k]))

        if frame_count < 2 or self.last_track_num < 20:
            return True

        parallax = []
        for tr in self.tracks.values():
            if tr.start_frame <= frame_count - 2 and tr.end_frame >= frame_count - 1:
                i = frame_count - 2 - tr.start_frame
                j = frame_count - 1 - tr.start_frame
                du = tr.pts[i][0] - tr.pts[j][0]
                dv = tr.pts[i][1] - tr.pts[j][1]
                parallax.append(np.hypot(du, dv))
        if not parallax:
            return True
        return float(np.mean(parallax)) >= self.min_parallax

    # ------------------------------------------------------------------
    def candidates(self) -> List[FeatureTrack]:
        """Landmark candidates in stable order (insertion order, like the
        reference's std::list traversal)."""
        return [t for t in self.tracks.values() if t.is_candidate(self.window_size)]

    def set_depths(self, dinv: np.ndarray, cands: List[FeatureTrack]):
        """Write solved inverse depths back; negative depth marks failure
        (≙ setDepth, `feature_manager.cpp:126-146`)."""
        for slot, tr in enumerate(cands):
            d = 1.0 / dinv[slot] if dinv[slot] != 0 else -1.0
            tr.estimated_depth = float(d)
            # a python bool: remove_failures tests it with `is False`
            tr.solve_ok = bool(d > 0)

    def remove_failures(self):
        dead = [fid for fid, t in self.tracks.items()
                if t.estimated_depth < 0 and t.solve_ok is False and t.is_candidate(self.window_size)]
        for fid in dead:
            del self.tracks[fid]

    def slot_fids(self, cap: int) -> np.ndarray:
        """Current candidate feature ids in pack slot order (streaming
        pipeline: keys lagged depth write-backs by feature id)."""
        return np.array([t.feature_id for t in self.candidates()][:cap],
                        dtype=np.int64)

    def set_depths_by_id(self, ids, dinv):
        for fid, d in zip(np.asarray(ids), np.asarray(dinv)):
            tr = self.tracks.get(int(fid))
            if tr is None:
                continue
            depth = 1.0 / d if d != 0 else -1.0
            tr.estimated_depth = float(depth)
            tr.solve_ok = bool(depth > 0)

    # ------------------------------------------------------------------
    def triangulate(self, cam_q: np.ndarray, cam_p: np.ndarray):
        """Multi-view DLT for tracks without depth, using per-frame *camera*
        poses (≙ `feature_manager.cpp:173-223`). cam_q/cam_p: (NB, ...) world
        poses of the camera at each keyframe time."""
        R = so3np.quat_to_matrix(np.asarray(cam_q))
        for tr in self.tracks.values():
            if not tr.is_candidate(self.window_size) or tr.estimated_depth > 0:
                continue
            i = tr.start_frame
            R0, t0 = R[i], cam_p[i]
            rows_A = []
            for k, pt in enumerate(tr.pts):
                j = i + k
                if j >= len(cam_p):
                    break
                Rj = R0.T @ R[j]
                tj = R0.T @ (cam_p[j] - t0)
                P = np.hstack([Rj.T, (-Rj.T @ tj)[:, None]])  # (3,4)
                f = np.array([pt[0], pt[1], 1.0])
                f = f / np.linalg.norm(f)
                rows_A.append(f[0] * P[2] - f[2] * P[0])
                rows_A.append(f[1] * P[2] - f[2] * P[1])
            A = np.stack(rows_A)
            _, _, Vt = np.linalg.svd(A, full_matrices=False)
            v = Vt[-1]
            depth = v[2] / v[3]
            tr.estimated_depth = depth if depth >= 0.1 else INIT_DEPTH

    # ------------------------------------------------------------------
    def slide_old(self, marg_R: np.ndarray, marg_p: np.ndarray,
                  new_R: np.ndarray, new_p: np.ndarray):
        """Window slides: drop frame 0 (≙ removeBackShiftDepth,
        `feature_manager.cpp:341-381`). marg/new are *camera* poses of the
        dropped frame and the new frame 0."""
        dead = []
        for fid, tr in self.tracks.items():
            if tr.start_frame != 0:
                tr.start_frame -= 1
                continue
            uv = tr.pts[0]
            tr.pts.pop(0)
            tr.rows.pop(0)
            if len(tr.pts) < 2:
                dead.append(fid)
                continue
            if tr.estimated_depth > 0:
                pt = np.array([uv[0], uv[1], 1.0]) * tr.estimated_depth
                w = marg_R @ pt + marg_p
                pj = new_R.T @ (w - new_p)
                tr.estimated_depth = pj[2] if pj[2] > 0 else INIT_DEPTH
        for fid in dead:
            del self.tracks[fid]

    def slide_second_new(self, frame_count: int):
        """Drop the second-newest frame (≙ removeFront,
        `feature_manager.cpp:401-422`)."""
        dead = []
        for fid, tr in self.tracks.items():
            if tr.start_frame == frame_count:
                tr.start_frame -= 1
                continue
            if tr.end_frame < frame_count - 1:
                continue
            j = frame_count - 1 - tr.start_frame
            tr.pts.pop(j)
            tr.rows.pop(j)
            if len(tr.pts) == 0:
                dead.append(fid)
        for fid in dead:
            del self.tracks[fid]
