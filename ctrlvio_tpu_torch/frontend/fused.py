"""Slot-identity feature tracking front end (PyTorch port of
`ctrlvio_tpu/frontend/fused.py`).

Per frame: CLAHE -> pyramid -> gyro-predicted pyramidal LK (kernel K1 on
the card) with the forward-backward check -> Shi-Tomasi refill of free
slots -> undistortion. The pyramid and the track state stay on the device
between frames; the host receives one packed (N, 8) array per frame
([x, y, nx, ny, live, tracked, refilled, pad]) and keeps the id lifecycle
in numpy. Feature identity is the slot: a slot tracks one feature until it
dies and is refilled; the host assigns globally unique ids to refill
events.

On the card a step reads nothing back: the gyro rotation and the kill mask
go up in one non-blocking copy from pinned memory, and the packed array
comes down the same way, behind a CUDA event that only `_consume` waits
on. With `lag=1` a frame is consumed one step later, so its pull overlaps
the next frame's work. The preprocessing of the first frame and each
step's device work are captured programs (`utils/graphs.py`, ≙ the JAX
package's `_jit_pre` and `_jit_step`), one each for the tracker's pyramid,
K1 inside the step's; the pyramid, points and live mask are carried in
place from step to step.

With `reject_wf` the host runs the epipolar F-RANSAC gate
(`frontend/fransac.py`) on each consumed frame: a feature that violates
the dominant two-view geometry is suppressed from publication at once and
its slot is freed on the device at the next dispatch (≙ rejectWithF,
`feature_tracker.cpp:201-235`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.utils import graphs, spans
from ctrlvio_tpu_torch.utils.device import recorded_syncs, resolve_device
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls

from . import clahe as clahe_mod
from . import corners, klt
from .fransac import reject_with_f
from .tracker import TrackerConfig


def rotation_flow(imu_t_ns, gyro, t0_ns, t1_ns, R_CtoI, bg=None):
    """Camera-frame relative rotation M (3, 3) between two frame times from
    raw gyro, for KLT initial-flow prediction: x_cur ~ M @ x_prev under
    pure rotation, M = R_ic^T dR^T R_ic (host numpy)."""
    imu_t_ns = np.asarray(imu_t_ns)
    lo = np.searchsorted(imu_t_ns, t0_ns, "left")
    hi = np.searchsorted(imu_t_ns, t1_ns, "right")
    q = np.array([1.0, 0.0, 0.0, 0.0])
    ts = np.concatenate([[t0_ns], imu_t_ns[lo:hi], [t1_ns]])
    for k in range(len(ts) - 1):
        dt = (ts[k + 1] - ts[k]) * 1e-9
        if dt <= 0:
            continue
        w = gyro[min(max(lo + k - 1, 0), len(gyro) - 1)]
        if bg is not None:
            w = w - bg
        q = so3np.quat_mul(q, so3np.quat_exp(np.asarray(w, np.float64) * dt))
    dR = so3np.quat_to_matrix(q[None])[0]
    R_ic = np.asarray(R_CtoI, np.float64)
    return (R_ic.T @ dR.T @ R_ic).astype(np.float32)


class FusedTracker:
    """Slot-identity KLT tracker. Feed frames with `step(t_ns, img)`; it
    returns the published feature dict of the current frame (lag=0) or of
    the previous one (lag=1; None on the first call): ids, pts
    (normalized), uv, vel, rows, t_ns.

    With `check_dispatch_syncs` set on a CUDA device, `dispatch_syncs`
    counts the synchronizing CUDA calls of each step's dispatch (uploads,
    the device work and the start of the pull; not the wait in `_consume`)
    and `sync_warnings` collects their messages. `timing` holds cumulative
    host seconds of its spans (`utils/spans.py`): "dispatch", "consume",
    and within the latter "pull_wait" (the wait for the packed array) and
    "fgate"."""

    def __init__(self, cfg: TrackerConfig, camera, image_shape, lag: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        pin_f32_matmuls()
        self.cfg = cfg
        self.camera = camera
        self.H, self.W = image_shape
        self.lag = lag
        N = cfg.max_cnt
        self.N = N

        # host-side identity state (slot-indexed, fixed size)
        self.ids = np.full((N,), -1, dtype=np.int64)
        self.track_cnt = np.zeros((N,), dtype=np.int64)
        self.prev_norm = np.zeros((N, 2))
        self.prev_live = np.zeros((N,), dtype=bool)
        self.prev_t_ns: Optional[int] = None
        self.next_id = 0
        # F-gate state: slots the host gate killed are suppressed from
        # publishing at once and freed on the device at the next dispatch
        self._kill = np.zeros((N,), dtype=bool)
        self._suppress = np.zeros((N,), dtype=bool)
        self.n_rejected = 0  # cumulative F-gate rejections
        self.check_dispatch_syncs = False
        self.dispatch_syncs = 0
        self.sync_warnings = []
        self._spans = spans.Recorder()
        self._span = self._spans.span
        self.timing = self._spans.timing

        # device-resident state: (pyramid tuple, pts (N,2) f32, live (N,))
        self._dev = None
        self._pending = None  # (t_ns, packed, event) awaiting consume
        self._programs = graphs.ProgramCache()

    # ------------------------------------------------------------------
    def _preprocess(self, img):
        img = img.to(self.device, torch.float32)
        if self.cfg.use_clahe:
            img = clahe_mod.clahe(img)
        return tuple(klt.pyramid(img, self.cfg.klt.levels))

    def _step(self, state, img, mk):
        """The step's program: `_megastep` on the carried state (pyramid,
        pts, live), with the rotation and kill mask as one uploaded vector
        (M_rel's 9 entries, then the N kill flags)."""
        pyr_prev, pts, live = state
        return self._megastep(img, pyr_prev, pts, live, mk[:9].reshape(3, 3),
                              mk[9:] > 0.5)

    def _megastep(self, img, pyr_prev, pts, live, M_rel, kill):
        """track -> refill free slots -> lift; returns the new device state
        and the packed (N, 8) f32 array. M_rel (3, 3): camera-frame rotation
        prev -> cur used to predict each feature's position; kill (N,):
        slots the host F-gate rejected."""
        cfg = self.cfg
        pyr_cur = self._preprocess(img)

        live = live & ~kill  # host F-gate kills free their slots here
        pts_in = torch.where(live[:, None], pts, torch.zeros_like(pts))
        # gyro-predicted initial flow: rotate the lifted ray, re-project
        rays = self.camera.lift(pts_in)
        rays3 = torch.cat([rays, torch.ones_like(rays[:, :1])], dim=1)
        rot = rays3 @ M_rel.T
        guess_uv = self.camera.project(rot).to(torch.float32)
        ahead = rot[:, 2] > 0.1
        guess = torch.where((live & ahead)[:, None], guess_uv, pts_in)
        guess = torch.stack([guess[:, 0].clamp(0.0, self.W - 1.0),
                             guess[:, 1].clamp(0.0, self.H - 1.0)], dim=1)
        new_pts, ok = klt.track(pyr_prev, pyr_cur, pts_in, cfg.klt, init=guess)
        ok = ok & live

        # refill: the k-th accepted candidate goes to the k-th free slot
        exclude = torch.where(ok[:, None], new_pts.flip(-1),
                              torch.full_like(new_pts, -1.0))
        cand, cand_ok = corners.detect(pyr_cur[0], max_corners=self.N,
                                       min_dist=cfg.min_dist,
                                       exclude_yx=exclude)
        free = ~ok
        cand_rank = torch.cumsum(cand_ok.to(torch.int32), 0) - 1
        free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
        sel = (cand_ok[None, :] & free[:, None]
               & (cand_rank[None, :] == free_rank[:, None]))
        from_cand = sel.to(cand.dtype) @ cand
        refilled = torch.any(sel, dim=1)

        pts_out = torch.where(ok[:, None], new_pts,
                              torch.where(refilled[:, None], from_cand,
                                          torch.full_like(new_pts, -1.0)))
        live_out = ok | refilled
        norm = self.camera.lift(torch.where(live_out[:, None], pts_out,
                                            torch.zeros_like(pts_out)))
        packed = torch.cat([
            pts_out, norm.to(torch.float32),
            live_out[:, None].to(torch.float32),
            ok[:, None].to(torch.float32),
            refilled[:, None].to(torch.float32),
            torch.zeros((self.N, 1), dtype=torch.float32, device=self.device),
        ], dim=1)
        return (tuple(pyr_cur), pts_out, live_out), packed

    # ------------------------------------------------------------------
    def step(self, t_ns: int, img, R_rel=None):
        """Feed one frame (numpy or tensor image); returns the feature dict
        for this frame (lag=0) or the previous one (lag=1).

        R_rel: optional (3, 3) camera-frame rotation prev -> cur frame (see
        `rotation_flow`) enabling gyro-predicted initial flow."""
        if self.prev_t_ns is not None and self._dev is not None and (
                t_ns < self.prev_t_ns
                or t_ns - self.prev_t_ns > 1_000_000_000):
            self.restart()

        imgd = torch.as_tensor(img, device=self.device)
        if self._dev is None:
            pre = self._programs.get(self._preprocess, (imgd,), self.device)
            self._dev = (pre(imgd),
                         torch.full((self.N, 2), -1.0, dtype=torch.float32,
                                    device=self.device),
                         torch.zeros((self.N,), dtype=torch.bool,
                                     device=self.device))
        M = np.eye(3, dtype=np.float32) if R_rel is None \
            else np.asarray(R_rel, np.float32)
        # dispatch with the kills of the previous consume, then clear them;
        # the program is captured (first use) before the check
        with self._span("dispatch"):
            args = (self._dev, imgd, self._upload(M, self._kill))
            step = self._programs.get(self._step, args, self.device,
                                      carry=True)
            with recorded_syncs(self.check_dispatch_syncs
                                and self.device.type == "cuda") as msgs:
                self._dev, packed = step(*args)
                pulled = (t_ns, *self._pull(packed))
            self.dispatch_syncs += len(msgs)
            self.sync_warnings.extend(msgs)
            self._kill = np.zeros((self.N,), dtype=bool)

        out = None
        if self.lag and self._pending is not None:
            out = self._consume(*self._pending)
        self._pending = pulled
        if not self.lag:
            out = self._consume(*self._pending)
            self._pending = None
        return out

    def flush(self):
        """Drain the pending frame (lag=1). Returns its feature dict."""
        if self._pending is None:
            return None
        out = self._consume(*self._pending)
        self._pending = None
        return out

    def restart(self):
        self._dev = None
        self._pending = None
        self.ids[:] = -1
        self.track_cnt[:] = 0
        self.prev_live[:] = False
        self.prev_t_ns = None
        self._kill[:] = False
        self._suppress[:] = False

    # ------------------------------------------------------------------
    def _upload(self, M, kill):
        """M (3, 3) f32 and kill (N,) bool as one (9 + N,) f32 vector, as
        the step's program takes it: on the card a fresh pinned buffer
        (the program copies it in without waiting), on the CPU the
        tensor."""
        src = torch.from_numpy(np.concatenate([M.reshape(-1),
                                               kill.astype(np.float32)]))
        if self.device.type == "cuda":
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            buf.copy_(src)
            return buf
        return src.to(self.device)

    def _pull(self, packed):
        """Start a copy of the packed array to the host (the program's
        output, which its next replay overwrites): (host tensor, CUDA
        event to wait on, or None on the CPU)."""
        if packed.device.type != "cuda":
            return packed.clone(), None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _consume(self, t_ns: int, packed, done=None):
        with self._span("consume"):
            return self._consume_pulled(t_ns, packed, done)

    def _consume_pulled(self, t_ns: int, packed, done):
        with self._span("pull_wait"):
            if done is not None:
                done.synchronize()
        p = packed.numpy().astype(np.float64)
        uv = p[:, 0:2]
        norm = p[:, 2:4]
        live = p[:, 4] > 0.5
        tracked = p[:, 5] > 0.5
        refilled = p[:, 6] > 0.5

        # epipolar outlier gate on the host: features violating the
        # dominant two-view geometry (e.g. tracks on independently moving
        # objects) are suppressed from this frame's publication and their
        # slots queued for the next dispatch's kill and refill
        self._suppress &= ~refilled  # the device refilled the slot
        if self.cfg.reject_wf:
            with self._span("fgate"):
                same = tracked & self.prev_live & ~self._suppress
                idx = np.nonzero(same)[0]
                if len(idx) >= 12:
                    inl = reject_with_f(self.prev_norm[idx], norm[idx],
                                        thresh_px=self.cfg.f_threshold)
                    bad = idx[~inl]
                    if len(bad):
                        self._suppress[bad] = True
                        self._kill[bad] = True
                        self.n_rejected += len(bad)
        live &= ~self._suppress
        tracked &= ~self._suppress

        # id lifecycle on the host (slot identity makes this vectorizable)
        n_new = int(refilled.sum())
        self.ids = np.where(tracked, self.ids, -1)
        if n_new:
            self.ids[refilled] = self.next_id + np.arange(n_new)
            self.next_id += n_new
        self.track_cnt = np.where(tracked, self.track_cnt + 1,
                                  np.where(refilled, 1, 0))

        vel = np.zeros((self.N, 2))
        if self.prev_t_ns is not None:
            dt = (t_ns - self.prev_t_ns) * 1e-9
            if dt > 0:
                same = tracked & self.prev_live
                vel[same] = (norm[same] - self.prev_norm[same]) / dt
        self.prev_t_ns = t_ns
        self.prev_norm = norm.copy()
        self.prev_live = live.copy()
        return dict(t_ns=t_ns, ids=self.ids[live].copy(), pts=norm[live],
                    uv=uv[live], vel=vel[live], rows=uv[live][:, 1])
