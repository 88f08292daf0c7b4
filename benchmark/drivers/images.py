"""One rig fed its raw rolling-shutter images: a call hands the estimator
the image's IMU samples, then the image (`process_image`), and takes the
pose it returns. The front end is attached lagged
(`CtrlVIO.attach_frontend(..., lag=1)`): a call estimates the frame of the
image before, at that frame's own time, and returns its pose; `flush`
estimates the last one. The driver calls nothing else of the port than
`set_initial_state`, `process_imu`, `process_image` and `flush`.

Set-up makes the truth and the IMU samples from the seed (the draws of
`sequence.py`: a seed gives the feature cell's motion and IMU), the
estimator and its front end, then draws the textured world on the host
and renders every image the run can use on the card (`render.py`), kept
there as uint8. Warm-up follows `single.py`'s rules.

Each frame the front end publishes is caught on its way into
`process_frame` (its ids in order): they make `seq.frames`, one a frame
time, which the float64 solve check (`solve_ref`) reads as it reads the
generator's frames in the feature cell, so that it holds each sampled
solve to what the front end really produced. After the window the
published frames' tracks are held to the scene's geometry (`track_ref`):
their median error, the share more than `track_ref.GROSS_PX` off, the
share lost between published frames and the share on a moving quad, each
against its limit in the cell's file, are part of `correct`. The harness
has no hook for a driver's own check, so a driver judges them through
`reference.judge`, which it wraps for its process (`judge_with_tracks`).
"""

from __future__ import annotations

import math
import sys

import numpy as np

from benchmark import reference, render, replay, sequence, track_ref
from benchmark.drivers import single

# the track check's numbers in `correct`, each held at or below its limit
# (the share of published features the next published frame keeps, as
# the share it loses)
TRACKS = {"track_err_px_median": lambda g: g["err_px_median"],
          "track_gross_pct": lambda g: g["gross_share"],
          "track_lost_pct": lambda g: 100.0 - g["tracked_share"],
          "track_moving_pct": lambda g: g["moving_share"]}


def truth(traffic: dict, n_frames: int, seed: int, device):
    """The sequence of `n_frames` images from `seed` without its features
    (`frames` empty): the truth's draws, IMU samples and start state of
    `sequence.generate`, and the truth itself."""
    d = sequence.draw({**traffic, "n_landmarks": 0}, n_frames, seed, device)
    gt = sequence.Lissajous(d.phases, traffic["speed"], traffic["pause"])
    t_ns, tf = sequence.frame_times(traffic, n_frames, device)
    imu_t, gyro, accel, g = sequence.imu(gt, d, traffic, n_frames)
    q0, p0, v0 = sequence.start_state(gt, float(tf[0]), device)
    host = lambda x: x.cpu().numpy()  # noqa: E731
    seq = sequence.Sequence(
        imu_t_ns=host(imu_t), gyro=host(gyro), accel=host(accel), frames=[],
        phases=host(d.phases), speed=traffic["speed"], pause=traffic["pause"],
        bg=host(d.bg), ba=host(d.ba), gravity=host(g),
        init=dict(t_ns=int(t_ns[0]), q=host(q0), p=host(p0), v=host(v0)))
    return seq, gt, [int(t) for t in host(t_ns)]


def tracker_config(block: dict):
    """The port's `TrackerConfig` of the configuration's `tracker` block."""
    from ctrlvio_tpu_torch.frontend.klt import KLTConfig
    from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig

    return TrackerConfig(
        max_cnt=block["max_cnt"], min_dist=block["min_dist"],
        use_clahe=block["equalize"], fb_check=block["flow_back"],
        freq=block["freq"], reject_wf=block["reject_wf"],
        f_threshold=block["f_threshold"],
        klt=KLTConfig(pred_levels=block["pred_levels"]))


def judge_with_tracks(drv):
    """`reference.judge` that also holds the track check of `drv`'s window
    (`drv.tracks`, `TRACKS`) to the limits of `drv`'s cell, when it judges
    that cell's run (its limits, by identity); the judge it wraps (the
    harness's own, however often a driver is made) for any other."""
    base = getattr(reference.judge, "without_tracks", reference.judge)

    def judge(lanes, line_delay, limits, solves, overflows):
        correct, checks, per_lane = base(lanes, line_delay, limits, solves,
                                         overflows)
        if limits is drv.limits:
            for k, number in TRACKS.items():
                v = math.nan if drv.tracks is None else number(drv.tracks)
                checks[k] = {"value": v, "limit": limits[k]}
                correct = correct and v <= limits[k]  # NaN fails
        return correct, checks, per_lane

    judge.without_tracks = base
    return judge


class Driver(single.Driver):
    lanes = 1

    def __init__(self, config, traffic, cell, seed, seconds, trace_calls,
                 device):
        from ctrlvio_tpu_torch.models.cameras import Equidistant

        if traffic["cam_rate"] != config["cam_rate"]:
            raise ValueError(f"the traffic's images come at "
                             f"{traffic['cam_rate']} Hz, the configuration "
                             f"states {config['cam_rate']} Hz")
        self.device = device
        self.warm = config["warmup"]
        n = (self.warm["max_calls"] + trace_calls + 1
             + math.ceil(seconds * cell["ceiling_calls_per_s"]))
        self.seq, self.gt, self.t_ns = truth(traffic, n, seed, device)
        self.vio, self.feed = replay.started(config, traffic, self.seq,
                                             device)
        cam = traffic["camera"]
        self.W, self.H = traffic["image_size"]
        self.block = config["tracker"]
        self.vio.attach_frontend(
            Equidistant(**{k: cam[k] for k in ("mu", "mv", "u0", "v0", "k2",
                                               "k3", "k4", "k5")}),
            (self.H, self.W), tracker_config(self.block),
            lag=self.block["lag"])
        inner = self.vio.process_frame

        def caught(t_ns, ids, pts, rows):
            o = np.argsort(ids, kind="stable")
            self.seq.frames.append((int(t_ns), np.asarray(ids)[o].copy(),
                                    np.array(pts, np.float64)[o],
                                    np.array(rows, np.float64)[o]))
            return inner(t_ns, ids, pts, rows)

        self.vio.process_frame = caught
        path = render.path_points(self.gt, self.t_ns[-1] * 1e-9 + 0.1,
                                  traffic["coarse_dt"])
        scene = traffic["scene"]
        self.world = render.world_for(scene, path, seed)
        self.images = render.Renderer(
            self.world, cam, config["rig"], self.H, self.W, device,
            photometric=scene["photometric"],
            pixel_noise=scene["pixel_noise"], seed=seed).frames(self.gt,
                                                                self.t_ns)
        self.config, self.traffic = config, traffic
        self.ahead = replay.ahead_ns(traffic)
        self.until_ns = int(traffic["warmup_until_s"] * sequence.S_TO_NS)
        self.k = 0
        self.poses = []
        self.pose_t = []
        self.spans = None
        self.every = cell["solve_every"]
        self.offset = seed % self.every
        self.sample_from = None
        self.kept = []
        self.limits = cell["limits"]
        self.tracks = None
        reference.judge = judge_with_tracks(self)

    def remaining(self) -> int:
        return len(self.t_ns) - self.k

    def call(self):
        t_ns = self.t_ns[self.k]
        keep = (self.sample_from is not None
                and (self.k - self.sample_from) % self.every == self.offset)
        if keep:
            before = self.snapshot()
            n0 = self.vio.counts["megastep"]
        n_pub = len(self.seq.frames)
        with replay.span(self.spans, "imu feed"):
            self.feed.until(t_ns + self.ahead)
        with replay.span(self.spans, "process_image"):
            out = self.vio.process_image(t_ns, self.images[self.k])
        if keep:
            del self.vio._upload
            if self.vio.counts["megastep"] == n0 + 1 and before[2]:
                pending = self.vio._stream_pending[-1]
                after = None
                if pending[0]["marg_old"]:
                    pr = self.vio._dev_state.prior
                    after = {"J": pr.J.clone(), "r0": pr.r0.clone()}
                self.kept.append((self.k, before, pending, after))
        self.poses.append(out)
        self.pose_t.append(self.seq.frames[-1][0]
                           if len(self.seq.frames) > n_pub else None)
        self.k += 1

    def warm_up(self):
        from ctrlvio_tpu_torch.estimator.odometry import MARGIN_OLD

        handoff, branches = None, set()
        while self.k < self.warm["max_calls"]:
            self.call()
            if handoff is None:
                if self.vio.counts["megastep"]:
                    handoff = self.k
            else:
                branches.add(self.vio.marg_flag == MARGIN_OLD)
                if (self.k >= handoff + self.warm["after_handoff"]
                        and len(branches) == 2
                        and self.seq.frames[-1][0] >= self.until_ns):
                    self.sample_from = self.k
                    return
        self.sample_from = self.k
        print(f"[bench] warm-up reached {self.k} calls (handoff at "
              f"{handoff}, slide branches {sorted(branches)}): a capture "
              f"may fall in the window", file=sys.stderr)

    def counters(self) -> dict:
        from ctrlvio_tpu_torch.ops import lk

        out = super().counters()  # settles the captured programs' counts
        out["frontend"] = dict(self.vio.tracker.counts)
        out["k1"] = {"by_levels": dict(lk.lk_track.launches_by_levels),
                     "plain": lk.lk_track_plain.calls,
                     "n": self.block["max_cnt"],
                     "iters": self.vio.tracker.cfg.klt.iters}
        return out

    def answers(self, lo: int, hi: int):
        """What the calls `lo`..`hi` returned (each the pose of the frame
        it estimated, at that frame's time; a call that estimated none
        counts as failed) and what the estimator holds after its flush;
        checks the tracks of the frames they published (`self.tracks`)."""
        t = [self.t_ns[k - 1] if self.pose_t[k] is None else self.pose_t[k]
             for k in range(lo, hi)]
        poses = [p if self.pose_t[k] is not None else None
                 for k, p in zip(range(lo, hi), self.poses[lo:hi])]
        self.check_tracks(t)
        return [single.lane_answers(self.vio, self.seq, poses, t)]

    def check_tracks(self, t_ns):
        """The track check (`track_ref.check`) of the frames published at
        the times `t_ns`, kept for the judge and printed on standard
        error."""
        want = set(t_ns)
        frames = [f for f in self.seq.frames if f[0] in want]
        self.tracks = track_ref.check(
            frames, self.world, self.gt, self.config["rig"],
            self.traffic["camera"], self.H, self.W, self.device)
        print("[bench] track check: " + ", ".join(
            f"{k} {v:.6g}" for k, v in self.tracks.items()), file=sys.stderr)
