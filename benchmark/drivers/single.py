"""One rig, one `CtrlVIO`: a call hands the estimator the frame's IMU
samples, then the frame (`process_frame`), and takes its pose.

Warm-up runs the synchronous frames, the stream's handoff, and then frames
until `after_handoff` have passed, the traffic's `warmup_until_s` is
reached and both slide branches of the streamed megastep (marginalize the
oldest keyframe, or drop the second newest) have been captured, so that no
capture falls in the window.

After the warm-up, one call in every `solve_every` of the cell (from an
offset drawn from the seed) keeps what the float64 reference of the solve
needs (`solve_ref.Record`): the port's prior and knots before the call (a
copy on the card, queued behind its work), the frame's packed input, the
summary the call queued, and where the call marginalized the oldest
keyframe the prior it left. They are read only once the window has
closed.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from benchmark import replay, sequence, solve_ref


class Driver:
    lanes = 1

    def __init__(self, config, traffic, cell, seed, seconds, trace_calls,
                 device):
        self.device = device
        self.warm = config["warmup"]
        n = (self.warm["max_calls"] + trace_calls
             + math.ceil(seconds * cell["ceiling_calls_per_s"]))
        self.seq = sequence.generate(traffic, config["rig"], n, seed, device)
        self.vio, self.feed = replay.started(config, traffic, self.seq,
                                             device)
        self.ahead = replay.ahead_ns(traffic)
        self.until_ns = int(traffic["warmup_until_s"] * sequence.S_TO_NS)
        self.k = 0
        self.poses = []
        self.spans = None
        self.every = cell["solve_every"]
        self.offset = seed % self.every
        self.sample_from = None
        self.kept = []

    def remaining(self) -> int:
        return len(self.seq.frames) - self.k

    def call(self):
        t_ns, ids, pts, rows = self.seq.frames[self.k]
        keep = (self.sample_from is not None
                and (self.k - self.sample_from) % self.every == self.offset)
        if keep:
            before = self.snapshot()
            n0 = self.vio.counts["megastep"]
        with replay.span(self.spans, "imu feed"):
            self.feed.until(t_ns + self.ahead)
        with replay.span(self.spans, "process_frame"):
            out = self.vio.process_frame(t_ns, ids, pts, rows)
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
        self.k += 1

    def snapshot(self):
        """Copies of the port's state before a kept call, and its blob
        caught on its way to the card."""
        st = self.vio._dev_state
        prev = {k: getattr(st.params, k).clone()
                for k in ("knots_q", "knots_p", "bg", "ba", "dinv", "ld")}
        prior = {k: v.clone() for k, v in st.prior._asdict().items()}
        caught = {}
        upload = self.vio._upload

        def catch(blob):
            caught["blob"] = blob.copy()
            return upload(blob)

        self.vio._upload = catch
        return prev, prior, caught

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
                        and self.seq.frames[self.k - 1][0] >= self.until_ns):
                    self.sample_from = self.k
                    return
        self.sample_from = self.k
        print(f"[bench] warm-up reached {self.k} calls (handoff at "
              f"{handoff}, slide branches {sorted(branches)}): a capture "
              f"may fall in the window", file=sys.stderr)

    def close(self):
        self.vio.flush()

    def timing(self) -> dict:
        return dict(self.vio.timing)

    def counters(self) -> dict:
        from ctrlvio_tpu_torch.ops import factor_kernels, lm_kernels
        from ctrlvio_tpu_torch.utils import graphs

        return {"graphs": graphs.stats(), "factor": factor_kernels.counts(),
                "lm": lm_kernels.counts(),
                "megasteps": self.vio.counts["megastep"]}

    def answers(self, lo: int, hi: int):
        """What the calls `lo`..`hi` returned and what the estimator holds
        after its flush, one record a lane."""
        return [lane_answers(self.vio, self.seq, self.poses[lo:hi],
                             [f[0] for f in self.seq.frames[lo:hi]])]

    def records(self, lo: int, hi: int):
        """The kept calls of the window as the reference reads them."""
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        out = []
        for k, (prev, prior, caught), (meta, obj, _), after in self.kept:
            if not lo <= k < hi:
                continue
            if isinstance(obj, tuple):
                obj[1].synchronize()
                obj = obj[0]
            out.append(solve_ref.Record(
                blob=caught["blob"],
                prev={n: host(v) for n, v in prev.items()},
                prior={n: host(v) for n, v in prior.items()},
                meta=meta, summary=host(obj).astype(float),
                after=None if after is None else {
                    n: host(v) for n, v in after.items()}))
        return out

    def overflows(self) -> int:
        """Marginalizations whose subset overflowed the configured caps,
        among the summaries the estimator read."""
        return int(self.vio.counts.get("marg_overflow", 0))


def lane_answers(vio, seq, poses, t_ns):
    """A lane's record for the judge: each call's pose (None where none
    came back), the final spline's knots and time base, the line delay."""
    tr = vio.traj
    ok = [p is not None for p in poses]
    nan4, nan3 = np.full(4, np.nan), np.full(3, np.nan)
    return dict(
        t_ns=np.asarray(t_ns, np.int64),
        q=np.stack([np.asarray(p[0], np.float64) if o else nan4
                    for p, o in zip(poses, ok)]),
        p=np.stack([np.asarray(p[1], np.float64) if o else nan3
                    for p, o in zip(poses, ok)]),
        knots_q=np.array(tr.knots_q[:tr.n]),
        knots_p=np.array(tr.knots_p[:tr.n]),
        dt_ns=int(tr.dt_ns), start_ns=int(vio.data_start_ns or 0),
        line_delay=float(tr.line_delay), phases=seq.phases, speed=seq.speed,
        pause=seq.pause)
