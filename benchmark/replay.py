"""What the driver modules share: the estimator a configuration describes,
started from the ground truth, and the IMU feed that hands each frame its
samples.

Only the port's entry points are called here: `CtrlVIO` with its
`VIOConfig` and `WindowConfig`.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import sequence


@contextlib.contextmanager
def span(spans, name: str):
    """A host span of the benchmark's own, on the clock the profiler's
    events carry (ns since the epoch), appended to `spans` unless it is
    None: a traced run labels its idle gaps by them."""
    if spans is None:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        spans.append((t0, time.time_ns(), name))


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def estimator(config: dict, device):
    """A `CtrlVIO` as the configuration's `estimator` block states it."""
    from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
    from ctrlvio_tpu_torch.solver.layout import WindowConfig

    est = dict(config["estimator"])
    wc = WindowConfig(**est.pop("window"))
    dtype = getattr(torch, est.pop("dtype"))
    if "marg_caps" in est:
        est["marg_caps"] = tuple(est["marg_caps"])
    rig = config["rig"]
    q_CtoI = sequence.quat_exp(torch.tensor(rig["ext_rot"],
                                            dtype=torch.float64)).numpy()
    return CtrlVIO(VIOConfig(window_config=wc, dtype=dtype, **est), q_CtoI,
                   np.array(rig["ext_pos"], np.float64), device=device)


class ImuFeed:
    """Hands an estimator the samples of its sequence up to a time."""

    def __init__(self, vio, seq: sequence.Sequence):
        self.vio, self.seq, self.next = vio, seq, 0

    def until(self, t_ns: int):
        s, k = self.seq, self.next
        n = len(s.imu_t_ns)
        while k < n and s.imu_t_ns[k] <= t_ns:
            self.vio.process_imu(int(s.imu_t_ns[k]), s.gyro[k], s.accel[k])
            k += 1
        self.next = k


def started(config: dict, traffic: dict, seq: sequence.Sequence, device):
    """An estimator with the samples up to its first frame's look-ahead
    fed and the ground-truth bootstrap set, and its feed."""
    vio = estimator(config, device)
    feed = ImuFeed(vio, seq)
    ahead = ahead_ns(traffic)
    feed.until(seq.init["t_ns"] + ahead)
    i = seq.init
    vio.set_initial_state(i["t_ns"], i["q"], i["p"], seq.bg, seq.ba,
                          seq.gravity, v0=i["v"])
    return vio, feed


def ahead_ns(traffic: dict) -> int:
    return int(round(traffic["imu_ahead_s"] * sequence.S_TO_NS))
