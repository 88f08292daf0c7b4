"""A CPU stand-in for CUDA-graph capture and replay, for tests only
(`tests/test_torch_graphs*.py` patch it into `ctrlvio_tpu_torch/utils/
graphs.py` with `replayed_programs`; the package has no such option), and
the estimator runs those tests share.

It keeps a graph's semantics, so that a caller that relies on anything a
graph does not give fails here as it would on the card:
- "capture" records the function and its static input tensors, and runs
  nothing on them: it makes the output tensors (from a run on copies of the
  inputs) and fills their floating entries with NaN, as a capture leaves
  its outputs unwritten;
- "replay" runs the function again on those same input tensors and copies
  the result into those same output tensors, so a caller that keeps an
  output across calls sees it overwritten, and a caller that rebinds an
  input in place of copying into it is not seen. Kernel launch counts made
  while the function runs are taken back: the program adds the launches
  it holds, as on the card.
"""

import contextlib

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.estimator import odometry
from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig
from ctrlvio_tpu_torch.utils import graphs


def standin_capture(body, inputs, device, pool, stream):
    out = body(graphs.clone(inputs))
    for t in graphs.leaves(out):
        if t.is_floating_point():
            t.fill_(float("nan"))

    def replay():
        with graphs.held_launches():
            new = body(inputs)
        for o, n in zip(graphs.leaves(out), graphs.leaves(new)):
            o.copy_(n)

    return out, replay


@contextlib.contextmanager
def replayed_programs():
    """Inside, programs are captured and replayed through the stand-in on
    the CPU, with a fresh process-wide cache of the synchronous path's
    programs and fresh counts."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "graphed_on", lambda device: True)
        mp.setattr(graphs, "capture", standin_capture)
        mp.setattr(odometry, "_SYNC_PROGRAMS", graphs.ProgramCache())
        graphs.reset_counts()
        yield


def captured():
    """The keys of the programs captured since the counts were reset."""
    return [c["key"] for c in graphs.stats()["graphs_captured"]]


def programs(cache):
    """The programs of a `graphs.ProgramCache`, by key."""
    return {p.label: p for p in cache._programs.values()}


# the estimator runs of the CPU tests: f64, short solves; the parallax
# threshold makes second-new frames beside the keyframes (both slide
# branches streamed, priors built at knot shifts 2 and 4 on `sim()`)
WINDOW = WindowConfig(KW=32, NB=6, LM=96, OBS=384, MIMU=192)
CFG = dict(window_config=WINDOW, fix_ld=False, ld_init=0.0,
           imu_overflow="subsample", ba_iters=4, init_ba_iters=8,
           predict_iters=4, min_parallax=0.15, dtype=torch.float64)
STREAM = dict(stream=True, stream_lag=2, stream_warmup=3)


def sim(seed=11):
    return synthetic.generate(synthetic.reference_noise(
        duration=2.2, n_landmarks=250, seed=seed))


def new_vio(sim, **kw):
    """A CPU CtrlVIO of `CFG` (with `kw`) from the ground-truth bootstrap,
    every IMU sample fed."""
    vio = CtrlVIO(VIOConfig(**{**CFG, **kw}),
                  so3np.quat_exp(np.array(sim.cfg.ext_rot)),
                  np.array(sim.cfg.ext_pos), device="cpu")
    init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    return vio


def run(sim, rebind_at=None, **kw):
    """Every frame through `process_frame`, then `flush()`. Returns the
    estimator, the poses it returned, the slide branch of each streamed
    frame and the knot shift of each prior build. At frame `rebind_at` the
    estimator's gravity tensor is replaced by a new one, 1e-4 larger (a
    constant rebound after the programs that read it were captured)."""
    vio = new_vio(sim, **kw)
    shifts = []
    pack = odometry.blob_pack

    def spy(*a, tail=(), **k):
        if len(tail):
            shifts.append(int(tail[3]))
        return pack(*a, tail=tail, **k)

    odometry.blob_pack = spy
    poses, branches = [], []
    try:
        for i, fr in enumerate(sim.frames):
            if i == rebind_at:
                vio._gravity_j = vio._gravity_j * (1.0 + 1e-4)
            n = vio.counts["megastep"]
            out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
            if out is not None:
                poses.append(np.concatenate(out))
            if vio.counts["megastep"] > n:
                branches.append(vio.marg_flag)
        vio.flush()
    finally:
        odometry.blob_pack = pack
    return vio, np.asarray(poses), branches, shifts


def assert_same_estimate(a, b):
    """Two estimators hold the same estimate, bit for bit: trajectory,
    line delay, biases, keyframes, the last solve's statistics, counts."""
    assert a.traj.n == b.traj.n
    assert np.array_equal(a.traj.knots_q[: a.traj.n],
                          b.traj.knots_q[: b.traj.n])
    assert np.array_equal(a.traj.knots_p[: a.traj.n],
                          b.traj.knots_p[: b.traj.n])
    assert a.traj.line_delay == b.traj.line_delay
    assert np.array_equal(a.bg, b.bg) and np.array_equal(a.ba, b.ba)
    assert [k.t_ns for k in a.keyframes] == [k.t_ns for k in b.keyframes]
    for x, y in zip(a.keyframes, b.keyframes):
        assert np.array_equal(x.p, y.p) and np.array_equal(x.q, y.q)
    sa, sb = vars(a.last_solve_stats), vars(b.last_solve_stats)
    assert sa.keys() == sb.keys()
    assert all(np.array_equal(sa[k], sb[k]) for k in sa)
    assert dict(a.counts) == dict(b.counts)
