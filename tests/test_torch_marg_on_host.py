"""`VIOConfig.marg_on_host` through the port's synchronous `CtrlVIO` on the
CPU in float32, against the JAX package's, and the rule that every option
of the JAX package's configurations exists in the port.

`marg_on_host=False` builds the per-frame marginalization prior in the
solve dtype (`marginalize.build_prior` in float32) from the solve-dtype
prior, and ends the float64 chain; the bootstrap prior stays float64. On
the sequences tried, in both packages, the first float32 build's
Jacobi-scaled Cholesky of the kept block fails (its gauge directions hold
only eps = 1e-7: `test_torch_marginalize.py::
test_build_prior_f32_gauge_free_fails_in_both`), the prior comes out NaN,
and every later LM step is rejected: the knots stay where the IMU
dead-reckoning put them. The port keeps that behaviour of the reference;
the slow test holds it to the JAX package's run frame by frame."""

import dataclasses

import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import odometry as jodometry
from ctrlvio_tpu.frontend import klt as jklt
from ctrlvio_tpu.frontend import tracker as jtracker
from ctrlvio_tpu.sim import synthetic as jsynthetic
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu_torch.estimator import odometry as todometry
from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.frontend import klt as tklt
from ctrlvio_tpu_torch.frontend import tracker as ttracker
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic as tsynthetic
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.utils.ate import ate_rmse
from tests.torch_parity import one_torch_thread  # noqa: F401

WINDOW = dict(KW=24, NB=6, LM=96, OBS=384, MIMU=192)
# fewer LM iterations than the defaults (12, 30) keep the runs short
ITERS = dict(ba_iters=4, init_ba_iters=10)
# the port's poses against the JAX package's, both float32: the float32
# solves' rounding, carried by the dead-reckoned knots once every step is
# rejected (measured <= 6 um over 21 frames, and 2e-12 s apart: one
# float32 step of the line delay)
POSE_GAP_M = 1e-4
LD_GAP_S = 1e-10


def run(side, duration, marg_on_host=None):
    """One package's synchronous CtrlVIO in float32 on a reference-noise
    feature sequence (seed 11) from the ground-truth bootstrap. Returns
    the simulation, the estimator and per solved frame: the position, the
    true position, whether the prior after that frame is finite, the LM
    steps accepted, and whether the f64 chain is still held."""
    kw = {} if marg_on_host is None else dict(marg_on_host=marg_on_host)
    if side == "jax":
        from ctrlvio_tpu.estimator.initializer import \
            bootstrap_from_sim as jbootstrap

        sim = jsynthetic.generate(jsynthetic.reference_noise(
            duration=duration, n_landmarks=250, seed=11))
        vio = jodometry.CtrlVIO(jodometry.VIOConfig(
            window_config=jlayout.WindowConfig(**WINDOW), dtype=np.float32,
            **ITERS, **kw), so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64)),
            np.array(sim.cfg.ext_pos))
        init = jbootstrap(sim)
    else:
        sim = tsynthetic.generate(tsynthetic.reference_noise(
            duration=duration, n_landmarks=250, seed=11))
        vio = todometry.CtrlVIO(todometry.VIOConfig(
            window_config=tlayout.WindowConfig(**WINDOW), **ITERS,
            dtype=torch.float32, **kw),
            so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64)),
            np.array(sim.cfg.ext_pos), device="cpu")
        init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    rows = []
    for fr in sim.frames:
        out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        if out is None:
            continue
        J = vio.prior.J
        J = J.numpy() if torch.is_tensor(J) else np.asarray(J)
        chain = (vio._prior64 if side == "torch"
                 else getattr(vio, "_prior_cpu64", None))
        rows.append((np.asarray(out[1]), sim.pose_at(fr.t_ns * 1e-9)[1],
                     bool(np.isfinite(J).all()),
                     int(vio.last_solve_stats.accepted), chain is not None,
                     J.dtype, vio.traj.line_delay))
    return sim, vio, rows


def test_solve_dtype_prior_in_the_port():
    """`marg_on_host=False`: the run bootstraps once the window fills and
    solves every later frame synchronously; the bootstrap's f64 prior
    seeds the chain, and after the first MARGIN_OLD frame the prior is
    float32 with the f64 chain gone. Here, as in the JAX package, that
    first float32 prior is NaN, and from then on no LM step is accepted
    and the line delay stays put, while the dead-reckoned poses stay
    finite."""
    sim, vio, rows = run("torch", 1.5, marg_on_host=False)
    n_frames = len(sim.frames)
    assert len(rows) == n_frames - WINDOW["NB"] + 1 >= 5
    assert vio.counts["sync_solve"] == len(rows) - 1  # the first: bootstrap
    assert rows[0][4] and rows[0][2]  # the bootstrap's f64 prior, finite
    assert all(r[5] == np.float32 and not r[4] for r in rows[1:])
    finite = [r[2] for r in rows]
    assert finite == [True] + [False] * (len(rows) - 1)
    assert rows[1][3] > 0  # the solve before the first f32 build
    assert all(r[3] == 0 for r in rows[2:])
    assert len({r[6] for r in rows[2:]}) == 1
    est = np.stack([r[0] for r in rows])
    assert np.isfinite(est).all()


def test_f64_prior_is_the_default():
    """`marg_on_host=True` is the default, bit for bit: the same poses,
    line delay and priors as a config that leaves the field unset, with
    the f64 chain held and every prior finite; the run follows the
    ground truth inside the e2e gates."""
    _, vio_d, default = run("torch", 1.5)
    sim, vio_t, explicit = run("torch", 1.5, marg_on_host=True)
    assert todometry.VIOConfig().marg_on_host is True
    assert len(default) == len(explicit) >= 5
    for a, b in zip(default, explicit):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[2:] == b[2:]
    assert all(r[2] and r[4] for r in explicit)
    assert torch.equal(vio_d.prior.J, vio_t.prior.J)
    assert vio_t._prior64.J.dtype == torch.float64
    est = np.stack([r[0] for r in explicit])
    gt = np.stack([r[1] for r in explicit])
    assert ate_rmse(est, gt, align="yaw") < 0.10
    assert abs(vio_t.traj.line_delay - sim.cfg.line_delay) < 2e-6


@pytest.mark.slow
def test_solve_dtype_prior_matches_jax():
    """The same 3 s sequence through both packages' CtrlVIO with
    `marg_on_host=False` in float32: the same solved frames, the prior
    non-finite from the same frame and no step accepted after it in
    either, poses within POSE_GAP_M and the line delay within LD_GAP_S of
    the JAX package's."""
    _, jvio, ref = run("jax", 3.0, marg_on_host=False)
    _, tvio, out = run("torch", 3.0, marg_on_host=False)
    assert len(out) == len(ref) >= 18
    assert [r[2] for r in out] == [r[2] for r in ref]
    assert [r[3] == 0 for r in out[2:]] == [r[3] == 0 for r in ref[2:]]
    gap = max(float(np.linalg.norm(a[0] - b[0])) for a, b in zip(ref, out))
    assert gap < POSE_GAP_M, gap
    assert abs(tvio.traj.line_delay - jvio.traj.line_delay) < LD_GAP_S


# ---------------------------------------------------------------------------
# every option of the reference's configurations exists in the port
# ---------------------------------------------------------------------------

# fields of the JAX package's configurations that the port leaves out on
# purpose, each with its reason (ROADMAP.md lists them too)
NOT_PORTED = {
    ("TrackerConfig", "use_pallas"):
        "the port's kernel rule: K1 runs for CUDA tensors and its plain "
        "version for CPU tensors, with no switch between them",
}
PAIRS = [
    (jodometry.VIOConfig, todometry.VIOConfig),
    (jtracker.TrackerConfig, ttracker.TrackerConfig),
    (jklt.KLTConfig, tklt.KLTConfig),
    (jsynthetic.SimConfig, tsynthetic.SimConfig),
    (jlayout.WindowConfig, tlayout.WindowConfig),
    (jlayout.SolveOptions, tlayout.SolveOptions),
]
_NO_DEFAULT = object()


def defaults(cls):
    """{field: default} of a dataclass or NamedTuple class."""
    if dataclasses.is_dataclass(cls):
        out = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                out[f.name] = f.default_factory()
            else:
                out[f.name] = _NO_DEFAULT
        return out
    return {k: cls._field_defaults.get(k, _NO_DEFAULT) for k in cls._fields}


def plain(x):
    """x as a comparable python value when it is a plain value (numbers,
    strings, None, and tuples of them, NamedTuples included); None
    otherwise (dtypes, arrays)."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return ("value", x)
    if isinstance(x, tuple):
        items = [plain(v) for v in x]
        return None if None in items else ("tuple", tuple(items))
    return None


@pytest.mark.parametrize("ref,port", PAIRS, ids=[p[0].__name__ for p in PAIRS])
def test_every_reference_option_is_in_the_port(ref, port):
    """Every field of the JAX package's configuration exists in the port's
    counterpart (bar NOT_PORTED), with an equal default wherever both
    defaults are plain values; the port may add options of its own."""
    want, have = defaults(ref), defaults(port)
    gaps = {(ref.__name__, k) for k in want} - {
        (ref.__name__, k) for k in have}
    assert gaps == {g for g in NOT_PORTED if g[0] == ref.__name__}
    for k in want.keys() & have.keys():
        a, b = plain(want[k]), plain(have[k])
        if a is not None and b is not None:
            assert a == b, (ref.__name__, k, want[k], have[k])
        else:
            assert (a is None) == (b is None), (ref.__name__, k)


def test_default_solve_dtype_is_float32_in_both():
    """The one default that is not a plain value: the solve dtype, numpy's
    in the JAX package and torch's in the port, float32 in both."""
    assert np.dtype(jodometry.VIOConfig().dtype) == np.float32
    assert todometry.VIOConfig().dtype == torch.float32
