"""The port's batched serving path on the CPU, float64: the prior roll and
the square-root marginalization with their shifts and dropped-knot count
as tensors (equal to the python-int form, bit for bit, and the roll to
the JAX package's), the branch-free megastep (equal to the host-branched
one on both slide branches of `tests/torch_stream_case.py`), a batch of
one MARGIN_OLD lane and one MARGIN_SECOND_NEW lane through one vmapped
megastep (each lane against the JAX megastep at `MEGA_RTOL`, no vmap
fallback), the dispatch hook's knot-seed rule, and a short
`BatchedStream` run whose lanes equal solo streams (within 1e-5 m, as
`tests/test_stream_batch.py` holds the JAX package's). Slow: the same
run against the JAX package's `BatchedStream`."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import stream as jstream
from ctrlvio_tpu.ops import factors as JF
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import marginalize as jmarg
from ctrlvio_tpu_torch.estimator import stream as tstream
from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.parallel import batch
from ctrlvio_tpu_torch.parallel.stream_batch import (BatchedStream,
                                                     batched_megastep)
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.solver import marginalize as tmarg
from ctrlvio_tpu_torch.utils.convert import tensor
from tests.torch_parity import close, one_torch_thread  # noqa: F401
from tests.torch_stream_case import CFG, OPTS, build_case, port_args

JCFG = jlayout.WindowConfig(*CFG)
MEGA_RTOL = 1e-6  # tests/test_torch_stream.py's


@pytest.fixture(scope="module")
def cases():
    return [build_case(True), build_case(False)]


def _equal(a, b):
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shifts", [(0, 0), (1, 1), (3, 1), (CFG.KW + 2,
                                                             CFG.NB)])
def test_roll_prior_tensor_shifts_equal_int_form(cases, shifts):
    """Shifts as device tensors give the python-int form's prior bit for
    bit, and both equal the JAX package's roll."""
    prior = tlayout.PriorFactor(*(tensor(x, "cpu", torch.float64)
                                  for x in cases[0]["prior"]))
    ks, bs = shifts
    a = tmarg.roll_prior(prior, ks, bs, CFG)
    b = tmarg.roll_prior(prior, torch.tensor(ks), torch.tensor(bs), CFG)
    _equal(a, b)
    j = jmarg.roll_prior(jlayout.PriorFactor(*cases[0]["prior"]), ks, bs,
                         JCFG)
    for x, y in zip(j, a):
        close(x, y, rtol=0.0)


def test_build_prior_sqrt_tensor_counts_equal_int_form(cases):
    """The square-root marginalization of the MARGIN_OLD case with the knot
    shift, bias shift and dropped-knot count as python ints, as tensors,
    and with the count left to the device: the same prior and overflow
    counts bit for bit."""
    case = cases[0]
    (state, blob, ext, g, info, w, cfg, _), _ = port_args(case, "cpu",
                                                          torch.float64)
    img, imu, bias = tstream.unpack_stream_blob(blob, cfg, torch.float64)[:3]
    drop = tstream.unpack_stream_blob(blob, cfg, torch.float64)[9]
    ks = case["knot_shift"]
    assert ks > 0
    opts = tlayout.SolveOptions(cauchy_c=1.0)

    def run(knot_shift, bias_shift, n_drop):
        return tmarg.build_prior_sqrt(
            state.params, img, imu, bias, state.prior, drop, ext, g, info,
            w, cfg, opts, knot_shift=knot_shift, bias_shift=bias_shift,
            return_overflow=True, n_drop_knots=n_drop)

    ref = run(ks, 1, ks)
    _equal(ref, run(torch.tensor(ks), torch.tensor(1), torch.tensor(ks)))
    _equal(ref, run(ks, 1, None))


def test_branchless_megastep_equals_host_branched(cases):
    """Directives read on the device (both slides and both seed sources
    computed, selected per field) give the host-branched megastep's state
    and summary bit for bit, on both slide branches."""
    for case in cases:
        args, kw = port_args(case, "cpu", torch.float64)
        _equal(tstream.megastep(*args, **kw),
               tstream.megastep_branchless(*args))


def test_mixed_batch_matches_jax_lane_by_lane(cases):
    """One MARGIN_OLD lane and one MARGIN_SECOND_NEW lane through one
    vmapped megastep: each lane's next state, summary and prior equal the
    JAX megastep's on that lane's inputs; vmap warns of no fallback to a
    per-lane loop."""
    pa = [port_args(c, "cpu", torch.float64)[0] for c in cases]
    _, _, ext, g, info, w, cfg, opts = pa[0]
    mega = batched_megastep(cfg, opts)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        st_b, sum_b = mega(batch.stack([a[0] for a in pa]),
                           torch.stack([a[1] for a in pa]), ext, g, info, w)
    assert not [x for x in caught if "performance drop" in str(x.message)]

    jmega = jax.jit(jstream.megastep, static_argnums=(6, 7))
    for i, case in enumerate(cases):
        c = case["consts"]
        st_j, sum_j = jmega(
            jstream.DevState(
                params=jlayout.WindowParams(*(jnp.asarray(x)
                                              for x in case["state"])),
                prior=jlayout.PriorFactor(*(jnp.asarray(x)
                                            for x in case["prior"]))),
            jnp.asarray(case["blob"]),
            JF.CamExtrinsics(*(jnp.asarray(x) for x in c["ext"])),
            jnp.asarray(c["gravity"]), jnp.asarray(c["info"]),
            jnp.asarray(c["w"]), JCFG, jlayout.SolveOptions(**OPTS))
        s_j = jstream.unpack_summary(np.asarray(sum_j), JCFG)
        s_t = tstream.unpack_summary(sum_b[i].numpy(), CFG)
        assert s_t["accepted"] == s_j["accepted"] >= 1
        for k in ("knots_q", "knots_p", "bg", "ba", "dinv", "rms", "marg_ovf",
                  "ld", "cost0", "cost"):
            close(s_j[k], s_t[k], MEGA_RTOL)
        for a, b in zip(st_j.params, st_b.params):
            close(a, b[i], MEGA_RTOL)
        Jj, rj = np.asarray(st_j.prior.J), np.asarray(st_j.prior.r0)
        Jt, rt = st_b.prior.J[i].numpy(), st_b.prior.r0[i].numpy()
        close(Jj.T @ Jj, Jt.T @ Jt, MEGA_RTOL)
        close(Jj.T @ rj, Jt.T @ rt, MEGA_RTOL)
        for a, b in zip(st_j.prior[2:], st_b.prior[2:]):
            close(a, b[i], MEGA_RTOL)
    # the second-new lane's prior rides through unchanged
    close(cases[1]["prior"][0], st_b.prior.J[1], 0.0)


# ---------------------------------------------------------------------------
# a short served run: two lanes, one keyframing every frame and one only
# when its tracks run short (parallax threshold out of reach), f64, four
# LM iterations a frame
# ---------------------------------------------------------------------------

SERVE_CFG = dict(
    window_config=tlayout.WindowConfig(KW=24, NB=5, LM=64, OBS=192,
                                       MIMU=128),
    fix_ld=False, ld_init=0.0, stream=True, stream_lag=2, stream_warmup=2,
    imu_overflow="subsample", ba_iters=4, init_ba_iters=8)
SERVE_S = 1.6
MIN_PARALLAX = (10.0 / 460.0, 0.2)


def _sims():
    return [synthetic.generate(synthetic.SimConfig(
        duration=SERVE_S, n_landmarks=300, seed=s)) for s in (11, 12)]


def _port_vio(sim, min_parallax, device="cpu"):
    vio = CtrlVIO(VIOConfig(**SERVE_CFG, dtype=torch.float64,
                            min_parallax=min_parallax),
                  so3np.quat_exp(np.array(sim.cfg.ext_rot)),
                  np.array(sim.cfg.ext_pos), device=device)
    init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    return vio


def _positions(vio, sim, first=5):
    base = vio.data_start_ns or 0
    return np.stack([vio.traj.pose(f.t_ns - base)[1][0]
                     for f in sim.frames[first:]])


@pytest.fixture(scope="module")
def served():
    """The two-lane run through BatchedStream, and the keyframe decision
    of each lane on each batched step."""
    sims = _sims()
    vios = [_port_vio(s, mp) for s, mp in zip(sims, MIN_PARALLAX)]
    coord = BatchedStream(vios)
    n = min(len(s.frames) for s in sims)
    flags = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k in range(n):
            steps = coord._n_steps
            coord.step([(s.frames[k].t_ns, s.frames[k].ids, s.frames[k].pts,
                         s.frames[k].rows) for s in sims])
            if coord._n_steps > steps:
                flags.append([v.marg_flag for v in vios])
        coord.flush()
    fallback = [x for x in caught if "performance drop" in str(x.message)]
    return dict(sims=sims, vios=vios, coord=coord, flags=flags, n=n,
                fallback=fallback)


def test_hooked_dispatch_takes_host_seeds_once():
    """A hooked instance holds no device state of its own: its first
    streamed dispatch uploads the mirror's knot seeds (the handoff), every
    later one seeds on the device, and nothing is dispatched by itself."""
    sim = _sims()[0]
    vio = _port_vio(sim, MIN_PARALLAX[0])
    calls = []
    vio._dispatch_hook = lambda v, blob, host_seeds, meta: calls.append(
        (host_seeds, float(blob[-1])))
    for fr in sim.frames[:10]:
        vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
    assert len(calls) >= 2
    assert calls[0] == (True, 1.0)
    assert all(c == (False, 0.0) for c in calls[1:])
    assert vio._dev_state is None and vio.counts["megastep"] == 0
    assert vio.counts["sync_solve_after_handoff"] == 0


def test_batched_stream_lanes_equal_solo_streams(served):
    """Lockstep batched steps over lanes whose keyframe decisions differ,
    each lane equal to its own solo stream (the host-branched megastep)
    within 1e-5 m, every frame after the warmup served by a batched step,
    and no vmap fallback."""
    sims, vios, coord = served["sims"], served["vios"], served["coord"]
    assert not served["fallback"]
    assert coord._n_steps >= 4
    # MARGIN_OLD beside MARGIN_SECOND_NEW in one call
    assert [0, 1] in served["flags"]
    for lane, (vio, sim) in enumerate(zip(vios, sims)):
        assert vio.counts["megastep"] == coord._n_steps
        assert vio.counts["sync_solve_after_handoff"] == 0
        solo = _port_vio(sim, MIN_PARALLAX[lane])
        for fr in sim.frames[: served["n"]]:
            solo.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        solo.flush()
        assert solo.counts["megastep"] == coord._n_steps
        assert np.abs(_positions(vio, sim) - _positions(solo, sim)).max() \
            < 1e-5
        assert abs(vio.traj.line_delay - solo.traj.line_delay) < 1e-9
    assert set(coord.timing) == {"host_lanes", "stack_upload", "dispatch",
                                 "complete"}
    assert coord.device_steady_ms(reps=1) > 0.0


@pytest.mark.slow
def test_batched_stream_matches_jax(served):
    """The same two lanes through the JAX package's BatchedStream (f64):
    each lane's trajectory within 1e-6 m of the port's and the same line
    delay to 1e-10 s. Slow: JAX compiles its vmapped megastep for minutes
    on the CPU."""
    from ctrlvio_tpu.estimator.initializer import \
        bootstrap_from_sim as jbootstrap
    from ctrlvio_tpu.estimator.odometry import CtrlVIO as JVIO
    from ctrlvio_tpu.estimator.odometry import VIOConfig as JConfig
    from ctrlvio_tpu.parallel.stream_batch import BatchedStream as JBatched

    sims = served["sims"]
    jcfg = dict(SERVE_CFG, window_config=jlayout.WindowConfig(
        *SERVE_CFG["window_config"]))
    jvios = []
    for sim, mp in zip(sims, MIN_PARALLAX):
        v = JVIO(JConfig(**jcfg, dtype=np.float64, min_parallax=mp),
                 so3np.quat_exp(np.array(sim.cfg.ext_rot)),
                 np.array(sim.cfg.ext_pos))
        init = jbootstrap(sim)
        for k in range(len(sim.imu_t_ns)):
            v.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
        v.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                            init.gravity, v0=init.v)
        jvios.append(v)
    jcoord = JBatched(jvios)
    for k in range(served["n"]):
        jcoord.step([(s.frames[k].t_ns, s.frames[k].ids, s.frames[k].pts,
                      s.frames[k].rows) for s in sims])
    jcoord.flush()
    assert jcoord._n_steps == served["coord"]._n_steps
    for jv, tv, sim in zip(jvios, served["vios"], sims):
        assert np.abs(_positions(jv, sim) - _positions(tv, sim)).max() < 1e-6
        assert abs(jv.traj.line_delay - tv.traj.line_delay) < 1e-10
