"""The captured programs (`ctrlvio_tpu_torch/utils/graphs.py`) on the card:
each replayed program against an eager call of its function on the same
inputs, no synchronizing call in staging and replay, and a capture that
cannot hold its function raising instead of running it eagerly.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so that it runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_graphs_gpu.py -q -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.estimator import stream
from ctrlvio_tpu_torch.estimator.odometry import (blob_pack, marg_prior,
                                                  window_solve)
from ctrlvio_tpu_torch.parallel import batch
from ctrlvio_tpu_torch.parallel.stream_batch import batched_megastep
from ctrlvio_tpu_torch.solver import layout
from ctrlvio_tpu_torch.utils import graphs
from ctrlvio_tpu_torch.utils.convert import to_dtype
from ctrlvio_tpu_torch.utils.device import recorded_syncs
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls
# imported by its own name: on a machine where another package provides a
# top-level `tests`, `tests.torch_stream_case` does not resolve
from torch_stream_case import CFG, OPTS, build_case, port_args

pytestmark = pytest.mark.gpu
ROOT = Path(__file__).resolve().parents[1]

# a replay against an eager call on one card: the same kernels, but
# CUDA's atomic `index_add` sums in another order on each run, and the
# LM iterations amplify that; the tolerances of
# `tests/test_torch_stream_gpu.py` (card against CPU): knots and biases
# 1e-3 absolute, inverse depths, line delay and the prior's J^T J 1e-3 of
# their largest entry, the prior's gradient J^T r0 1e-2
TOL_STATE = 1e-3
TOL_REL = 1e-3
TOL_GRAD = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the programs are CUDA graphs")
    pin_f32_matmuls()
    return torch.device("cuda")


def _abs(a, b):
    return float((a.double() - b.double()).abs().max())


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _prior_close(got, ref):
    Jg, Jr = got.J.double(), ref.J.double()
    assert _rel(Jg.T @ Jg, Jr.T @ Jr) <= TOL_REL
    assert _rel(Jg.T @ got.r0.double(), Jr.T @ ref.r0.double()) <= TOL_GRAD


def _state_close(got, ref):
    for a, b in zip(got.params[:4], ref.params[:4]):
        assert _abs(a, b) <= TOL_STATE
    assert _rel(got.params.dinv, ref.params.dinv) <= TOL_REL
    _prior_close(got.prior, ref.prior)


def _summary_close(got, ref):
    g = stream.unpack_summary(got.double().cpu().numpy(), CFG)
    r = stream.unpack_summary(ref.double().cpu().numpy(), CFG)
    for k in ("knots_q", "knots_p", "bg", "ba"):
        assert np.abs(g[k] - r[k]).max() <= TOL_STATE, k
    assert g["accepted"] == r["accepted"]


def _megastep(case, cuda):
    args, kw = port_args(case, cuda, torch.float32)
    static = dict(cfg=args[6], opts=args[7], marg_old=kw["marg_old"],
                  host_seeds=kw["host_seeds"])
    return args[:6], static


@pytest.mark.parametrize("marg_old", [True, False])
def test_megastep_program_matches_eager(cuda, marg_old):
    """The solo megastep's program (the window roll read from the blob on
    the device), replayed twice from the same state, against the eager
    call with the host's int shift."""
    case = build_case(marg_old)
    args, static = _megastep(case, cuda)
    ref_state, ref_sum = stream.megastep(*args, **static,
                                         knot_shift=case["knot_shift"])
    prog = graphs.ProgramCache().get(stream.megastep, args, cuda, static,
                                     carry=True)
    for _ in range(2):
        state, summ = prog(*args)
        torch.cuda.synchronize()
        _state_close(state, ref_state)
        _summary_close(summ, ref_sum)
    assert prog.replays == 2


@pytest.mark.parametrize("marg_old", [True, False])
def test_megastep_program_launches_k6_once_a_replay(cuda, marg_old):
    """K6 (the QR prior's kernel) inside the captured megastep: its launch
    count rises by one a replay of the megastep that marginalizes the
    oldest keyframe, and by none a replay of the one that does not."""
    from ctrlvio_tpu_torch.ops import qr_prior
    args, static = _megastep(build_case(marg_old), cuda)
    prog = graphs.ProgramCache().get(stream.megastep, args, cuda, static,
                                     carry=True)
    prog(*args)
    torch.cuda.synchronize()
    qr_prior.reset_counts()
    for _ in range(3):
        prog(*args)
    torch.cuda.synchronize()
    assert qr_prior.counts()["qr_prior_r"] == (3 if marg_old else 0)


def test_batched_program_matches_eager(cuda, deterministic):
    """The batched megastep's program over a MARGIN_OLD lane and a
    MARGIN_SECOND_NEW lane against the eager vmapped call, both under
    deterministic algorithms (CUDA's atomic `index_add` sums in another
    order on each run otherwise, which the LM iterations amplify)."""
    pa = [port_args(build_case(m), cuda, torch.float32)[0]
          for m in (True, False)]
    _, _, ext, g, info, w, cfg, opts = pa[0]
    mega = batched_megastep(cfg, opts)
    args = (batch.stack([a[0] for a in pa]), torch.stack([a[1] for a in pa]),
            ext, g, info, w)
    ref_state, ref_sum = mega(*args)
    state, summ = graphs.ProgramCache().get(mega, args, cuda,
                                            carry=True)(*args)
    torch.cuda.synchronize()
    for i in range(2):
        _state_close(_lane(state, i), _lane(ref_state, i))
        _summary_close(summ[i], ref_sum[i])


def _lane(t, i):
    return type(t)(*(_lane(x, i) if isinstance(x, tuple) else x[i]
                     for x in t))


def _sync_inputs(case, cuda, dtype=torch.float32):
    """The case's factors and state as the synchronous path's blob (f32,
    or `dtype`), its prior, the four constants, and the dropped knots."""
    args, _ = port_args(case, "cpu", torch.float64)
    img, imu, bias, fixed, *_, drop, _ = stream.unpack_stream_blob(
        args[1], CFG, torch.float64)
    npy = lambda t: type(t)(*(x.numpy() for x in t))
    img, imu, bias = npy(img), npy(imu), npy(bias)
    p = case["state"]
    npdt = np.float64 if dtype == torch.float64 else np.float32
    blob = blob_pack(img, imu, bias, p[0], p[1], p[2], p[3], p[4], p[5],
                     fixed.numpy(), npdt)
    consts = tuple(to_dtype(x, dtype) if isinstance(x, tuple)
                   else x.to(dtype) for x in args[2:6])
    prior = layout.PriorFactor(*(torch.tensor(x, dtype=dtype)
                                 for x in case["prior"]))
    dev = lambda t: graphs.tree_map(lambda x: x.to(cuda), t)
    return (img, imu, bias, p, drop.numpy(), torch.from_numpy(blob),
            dev(prior), dev(consts))


@pytest.mark.parametrize("restore", [True, False])
def test_window_solve_program_matches_eager(cuda, restore):
    """The synchronous window solve (`restore`: with the gauge restore, as
    each frame; without, as the bootstrap's predict) replayed from a
    pinned blob against the eager call."""
    *_, blob, prior, consts = _sync_inputs(build_case(True), cuda)
    static = dict(cfg=CFG, opts=layout.SolveOptions(**OPTS),
                  ne_mode="chunked", chunk=None, restore=restore)
    pinned = blob.pin_memory()
    ref = window_solve(blob.to(cuda), prior, *consts, **static)
    args = (pinned, prior, *consts)
    got = graphs.ProgramCache().get(window_solve, args, cuda, static)(*args)
    torch.cuda.synchronize()
    assert _abs(got[: 7 * CFG.KW], ref[: 7 * CFG.KW]) <= TOL_STATE
    assert torch.equal(got[-2:], ref[-2:])  # accepted steps, iterations


def test_prior_program_matches_eager_at_two_shifts(cuda):
    """The f64 prior build with its knot shift in the upload: one program
    replayed at shifts 1 and 3, each against the eager call."""
    img, imu, bias, p, drop, _, prior, consts = _sync_inputs(
        build_case(True), cuda)
    old = to_dtype(prior, torch.float64)
    static = dict(cfg=CFG, opts=layout.SolveOptions(**OPTS, cauchy_c=1.0))
    cache = graphs.ProgramCache()
    ext, gravity, info, w = consts
    for shift in (1, 3):
        blob = torch.from_numpy(blob_pack(
            img, imu, bias, p[0], p[1], p[2], p[3], p[4], p[5], drop,
            np.float64, tail=(*gravity.cpu().double().numpy(), shift, 1)))
        ref = marg_prior(blob.to(cuda), old, ext, info, w, **static)
        args = (blob.pin_memory(), old, ext, info, w)
        got = cache.get(marg_prior, args, cuda, static)(*args)
        torch.cuda.synchronize()
        _prior_close(got, ref)
        for a, b in zip(got[2:], ref[2:]):  # the rolled linearization point
            assert _abs(a, b) <= 1e-12
    assert len(cache) == 1


def test_staging_and_replay_make_no_synchronizing_call(cuda):
    """Sync debug mode "warn" over a captured megastep's call from a
    pinned blob (its copy in and its replay): no synchronizing call."""
    args, static = _megastep(build_case(True), cuda)
    args = (args[0], args[1].cpu().pin_memory(), *args[2:])
    prog = graphs.ProgramCache().get(stream.megastep, args, cuda, static,
                                     carry=True)
    torch.cuda.synchronize()
    with recorded_syncs() as msgs:
        state, _ = prog(*args)
        prog(state, *args[1:])
    torch.cuda.synchronize()
    assert msgs == []


def test_fused_tracker_program_matches_eager(cuda, monkeypatch):
    """The fused front end's programs (first-frame pyramid, and the step
    with K1 inside) over 10 textured frames against the eager tracker on
    the card: the same published ids, points within 1e-3 px; K1 launched
    once a frame by replays, plus once by the warm-up before capture."""
    from ctrlvio_tpu_torch.frontend.fused import FusedTracker, rotation_flow
    from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig
    from ctrlvio_tpu_torch.models import cameras
    from ctrlvio_tpu_torch.ops import lk, so3np
    from ctrlvio_tpu_torch.sim import render, synthetic

    H, W, FX = 256, 320, 200.0
    s = synthetic.generate(synthetic.SimConfig(
        duration=1.0, n_landmarks=50, seed=5, image_h=H, image_w=W, fx=FX,
        fy=FX, cx=W / 2, cy=H / 2))
    cam = cameras.Pinhole(FX, FX, W / 2, H / 2)
    imgs = render.render_textured_sequence(s, H, W, cam, seed=2)
    R = so3np.quat_to_matrix(
        so3np.quat_exp(np.asarray(s.cfg.ext_rot))[None])[0]

    def track():
        tracker = FusedTracker(TrackerConfig(max_cnt=80, min_dist=12),
                               cam, (H, W), device=cuda)
        outs, prev = [], None
        for i, fr in enumerate(s.frames):
            M = None if prev is None else rotation_flow(
                s.imu_t_ns, s.gyro, prev, fr.t_ns, R)
            prev = fr.t_ns
            outs.append(tracker.step(fr.t_ns, imgs[i], R_rel=M))
        return outs

    lk.reset_counts()
    graphs.reset_counts()
    got = track()
    launches, st = lk.lk_track.launches, graphs.stats()
    monkeypatch.setattr(graphs, "graphed_on", lambda device: False)
    ref = track()
    n = len(s.frames)
    assert st["launches_replayed"]["lk_track"] == n
    assert launches == n + st["launches_warm_up"]["lk_track"] == n + 1
    for a, b in zip(got, ref):
        assert np.array_equal(a["ids"], b["ids"])
        if len(a["ids"]):
            assert np.abs(a["uv"] - b["uv"]).max() <= 1e-3


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _equal(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(graphs.leaves(a), graphs.leaves(b)))


@pytest.mark.parametrize("marg_old", [True, False])
def test_megastep_exit_nodes_bit_equal_and_skip(cuda, deterministic,
                                                marg_old):
    """The solo megastep's program with the LM's exit node, under
    deterministic algorithms: its state and summary equal the eager call's
    bit for bit (the eager call runs every iteration, the frozen ones
    changing nothing), and the replay ran the WHILE node's body for the
    iterations after the first up to `iters` only (the device counter of
    trips), K4 once before the node and once a trip."""
    args, static = _megastep(build_case(marg_old), cuda)
    ref = stream.megastep(*graphs.clone(args), **static)
    prog = graphs.ProgramCache().get(stream.megastep, graphs.clone(args),
                                     cuda, static, carry=True)
    graphs.reset_counts()
    got = prog(*graphs.clone(args))
    torch.cuda.synchronize()
    st = graphs.stats()
    iters = stream.unpack_summary(got[1].double().cpu().numpy(),
                                  CFG)["iters"]
    assert _equal(got, ref)
    assert 1 <= iters < static["opts"].max_iters
    assert st["while_trips"] == iters - 1
    assert st["launches_replayed"]["lm_accept"] == iters


def test_batched_solver_program_bit_equal(cuda, deterministic):
    """The batched window solver's program (`make_batched_solver` without
    a mesh, one program a B) against the same vmapped solve run eagerly,
    B = 4, under deterministic algorithms: equal bit for bit, twice."""
    from ctrlvio_tpu_torch.parallel import multihost
    from ctrlvio_tpu_torch.sim import tiny

    prob = tiny.tiny_problem(torch.float32, device=cuda)
    opts = layout.SolveOptions(max_iters=6)
    args = (*multihost.stacked(prob, 4), *prob.aux)
    ref = batch.batched_solve(*args, cfg=prob.cfg, opts=opts)
    solve = batch.make_batched_solver(prob.cfg, opts)
    for _ in range(2):
        got = solve(*args)
        torch.cuda.synchronize()
        assert _equal(got, ref)


def test_bootstrap_program_matches_host_exit_solve(cuda, deterministic):
    """The f64 bootstrap BA's program (`window_solve` in f64 at tol 0,
    `CtrlVIO._init_solve_f64`'s) against the host-exit `lm.solve_window`
    on the same window, restored the same way, under deterministic
    algorithms: equal bit for bit, every iteration executed."""
    from ctrlvio_tpu_torch.estimator.odometry import blob_unpack
    from ctrlvio_tpu_torch.solver import gauge, lm

    *_, blob, prior, consts = _sync_inputs(build_case(True), cuda,
                                           torch.float64)
    opts = layout.SolveOptions(**OPTS)._replace(max_iters=30, tol=0.0,
                                                solver="chol")
    static = dict(cfg=CFG, opts=opts, ne_mode="chunked", chunk=None,
                  restore=True)
    args = (blob.pin_memory(), prior, *consts)
    graphs.reset_counts()
    got = graphs.ProgramCache().get(window_solve, args, cuda,
                                    static)(*args).clone()
    torch.cuda.synchronize()
    bodies = graphs.stats()["while_trips"]
    img, imu, bias, params, fixed, _ = blob_unpack(blob.to(cuda), CFG)
    p, st = lm.solve_window(params, img, imu, bias, prior, fixed, *consts,
                            CFG, opts)
    q, pos = gauge.restore_gauge(p.knots_q, p.knots_p, params.knots_q[0],
                                 params.knots_p[0], 0, 0)
    ref = torch.cat([q.reshape(-1), pos.reshape(-1), p.bg.reshape(-1),
                     p.ba.reshape(-1), p.dinv, p.ld.reshape(1)])
    assert torch.equal(got[: ref.numel()], ref)
    assert float(got[-1]) == int(st.iters) == 30 and bodies == 29


HOST_READ_IN_NODE = """
import torch
from ctrlvio_tpu_torch.utils import graphs
calls = []
def body(c, h):
    calls.append(1)
    c.add_(float(c.sum()))
def reads_host_in_node(x):
    y = x * 2.0
    graphs.run_while(body, y, 1, graphs.while_handle(y.device))
    return y
try:
    graphs.ProgramCache().get(reads_host_in_node,
                              (torch.ones(4, device="cuda"),), "cuda")
    print("captured", len(calls))
except RuntimeError:
    print("raised", len(calls))
"""


def test_capture_of_a_host_read_in_a_node_raises(cuda):
    """A host read inside a WHILE node's body cannot be captured either:
    the capture raises (the body ran twice: the warm-up, then the
    attempted capture), in a process of its own."""
    out = subprocess.run([sys.executable, "-c", HOST_READ_IN_NODE],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.split() == ["raised", "2"], (
        out.stdout, out.stderr[-2000:])


HOST_READ = """
import torch
from ctrlvio_tpu_torch.utils import graphs
calls = []
def reads_host(x):
    calls.append(1)
    return x * float(x.sum())
try:
    graphs.ProgramCache().get(reads_host, (torch.ones(4, device="cuda"),),
                              "cuda")
    print("captured", len(calls))
except RuntimeError:
    print("raised", len(calls))
"""


def test_capture_of_a_host_read_raises(cuda):
    """A function that reads the device from the host cannot be captured:
    the capture raises, and the function is not run again eagerly in its
    place (it ran twice: the warm-up, then the attempted capture). In a
    process of its own: a failed capture may leave the card's context
    unusable for what follows."""
    out = subprocess.run([sys.executable, "-c", HOST_READ], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split() == ["raised", "2"], (
        out.stdout, out.stderr[-2000:])
