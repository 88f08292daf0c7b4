"""The front end's F-RANSAC gate on the step's state (`ops/fgate.py`: K7's
plain version, which CPU tensors take) on the CPU, against the JAX
package's host gate `ctrlvio_tpu/frontend/fransac.py::reject_with_f`:

- the plain version's rejections equal the slots `reject_with_f` rejects
  among the common tracks, bit for bit, in `tests/test_fransac.py`'s three
  cases and in two-view sets of 12, 13, 40 and 150 tracks among 150 slots
  (`sim/windows.py::fgate_case`: no outliers, 30 % gross outliers, a tie
  in the hypotheses' inlier counts, a rigid cluster moving against the
  scene);
- the sample table's row n is `reject_with_f`'s draw for n tracks;
- the fused tracker with the gate in its step, at lag 0 and 1, on the
  lagged tests' scene with its moving quad: the JAX package's tracker's
  published ids and points, rejections and gated frames; replayed through
  the CPU stand-in for captured programs, the eager tracker's frames bit
  for bit, the plain gate counted once a step through replays.

Tolerances: masks and ids exactly; published points within 1e-3 px, as
`tests/test_torch_tracker.py` holds them (the plain LK sums its patch in
another order than JAX)."""

import contextlib

import numpy as np
import pytest
import torch

from ctrlvio_tpu.frontend import fransac as jfransac
from ctrlvio_tpu.frontend.fused import FusedTracker as JFusedTracker
from ctrlvio_tpu.frontend.klt import KLTConfig as JKLTConfig
from ctrlvio_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
from ctrlvio_tpu.models import cameras as jcam
from ctrlvio_tpu_torch.frontend.fused import FusedTracker, rotation_flow
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig
from ctrlvio_tpu_torch.ops import fgate as fg
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim.windows import FGATE_KINDS, fgate_case
from ctrlvio_tpu_torch.utils import graphs
from tests.test_torch_frontend_lagged import (CAM, TRACKER, H, W,  # noqa: F401
                                             scene)
from tests.test_fransac import _two_view
from tests.torch_graph_standin import replayed_programs
from tests.torch_parity import one_torch_thread  # noqa: F401

N = 150
PX_TOL = 1e-3  # px, published points
# a seed for each n whose hypotheses tie at the most inliers with masks
# that differ, so that the lowest index decides
TIE_SEEDS = {12: 0, 13: 3, 40: 5, 150: 1}


@pytest.fixture(scope="module")
def table():
    return torch.from_numpy(fg.sample_table(N).copy())


def common(case):
    """The common tracks' slots of a case, in slot order."""
    supp1 = case["suppress"] & ~case["refilled"]
    return torch.nonzero(case["tracked"] & case["prev_pub"]
                         & ~supp1).flatten()


def expected(case, thresh):
    """(bad, suppress_out, prev_pub_out) with `reject_with_f` (the JAX
    package's) as the gate."""
    idx = common(case).numpy()
    bad = np.zeros(case["norm"].shape[0], bool)
    if len(idx) >= fg.MIN_TRACKS:
        inl = jfransac.reject_with_f(
            case["prev_norm"].numpy().astype(np.float64)[idx],
            case["norm"].numpy().astype(np.float64)[idx], thresh_px=thresh)
        bad[idx[~inl]] = True
    supp = (case["suppress"] & ~case["refilled"]).numpy() | bad
    return bad, supp, case["live"].numpy() & ~supp


def fransac_cases():
    """`tests/test_fransac.py`'s three cases: gross outliers, noise only,
    a degenerate set of five."""
    p0, p1 = _two_view()
    bad = np.zeros(len(p0), bool)
    bad[::9] = True
    p1c = p1.copy()
    p1c[bad] += np.random.default_rng(7).uniform(0.05, 0.2, (bad.sum(), 2))
    q0, q1 = _two_view(seed=5)
    q1n = q1 + np.random.default_rng(11).normal(0, 0.3 / 460.0, q1.shape)
    d0 = np.random.default_rng(0).normal(0, 0.3, (5, 2))
    return [(p0, p1c, 1.0, 0), (q0, q1n, 1.5, 0), (d0, d0 + 0.01, 1.0, 0)]


def placed(p0, p1, seed):
    """`fgate_case`'s other slots at N, with the points p0 -> p1 (n, 2)
    placed in its common slots."""
    n = len(p0)
    case = fgate_case(N, n, "clean", seed)
    idx = common(case)
    case["prev_norm"][idx] = torch.from_numpy(p0).float()
    case["norm"][idx] = torch.from_numpy(p1).float()
    return case


def assert_gate_matches(case, table, thresh):
    want = expected(case, thresh)
    calls = fg.fgate_plain.calls
    got = fg.fgate(**case, table=table, thresh=thresh)
    assert fg.fgate_plain.calls == calls + 1
    for g, w, name in zip(got, want, ("bad", "suppress", "prev_pub")):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    return want[0]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_plain_gate_matches_reject_with_f_fransac_cases(table, k):
    """`tests/test_fransac.py`'s cases placed among 150 slots: gross
    outliers (rejected), noise only, a set of five (below MIN_TRACKS:
    nothing rejected)."""
    a, b, thresh, _ = fransac_cases()[k]
    bad = assert_gate_matches(placed(a, b, seed=k), table, thresh)
    assert bad.any() == (k == 0)


@pytest.mark.parametrize("kind", FGATE_KINDS)
@pytest.mark.parametrize("n", [12, 13, 40, 150])
def test_plain_gate_matches_reject_with_f(table, n, kind):
    seed = (TIE_SEEDS[n] if kind == "tie"
            else 10 * n + FGATE_KINDS.index(kind))
    case = fgate_case(N, n, kind, seed)
    assert len(common(case)) == n
    if kind == "tie":
        idx = common(case)
        inl = fg.gate_mask_plain(
            case["prev_norm"][idx].double() * fg.VIRTUAL_FOCAL,
            case["norm"][idx].double() * fg.VIRTUAL_FOCAL, table[n].long(),
            1.0)[2]
        cnt = inl.sum(dim=1)
        top = torch.nonzero(cnt == cnt.max()).flatten().tolist()
        assert len({tuple(inl[h].tolist()) for h in top}) >= 2
    bad = assert_gate_matches(case, table, 1.0)
    if kind == "outliers":
        assert bad.sum() >= 2


def test_sample_table_is_reject_with_fs_draw():
    t = fg.sample_table(N)
    assert t.shape == (N + 1, fg.HYPS, fg.SAMPLE) and t.dtype == np.uint8
    assert not t[: fg.MIN_TRACKS].any()
    for n in range(fg.MIN_TRACKS, N + 1):
        rng = np.random.default_rng(0)
        want = np.argsort(rng.random((fg.HYPS, n)), axis=1)[:, :fg.SAMPLE]
        np.testing.assert_array_equal(t[n], want, err_msg=f"n = {n}")
    with pytest.raises(ValueError):
        fg.sample_table(fg.MAX_N + 1)


# ---------------------------------------------------------------------------
# the fused tracker
# ---------------------------------------------------------------------------


def drive(tracker, sim, imgs):
    """Every frame through `step` with the gyro-predicted rotation, then
    `flush`: the published dicts."""
    R = so3np.quat_to_matrix(
        so3np.quat_exp(np.asarray(sim.cfg.ext_rot))[None])[0]
    outs, prev = [], None
    for i, fr in enumerate(sim.frames):
        M = None if prev is None else rotation_flow(
            sim.imu_t_ns, sim.gyro, prev, fr.t_ns, R)
        prev = fr.t_ns
        outs.append(tracker.step(fr.t_ns, imgs[i], R_rel=M))
    outs.append(tracker.flush())
    return [o for o in outs if o is not None]


def jax_tracker(lag):
    cfg = dict(TRACKER)
    klt = cfg.pop("klt")
    return JFusedTracker(JTrackerConfig(
        **cfg, klt=JKLTConfig(pred_levels=klt.pred_levels)),
        jcam.Equidistant(**CAM), (H, W), lag=lag)


@pytest.mark.parametrize("lag", [0, 1])
def test_gated_tracker_matches_jax(scene, lag, monkeypatch):
    """The gate in the step: each published frame's ids and points as the
    JAX package's tracker publishes them with its host gate; the same
    rejections (the quad makes the gate fire) and the same frames gated
    (those on which the JAX tracker called its gate); one plain gate a
    step."""
    sim, cam, imgs = scene
    gated = []
    real = jfransac.reject_with_f

    def counted(*args, **kw):
        gated.append(len(args[0]))
        return real(*args, **kw)

    monkeypatch.setattr(jfransac, "reject_with_f", counted)
    jtr = jax_tracker(lag)
    ref = drive(jtr, sim, imgs)
    calls = fg.fgate_plain.calls
    tr = FusedTracker(TrackerConfig(**TRACKER), cam, (H, W), lag=lag,
                      device="cpu")
    out = drive(tr, sim, imgs)
    assert fg.fgate_plain.calls - calls == len(sim.frames)
    assert len(out) == len(ref) == len(sim.frames)
    for a, b in zip(ref, out):
        assert b["t_ns"] == a["t_ns"]
        np.testing.assert_array_equal(b["ids"], a["ids"])
        np.testing.assert_allclose(b["uv"], a["uv"], rtol=0, atol=PX_TOL)
    assert tr.counts["rejected"] == jtr.n_rejected > 0
    assert tr.counts["gated"] == len(gated) > 0
    assert min(gated) >= fg.MIN_TRACKS


@pytest.mark.parametrize("lag", [0, 1])
def test_gated_tracker_replayed_equals_eager(scene, lag):
    """The gated step's program through the CPU stand-in for captured
    programs: the eager tracker's frames bit for bit, its rejections and
    gated frames; the plain gate counted once a step by replays and once
    by the warm-up before the step's capture."""
    sim, cam, imgs = scene
    runs = []
    for replayed in (False, True):
        ctx = (replayed_programs() if replayed
               else contextlib.nullcontext())
        with ctx:
            fg.reset_counts()
            graphs.reset_counts()
            tr = FusedTracker(TrackerConfig(**TRACKER), cam, (H, W),
                              lag=lag, device="cpu")
            outs = drive(tr, sim, imgs)
            st = graphs.stats()
            runs.append((outs, dict(tr.counts), fg.fgate_plain.calls, st))
    (eager, c_e, n_e, _), (got, c_r, n_r, st) = runs
    assert len(got) == len(eager) == len(sim.frames)
    for a, b in zip(got, eager):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert c_r == c_e and c_e["rejected"] > 0 and c_e["gated"] > 0
    n = len(sim.frames)
    assert n_e == n
    assert st["launches_replayed"]["fgate_plain"] == n
    assert st["launches_warm_up"]["fgate_plain"] == 1
    assert n_r == n + 1
