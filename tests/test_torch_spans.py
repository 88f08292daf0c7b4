"""Host spans and device stamps (`ctrlvio_tpu_torch/utils/spans.py`,
`ops/stamp.py`, `csrc/stamp.cu`).

On the CPU, through the replay stand-in (`tests/torch_graph_standin.py`):
spans nest with their parents and frames; recording changes no pose and no
`timing` key; a stamped megastep's trip stamps equal its WHILE node's
settled trips; an unstamped program holds no stamp; the clock's
arithmetic. The gpu-marked cases run the same on the card, with the
card's timer and a real WHILE node. This file imports neither JAX nor the
JAX package:

    python -m pytest tests/test_torch_spans.py -q -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.ops import stamp as stamp_op
from ctrlvio_tpu_torch.utils import graphs, spans
# imported by their own names: on a machine where another package
# provides a top-level `tests`, `tests.<helper>` does not resolve
from torch_graph_standin import (CFG, STREAM, programs, replayed_programs,
                                 sim as make_sim)
from torch_parity import one_torch_thread  # noqa: F401

# the spans a streamed frame opens, each under its parent
FRAME_TREE = {"consume": "process_frame", "add_frame": "process_frame",
              "predict": "process_frame", "triangulate": "process_frame",
              "dispatch": "process_frame", "slide": "process_frame",
              "forecast": "process_frame", "pack": "dispatch",
              "megastep": "dispatch", "upload": "megastep",
              "replay": "megastep", "enqueue_summary": "megastep",
              "consume_dr": "consume", "consume_fetch": "consume",
              "consume_apply": "consume"}


def new_vio(sim, device, **kw):
    """A CtrlVIO of the stand-in's `CFG` on `device` from the ground-truth
    bootstrap, every IMU sample fed."""
    vio = CtrlVIO(VIOConfig(**{**CFG, **kw}),
                  so3np.quat_exp(np.array(sim.cfg.ext_rot)),
                  np.array(sim.cfg.ext_pos), device=device)
    init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    return vio


def run(sim, device, record: bool, frames=None):
    """The first `frames` frames of `sim` (all by default) through a
    streamed estimator, recording or not, then `flush()`. Returns the
    estimator and its poses."""
    vio = new_vio(sim, device, **STREAM)
    vio.check_dispatch_syncs = True
    if record:
        vio.trace(True)
    poses = []
    for fr in sim.frames[:frames]:
        out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        if out is not None:
            poses.append(np.concatenate(out))
    vio.flush()
    if record:
        vio.trace(False)
    return vio, np.asarray(poses)


@pytest.fixture(scope="module")
def sim():
    return make_sim()


@pytest.fixture(scope="module")
def replayed(sim):
    """The stand-in's runs, recording off and on, and what each
    megastep program holds."""
    out = {}
    for record in (False, True):
        with replayed_programs():
            vio, poses = run(sim, "cpu", record)
            graphs.settle()
            out[record] = (vio, poses, programs(vio._programs))
    return out


def test_spans_nest_with_parents_and_frames():
    rec = spans.Recorder(frame_root="frame", capacity=8)
    with rec.span("outside"):
        pass
    rec.start()
    with rec.span("outside"):
        pass
    for _ in range(2):
        with rec.span("frame"):
            with rec.span("a"):
                with rec.span("b"):
                    assert rec.frame() == rec.frames - 1
            with rec.span("a"):
                pass
    with pytest.raises(RuntimeError):
        with rec.span("frame"):
            rec.stop()
    rec.stop()
    with rec.span("b"):
        pass
    got = rec.record()
    names = [got["names"][r[spans.NAME]] for r in got["rows"]]
    # the ring holds the newest 8 of the 10 spans begun while recording
    # (the last, a frame that tried to stop recording inside itself)
    assert rec.begun == 10 and len(names) == 8
    assert names == ["a", "b", "a", "frame", "a", "b", "a", "frame"]
    rows = got["rows"]
    parent = [names[p] if p >= 0 else None for p in rows[:, spans.PARENT]]
    # the first frame's root was overwritten: its children lose their
    # parent, not their frame
    assert parent == [None, "a", None, None, "frame", "a", "frame", None]
    assert list(rows[:, spans.FRAME]) == [0, 0, 0, 1, 1, 1, 1, 2]
    assert (rows[:, spans.END] >= rows[:, spans.START]).all()
    assert set(rec.timing) == {"outside", "frame", "a", "b"}
    assert all(v >= 0.0 for v in rec.timing.values())


def test_recording_keeps_poses_and_timing_keys(replayed):
    (vio_off, poses_off, _), (vio_on, poses_on, _) = (replayed[False],
                                                      replayed[True])
    assert len(poses_off) > 10
    assert np.array_equal(poses_on, poses_off)
    assert np.array_equal(vio_on.traj.knots_q[: vio_on.traj.n],
                          vio_off.traj.knots_q[: vio_off.traj.n])
    assert set(vio_on.timing) == set(vio_off.timing)
    assert set(FRAME_TREE) <= set(vio_on.timing)
    assert {"process_imu", "ba", "ba_pack", "ba_solve"} <= set(vio_on.timing)
    assert vio_off.trace_record()["megasteps"] is None
    assert len(vio_off.trace_record()["spans"]["rows"]) == 0
    # no host read in a recorded dispatch (the check runs on the card)
    assert vio_on.counts["megastep_syncs"] == 0


def test_recorded_spans_form_frames(replayed, sim):
    vio, _, _ = replayed[True]
    got = vio.trace_record()["spans"]
    names, rows = got["names"], got["rows"]
    name = [names[r[spans.NAME]] for r in rows]
    roots = [i for i, n in enumerate(name) if n == "process_frame"]
    assert len(roots) == len(sim.frames)
    assert [rows[i, spans.FRAME] for i in roots] == list(range(len(roots)))
    for i, n in enumerate(name):
        p = rows[i, spans.PARENT]
        if n.startswith("consume_") and p < 0:
            continue  # `flush()`'s pulls, outside any frame
        if n in FRAME_TREE:
            assert name[p] == FRAME_TREE[n], (n, name[p])
            assert rows[i, spans.FRAME] == rows[p, spans.FRAME]
            assert rows[p, spans.START] <= rows[i, spans.START]
            assert rows[i, spans.END] <= rows[p, spans.END]
        if n == "process_imu":
            assert rows[i, spans.FRAME] == -1
    # each span's seconds are in `timing`
    total = sum((r[spans.END] - r[spans.START]) * 1e-9 for r, n
                in zip(rows, name) if n == "replay")
    assert total == pytest.approx(vio.timing["replay"], rel=1e-9)


def test_stamped_megasteps_and_their_frames(replayed):
    vio, _, _ = replayed[True]
    got = vio.trace_record()
    m = got["megasteps"]
    n = vio.counts["megastep"]
    assert len(m["stamps"]) == n
    # the host's count of stamped runs is the card's
    assert list(m["seq"]) == list(m["index"]) == list(range(n))
    rows = got["spans"]["rows"]
    names = got["spans"]["names"]
    frames_dispatched = {int(r[spans.FRAME]) for r in rows
                         if names[r[spans.NAME]] == "megastep"}
    assert set(m["frame"].tolist()) == frames_dispatched
    slot = {t: i for i, t in enumerate(m["tags"])}
    st = m["stamps"]
    for k in range(n):
        order = ["start", "merged", "lm_first", "gauge"]
        if m["marg_old"][k]:
            order += ["prior_begin", "prior_end"]
        else:
            assert st[k, slot["prior_begin"]] == st[k, slot["prior_end"]] == 0
        order += ["slide", "end"]
        t = [st[k, slot[o]] for o in order]
        assert all(x > 0 for x in t) and t == sorted(t)
        trips = st[k, m["trip0"]: m["trip0"] + m["trips"][k]]
        assert list(trips) == sorted(trips)
        assert st[k, slot["lm_first"]] <= trips.min(initial=2**62)
        assert trips.max(initial=0) <= st[k, slot["gauge"]]
    assert {True, False} == set(m["marg_old"].tolist())


def test_trip_stamps_equal_settled_trips(replayed):
    vio, _, progs = replayed[True]
    m = vio.trace_record()["megasteps"]
    settled = sum(sum(p._nodes.settled) for p in progs.values())
    assert settled > 0
    assert int(m["trips"].sum()) == settled


def test_an_unstamped_program_holds_no_stamp(replayed):
    _, _, off = replayed[False]
    _, _, on = replayed[True]
    assert off and on
    for prog in off.values():
        assert not any(d.get("stamp_plain") for d in prog._held)
        assert not any(d.get("stamp_plain") for node in prog._nodes.held
                       for d in node)
    for label, prog in on.items():
        held = sum(d.get("stamp_plain", 0) for d in prog._held)
        # start, merged, lm_first, gauge, slide, end (and the prior's two)
        assert held == (8 if "marg_old=True" in label else 6), label
        trip = sum(d.get("stamp_plain", 0) for node in prog._nodes.held
                   for d in node)
        assert trip == 1


def test_eager_megasteps_stamp_every_trip(sim):
    """Without the stand-in (the CPU's eager programs) each megastep runs
    every iteration: `ba_iters - 1` trips a row."""
    vio, _ = run(sim, "cpu", True, frames=14)
    m = vio.trace_record()["megasteps"]
    assert len(m["trips"]) == vio.counts["megastep"] > 0
    assert (m["trips"] == vio.cfg.ba_iters - 1).all()


def test_clock_offset_arithmetic():
    clock = spans.Clock()
    with pytest.raises(RuntimeError):
        clock.to_host(5)
    # the stamps' clock 1,000 ns behind the host's at host time 10,000 ns,
    # 1,100 behind at 1,010,000: the offset is interpolated
    clock.calibrations = [(10_000, 1_000, 40), (1_010_000, 1_100, 60)]
    assert clock.error_ns() == 60
    dev = np.array([9_000, 509_000 - 50, 1_008_900, 0])
    assert clock.to_host(dev).tolist() == [10_000, 510_000, 1_010_000, 0]
    clock.calibrations = clock.calibrations[:1]
    assert clock.to_host(np.array([5])).tolist() == [1_005]
    # on the CPU the stamps' clock is the host's
    cpu = spans.Clock()
    host, offset, err = cpu.calibrate("cpu", n=5)
    assert 0 <= err < 5_000_000 and abs(offset) <= err + 1
    assert host > 0


def test_the_stamp_modes():
    ring = torch.zeros((2, spans.TRIP0 + 2), dtype=torch.int64)
    head = torch.zeros((1,), dtype=torch.int64)
    ring[0].fill_(7)
    stamp_op.stamp(ring, head, spans.SLOT["start"], stamp_op.START)
    for _ in range(3):
        stamp_op.stamp(ring, head, spans.TRIP0, stamp_op.TRIP)
    stamp_op.stamp(ring, head, spans.SLOT["end"], stamp_op.END)
    row = ring[0]
    assert int(head) == 1 and int(row[spans.SEQ]) == 0
    assert int(row[spans.N_TRIPS]) == 3  # the third trip has no slot
    assert (row[spans.TRIP0:] > 0).all()
    assert int(row[spans.SLOT["merged"]]) == 0  # zeroed by the start
    assert row[spans.SLOT["start"]] <= row[spans.TRIP0] <= row[
        spans.SLOT["end"]]
    stamp_op.stamp(ring, head, spans.SLOT["start"], stamp_op.START)
    assert int(ring[1, spans.SEQ]) == 1 and int(head) == 1


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamps are the card's timer")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_stamps_in_captured_while_nodes(cuda, sim):
    """A recorded streamed run on the card: no host read in a dispatch,
    every row's stamps in order, its trips the WHILE nodes' settled trips,
    the card's count of runs the host's, the clock's error within 50 us."""
    graphs.reset_counts()
    vio, poses = run(sim, cuda, True)
    assert len(poses) > 10
    assert vio.counts["megastep_syncs"] == 0, vio.sync_warnings[:3]
    got = vio.trace_record()
    m = got["megasteps"]
    n = vio.counts["megastep"]
    assert list(m["seq"]) == list(m["index"]) == list(range(n))
    slot = {t: i for i, t in enumerate(m["tags"])}
    st = m["stamps"]
    for k in range(n):
        t = [st[k, slot[o]] for o in ("start", "merged", "lm_first")]
        t += list(st[k, m["trip0"]: m["trip0"] + m["trips"][k]])
        t += [st[k, slot["gauge"]]]
        if m["marg_old"][k]:
            t += [st[k, slot["prior_begin"]], st[k, slot["prior_end"]]]
        t += [st[k, slot["slide"]], st[k, slot["end"]]]
        assert all(x > 0 for x in t) and t == sorted(t), k
    graphs.settle()
    progs = programs(vio._programs)
    settled = sum(sum(p._nodes.settled) for p in progs.values())
    assert int(m["trips"].sum()) == settled > 0
    assert got["clock_error_ns"] <= 50_000, got["clock"]
    # the stamped runs lie inside the frames that dispatched them
    rows, names = got["spans"]["rows"], got["spans"]["names"]
    frame_span = {int(r[spans.FRAME]): r for r in rows
                  if names[r[spans.NAME]] == "process_frame"}
    for k in range(n):
        f = frame_span[int(m["frame"][k])]
        assert st[k, slot["start"]] >= f[spans.START] - 50_000


@pytest.mark.gpu
def test_card_unstamped_programs_hold_no_stamp_node(cuda, sim):
    graphs.reset_counts()
    stamp_op.reset_counts()
    vio, _ = run(sim, cuda, False)
    assert vio.counts["megastep"] > 0
    for prog in programs(vio._programs).values():
        assert not any(d.get("stamp") for d in prog._held)
    assert stamp_op.counts()["stamp"] == 0
