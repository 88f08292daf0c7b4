"""The readers of the port's spans and stamps (`benchmark/spans.py`, the
metrics that read `ctx["spans"]`) on a synthetic window, None where the
port records nothing, and `benchmark/spanrun.py` on a small run on the
CPU."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, spanrun, spans

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = {k: harness.load_module(ROOT / "benchmark" / "metrics"
                                  / f"{k}.py") for k in spanrun.READERS}
MS = 1_000_000  # ns
# the port's stamp tags, in the order a megastep stamps them
TAGS = ("start", "merged", "lm_first", "gauge", "prior_begin", "prior_end",
        "slide", "end")


def megastep(start, lm_first, trips, gauge, prior, slide, end, frame):
    m = dict(start=start, merged=start + MS // 10, lm_first=lm_first,
             trips=trips, gauge=gauge, prior_begin=prior[0],
             prior_end=prior[1], slide=slide, end=end, frame=frame,
             marg_old=prior[0] > 0)
    return m


def synthetic():
    """Two calls: the first 10 ms with 4 ms of pull, its megastep 7 ms
    (two trips of 0.5 and 0.6 ms, a 4 ms prior); the second 12 ms, its
    megastep 2 ms with no trip and no prior. Traced: [0, 20) ms with two
    device operations, 1 ms each."""
    m0 = megastep(1 * MS, 2 * MS, [2.5 * MS, 3.1 * MS], 3.2 * MS,
                  (3.3 * MS, 7.3 * MS), 7.4 * MS, 8 * MS, 0)
    m1 = megastep(11 * MS, 12 * MS, [], 12.1 * MS, (0, 0), 12.2 * MS,
                  13 * MS, 1)
    return {"frames": [dict(frame=0, start=0, end=10 * MS, fetch_s=0.004),
                       dict(frame=1, start=10 * MS, end=22 * MS,
                            fetch_s=0.0)],
            "megasteps": [m0, m1], "traced_megasteps": [m0, m1],
            "spans": [(0, 10 * MS, "process_frame", 0),
                      (10 * MS, 22 * MS, "process_frame", 0),
                      (17 * MS, 18 * MS, "pack", 2)],
            "traced": (0, 20 * MS),
            "ops": [(1 * MS, 2 * MS, "void image_rows_kernel<float>"),
                    (15 * MS, 16 * MS, "other")],
            "clock_error_ns": 4_000}


def test_each_reading_of_a_synthetic_window():
    ctx = {"driver": "single", "spans": synthetic()}
    got = {k: m.read(ctx) for k, m in METRICS.items()}
    assert got == pytest.approx({
        "device_ms_per_frame.single": 4.5, "device_idle_share.single": 50.0,
        "lm_trip_ms.single": 0.55, "qr_prior_ms.single": 4.0,
        "host_frame_ms.single": 9.0})


@pytest.mark.parametrize("ctx", [{"driver": "single"},
                                 {"driver": "single", "spans": None},
                                 {"driver": "serve", "spans": synthetic()}])
def test_none_where_no_spans_are_read(ctx):
    assert all(m.read(ctx) is None for m in METRICS.values())


def test_untraced_window_has_no_idle_share():
    sp = dict(synthetic(), traced=None, ops=None, traced_megasteps=[])
    ctx = {"driver": "single", "spans": sp}
    assert METRICS["device_idle_share.single"].read(ctx) is None
    assert METRICS["device_ms_per_frame.single"].read(ctx) == 4.5
    assert spans.gaps(sp) == [] and spans.k2_inside(sp) is None


def test_gaps_labelled_by_stamps_then_spans():
    sp = synthetic()
    assert spans.gaps(sp) == [("megastep:qr_prior", 13.0), ("pack", 4.0),
                              ("process_frame", 1.0)]
    assert spans.k2_inside(sp) == (1, 2)
    assert spans.tenths(sp) == [(6.0, 7.0, 2.0), (12.0, 2.0, 0.0)]
    assert spans.window_idle(sp) == pytest.approx(25.0)


def test_traced_ops_moved_onto_the_stamps_clock():
    """The profiler's clock 5 us behind the stamps' and drifting 700 ppm:
    each megastep's traced stamp launches (those outside the WHILE node
    and one trip) fitted by their first and last to the megastep's start
    and end stamps move every traced operation back."""
    m0, m1 = synthetic()["megasteps"]
    ms = [{k: (v if k in ("trips", "marg_old", "frame") else int(v))
           for k, v in m.items()} for m in (m0, m1)]
    for m in ms:
        m["trips"] = [int(t) for t in m["trips"]]
    lo = ms[0]["start"]

    def traced(t):
        return int(t - 5_000 - 700e-6 * (t - lo))

    stamps = [v for m in ms for k, v in m.items()
              if k not in ("trips", "marg_old", "frame") and v > 0]
    stamps += [ms[0]["trips"][-1]]
    ops = [(traced(t), traced(t) + 1_200, "stamp_kernel") for t in stamps]
    ops.append((traced(3 * MS), traced(4 * MS), "image_rows_kernel"))
    fit, moved = spans.align(ops, ms)
    assert fit["stamps"] == fit["launches"] == 15
    assert fit["ppm"] == pytest.approx(700, rel=1e-2)
    assert fit["resid_ns"] < 5.0
    assert moved[-1][0] == pytest.approx(3 * MS, abs=5)
    assert moved[-1][1] - moved[-1][0] == pytest.approx(MS, rel=1e-3)
    # a trace that lost a stamp launch is left as it is
    fit, kept = spans.align(ops[1:], ms)
    assert "ppm" not in fit and kept == ops[1:]


class FakeVio:
    """A port's `trace_record` for two calls and a call of a traced
    sub-window, each with its megastep (one trip)."""

    def trace_record(self):
        names = ["process_frame", "consume", "consume_fetch", "dispatch"]
        rows = []
        for f, t in enumerate((0, 20 * MS, 40 * MS)):
            i = len(rows)
            rows += [(t, t + 15 * MS, 0, -1, f),
                     (t + MS, t + 5 * MS, 1, i, f),
                     (t + 2 * MS, t + 4 * MS, 2, i + 1, f),
                     (t + 6 * MS, t + 8 * MS, 3, i, f)]
        stamps = np.zeros((3, len(TAGS) + 2), np.int64)
        for k in range(3):
            t = k * 20 * MS + 7 * MS
            stamps[k, :len(TAGS)] = t + np.arange(len(TAGS)) * MS
            stamps[k, len(TAGS)] = t + 2 * MS + MS // 2
        stamps[:, TAGS.index("prior_begin")] = 0
        stamps[:, TAGS.index("prior_end")] = 0
        return {"spans": {"names": names, "rows": np.array(rows)},
                "megasteps": {"tags": TAGS, "trip0": len(TAGS),
                              "stamps": stamps, "trips": np.ones(3, int),
                              "frame": np.arange(3),
                              "marg_old": np.zeros(3, bool)},
                "clock": [], "clock_error_ns": 3_000}


def test_window_selects_its_calls_and_their_megasteps():
    sp = spans.window(FakeVio(), 0, 36 * MS, traced=(38 * MS, 60 * MS),
                      ops=[])
    assert [f["frame"] for f in sp["frames"]] == [0, 1]
    assert [f["fetch_s"] for f in sp["frames"]] == [0.002, 0.002]
    assert [m["frame"] for m in sp["megasteps"]] == [0, 1]
    assert [m["frame"] for m in sp["traced_megasteps"]] == [2]
    assert sp["megasteps"][0]["trips"] == [9 * MS + MS // 2]
    depth = {n: d for _, _, n, d in sp["spans"]}
    assert depth == {"process_frame": 0, "consume": 1, "consume_fetch": 2,
                     "dispatch": 1}
    ctx = {"driver": "single", "spans": sp}
    assert METRICS["host_frame_ms.single"].read(ctx) == pytest.approx(13.0)
    assert METRICS["lm_trip_ms.single"].read(ctx) == pytest.approx(0.5)
    assert METRICS["qr_prior_ms.single"].read(ctx) is None


def test_a_port_without_spans_reads_none():
    assert spans.window(object(), 0, 1) is None


def small_cell():
    cell = harness.Cell(BENCH, "tumrs_single.features")
    cell.traffic["warmup_until_s"] = 0.0
    cell.traffic["max_cnt"] = 40
    est = cell.config["estimator"]
    est["stream_warmup"] = 2
    est["window"].update(LM=128, OBS=512)
    est["marg_caps"] = [512, 128, 128]
    cell.config["warmup"]["max_calls"] = 16
    cell.spec["ceiling_calls_per_s"] = 6
    return cell


def test_spanrun_on_a_small_cpu_run():
    """Recording on, a short window on the CPU (eager programs: every LM
    iteration runs), not traced: each reading but the idle share, the
    trips stamped equal to the LM's accept steps less the megasteps."""
    out = spanrun.one(small_cell(), 3_000_000_021, 1.0, True, False,
                      torch.device("cpu"), METRICS, pin=False)
    assert out["calls"] > 0 and out["record"] == 1
    got = out["metrics"]
    assert got["device_idle_share.single"] is None
    for k in ("device_ms_per_frame.single", "lm_trip_ms.single",
              "host_frame_ms.single"):
        assert got[k] > 0.0, k
    assert out["trips_stamped"] == out["k4_settled_less_megasteps"] > 0
    assert out["megasteps_stamped"] == out["calls"]
