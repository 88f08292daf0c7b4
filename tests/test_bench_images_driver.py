"""The image cell's driver (`benchmark/drivers/images.py`) through the
harness on the CPU, at a reduced size: the estimator float64 and
synchronous for 4 frames, then streamed; images 160x128 (the camera's
focal length scaled to fit); a small window.

Each call returns the pose of the frame the lagged front end published,
and the float64 solve check finds every packed observation among the
published frames (`seq.frames`) the driver caught; where the check places
every keyframe of the window there is no input fault. The track check's
numbers join the judge's checks, and one beyond its limit fails the
run. This file imports neither JAX nor the JAX package.
"""

import contextlib
import copy
import io
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, reference, solve_ref
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SCALE = 8


def small_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, "tumrs_images.textured")
    c = cell.traffic["camera"]
    cell.traffic = dict(
        cell.traffic, warmup_until_s=0.5,
        camera=dict(c, **{k: c[k] / SCALE for k in ("mu", "mv", "u0", "v0")}),
        image_size=[1280 // SCALE, 1024 // SCALE])
    cfg = copy.deepcopy(cell.config)
    cfg["tracker"].update(min_dist=25 // SCALE, f_threshold=1.0 / SCALE)
    cfg["estimator"]["window"] = dict(KW=24, NB=6, LM=96, OBS=384, MIMU=192,
                                      dt=0.05)
    cfg["estimator"].update(dtype="float64", stream_warmup=4, stream_lag=2,
                            stream_consume_every=1, ba_iters=3,
                            init_ba_iters=4, predict_iters=4,
                            marg_caps=[384, 64, 96])
    cfg["warmup"] = dict(after_handoff=2, max_calls=16)
    cell.config = cfg
    cell.spec = dict(cell.spec, ceiling_calls_per_s=4, solve_every=2)
    return cell


def judged_windows(monkeypatch):
    """Each sampled call's float64 check as `solve_ref.check` makes it:
    (packed image observations not found among the caught frames,
    keyframes its image pairs place, the window's keyframes, its input
    faults, its gaps)."""
    seen, windows = [], []

    class Window(solve_ref.Window):
        def __init__(self, rec, *args):
            super().__init__(rec, *args)
            b = solve_ref.split(rec.blob, solve_ref.blob_fields(self.w))
            img = self.img
            kf = torch.cat([img["i0_i"] + img["f_i"],
                            img["i0_j"] + img["f_j"]])
            windows.append((int((b["valid"] > 0.5).sum()) - len(img["lm"]),
                            len(torch.unique(kf)), self.NB, self.faults))

    check = solve_ref.check

    def checked(*args):
        out = check(*args)
        seen.extend(zip(windows, out))
        return out

    monkeypatch.setattr(solve_ref, "Window", Window)
    monkeypatch.setattr(solve_ref, "check", checked)
    return seen


@pytest.fixture(scope="module")
def small_run():
    """One run of the small cell (a 10 s window) whose `track_lost_pct`
    limit lies below any reading: its result line, its standard error,
    and each sampled window's check."""
    cell = small_cell()
    cell.spec = dict(cell.spec, limits=dict(cell.spec["limits"],
                                            track_lost_pct=-1.0))
    err = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stderr(err):
        seen = judged_windows(mp)
        out, _ = harness.run(cell, 2**31 + 3, 10.0, False,
                             torch.device("cpu"), time.perf_counter())
    return out, err.getvalue(), seen


def test_the_harness_runs_the_image_driver(small_run):
    out, err, seen = small_run
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert checks["marg_overflows"] == 0
    # every packed observation is among the published frames the driver
    # caught
    assert seen and all(w[0] == 0 for w, _ in seen)
    assert checks["input_faults"] == sum(w[3] for w, _ in seen)
    # `solve_ref` places keyframes through image pairs only: a newest
    # keyframe that holds none (short tracks at this size) leaves it one
    # keyframe short, and its IMU samples' bias index one low. Where it
    # places every keyframe there is no input fault, and the float64
    # reference follows the float64 port solve by solve.
    placed = [g for w, g in seen if w[1] == w[2]]
    assert placed and all(w[3] == 0 for w, _ in seen if w[1] == w[2])
    assert all(g["rot_urad"] < 0.1 and g.get("prior_grad", 0.0) < 0.01
               for g in placed)
    assert "[bench] track check: pairs" in err
    tracks = {k: c for k, c in out["checks"].items()
              if k.startswith("track_")}
    assert set(tracks) == {"track_err_px_median", "track_gross_pct",
                           "track_lost_pct", "track_moving_pct"}
    assert all(math.isfinite(c["value"]) for c in tracks.values())
    assert all(c["limit"] > 0 for k, c in tracks.items()
               if k != "track_lost_pct")
    assert set(out["metrics"]) == {"frames_per_s", "frame_latency_ms_p95",
                                   "setup_s"}
    assert out["device"]["platform"] == "cpu"


def test_a_failed_track_check_fails_the_run(small_run):
    out, _, _ = small_run
    lost = out["checks"]["track_lost_pct"]
    assert lost["value"] > lost["limit"] and not out["correct"]


def test_the_wrapped_judge_holds_only_its_own_cell(monkeypatch):
    images = harness.load_module(ROOT / "benchmark/drivers/images.py")

    def base(lanes, line_delay, limits, solves, overflows):
        return True, {"ate_online_cm": {"value": 1.0, "limit": 2.0}}, []

    monkeypatch.setattr(reference, "judge", base)
    tracks = {"err_px_median": 0.3, "gross_share": 0.2,
              "tracked_share": 90.0, "moving_share": float("nan")}
    limits = {"track_err_px_median": 0.6, "track_gross_pct": 1.0,
              "track_lost_pct": 40.0, "track_moving_pct": 1.0}
    first = SimpleNamespace(limits=dict(limits), tracks=tracks)
    drv = SimpleNamespace(limits=limits, tracks=dict(
        tracks, moving_share=0.1))
    reference.judge = images.judge_with_tracks(first)
    reference.judge = images.judge_with_tracks(drv)  # made again: no chain
    assert reference.judge.without_tracks is base
    correct, checks, _ = reference.judge([], 0.0, limits, [], 0)
    assert correct and checks["track_lost_pct"] == {"value": 10.0,
                                                    "limit": 40.0}
    # another cell's run (other limits) is judged as the harness judges it
    assert reference.judge([], 0.0, dict(limits), [], 0)[1].keys() == {
        "ate_online_cm"}
    drv.tracks = dict(tracks, moving_share=1.5)
    assert not reference.judge([], 0.0, limits, [], 0)[0]
    drv.tracks = tracks  # a NaN fails
    assert not reference.judge([], 0.0, limits, [], 0)[0]
