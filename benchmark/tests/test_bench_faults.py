"""`correct` comes out false when the timed path is broken underneath: the
whole run (set-up, warm-up, window, judge) with one fault planted in the
port, at the cell's own size on a card, on three consecutive seeds. Each
test prints the judge's numbers (`pytest -s`): they are the upper readings
the limits are set below.

The faults: a solve that returns its state unchanged; the marginalization
returning the prior it was given (the oldest keyframe's factors never enter
it); an answer altered where it is produced (one returned pose moved by
1 m); the line delay, which the configuration calibrates online, held at
its start. One chip and one rig a cell: no batch to halve and no exchange
between chips to leave out.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (3_000_000_001, 3_000_000_002, 3_000_000_003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("a fault is read at the cell's size on a card")
    return torch.device("cuda", 0)


def solve_unchanged(monkeypatch, cell):
    from ctrlvio_tpu_torch.solver import lm

    real = lm.solve_window_fixed

    def unchanged(params, *args, **kw):
        _, stats = real(params, *args, **kw)
        return params, stats

    monkeypatch.setattr(lm, "solve_window_fixed", unchanged)


def prior_unchanged(monkeypatch, cell):
    from ctrlvio_tpu_torch.solver import marginalize

    real = marginalize.build_prior_sqrt

    def passed_through(params, img, imu, bias, old_prior, *args, **kw):
        _, ovf = real(params, img, imu, bias, old_prior, *args, **kw)
        return marginalize.roll_prior(old_prior, kw["knot_shift"],
                                      kw["bias_shift"], args[5]), ovf

    monkeypatch.setattr(marginalize, "build_prior_sqrt", passed_through)


def answer_altered(monkeypatch, cell):
    from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO

    state = {"armed": False}
    real_warm, real_frame = cell.driver.warm_up, CtrlVIO.process_frame

    def warm_up(self):
        real_warm(self)
        state["armed"] = True

    def process_frame(self, *args):
        out = real_frame(self, *args)
        if state["armed"] and out is not None:
            state["armed"] = False
            out = (out[0], out[1] + torch.tensor([1.0, 0.0, 0.0]).numpy())
        return out

    monkeypatch.setattr(cell.driver, "warm_up", warm_up)
    monkeypatch.setattr(CtrlVIO, "process_frame", process_frame)


def line_delay_held(monkeypatch, cell):
    # the configuration calibrates the line delay online; held at its
    # start (0) it stays ~29.5 us off
    cell.config["estimator"]["fix_ld"] = True


FAULTS = {"solve_unchanged": (solve_unchanged, "ate_online_cm"),
          "prior_unchanged": (prior_unchanged, "prior_info"),
          "answer_altered": (answer_altered, "pose_err_max_cm"),
          "line_delay_held": (line_delay_held, "ld_err_us")}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_correct_false(name, fault, seed, card, monkeypatch):
    cell = harness.Cell(BENCH, name)
    plant, number = FAULTS[fault]
    plant(monkeypatch, cell)
    out, _ = harness.run(cell, seed, BENCH["run_seconds"], False, card,
                         time.perf_counter())
    print(json.dumps({"fault": fault, "seed": seed, "correct": out["correct"],
                      "numbers": {k: c["value"] for k, c in
                                  out["checks"].items()}}))
    assert out["correct"] is False, out["checks"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]
