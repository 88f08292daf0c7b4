"""The control comes out not correct: the port with its streamed solve in
TF32 matrix products (the nearest precision below the full float32 that
the configuration states), at the cell's own size, on three consecutive
seeds. Each test prints the judge's numbers (`pytest -s`). Needs the
card."""

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import control, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = (4_000_000_001, 4_000_000_002, 4_000_000_003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(name, seed, card, monkeypatch):
    control.apply("tf32", monkeypatch.setattr)
    cell = harness.Cell(BENCH, name)
    out, _ = harness.run(cell, seed, BENCH["run_seconds"], False, card,
                         time.perf_counter())
    print(json.dumps({"control": "tf32", "seed": seed,
                      "correct": out["correct"],
                      "numbers": {k: c["value"] for k, c in
                                  out["checks"].items()}}))
    assert out["correct"] is False, out["checks"]
