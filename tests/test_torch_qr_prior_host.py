"""K6's own code (`ctrlvio_tpu_torch/csrc/qr_prior.cu`) on the CPU:
`tests/torch_qr_prior_host.cpp` includes the source and runs a lane's
blocks in ticket order, each whole (its load phases thread by thread, then
its chain of steps, each thread reading its column of the input rows), its
shared memory poisoned with NaN bytes, through the same C entry
point as the CUDA library (`ops/qr_prior.py::call`). Held to the plain
version through J^T J and J^T r0 within `chip_smoke.QR_TOL`: both shapes
of `QR_PRIOR_SHAPES` in float32 and float64 (a chain of 65 and 130 blocks
at the cell's), landmarks whose rows span several blocks, no live IMU
slot, rows of lost landmarks, one block for every row, lanes sharing
inputs at stride 0 with their own first kept row, a window wide enough
for the instance of half the rows a block. The harness builds with
g++ into a temporary directory (~3 s); without g++ the tests skip."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from chip_smoke import QR_TOL, prior_gram_err
from ctrlvio_tpu_torch.ops import qr_prior as qr
from ctrlvio_tpu_torch.sim.windows import QR_PRIOR_SHAPES, qr_prior_case
from tests.torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
HARNESS = REPO / "tests" / "torch_qr_prior_host.cpp"
NAMES = ("J", "r", "J_lm", "new_idx", "live_img", "live_imu", "live_bias",
         "cs_c", "order")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host harness")
    out = tmp_path_factory.mktemp("qr_host") / "libqr_prior_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC", "-o", str(out),
                    str(HARNESS)], check=True, capture_output=True)
    return qr.declare(ctypes.CDLL(str(out)))


def run(lib, lanes):
    """K6's host run over `lanes` (keyword dicts of `qr_prior_case`, the
    first one's kept rows for all): (J_out, r_out) with the lane axis."""
    ts = [torch.stack([ln[k] for ln in lanes]) for k in NAMES]
    return qr.call(lib, (*ts, None), lanes[0]["keep_from"], lanes[0]["MLM"],
                   lanes[0]["eps"])


# the default draw at both shapes, the other cases at the e2e caps
CASES = {"default": {}, "long_tracks": dict(landmarks=2),
         "no_imu": dict(imu_live=0.0), "lost_rows": dict(lost=0.33)}
RUNS = [(shape, case) for shape in QR_PRIOR_SHAPES for case in CASES
        if case == "default" or shape == "e2e"]


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64), ids=str)
@pytest.mark.parametrize("shape,case", RUNS)
def test_kernel_matches_plain_version(host, shape, case, dtype):
    kw, _ = qr_prior_case(QR_PRIOR_SHAPES[shape], dtype, "cpu", seed=5,
                          **CASES[case])
    J, r = run(host, [kw])
    ref = qr.qr_prior_r_plain(**kw)
    assert prior_gram_err((J[0], r[0]), ref) < QR_TOL[dtype]
    keep = kw["keep_from"]
    assert torch.all(J[0, :keep] == 0) and torch.all(r[0, :keep] == 0)


def test_one_block_takes_every_row(host):
    dims = dict(MOBS=6, MIMU=2, NBM1=2, C=13, MLM=4)
    kw, _ = qr_prior_case(dims, torch.float64, "cpu", seed=1, n_drop=0)
    J, r = run(host, [kw])
    assert prior_gram_err((J[0], r[0]), qr.qr_prior_r_plain(**kw)) \
        < QR_TOL[torch.float64]


def test_lanes_sharing_inputs_at_stride_zero(host):
    """Two lanes over one J, r and J_lm (lane stride 0), each with its own
    masks, slots, column order and first kept row."""
    dims = QR_PRIOR_SHAPES["e2e"]
    a, _ = qr_prior_case(dims, torch.float32, "cpu", seed=2, n_drop=1)
    b, _ = qr_prior_case(dims, torch.float32, "cpu", seed=9, n_drop=3)
    b.update(J=a["J"], r=a["r"], J_lm=a["J_lm"], cs_c=a["cs_c"])
    ts = [torch.stack([a[k], b[k]]) for k in NAMES]
    for k in range(3):
        ts[k] = ts[k][:1].expand(2, *ts[k].shape[1:])
    keep = torch.tensor([a["keep_from"], b["keep_from"]])
    J, r = qr.call(host, (*ts, keep), 0, dims["MLM"], a["eps"])
    for k, kw in enumerate((a, b)):
        assert prior_gram_err((J[k], r[k]), qr.qr_prior_r_plain(**kw)) \
            < QR_TOL[torch.float32]


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64), ids=str)
def test_wide_window_takes_the_wide_instance(host, dtype):
    """A window of KW = 48, NB = 11 (C = 355): the instance of half the
    rows a block."""
    dims = dict(MOBS=96, MIMU=24, NBM1=10, C=355, MLM=48)
    kw, _ = qr_prior_case(dims, dtype, "cpu", seed=4)
    rows = qr.geometry(host, dtype, 1, dims["C"])[0]
    assert rows == {torch.float32: 32, torch.float64: 16}[dtype]
    J, r = run(host, [kw])
    assert prior_gram_err((J[0], r[0]), qr.qr_prior_r_plain(**kw)) \
        < QR_TOL[dtype]
