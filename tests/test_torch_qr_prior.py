"""K6's plain version (`ops/qr_prior.py::qr_prior_r_plain`, the QR prior's
landmark elimination and Householder absorption) against
`torch.linalg.qr(A, mode="r")` of the assembled [A | b] that
`build_prior_sqrt` built before K6 (`chip_smoke.assembled_qr_prior`), on
`sim/windows.py::qr_prior_case`'s rows at the benchmark cell's shapes
(4,674 x 516 assembled) and the e2e caps' (2,242 x 388), float32 and
float64: through J^T J and J^T r0 (R's row signs are free), within
`chip_smoke.QR_TOL`. The cases: the default draw, most landmark slots
empty, no live IMU slot, a third of the active obs on a landmark that lost
its slot (row_ok 0), one and three dropped knots. Also: the first kept row
as a tensor, the op's CPU route lane by lane, and torch.func.vmap over
lanes, each equal to the plain version. `build_prior_sqrt` through the
plain path against the JAX package stays in
`tests/test_torch_marginalize_sqrt.py`."""

import pytest
import torch

from chip_smoke import QR_TOL, assembled_qr_prior, prior_gram_err
from ctrlvio_tpu_torch.ops import qr_prior as qr
from ctrlvio_tpu_torch.sim.windows import QR_PRIOR_SHAPES, qr_prior_case
from tests.torch_parity import one_torch_thread  # noqa: F401

CASES = {"default": {}, "empty_slots": dict(landmarks=12),
         "no_imu": dict(imu_live=0.0), "lost_rows": dict(lost=0.33),
         "one_knot": dict(n_drop=1), "three_knots": dict(n_drop=3)}
DTYPES = (torch.float32, torch.float64)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", QR_PRIOR_SHAPES)
def test_plain_matches_the_assembled_qr(shape, dtype, case):
    kw, row_ok = qr_prior_case(QR_PRIOR_SHAPES[shape], dtype, "cpu", seed=3,
                               **CASES[case])
    got = qr.qr_prior_r_plain(**kw)
    (ref, A) = assembled_qr_prior(kw, row_ok)
    n = QR_PRIOR_SHAPES[shape]
    assert A.shape == (2 * n["MOBS"] + 6 * n["MIMU"] + 6 * n["NBM1"]
                       + n["C"] + n["MLM"] + n["C"],
                       n["MLM"] + n["C"] + 1)
    assert prior_gram_err(got, ref) < QR_TOL[dtype]
    keep = kw["keep_from"]
    assert torch.all(got[0][:keep] == 0) and torch.all(got[1][:keep] == 0)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()


def test_wrapper_on_the_cpu_takes_the_plain_version():
    kw, _ = qr_prior_case(QR_PRIOR_SHAPES["e2e"], torch.float32, "cpu")
    qr.reset_counts()
    a = qr.qr_prior_r(**kw)
    b = qr.qr_prior_r_plain(**{**kw, "keep_from": torch.tensor(
        kw["keep_from"])})
    assert qr.counts() == {"qr_prior_r": 0, "qr_prior_r_plain": 2}
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


NAMES = ("J", "r", "J_lm", "new_idx", "live_img", "live_imu", "live_bias",
         "cs_c", "order")


@pytest.mark.parametrize("route", ["op", "vmap"])
def test_lanes_equal_the_plain_version(route):
    dims = dict(MOBS=48, MIMU=16, NBM1=4, C=61, MLM=24)
    lanes = [qr_prior_case(dims, torch.float64, "cpu", seed=s,
                           n_drop=1 + s)[0] for s in range(3)]
    st = [torch.stack([ln[k] for ln in lanes]) for k in NAMES]
    keep = torch.tensor([ln["keep_from"] for ln in lanes])
    if route == "op":
        J, r = qr.qr_prior_op(*st, keep, 0, dims["MLM"], lanes[0]["eps"])
    else:
        J, r = torch.func.vmap(lambda *ts: qr.qr_prior_r(
            *ts[:-1], ts[-1], dims["MLM"], lanes[0]["eps"]))(*st, keep)
    for k, ln in enumerate(lanes):
        assert prior_gram_err((J[k], r[k]), qr.qr_prior_r_plain(**ln)) \
            < QR_TOL[torch.float64]
