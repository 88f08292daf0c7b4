"""The float64 reference of the streamed solve against the port's own
float64 megastep from the same state and input (on the CPU, a small
window): the reference follows the port's LM to the float32 rounding of
the packed input, its marginalization equals the port's square-root prior,
and a packed value that is not the generator's counts as an input fault.
Its pieces: the closed-form body rate against forward mode, the difference
Jacobians against forward mode."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, solve_ref

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 3_000_000_019


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
    cell.spec["solve_every"] = 3
    return cell


@pytest.fixture(scope="module")
def kept():
    """A few sampled calls of a small run on the CPU."""
    cell = small_cell()
    dev = torch.device("cpu")
    drv = cell.driver(cell.config, cell.traffic, cell.spec, SEED, 4.0, 0,
                      dev)
    drv.warm_up()
    lo = drv.k
    for _ in range(6):
        drv.call()
    return cell, drv, drv.records(lo, drv.k), [
        x for x in drv.kept if x[0] >= lo]


def port64(drv, prev, prior, blob, meta):
    """The port's own megastep in float64 from the kept state."""
    from ctrlvio_tpu_torch.estimator import stream
    from ctrlvio_tpu_torch.solver.layout import PriorFactor, WindowParams

    vio = drv.vio
    f64 = lambda t: t.double()  # noqa: E731
    st = stream.DevState(
        params=WindowParams(**{k: f64(v) for k, v in prev.items()}),
        prior=PriorFactor(*(f64(v) for v in prior.values())))
    ext = type(vio._ext)(*(f64(v) for v in vio._ext))
    return stream.megastep(
        st, torch.from_numpy(blob).double(), ext, f64(vio._gravity_j),
        f64(vio._imu_info), f64(vio._sqrt_info_img), cfg=vio.wc,
        opts=vio._ba_opts, marg_old=meta["marg_old"], host_seeds=False,
        caps=vio.cfg.marg_caps, ne_mode=vio.cfg.ne_mode,
        chunk=vio.cfg.ne_chunk)


def test_reference_follows_the_ports_float64_solve(kept):
    cell, drv, recs, raw = kept
    assert len(recs) >= 2
    for rec, (_, (prev, prior, caught), (meta, _, _), _) in zip(recs, raw):
        win = solve_ref.Window(rec, drv.seq, cell.config, cell.traffic,
                               drv.vio.data_start_ns, torch.device("cpu"))
        assert win.faults == 0
        x, cost0 = win.lm(int(win.answer["iters"][0]))
        st, summ = port64(drv, prev, prior, caught["blob"], meta)
        win.answer = solve_ref.split(summ.numpy(),
                                     solve_ref.summary_fields(
                                         cell.config["estimator"]["window"]))
        assert abs(cost0 - win.answer["costs"][0]) < 1e-5 * cost0
        g = solve_ref.gaps(win, x)
        # the port's packed input is float32: the two solves differ by its
        # rounding, far below what float32 arithmetic moves (tens of urad)
        assert g["rot_urad"] < 0.5 and g["pos_um"] < 2.0, g
        assert g["ld_ns"] < 0.05, g
        if meta["marg_old"]:
            p = solve_ref.prior_gaps(win, x, {"J": st.prior.J.numpy(),
                                              "r0": st.prior.r0.numpy()})
            assert p["prior_info"] < 1e-4 and p["prior_grad"] < 1e-4, p


def test_a_packed_value_not_the_generators_is_a_fault(kept):
    cell, drv, recs, _ = kept
    rec = recs[0]
    fields = solve_ref.blob_fields(cell.config["estimator"]["window"])
    offs = np.cumsum([0] + [int(np.prod(s)) for _, s in fields])
    at = {n: o for (n, _), o in zip(fields, offs)}
    blob = rec.blob.copy()
    blob[at["gyro"]] += 1e-3  # the first IMU sample's gyro
    blob[at["pt_j"] + 3 * 5] += 1e-3  # the sixth pair's target point
    bad = solve_ref.Record(blob=blob, prev=rec.prev, prior=rec.prior,
                           meta=rec.meta, summary=rec.summary)
    win = solve_ref.Window(bad, drv.seq, cell.config, cell.traffic,
                           drv.vio.data_start_ns, torch.device("cpu"))
    assert win.faults == 2


def test_body_rate_is_the_rotations_derivative():
    g = torch.Generator().manual_seed(1)
    q4 = solve_ref.qexp(0.3 * torch.randn(6, 4, 3, generator=g,
                                          dtype=torch.float64))
    u = torch.rand(6, generator=g, dtype=torch.float64)
    q, dq = torch.func.jvp(lambda t: solve_ref.rot_pose(q4, t), (u,),
                           (torch.ones_like(u),))
    w = 2.0 * solve_ref.qmul(solve_ref.qconj(q), dq)[..., 1:] * 20.0
    np.testing.assert_allclose(solve_ref.body_rate(q4, u, 20.0).numpy(),
                               w.numpy(), rtol=0, atol=1e-12)


def test_differences_match_forward_mode():
    g = torch.Generator().manual_seed(2)
    a = torch.randn(5, 3, generator=g, dtype=torch.float64)

    def f(e):
        return torch.sin(a * (1.0 + e[..., :3])) * torch.exp(e[..., 3:4])

    steps = torch.full((4,), 1e-6, dtype=torch.float64)
    r, J = solve_ref.differences(f, steps)
    Jf = torch.func.jacfwd(lambda e: f(e[None, None, :])[0])(
        torch.zeros(4, dtype=torch.float64))
    np.testing.assert_allclose(r.numpy(), f(torch.zeros(1, 1, 4,
                               dtype=torch.float64))[0].numpy())
    np.testing.assert_allclose(J.numpy(), Jf.numpy(), rtol=0, atol=1e-9)
