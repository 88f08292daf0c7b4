"""Parity of the port's multi-process layer with the JAX package, float64
on the CPU (the port of `tests/test_parallel.py`): the (seq, fac) mesh
over `torch.distributed`, the seq-sharded batched solver, the
factor-sharded step and the full factor-sharded solve, with the
non-empty marginalization prior of `test_torch_solver.py`'s problem (so a
prior or bias pair counted on every rank would show).

One module-scoped launch of 4 gloo ranks (`tests/torch_dist_case.py`,
no JAX) computes every port case and writes one npz a rank; meanwhile
this process computes the JAX side. This file holds the mesh, the batch
and the solve against JAX's single-device solve;
`test_torch_sharded_lm.py` the step and the solve against JAX's own
sharded functions on the conftest's 8-device CPU mesh (the JAX compiles
split over the two files keep each under 90 s)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.ops import so3np
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import lm as jlm
from ctrlvio_tpu_torch.parallel import multihost
from tests.test_torch_solver import CFG, jx, prob  # noqa: F401
from tests.torch_parity import close, one_torch_thread  # noqa: F401

WORLD = 4
MAX_ITERS = 6
CASE = Path(__file__).with_name("torch_dist_case.py")


def _lanes(pb):
    """Four starting points of the fixture's window: its own, two with the
    active knots perturbed further (two seeds), and one near the solution
    (one more accepted step than usual from a warm start)."""
    act = ~pb["fixed"]
    p = pb["params"]
    lanes = [p]
    for seed in (5, 6):
        rng = np.random.default_rng(seed)
        dq = rng.normal(size=(CFG.KW, 3)) * 0.01 * act[:, None]
        dp = rng.normal(size=(CFG.KW, 3)) * 0.01 * act[:, None]
        lanes.append(p._replace(knots_q=so3np.boxplus(p.knots_q, dq),
                                knots_p=p.knots_p + dp))
    rng = np.random.default_rng(7)
    lanes.append(p._replace(dinv=p.dinv * (1.0 + 0.05 * rng.normal(
        size=p.dinv.shape))))
    return lanes


def _write_inputs(pb, lanes, path):
    z = {"cfg": np.array(CFG[:5]), "dt": np.float64(CFG.dt),
         "max_iters": np.int64(MAX_ITERS), "fixed": pb["fixed"],
         "gravity": pb["gravity"], "info": pb["info"], "w": pb["w"]}
    for key in ("img", "imu", "bias", "prior", "ext"):
        for f, x in zip(pb[key]._fields, pb[key]):
            z[f"{key}.{f}"] = np.asarray(x)
    for i, lane in enumerate(lanes):
        for f, x in zip(lane._fields, lane):
            z[f"lane{i}.{f}"] = np.asarray(x)
    np.savez(path, **z)


def _jargs(pb, params):
    return (jx(params), jx(pb["img"]), jx(pb["imu"]), jx(pb["bias"]),
            jx(pb["prior"]), jnp.asarray(pb["fixed"]), jx(pb["ext"]),
            jnp.asarray(pb["gravity"]), jnp.asarray(pb["info"]),
            jnp.asarray(pb["w"]))


@pytest.fixture(scope="module")
def launched(prob, tmp_path_factory):  # noqa: F811
    """The 4 ranks, started on the fixture's window and lanes; they run
    while the JAX side compiles and computes."""
    d = tmp_path_factory.mktemp("dist")
    _write_inputs(prob, _lanes(prob), d / "in.npz")
    ranks = multihost.Ranks(
        lambda r: [sys.executable, str(CASE), str(r), str(WORLD), str(d)],
        WORLD, d, multihost.rank_env(torch.device("cpu")))
    yield ranks, d
    ranks.stop()


@pytest.fixture(scope="module")
def jax_side(prob, launched):  # noqa: F811
    """JAX's `lm.solve_window` (6 iterations) on each lane."""
    jo6 = jlayout.SolveOptions(max_iters=MAX_ITERS)
    solve = jax.jit(lambda *a: jlm.solve_window(*a, cfg=CFG, opts=jo6))
    return {"lanes": [solve(*_jargs(prob, p)) for p in _lanes(prob)]}


@pytest.fixture(scope="module")
def port(launched, jax_side):
    """Every rank's results (the ranks are waited for after the JAX side
    is done)."""
    ranks, d = launched
    ranks.wait(timeout=300)
    return [dict(np.load(d / f"out{r}.npz")) for r in range(WORLD)]


def params_of(z, key):
    return dict(zip(jlayout.WindowParams._fields,
                    (z[f"{key}.params.{f}"] for f in
                     jlayout.WindowParams._fields)))


def same_solve(z, ref_p, ref_s):
    """The port's full sharded solve in `z` against a JAX solve: the same
    accepted count, knots and inverse depths within 1e-9, the line delay
    within 1e-12, the cost within 1e-8 relative."""
    got = params_of(z, "solve")
    assert int(ref_s.accepted) == int(z["solve.stats.accepted"])
    for name in ("knots_p", "knots_q", "dinv"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref_p, name)),
                                   rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["ld"], float(ref_p.ld), rtol=0, atol=1e-12)
    np.testing.assert_allclose(z["solve.stats.cost"], float(ref_s.cost),
                               rtol=1e-8)


def test_mesh_construction(port):
    """Mesh (2, 2) over 4 ranks: rank r at seq r // 2, fac r % 2; each
    axis group holds the 2 ranks of this rank's line."""
    for r, z in enumerate(port):
        np.testing.assert_array_equal(z["mesh.shape"], [2, 2])
        np.testing.assert_array_equal(z["mesh.index"], [r // 2, r % 2])
        np.testing.assert_array_equal(z["mesh.size"], [2, 2])
        np.testing.assert_array_equal(z["mesh.group_size"], [2, 2])
        seq_line = [r % 2, r % 2 + 2]
        fac_line = [2 * (r // 2), 2 * (r // 2) + 1]
        np.testing.assert_array_equal(z["mesh.rank_sums"],
                                      [sum(seq_line), sum(fac_line)])


def test_seq_sharded_batch_matches_jax(jax_side, port):
    """4 lanes, one a seq rank, all-gathered to every rank: each lane
    equals JAX's `lm.solve_window` on its own inputs (1e-8 of the
    largest entry), and every rank holds the same batch."""
    z0 = port[0]
    for z in port[1:]:
        for k in z0:
            if k.startswith("batch."):
                np.testing.assert_array_equal(z[k], z0[k], k)
    got = params_of(z0, "batch")
    for i, (pj, sj) in enumerate(jax_side["lanes"]):
        assert int(sj.accepted) == int(z0["batch.stats.accepted"][i])
        close(sj.cost, z0["batch.stats.cost"][i], rtol=1e-8)
        for name, x in zip(pj._fields, pj):
            close(x, got[name][i], rtol=1e-8)


def test_full_sharded_solve_matches_jax(jax_side, port):
    """fac = 4, 6 iterations, on every rank: JAX's single-device
    `lm.solve_window` (`same_solve`)."""
    for z in port:
        same_solve(z, *jax_side["lanes"][0])


def test_fac1_equals_solve_window_fixed(port):
    """At fac = 1 the sharded solve is `lm.solve_window_fixed` plus an
    all-reduce over one rank: bit for bit the same result."""
    z = port[0]
    keys = [k for k in z if k.startswith("fac1.")]
    assert len(keys) == 10
    for k in keys:
        np.testing.assert_array_equal(z[k], z["fixed." + k[5:]], k)


def test_cg_option_keeps_chol(port):
    """`solver="cg"` in the options: the sharded solve still runs the
    Cholesky Schur solve (as the JAX package's sharded path does), so its
    result equals the chol one exactly."""
    for z in port:
        keys = [k for k in z if k.startswith("solve_cg.")]
        assert len(keys) == 10
        for k in keys:
            np.testing.assert_array_equal(z[k], z["solve." + k[9:]], k)
