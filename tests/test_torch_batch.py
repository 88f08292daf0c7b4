"""Parity of the port's batched window solver with the JAX package, float64
on the CPU: `parallel.batch.make_batched_solver` lane by lane against JAX's
single `lm.solve_window` (the port of `tests/test_parallel.py::
test_batched_solver_matches_single`; with CG against the port's own single
solve, which `tests/test_torch_cg.py` holds to JAX's), and the port's
`sim/tiny.py` against `__graft_entry__._tiny_problem`. The window problem
is `test_torch_solver.py`'s."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.ops import so3np
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import lm as jlm
from ctrlvio_tpu_torch.parallel import batch
from ctrlvio_tpu_torch.sim import tiny
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.solver import lm as tlm
from ctrlvio_tpu_torch.utils.convert import tensor
from tests.test_torch_solver import CFG, TCFG, args, jx, prob  # noqa: F401
from tests.torch_parity import close, one_torch_thread  # noqa: F401


def _lanes(prob):
    """Three window problems: the fixture's, one whose knots are perturbed
    further, and one started from the fixture's solution (so the lanes
    stop on different iterations)."""
    rng = np.random.default_rng(5)
    act = ~prob["fixed"]
    p = prob["params"]
    dq = rng.normal(size=(CFG.KW, 3)) * 0.01 * act[:, None]
    dp = rng.normal(size=(CFG.KW, 3)) * 0.01 * act[:, None]
    far = p._replace(knots_q=so3np.boxplus(p.knots_q, dq),
                     knots_p=p.knots_p + dp)
    ta = args(prob, "torch")
    sol, _ = tlm.solve_window_fixed(*ta[:5], tensor(prob["fixed"]), *ta[5:],
                                    TCFG, tlayout.SolveOptions(max_iters=8))
    near = type(p)(*(x.numpy() for x in sol))
    return [prob, dict(prob, params=far), dict(prob, params=near)]


@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_batched_solver_matches_single(prob, solver):
    """Three lanes through one batched call, costs never rising and vmap
    falling back to a per-lane loop for no operation. chol: each lane
    equals JAX's `lm.solve_window` on its own inputs (the port of
    test_parallel.py::test_batched_solver_matches_single); cg (48
    iterations): each lane equals the port's single `solve_window_fixed`."""
    opts = tlayout.SolveOptions(max_iters=6, tol=1e-3, solver=solver)
    lanes = _lanes(prob)
    tl = [args(pb, "torch") for pb in lanes]
    fixed = tensor(prob["fixed"])
    solve_b = batch.make_batched_solver(TCFG, opts)
    stacked = [batch.stack([a[k] for a in tl]) for k in range(5)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out_b, st_b = solve_b(*stacked, torch.stack([fixed] * 3), *tl[0][5:])
    assert not [w for w in caught if "performance drop" in str(w.message)]
    assert bool((st_b.cost <= st_b.cost0).all())
    assert len(set(st_b.accepted.tolist())) > 1  # lanes stop apart
    for i, pb in enumerate(lanes):
        if solver == "chol":
            ja = args(pb, "jax")
            p1, s1 = jlm.solve_window(*ja[:5], jnp.asarray(prob["fixed"]),
                                      *ja[5:], CFG, jlayout.SolveOptions(*opts))
            rtol = 1e-7
        else:
            p1, s1 = tlm.solve_window_fixed(*tl[i][:5], fixed, *tl[i][5:],
                                            TCFG, opts)
            rtol = 1e-9
        assert int(s1.accepted) == int(st_b.accepted[i])
        close(s1.cost, st_b.cost[i], rtol=1e-8)
        for x, y in zip(p1, out_b):
            close(x, y[i], rtol=rtol)


def test_tiny_problem_matches_graft_entry():
    """`sim.tiny.tiny_problem` builds `__graft_entry__._tiny_problem`'s
    window (f64, the default and `bench.py --mode batch`'s config)."""
    import __graft_entry__ as g

    from ctrlvio_tpu_torch.solver.layout import WindowConfig

    for cfg in (None, WindowConfig(KW=48, NB=11, LM=256, OBS=768, MIMU=512,
                                   dt=0.05)):
        jcfg = None if cfg is None else jlayout.WindowConfig(*cfg)
        ref = g._tiny_problem(np.float64, jcfg)
        got = tiny.tiny_problem(torch.float64, cfg, device="cpu")
        assert tuple(ref[0]) == tuple(got.cfg)
        for a, b in zip(ref[1:6], got[1:6]):
            for x, y in zip(jx(a) if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                close(x, y, rtol=1e-12)
        (ext_j, *rest_j), (ext_t, *rest_t) = ref[6], got.aux
        for x, y in zip([*ext_j, *rest_j], [*ext_t, *rest_t]):
            close(x, y, rtol=1e-12)
        for x, y in zip(ref[7], got.prior):
            close(x, y, rtol=0.0)
