"""The batched window solver as one captured program a B (≙ the JAX
package's `jax.jit` of its vmapped solve, `parallel/batch.py:42`), on the
CPU through the test-only replay stand-in (`tests/torch_graph_standin.py`):
lane by lane bit-equal to the eager `torch.func.vmap`, with JAX's
`lm.solve_window` on each lane's own inputs as the oracle (as
`tests/test_torch_batch.py`), which also holds the replayed single solve
of `tests/test_torch_lm_exit.py`, whose WHILE node stops once it froze. One
JAX compile for the file: every JAX solve shares its options."""

import warnings

import jax.numpy as jnp
import pytest
import torch

from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import lm as jlm
from ctrlvio_tpu_torch.parallel import batch
from ctrlvio_tpu_torch.utils import graphs
from ctrlvio_tpu_torch.utils.convert import tensor
from tests.test_torch_batch import _lanes
from tests.test_torch_lm_exit import MAX_ITERS, TOL, _inputs, _opts, replayed
from tests.test_torch_solver import CFG, TCFG, args, prob  # noqa: F401
from tests.torch_graph_standin import captured, programs, replayed_programs
from tests.torch_parity import close, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def lanes(prob):
    """Two lanes that stop on different iterations (the fixture's problem
    and one started from its 8-iteration solution), and JAX's solve of
    each (chol, the lm_exit file's options)."""
    torch.set_num_threads(1)
    ls = _lanes(prob)[::2]
    jo = jlayout.SolveOptions(max_iters=MAX_ITERS, tol=TOL)
    ref = []
    for pb in ls:
        ja = args(pb, "jax")
        ref.append(jlm.solve_window(*ja[:5], jnp.asarray(prob["fixed"]),
                                    *ja[5:], CFG, jo))
    return ls, ref


def _stacked(prob, ls):
    tl = [args(pb, "torch") for pb in ls]
    fixed = tensor(prob["fixed"])
    return (*[batch.stack([a[k] for a in tl]) for k in range(5)],
            torch.stack([fixed] * len(ls)), *tl[0][5:])


def test_batched_program_equals_eager_vmap(prob, lanes):
    """Two lanes through `make_batched_solver` replayed: one program,
    captured once and replayed, equal bit for bit to the eager vmap of `solve_window_fixed` (no per-lane fallback); each lane
    holds to JAX's solve of it (accepted steps, cost 1e-8, params 1e-7),
    and its `iters` is where that lane converged."""
    ls, ref = lanes
    a = _stacked(prob, ls)
    opts = _opts("chol")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eager = batch.make_batched_solver(TCFG, opts)(*a)
    assert not [w for w in caught if "performance drop" in str(w.message)]
    with replayed_programs():
        solve = batch.make_batched_solver(TCFG, opts)
        got = graphs.clone(solve(*a))
        keys = captured()
        (prog,) = programs(batch._PROGRAMS).values()
    assert keys == ["batched_solve(B=2, solver=chol)"] and prog.replays == 1
    assert all(torch.equal(x, y) for x, y in
               zip(graphs.leaves(got), graphs.leaves(eager)))
    p_b, st_b = got
    assert len(set(st_b.iters.tolist())) > 1  # lanes stop apart
    for i, (pj, sj) in enumerate(ref):
        assert int(sj.accepted) == int(st_b.accepted[i])
        close(sj.cost, st_b.cost[i], rtol=1e-8)
        for x, y in zip(pj, p_b):
            close(x, y[i], rtol=1e-7)


def test_replayed_exit_solve_matches_jax(prob, lanes):
    """The single f64 chol solve replayed with its WHILE node (the lm_exit
    file's case, lane 0 here) against JAX's `lm.solve_window` on the same
    numpy inputs, at `tests/test_torch_lm.py`'s tolerances: the same
    accepted steps, cost0, damping, cost to 1e-8 and params to 1e-7."""
    (p, st), counts, _ = replayed(_inputs(prob, torch.float64),
                                  _opts("chol"))
    pj, sj = lanes[1][0]
    assert counts["run"] == int(st.iters) - 1 < MAX_ITERS - 1
    assert int(sj.accepted) == int(st.accepted)
    close(sj.cost0, st.cost0)
    close(sj.cost, st.cost, rtol=1e-8)
    close(sj.lm_lambda, st.lm_lambda)
    for x, y in zip(pj, p):
        close(x, y, rtol=1e-7)
