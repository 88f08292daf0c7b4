"""The LM's exit on the device (`solver/lm.py::solve_window_fixed`, its
iterations after the first the body of `utils/graphs.py::run_while`), on
the CPU through the test-only replay stand-in
(`tests/torch_graph_standin.py`), which on replay runs a recorded body
while the solve is not done, as the CUDA-graph WHILE node does whose
condition K4 sets: a replayed solve that converges before
`max_iters` executes exactly `iters` iterations and equals, bit for bit,
the eager `solve_window_fixed` (every iteration run, the frozen ones
changing nothing) and the host-exit `lm.solve_window`; `iters` is the
host-exit loop's count. The window problem is `test_torch_solver.py`'s,
with its prior, at tol 1e-2, where chol stops at iteration 6 and CG at 11
of 12. `test_torch_graphs_batch.py` holds the replayed f64 chol solve to
the JAX package's `lm.solve_window` (one JAX compile a file)."""

from typing import NamedTuple

import pytest
import torch

from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.solver import lm as tlm
from ctrlvio_tpu_torch.utils import graphs
from ctrlvio_tpu_torch.utils.convert import tensor
from tests.test_torch_solver import TCFG, args, prob  # noqa: F401
from tests.torch_graph_standin import WHILE_COUNTS, replayed_programs
from tests.torch_parity import one_torch_thread  # noqa: F401

MAX_ITERS, TOL = 12, 1e-2


def _cast(x, dtype):
    if isinstance(x, tuple):
        return type(x)(*(_cast(y, dtype) for y in x))
    return x.to(dtype) if x.is_floating_point() else x


def _inputs(prob, dtype):
    ta = [_cast(x, dtype) for x in args(prob, "torch")]
    return (*ta[:5], tensor(prob["fixed"]), *ta[5:])


def _opts(solver):
    return tlayout.SolveOptions(max_iters=MAX_ITERS, tol=TOL, solver=solver)


def replayed(a, opts):
    """`solve_window_fixed` as a program through the stand-in, called
    once; returns a copy of its output, the bodies run and skipped, and
    `graphs.stats()` after the call."""
    with replayed_programs():
        prog = graphs.ProgramCache().get(
            tlm.solve_window_fixed, a, "cpu", dict(cfg=TCFG, opts=opts))
        out = graphs.clone(prog(*a))
        counts = dict(WHILE_COUNTS)
        st = graphs.stats()
    return out, counts, st


def _equal(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(graphs.leaves(a), graphs.leaves(b)))


@pytest.fixture(scope="module")
def f64_chol(prob):
    """The f64 chol case: the replayed program's output and counts."""
    torch.set_num_threads(1)
    return replayed(_inputs(prob, torch.float64), _opts("chol"))


def test_replayed_solve_executes_iters(f64_chol):
    """The replayed f64 chol solve: one WHILE node recorded, whose body
    ran for iterations 2..iters and not for the rest."""
    (_, st), counts, _ = f64_chol
    iters = int(st.iters)
    assert 1 < iters < MAX_ITERS
    assert counts == {"run": iters - 1, "skipped": MAX_ITERS - iters,
                      "nodes": 1}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_iters_is_the_host_exit_count(prob, f64_chol, dtype, solver):
    """`iters` of `solve_window_fixed` is the number of iterations the
    host-exit `solve_window` ran, and the two results are bit-equal; the
    f64 chol case's replay too, which ran `iters - 1` bodies."""
    a = _inputs(prob, dtype)
    opts = _opts(solver)
    eager = tlm.solve_window_fixed(*a, TCFG, opts)
    host = tlm.solve_window(*a, TCFG, opts)
    n = int(host[1].iters)
    assert n < MAX_ITERS  # the host loop left early
    assert int(eager[1].iters) == n and _equal(eager, host)
    if (dtype, solver) == (torch.float64, "chol"):
        got, counts, _ = f64_chol
        assert int(got[1].iters) == n and counts["run"] == n - 1
        assert _equal(got, eager)



def test_ne_ab_times_its_variants_as_programs():
    """`tools/ne_ab.run` times each variant's batched megastep as a
    captured program (≙ the JAX tool's `jax.jit(jax.vmap(mega))`): through
    the stand-in, one program a variant and B, each first step equal bit
    for bit to the eager run's, the results marked graphed."""
    from ctrlvio_tpu_torch.tools import ne_ab, profile_serve

    vio, st, blob = profile_serve.capture_state(duration=2.0, warmup=3,
                                                device="cpu")
    variant = ([1], ["dense", "chunked"], [0], ["chol"])
    _, eager = ne_ab.run(vio, st, blob, *variant, reps=1, warm=0)
    with replayed_programs():
        results, got = ne_ab.run(vio, st, blob, *variant, reps=1, warm=0)
        keys = sorted(c["key"] for c in graphs.stats()["graphs_captured"])
    assert keys == ["ne_ab(chunked/chol, B=1)", "ne_ab(dense/chol, B=1)"]
    assert all(r["graphed"] for r in results)
    assert got.keys() == eager.keys()
    for k in got:
        assert _equal(got[k], eager[k]), k


def test_settled_counts_are_the_trips(f64_chol):
    """The counts settled from the node's counter of trips
    (`graphs.stats`): the trips the replay ran, and the accept step (its
    plain version on the CPU) once before the node and once a trip."""
    (_, st), _, stats = f64_chol
    iters = int(st.iters)
    assert stats["while_nodes"] == 1
    assert stats["if_bodies_run"] == iters - 1
    assert stats["launches_replayed"]["lm_accept_plain"] == iters


class _Loop(NamedTuple):
    x: torch.Tensor
    done: torch.Tensor


def _count_to(x, n):
    """x counted up to n by a `graphs.run_while` of at most 5 trips."""
    c = _Loop(x.clone(), x >= n)

    def body(c, handle):
        c.x.add_(1)
        c.done.copy_(c.x >= n)

    graphs.run_while(body, c, 5, graphs.while_handle(x.device))
    return c.x


def test_released_programs_take_their_nodes_along():
    """More programs with a WHILE node each than the 1024 node counters
    a device once had, captured one after another through the stand-in
    and released in between, as streamed sessions come and go: every
    capture succeeds, the trips of each released program are settled
    (3 each), and nothing of them stays held."""
    n_programs = 1100
    x = torch.zeros(())
    with replayed_programs():
        for _ in range(n_programs):
            prog = graphs.ProgramCache().get(_count_to, (x,), "cpu",
                                             dict(n=3))
            assert float(prog(x)) == 3.0
            del prog
        st = graphs.stats()
        assert WHILE_COUNTS["run"] == 3 * n_programs
    assert st["while_nodes"] == n_programs
    assert st["if_bodies_run"] == 3 * n_programs
    assert not graphs._RETIRED and not list(graphs._WHILE_PROGRAMS)
