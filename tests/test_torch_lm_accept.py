"""The LM's accept step (`ctrlvio_tpu_torch/ops/lm_kernels.py`, kernel K4
on the card) on the CPU.

- The plain version, `lm_kernels.accept_step_plain`, against the JAX
  package's rule, transcribed with jnp from
  `ctrlvio_tpu/solver/lm.py:232-249` (the `while_loop`'s body's accept
  test, selects and scalars, applied where its `cond` holds), on the
  same numpy-drawn state and trial: equal bit for bit, float32 and
  float64, in every case of `sim/windows.py::ACCEPT_CASES` (accepted,
  rejected, done already set, NaN and infinite trial cost, the relative
  decrease at `tol`, lambda at both clamps).
- K4's own code (`csrc/lm_accept.cu`): `tests/torch_lm_accept_host.cpp`
  includes it and runs each lane's blocks one after another, thread by
  thread, with the in-place instance's last-arrival scalar update, through
  the CUDA library's entry point. Both instances, 1 lane and 3 lanes of
  mixed cases, float32 and float64, equal the plain version bit for bit,
  the condition a handle would get included; leaves that are not 16-byte
  aligned take the one-element path and give the same bits. The harness
  builds with g++ into a temporary directory (~2 s); without g++ those
  tests skip.
- The custom op's vmap rule (one call over the lanes) and fake shapes.

The kernel itself is held to the plain version on the card by
`tests/test_torch_kernels.py` (gpu-marked) and `chip_smoke.py`."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.ops import lm_kernels as lk4
from ctrlvio_tpu_torch.sim.windows import ACCEPT_CASES, accept_case
from ctrlvio_tpu_torch.solver.layout import WindowConfig
from ctrlvio_tpu_torch.utils import graphs
from tests.torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
HARNESS = REPO / "tests" / "torch_lm_accept_host.cpp"
# C = 6 KW + 6 NB + 1 = 97: H is 9,409 values, 10 blocks of f32 items
WIN = WindowConfig(KW=12, NB=4, LM=64, OBS=128, MIMU=64)
DTYPES = [torch.float32, torch.float64]
CASES = list(ACCEPT_CASES)


def _np(t):
    return t.detach().cpu().numpy()


def _plain(case, dtype, in_place=False, seed=0):
    st, trial, ne_t, cost_t, opts = accept_case(WIN, dtype, "cpu", case,
                                                seed)
    return lk4.accept_step_plain(st, trial, ne_t, cost_t,
                                 opts.lm_lambda_down, opts.lm_lambda_up,
                                 opts.tol, in_place)


def _jax_rule(case, dtype, seed=0):
    """The JAX package's LM body and cond on the case, as lm.py:232-249
    write them: the body's new carry where the cond holds, else the
    carry."""
    st, trial, ne_t, cost_t, opts = accept_case(WIN, dtype, "cpu", case,
                                                seed)
    J = lambda t: jnp.asarray(_np(t))  # noqa: E731
    p, ne = [J(x) for x in st.p], [J(x) for x in st.ne]
    cost, lam, n_acc = J(st.cost), J(st.lam), J(st.n_acc).astype(jnp.int32)
    it, done = J(st.iters).astype(jnp.int32), J(st.done)
    trial, ne_t, cost_t = [J(x) for x in trial], [J(x) for x in ne_t], \
        J(cost_t)
    # body (lm.py:232-245, the trial's parts given)
    accept = jnp.logical_and(cost_t < cost, jnp.isfinite(cost_t))
    p_next = [jnp.where(accept, b, a) for a, b in zip(p, trial)]
    ne_next = [jnp.where(accept, b, a) for a, b in zip(ne, ne_t)]
    lam_next = jnp.where(accept, lam * opts.lm_lambda_down,
                         lam * opts.lm_lambda_up)
    lam_next = jnp.clip(lam_next, 1e-10, 1e8)
    cost_next = jnp.where(accept, cost_t, cost)
    rel_dec = (cost - cost_next) / jnp.maximum(cost, 1e-30)
    done_next = jnp.logical_and(accept, rel_dec < opts.tol)
    new = (p_next + ne_next + [cost_next, lam_next,
                               n_acc + accept.astype(jnp.int32), done_next,
                               it + 1])
    # cond (lm.py:247-249)
    go = jnp.logical_and(it < opts.max_iters, jnp.logical_not(done))
    old = p + ne + [cost, lam, n_acc, done, it]
    return [np.asarray(jnp.where(go, a, b)) for a, b in zip(new, old)]


def _same(got, ref):
    """Leaf by leaf the same values (NaN where NaN), counts by value."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        if a.dtype.kind == "f":
            assert a.dtype == b.dtype
            assert np.array_equal(a, b, equal_nan=True)
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_step_is_the_jax_rule(dtype):
    """`lm_kernels.accept_step_plain` against the JAX package's LM body
    and cond in every case: bit for bit."""
    for case in CASES:
        got = [_np(t) for t in graphs.leaves(_plain(case, dtype))]
        _same(got, _jax_rule(case, dtype))


def test_cases_take_the_branches_they_name():
    """The cases reach what they are named for: accept or not, done or
    not, lambda clamped."""
    expect = {"accepted": (4, False), "rejected": (3, False),
              "done": (3, True), "nan_cost_t": (3, False),
              "inf_cost_t": (3, False), "rel_dec_at_tol": (4, False),
              "rel_dec_at_f32_tol": (4, False),
              "converged": (4, True), "lam_floor": (4, False),
              "lam_ceiling": (3, False)}
    for dtype in DTYPES:
        for case, (n_acc, done) in expect.items():
            new = _plain(case, dtype)
            assert (int(new.n_acc), bool(new.done)) == (n_acc, done), case
        assert float(_plain("lam_floor", dtype).lam) == float(
            torch.tensor(1e-10, dtype=dtype))
        assert float(_plain("lam_ceiling", dtype).lam) == 1e8


@pytest.mark.parametrize("dtype", DTYPES)
def test_in_place_plain_step_updates_the_state(dtype):
    """With `in_place` the plain version writes the same values into the
    state's own tensors and returns them."""
    for case in ("accepted", "rejected", "converged"):
        st = accept_case(WIN, dtype, "cpu", case)[0]
        got = _plain(case, dtype, in_place=True)
        ref = _plain(case, dtype)
        assert all(torch.equal(a, b) for a, b in
                   zip(graphs.leaves(got), graphs.leaves(ref)))
        assert [t.shape for t in graphs.leaves(got)] == \
            [t.shape for t in graphs.leaves(st)]


# ---------------------------------------------------------------------------
# K4's code on the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host harness")
    lib_path = tmp_path_factory.mktemp("lm_accept_host") / "liblm_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(lib_path), str(HARNESS)], check=True,
                   capture_output=True, text=True)
    lib = lk4.declare(ctypes.CDLL(str(lib_path)))
    lib.lm_accept_host_conditions.argtypes = [ctypes.c_void_p]
    lib.lm_accept_host_blocks.argtypes = [ctypes.c_longlong]
    lib.lm_accept_host_blocks.restype = ctypes.c_int
    return lib


def _lanes(cases, dtype, misalign=False):
    """The cases as lanes: (state leaves, trial leaves, scalars (cost,
    cost_t, lam, n_acc, done, iters)), each with a lane axis, and the
    options. `misalign`: every leaf one element into a larger buffer, so
    none is 16-byte aligned."""
    per = [accept_case(WIN, dtype, "cpu", c, seed=k)
           for k, c in enumerate(cases)]

    def stack(ts):
        t = torch.stack(ts)
        if not misalign:
            return t
        buf = torch.empty(t.numel() + 1, dtype=t.dtype)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    leaves = [stack([graphs.leaves(x[0])[k] for x in per])
              for k in range(lk4.N_LEAVES)]
    trial = [stack([([*x[1], *x[2]])[k] for x in per])
             for k in range(lk4.N_LEAVES)]
    scalars = [torch.stack([x[3] if k == 1 else
                            [x[0].cost, None, x[0].lam, x[0].n_acc,
                             x[0].done, x[0].iters][k] for x in per])
               for k in range(6)]
    return leaves, trial, scalars, per[0][4]


def _run_host(lib, in_place, leaves, trial, scalars, opts, handle=None):
    """The harness's K4 on the lanes; returns the state after it (the
    outputs, or the updated inputs in place) and the conditions."""
    L = scalars[0].shape[0]
    if in_place:
        outs = leaves
        s_outs = [scalars[0], scalars[2], scalars[3], scalars[4],
                  scalars[5]]
        arrive = torch.zeros(L, dtype=torch.int32)
    else:
        outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
                for t in leaves]
        s_outs = [torch.empty(L, dtype=d) for d in (
            leaves[0].dtype, leaves[0].dtype, torch.int64, torch.bool,
            torch.int64)]
        arrive = None
    lk4.call(lib, in_place, leaves, trial, scalars, outs, s_outs,
             opts.lm_lambda_down, opts.lm_lambda_up, opts.tol,
             opts.max_iters, handle, arrive)
    cond = (ctypes.c_int * L)()
    lib.lm_accept_host_conditions(cond)
    if arrive is not None:
        assert int(arrive.abs().sum()) == 0  # zero at rest
    return [*outs, *s_outs], list(cond)


def _plain_lanes(cases, dtype):
    return [[_np(t) for t in graphs.leaves(_plain(c, dtype, seed=k))]
            for k, c in enumerate(cases)]


def _check_lanes(got, cases, dtype):
    ref = _plain_lanes(cases, dtype)
    for ln in range(len(cases)):
        _same([_np(t[ln]) for t in got], ref[ln])


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_host_kernel_matches_plain_one_lane(host, dtype, in_place):
    """One lane, every case, both instances: the plain version's bits,
    and the condition !done && iters < max_iters where a handle is
    given; the lane spans several blocks."""
    items = sum(int(np.prod(s)) for s in
                [t.shape[1:] for t in _lanes(["accepted"], dtype)[0]])
    assert host.lm_accept_host_blocks(items // (16 // (
        4 if dtype == torch.float32 else 8))) > 4
    for case in CASES:
        leaves, trial, scalars, opts = _lanes([case], dtype)
        got, cond = _run_host(host, in_place, leaves, trial, scalars, opts,
                              handle=7)
        _check_lanes(got, [case], dtype)
        new = _plain(case, dtype)
        assert cond == [int(not bool(new.done)
                            and int(new.iters) < opts.max_iters)]


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_host_kernel_matches_plain_three_lanes(host, dtype, in_place):
    """Three lanes of different cases in one call, both instances, with
    and without 16-byte alignment: each lane the plain version's bits;
    without a handle no condition is set."""
    for cases in (["accepted", "rejected", "done"],
                  ["converged", "nan_cost_t", "lam_floor"]):
        for misalign in (False, True):
            leaves, trial, scalars, opts = _lanes(cases, dtype, misalign)
            got, cond = _run_host(host, in_place, leaves, trial, scalars,
                                  opts)
            _check_lanes(got, cases, dtype)
            assert cond == [-1, -1, -1]


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_kernel_reads_shared_inputs_at_lane_stride_0(host, dtype):
    """The functional instance with the trial shared by three lanes
    (expanded, lane stride 0, as the vmap rule passes an unbatched
    input): each lane the plain version's bits."""
    cases = ["accepted", "rejected", "converged"]
    leaves, trial, scalars, opts = _lanes(cases, dtype)
    trial = [t[:1].expand_as(t) for t in trial]
    got, _ = _run_host(host, False, leaves, trial, scalars, opts)
    for ln, case in enumerate(cases):
        st, tr, ne_t, cost_t, o = accept_case(WIN, dtype, "cpu", case,
                                              seed=ln)
        tr0 = accept_case(WIN, dtype, "cpu", cases[0], seed=0)
        ref = lk4.accept_step_plain(st, tr0[1], tr0[2], cost_t,
                                    o.lm_lambda_down, o.lm_lambda_up, o.tol)
        _same([_np(t[ln]) for t in got], [_np(t) for t in
                                          graphs.leaves(ref)])


# ---------------------------------------------------------------------------
# the custom op
# ---------------------------------------------------------------------------


def _op_args(cases, dtype):
    leaves, trial, scalars, opts = _lanes(cases, dtype)
    return [*leaves, *trial, *scalars], opts


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_vmap_rule_is_one_call_over_the_lanes(dtype, monkeypatch):
    """`torch.func.vmap` over three lanes of the custom op (a lane axis of
    1 each, the trial shared) makes one call of the op over three lanes,
    equal to the plain version lane by lane."""
    cases = ["accepted", "rejected", "converged"]
    ts, opts = _op_args(cases, dtype)
    op, calls = lk4.lm_accept_op, []

    def spy(*a):
        calls.append(a[0].shape[0])
        return op(*a)

    monkeypatch.setattr(lk4, "lm_accept_op", spy)
    shared = range(lk4.N_LEAVES, 2 * lk4.N_LEAVES)
    in_dims = tuple(None if k in shared else 0 for k in range(len(ts)))
    args = [t[:1] if k in shared else t.unsqueeze(1)
            for k, t in enumerate(ts)]
    out = torch.func.vmap(
        lambda *a: op(*a, opts.lm_lambda_down, opts.lm_lambda_up, opts.tol,
                      opts.max_iters, None), in_dims=in_dims)(*args)
    assert calls == [3]
    tr0 = accept_case(WIN, dtype, "cpu", cases[0], seed=0)
    for ln, case in enumerate(cases):
        st, _, _, cost_t, o = accept_case(WIN, dtype, "cpu", case, seed=ln)
        ref = lk4.accept_step_plain(st, tr0[1], tr0[2], cost_t,
                                    o.lm_lambda_down, o.lm_lambda_up, o.tol)
        _same([_np(t[ln, 0]) for t in out],
              [_np(t) for t in graphs.leaves(ref)])


def test_op_fake_shapes():
    """The op's fake shapes and dtypes are those of its outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ts, opts = _op_args(["accepted", "rejected"], torch.float32)
    real = lk4.lm_accept_op(*ts, opts.lm_lambda_down, opts.lm_lambda_up,
                            opts.tol, opts.max_iters, None)
    with FakeTensorMode() as mode:
        fake = lk4.lm_accept_op(*[mode.from_tensor(t) for t in ts],
                                opts.lm_lambda_down, opts.lm_lambda_up,
                                opts.tol, opts.max_iters, None)
    assert [(t.shape, t.dtype) for t in fake] == \
        [(t.shape, t.dtype) for t in real]


def test_wrapper_on_the_cpu_takes_the_plain_version():
    """On the CPU `accept_step` runs the plain version (counted), launches
    nothing, and refuses a conditional handle."""
    lk4.reset_counts()
    st, trial, ne_t, cost_t, opts = accept_case(WIN, torch.float32, "cpu")
    new = lk4.accept_step(st, trial, ne_t, cost_t, opts)
    assert lk4.counts() == {"lm_accept": 0, "lm_accept_plain": 1}
    _same([_np(t) for t in graphs.leaves(new)],
          [_np(t) for t in graphs.leaves(_plain("accepted",
                                                torch.float32))])
    with pytest.raises(ValueError):
        lk4.accept_step(st, trial, ne_t, cost_t, opts, handle=1)
