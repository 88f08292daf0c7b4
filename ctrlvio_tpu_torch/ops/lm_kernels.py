"""The LM iteration's accept step and exit: kernel K4 and its plain version.

After each LM trial (`solver/lm.py`) the state takes the trial's
parameters and normal equations where the trial is accepted (its cost
lower and finite, the solve not done), and the five scalars move on: the
cost, lambda (down on an accept, up on a rejection, clamped; frozen once
done), the accepted count, `done` (an accepted step with relative cost
decrease below `tol`) and the iteration count (while not done). K4
(`csrc/lm_accept.cu`, `accept_step`) does that in one launch, and in a
captured solve also sets the condition of the CUDA-graph WHILE node that
holds the later iterations (`utils/graphs.py::run_while`) to "not done and
fewer than `max_iters` iterations". It replaces no Pallas kernel: it ports
what XLA fuses from the JAX package's LM loop (`ctrlvio_tpu/solver/
lm.py:225-252`: the body's accept test and `tree_map(jnp.where)` selects,
and the `while_loop`'s cond).

- `accept_step_plain`: the plain PyTorch version, the solver's former
  composition (the trial's accept test, one `torch.where` a leaf, the
  scalars' updates; with `in_place`, the copy into the state's tensors).
- `accept_step`: the wrapper. CPU tensors take the plain version; CUDA
  tensors launch K4 or raise: there is no fallback. `in_place` launches
  the in-place instance (the state's tensors updated, nothing written on
  a rejection); otherwise the functional instance writes fresh outputs,
  through the custom op `torch.ops.ctrlvio_tpu_torch.lm_accept` (a lane
  axis first; its vmap rule folds the vmapped axis into it, shared inputs
  at lane stride 0, so B lanes under vmap are one launch). The in-place
  instance goes through `torch.ops.ctrlvio_tpu_torch.lm_accept_` (one
  lane, the state's tensors mutated). Both ops launch from inside a
  dispatched op, so a profiler links each launch to the range that made
  it. `handle`, a conditional handle from `graphs.while_handle`, makes
  the launch set it.

`kernel_attributes()` reads the four instances' registers, spill bytes,
shared bytes and threads a block on the card. `accept_step.launches`
counts K4's launches and `accept_step_plain.calls` the plain version's
runs; `counts()` reads them (the launches in WHILE nodes' bodies
settled first, once a trip), `reset_counts()` zeroes them; both are
registered with `utils/graphs.py`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ctrlvio_tpu_torch.solver.layout import WindowParams
from ctrlvio_tpu_torch.utils import graphs

OP = "ctrlvio_tpu_torch::lm_accept"
LEAVES = ("knots_q", "knots_p", "bg", "ba", "dinv", "ld", "H", "g", "h_ll",
          "g_l", "H_cl")
SCALARS_IN = ("cost", "cost_t", "lam", "n_acc", "done", "iters")
N_LEAVES = len(LEAVES)
FLOATS = (torch.float32, torch.float64)


class LMState(NamedTuple):
    """What one LM iteration carries to the next."""

    p: WindowParams
    ne: tuple       # (H, g, h_ll, g_l, H_cl)
    cost: torch.Tensor
    lam: torch.Tensor
    n_acc: torch.Tensor   # int64
    done: torch.Tensor    # bool
    iters: torch.Tensor   # int64


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def accept_step_plain(st: LMState, trial: WindowParams, ne_t, cost_t,
                      lm_lambda_down: float, lm_lambda_up: float,
                      tol: float, in_place: bool = False) -> LMState:
    """The state after the trial (`trial`, its normal equations `ne_t`
    and cost `cost_t`): every piece selected by `torch.where` on
    `accept`, which is false once `done` is set, so a step after `done`
    changes nothing. With `in_place` the new values are copied into the
    tensors of `st`, which is returned."""
    accept_step_plain.calls += 1
    p, ne, cost, lam, n_acc, done, iters = st
    accept = (cost_t < cost) & torch.isfinite(cost_t)
    accept = accept & ~done
    rel_dec = (cost - cost_t) / torch.clamp(cost, min=1e-30)
    lam_next = torch.clamp(torch.where(accept, lam * lm_lambda_down,
                                       lam * lm_lambda_up), 1e-10, 1e8)
    new = LMState(
        p=type(p)(*(torch.where(accept, b, a) for a, b in zip(p, trial))),
        ne=tuple(torch.where(accept, b, a) for a, b in zip(ne, ne_t)),
        cost=torch.where(accept, cost_t, cost),
        lam=torch.where(done, lam, lam_next),
        n_acc=n_acc + accept.to(torch.int64),
        done=done | (accept & (rel_dec < tol)),
        iters=iters + (~done).to(torch.int64))
    if in_place:
        graphs.copy_tree(st, new)
        return st
    return new


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------


def declare(lib):
    """`lib` (the CUDA library, or a host build of the same source) with
    its entry point's signature declared."""
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.lm_accept.argtypes = [i, i, p, p, p, p, p, p, p, p, d, d, d,
                              ctypes.c_longlong, i, ctypes.c_ulonglong, p, i,
                              p]
    lib.lm_accept.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its entry points' signatures declared."""
    from ctrlvio_tpu_torch.utils import cuda_build

    lib = declare(cuda_build.load("lm_accept"))
    lib.lm_accept_attributes.argtypes = [ctypes.c_void_p]
    lib.lm_accept_attributes.restype = ctypes.c_int
    return lib


INSTANCES = ("float32 functional", "float32 in_place", "float64 functional",
             "float64 in_place")
ATTRIBUTES = ("registers", "local_bytes", "shared_bytes",
              "max_threads_per_block", "threads_per_block")


def kernel_attributes():
    """Each instance's resources on the card (`cudaFuncGetAttributes`):
    registers a thread, local (spill) bytes a thread, static shared bytes
    a block, the most threads a block it can launch with and the threads a
    block it launches with, by instance ("float32 functional", ...)."""
    n = len(ATTRIBUTES)
    out = (ctypes.c_longlong * (n * len(INSTANCES)))()
    err = _lib().lm_accept_attributes(out)
    if err != 0:
        raise RuntimeError(f"lm_accept_attributes: cudaError {err}")
    return {name: dict(zip(ATTRIBUTES, out[n * k: n * (k + 1)]))
            for k, name in enumerate(INSTANCES)}


def _lane_stride(t):
    return t.stride(0) if t.shape[0] > 1 else 0


def call(lib, in_place, leaves, trial, scalars, outs, s_outs, down, up, tol,
         max_iters, handle, arrive, stream=None):
    """One call of `lib`'s entry point: `leaves`, `trial` (11 each),
    `scalars` (cost, cost_t, lam, n_acc, done, iters) and the outputs
    `outs`, `s_outs` (cost, lam, n_acc, done, iters; the state's own in
    place) each with a lane axis, the lane's block contiguous; `arrive`
    the lanes' arrival counters (in place) or None. Raises if the entry
    point returns an error."""
    L = scalars[0].shape[0]
    dtype = FLOATS.index(leaves[0].dtype)
    P = ctypes.c_void_p
    ptrs = lambda ts: (P * len(ts))(*[t.data_ptr() for t in ts])  # noqa: E731
    n = (ctypes.c_longlong * N_LEAVES)(*[t[0].numel() for t in leaves])
    strides = (ctypes.c_longlong * (3 * N_LEAVES))(
        *[_lane_stride(t) for t in (*leaves, *trial, *outs)])
    s_strides = (ctypes.c_longlong * len(scalars))(
        *[_lane_stride(t) for t in scalars])
    err = lib.lm_accept(
        dtype, int(in_place), ptrs(leaves), ptrs(trial), ptrs(outs), n,
        strides, ptrs(scalars), s_strides, ptrs(s_outs), float(down),
        float(up), float(tol), int(max_iters), int(handle is not None),
        0 if handle is None else handle % 2**64,
        None if arrive is None else arrive.data_ptr(), L, stream)
    if err != 0:
        raise RuntimeError(f"lm_accept: K4 launch failed (cudaError {err})")


def _check(ts, L, fdt, dev):
    """Raise unless the op's inputs are what K4 takes: one device, one
    float dtype (f32 or f64) for the leaves, cost, cost_t and lam, int64
    counts, a bool done, a lane axis of `L`, each lane's block
    contiguous, the trial's leaves shaped as the state's."""
    if fdt not in FLOATS:
        raise TypeError(f"lm_accept: the state must be float32 or float64, "
                        f"got {fdt}")
    names = ([f"state.{x}" for x in LEAVES] + [f"trial.{x}" for x in LEAVES]
             + list(SCALARS_IN))
    want = [fdt] * (2 * N_LEAVES + 3) + [torch.int64, torch.bool,
                                         torch.int64]
    for t, name, w in zip(ts, names, want):
        if t.dtype != w:
            raise TypeError(f"lm_accept: {name} is {t.dtype}, expected {w}")
        if t.device != dev:
            raise ValueError(f"lm_accept: {name} is on {t.device}, "
                             f"expected {dev}")
        if t.dim() < 1 or t.shape[0] != L:
            raise ValueError(f"lm_accept: {name} has shape "
                             f"{tuple(t.shape)}, expected a lane axis of {L}")
        if not t[0].is_contiguous():
            raise ValueError(f"lm_accept: {name} must be contiguous in each "
                             f"lane")
    for k in range(N_LEAVES):
        if ts[k].shape[1:] != ts[N_LEAVES + k].shape[1:]:
            raise ValueError(f"lm_accept: trial.{LEAVES[k]} has shape "
                             f"{tuple(ts[N_LEAVES + k].shape)}, the state's "
                             f"{tuple(ts[k].shape)}")
    for t, name in zip(ts[2 * N_LEAVES:], SCALARS_IN):
        if t.dim() != 1:
            raise ValueError(f"lm_accept: {name} must be one value a lane")


def _require_cuda(dev):
    if dev.type != "cuda":
        raise ValueError(f"lm_accept: unsupported device {dev}")


def _launch(*args):
    """The op on the card: the functional instance, once over every
    lane."""
    ts, (down, up, tol, max_iters, handle) = args[:-5], args[-5:]
    dev, fdt, L = ts[0].device, ts[0].dtype, ts[-1].shape[0]
    _require_cuda(dev)
    _check(ts, L, fdt, dev)
    if handle is not None and L != 1:
        raise ValueError("lm_accept: a conditional handle takes one lane")
    leaves, trial, scalars = (ts[:N_LEAVES], ts[N_LEAVES: 2 * N_LEAVES],
                              ts[2 * N_LEAVES:])
    outs = [torch.empty((L, *t.shape[1:]), dtype=fdt, device=dev)
            for t in leaves]
    s_outs = [torch.empty((L,), dtype=d, device=dev)
              for d in (fdt, fdt, torch.int64, torch.bool, torch.int64)]
    with torch.cuda.device(dev):
        call(_lib(), False, leaves, trial, scalars, outs, s_outs, down, up,
             tol, max_iters, handle, None,
             torch.cuda.current_stream(dev).cuda_stream)
    accept_step.launches += 1
    return (*outs, *s_outs)


def _lanes_plain(*args):
    """The op off the card: the plain version lane by lane."""
    ts, (down, up, tol, _, handle) = args[:-5], args[-5:]
    if handle is not None:
        raise ValueError("lm_accept: a conditional handle needs the card")
    outs = []
    for ln in range(ts[-1].shape[0]):
        new = accept_step_plain(*_state(t[ln] for t in ts), down, up, tol)
        outs.append(graphs.leaves(new))
    return tuple(torch.stack(o) for o in zip(*outs))


def _fake(*args):
    ts = args[:-5]
    return (*(t.new_empty(t.shape) for t in ts[:N_LEAVES]),
            ts[2 * N_LEAVES].new_empty(ts[-1].shape),
            ts[2 * N_LEAVES].new_empty(ts[-1].shape),
            ts[-1].new_empty(ts[-1].shape),
            ts[-2].new_empty(ts[-1].shape),
            ts[-1].new_empty(ts[-1].shape))


def _lane_major(a, d, B):
    """A vmapped input as the op takes it under vmap: the vmapped axis
    `d` (None: shared by every lane) folded into the lane axis, each
    lane's block contiguous."""
    if d is None:
        a = a.unsqueeze(0).expand(B, *a.shape)
    else:
        a = a.movedim(d, 0)
    a = a.reshape(B * a.shape[1], *a.shape[2:])
    return a if a[0].is_contiguous() else a.contiguous()


def _vmap_rule(info, in_dims, *args):
    B = info.batch_size
    flat = [_lane_major(a, d, B) if isinstance(a, torch.Tensor) else a
            for a, d in zip(args, in_dims)]
    outs = lm_accept_op(*flat)
    return (tuple(o.reshape(B, -1, *o.shape[1:]) for o in outs),
            (0,) * len(outs))


_SCHEMA = ("(" + ", ".join(
    [f"Tensor {x}" for x in LEAVES] + [f"Tensor t_{x}" for x in LEAVES]
    + [f"Tensor {x}" for x in SCALARS_IN])
    + ", float down, float up, float tol, int max_iters, int? handle) -> ("
    + ", ".join(["Tensor"] * (N_LEAVES + 5)) + ")")

lm_accept_op = torch.library.custom_op(OP, _lanes_plain, mutates_args=(),
                                       schema=_SCHEMA)
lm_accept_op.register_kernel("cuda")(_launch)
lm_accept_op.register_fake(_fake)
torch.library.register_vmap(OP, _vmap_rule)


# device -> the in-place instance's arrival counter (one lane), made at its
# first launch, which is never inside a capture: a program's warm-up runs
# every loop's body eagerly first
_ARRIVE = {}


def _arrive(dev):
    if dev not in _ARRIVE:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("lm_accept: the in-place instance's first "
                               "launch on a device cannot be captured")
        _ARRIVE[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return _ARRIVE[dev]


def _state(ts):
    """The state, trial, trial normal equations and trial cost from the
    op's tensors (state leaves, trial leaves, scalars)."""
    x = list(ts)
    cost, cost_t, lam, n_acc, done, iters = x[2 * N_LEAVES:]
    return (LMState(WindowParams(*x[:6]), tuple(x[6:N_LEAVES]), cost, lam,
                    n_acc, done, iters),
            WindowParams(*x[N_LEAVES:N_LEAVES + 6]),
            tuple(x[N_LEAVES + 6:2 * N_LEAVES]), cost_t)


def _in_place_plain(*args):
    """The in-place op off the card: the plain version, in place."""
    ts, (down, up, tol, _, handle) = args[:-5], args[-5:]
    if handle is not None:
        raise ValueError("lm_accept: a conditional handle needs the card")
    accept_step_plain(*_state(ts), down, up, tol, in_place=True)


def _launch_in_place(*args):
    """The in-place op on the card: K4's in-place instance, one lane."""
    ts, (down, up, tol, max_iters, handle) = args[:-5], args[-5:]
    dev, fdt = ts[0].device, ts[0].dtype
    _require_cuda(dev)
    one = [t.unsqueeze(0) for t in ts]
    _check(one, 1, fdt, dev)
    for t, name in zip(ts[:N_LEAVES], LEAVES):
        if not t.is_contiguous():
            raise ValueError(f"lm_accept: state.{name} must be contiguous "
                             f"to be updated in place")
    leaves, trial, scalars = (one[:N_LEAVES], one[N_LEAVES: 2 * N_LEAVES],
                              one[2 * N_LEAVES:])
    s_outs = [scalars[0], scalars[2], scalars[3], scalars[4], scalars[5]]
    with torch.cuda.device(dev):
        call(_lib(), True, leaves, trial, scalars, leaves, s_outs, down, up,
             tol, max_iters, handle, _arrive(dev),
             torch.cuda.current_stream(dev).cuda_stream)
    accept_step.launches += 1


MUTATED = (*LEAVES, "cost", "lam", "n_acc", "done", "iters")
_IN_PLACE_SCHEMA = ("(" + ", ".join(
    [f"Tensor(a{k}!) {x}" for k, x in enumerate(LEAVES)]
    + [f"Tensor t_{x}" for x in LEAVES]
    + ["Tensor(b0!) cost", "Tensor cost_t", "Tensor(b1!) lam",
       "Tensor(b2!) n_acc", "Tensor(b3!) done", "Tensor(b4!) iters"])
    + ", float down, float up, float tol, int max_iters, int? handle) -> ()")

lm_accept_in_place_op = torch.library.custom_op(
    OP + "_", _in_place_plain, mutates_args=MUTATED, schema=_IN_PLACE_SCHEMA)
lm_accept_in_place_op.register_kernel("cuda")(_launch_in_place)
lm_accept_in_place_op.register_fake(lambda *args: None)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def _flat(st: LMState, trial: WindowParams, ne_t, cost_t):
    """The state's leaves, the trial's, and the six scalars."""
    return ([*st.p, *st.ne], [*trial, *ne_t],
            [st.cost, cost_t, st.lam, st.n_acc, st.done, st.iters])


def _signed(handle):
    """A conditional handle (unsigned 64 bits) as an op's int argument."""
    if handle is None:
        return None
    return handle if handle < 2**63 else handle - 2**64


def accept_step(st: LMState, trial: WindowParams, ne_t, cost_t, opts,
                handle: Optional[int] = None,
                in_place: bool = False) -> LMState:
    """The state after the trial (see `accept_step_plain`; `opts` gives
    lambda's factors, `tol` and `max_iters`). CPU tensors take the plain
    version; CUDA tensors launch K4 once, or raise. `in_place` updates
    the tensors of `st` (and returns it); `handle` (a conditional handle
    of the capture, `graphs.while_handle`) makes K4 set the WHILE node's
    condition."""
    dev = st.cost.device
    if dev.type == "cpu":
        if handle is not None:
            raise ValueError("lm_accept: a conditional handle needs the card")
        return accept_step_plain(st, trial, ne_t, cost_t,
                                 opts.lm_lambda_down, opts.lm_lambda_up,
                                 opts.tol, in_place)
    _require_cuda(dev)
    leaves, tr, scalars = _flat(st, trial, ne_t, cost_t)
    consts = (float(opts.lm_lambda_down), float(opts.lm_lambda_up),
              float(opts.tol), int(opts.max_iters), _signed(handle))
    if in_place:
        lm_accept_in_place_op(*leaves, *(t.contiguous() for t in tr),
                              *scalars, *consts)
        return st
    out = lm_accept_op(*(t.unsqueeze(0) for t in (*leaves, *tr, *scalars)),
                       *consts)
    out = [o[0] for o in out]
    return LMState(type(st.p)(*out[:6]), tuple(out[6:N_LEAVES]),
                   *out[N_LEAVES:])


def reset_counts():
    """Set K4's launch count and the plain version's call count to 0."""
    accept_step.launches = 0
    accept_step_plain.calls = 0


def _counts():
    """K4's launches (`lm_accept`) and the plain version's runs
    (`lm_accept_plain`)."""
    return {"lm_accept": accept_step.launches,
            "lm_accept_plain": accept_step_plain.calls}


def _add_counts(delta):
    accept_step.launches += delta.get("lm_accept", 0)
    accept_step_plain.calls += delta.get("lm_accept_plain", 0)


reset_counts()
counts = graphs.register_counter(_counts, _add_counts)
