"""Captured programs: the port's counterpart of `jax.jit`.

The JAX package compiles each per-frame function into one program with
`jax.jit` and dispatches it once a call. On the card the port captures the
same function into a CUDA graph, once per set of static arguments, and
replays it with one launch a call:

- `Program` captures `fn(*args, **static)` over static input buffers on the
  device. Each call copies its arguments into those buffers (a
  non-blocking copy from pinned host memory, or a copy on the device),
  replays the graph and returns the graph's output tensors. The next
  replay overwrites them: a caller that keeps an output past the next call
  keeps a copy.
- With `carry=True`, `fn` returns (new state, outputs), and the graph
  copies the new state into the buffers of its first argument. So a state
  chained from call to call stays in place: the program returns those
  buffers as the state, and a call that passes them back copies nothing.
- `ProgramCache` keys its programs as `jax.jit` keys its cache: the
  function, the static arguments, the structure, shapes and dtypes of the
  tensor arguments, and the device.

Before its capture the function runs once on the capture stream (a side
stream), on copies of the arguments, and its results are thrown away, so
that cuBLAS and cuSOLVER create their handles and workspaces outside the
graph. Warm-up
and capture run with cuSOLVER as the linear-algebra library: MAGMA
synchronizes with the host, which a capture cannot hold. A capture or a
replay that fails raises; nothing falls back to running the function
eagerly on the card. On the CPU, `ProgramCache.get` returns the function
itself, run eagerly: the plain version, as the kernel rule has CPU tensors
take (`graphed_on`).

The programs of one `ProgramCache` share one graph memory pool a device,
and the pool lives as long as they do (PyTorch's allocator releases a pool
once the last graph capturing into it is gone, and a released pool cannot
take another capture). Sharing is safe because a cache's programs replay
one at a time on the current stream of the thread that runs them, and
each keeps its own outputs alive: a replay writes only into its own
outputs and into intermediates that no live tensor holds.

`run_if(pred, body, carry)` is the one control-flow primitive (≙ the
exit of `lax.while_loop`): while a graph is captured it records `body`
into a CUDA-graph IF node on the 0-dim device bool `pred`, so a replay
runs the body only where `pred` is true; run eagerly (the warm-up before
a capture, the CPU) the body always runs. `body` writes its results into
the `carry` tensors in place, and nothing made inside it is read after
it. The installed torch (2.11) has no conditional node of its own, so
the node comes from `csrc/graph_cond.cu` (built at first use, like the
kernels): a one-thread kernel sets the node's condition from `pred` on
each replay, and the body is captured on a stream of its own, its memory
from a graph pool of its own. Each recorded body also adds one to a
device counter, so `stats` reports the bodies the replays ran.

A kernel wrapper registered with `register_counter` counts its kernel's
launches as they run. A launch made while a graph is captured runs nothing:
its count is taken back, held by the program, and added again on each
replay. `stats` lists the captures (key, seconds, reserved device memory
before and after) and counts the replays and the launches they made.
"""

from __future__ import annotations

import contextlib
import functools
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch

# (read() -> {name: count}, add({name: delta})) of each registered kernel
# wrapper's launch counts
_COUNTERS: List = []
# every live cache, for the size of their pools (`pool_mb`)
_CACHES = weakref.WeakSet()
_STATS: Dict = {}
# device -> int64 tensor: the recorded `run_if` bodies the replays ran
_BODIES: Dict = {}
# device -> (the stream bodies are captured on, their graph pool)
_BODY_STREAMS: Dict = {}
# launches of the IF nodes' set kernel (`csrc/graph_cond.cu`), a counter
# like a kernel wrapper's: a capture holds them, each replay adds them
_IF_LAUNCHES: Dict[str, int] = {"if_node_set": 0}


def register_counter(read: Callable[[], Dict[str, int]],
                     add: Callable[[Dict[str, int]], None]):
    """Register a kernel wrapper's launch counts (see the module notes)."""
    _COUNTERS.append((read, add))


def _read_if_launches():
    return dict(_IF_LAUNCHES)


def _add_if_launches(d):
    for k, v in d.items():
        _IF_LAUNCHES[k] += v


def reset_counts():
    """Forget the recorded captures and set the replay counts to 0 (the
    programs themselves stay captured)."""
    _STATS.clear()
    _STATS.update(captures=[], replays=0, launches_replayed={},
                  launches_warm_up={}, if_nodes=0)
    for t in _BODIES.values():
        t.zero_()
    _IF_LAUNCHES["if_node_set"] = 0


reset_counts()
register_counter(_read_if_launches, _add_if_launches)


def _read_counts():
    return [read() for read, _ in _COUNTERS]


def _gained(before, after):
    """Per counter, the counts that grew from `before` to `after`."""
    return [{k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}
            for b, a in zip(before, after)]


def _tally(into: Dict[str, int], deltas):
    for d in deltas:
        for k, v in d.items():
            into[k] = into.get(k, 0) + v


@contextlib.contextmanager
def held_launches():
    """Yield a list that, on exit, holds per registered counter the
    launches counted inside; the counts themselves are set back. What a
    capture records runs only when the graph is replayed."""
    before = _read_counts()
    held: List = []
    try:
        yield held
    finally:
        gained = _gained(before, _read_counts())
        for (_, add), d in zip(_COUNTERS, gained):
            add({k: -v for k, v in d.items()})
        held.extend(gained)


def graphed_on(device: torch.device) -> bool:
    """Whether programs on `device` run as captured graphs: on a CUDA
    device they do; on the CPU the function runs eagerly."""
    return device.type == "cuda"


# ---------------------------------------------------------------------------
# trees of tensors: tensors in (named) tuples and lists
# ---------------------------------------------------------------------------


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_map(f, tree):
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(f, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, t) for t in tree)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def clone(tree):
    """A copy of every tensor of `tree`, same structure."""
    return tree_map(torch.clone, tree)


def _signature(tree):
    """Structure, shapes and dtypes of a tree of tensors (hashable)."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return (type(tree).__name__,) + tuple(_signature(t) for t in tree)


def copy_tree(dst, src):
    """Copy the leaves of `src` into those of `dst` (a leaf that is its
    own destination, a state passed through unchanged, is left as it
    is)."""
    for a, b in zip(leaves(dst), leaves(src)):
        a.copy_(b)


def _eager(fn, static, device, *args):
    """`fn(*args, **static)` run eagerly, its arguments moved to `device`
    first (a program's host inputs come as pinned host buffers; on the CPU
    nothing moves)."""
    return fn(*tree_map(lambda t: t.to(device, non_blocking=True), args),
              **static)


def _body(fn, static, carry, inputs):
    out = fn(*inputs, **static)
    if not carry:
        return out
    state, rest = out
    copy_tree(inputs[0], state)
    return rest


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------


def _indexed(device: torch.device) -> torch.device:
    """`device` with its index (a tensor's device always has one)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _body_counter(device: torch.device) -> torch.Tensor:
    """The device's counter of recorded bodies run, made by `Program`
    before its capture: one made during a capture would be the graph's
    memory, zeroed by a kernel of the graph."""
    device = _indexed(device)
    if device not in _BODIES:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("graphs.run_if records its node only in a "
                               "`Program`'s capture")
        _BODIES[device] = torch.zeros((), dtype=torch.int64, device=device)
    return _BODIES[device]


def _cond_lib():
    """The IF-node helper (`csrc/graph_cond.cu`), built at first use."""
    import ctypes

    from . import cuda_build

    lib = cuda_build.load("graph_cond")
    p = ctypes.c_void_p
    lib.if_stream_create.argtypes = [ctypes.POINTER(p)]
    lib.if_begin.argtypes = [p, p, p, ctypes.POINTER(p)]
    lib.if_end.argtypes = [p, p]
    lib.if_error_string.argtypes = [ctypes.c_int]
    lib.if_error_string.restype = ctypes.c_char_p
    return lib


def _cond_check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: {lib.if_error_string(err).decode()}")


def _body_stream(device: torch.device):
    """The device's stream that bodies are captured on (its own, never in
    any other capture), and the pool their allocations come from: one of
    their own, since the allocator records one capture at a time into a
    pool; it is never released (bodies run one at a time, so its blocks
    serve every body of the process)."""
    if device not in _BODY_STREAMS:
        import ctypes

        lib = _cond_lib()
        raw = ctypes.c_void_p()
        with torch.cuda.device(device):
            _cond_check(lib, lib.if_stream_create(ctypes.byref(raw)),
                        "creating the body stream")
        _BODY_STREAMS[device] = (torch.cuda.ExternalStream(raw.value,
                                                           device=device),
                                 torch.cuda.graph_pool_handle())
    return _BODY_STREAMS[device]


def run_if(pred: torch.Tensor, body: Callable, carry) -> None:
    """`body(carry)` where the 0-dim bool tensor `pred` is true: recorded
    into a CUDA-graph IF node while the current stream is captured, run
    unconditionally otherwise (see the module notes). `body` updates the
    tensors of `carry` in place."""
    if not (pred.is_cuda and torch.cuda.is_current_stream_capturing()):
        body(carry)
        return
    import ctypes

    lib = _cond_lib()
    device = pred.device
    counter = _body_counter(device)
    side, pool = _body_stream(device)
    pred = pred.to(torch.bool).contiguous()
    node_body = ctypes.c_void_p()
    _cond_check(lib, lib.if_begin(
        torch.cuda.current_stream(device).cuda_stream, pred.data_ptr(),
        side.cuda_stream, ctypes.byref(node_body)), "adding an IF node")
    _IF_LAUNCHES["if_node_set"] += 1
    torch._C._cuda_beginAllocateCurrentThreadToPool(device.index, pool)
    try:
        with torch.cuda.stream(side):
            body(carry)
            counter.add_(1)
    finally:
        torch._C._cuda_endAllocateToPool(device.index, pool)
        err = lib.if_end(side.cuda_stream, node_body)
    _cond_check(lib, err, "ending an IF node's body")
    _STATS["if_nodes"] += 1


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


def capture(body, inputs, device: torch.device, pool, stream):
    """Capture `body(inputs)` into a CUDA graph on `device` and `stream`,
    its memory from `pool`. Returns (the graph's output tree, a function
    that replays it)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool,
                                                     stream=stream):
        out = body(inputs)
    return out, graph.replay


@contextlib.contextmanager
def _capture_stream(device: torch.device):
    """Yield the side stream that warm-up and capture run on (None on the
    CPU), ordered after the current stream's work and before its next."""
    if device.type != "cuda":
        yield None
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    yield side
    torch.cuda.current_stream(device).wait_stream(side)


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """cuSOLVER/cuBLAS for the linear algebra inside (MAGMA synchronizes
    with the host)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _reserved_mb(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.memory_reserved(device) / 2**20


def pool_mb() -> Optional[float]:
    """Device memory the live caches' graph pools hold now (MiB), from the
    caching allocator's segments; None where no pool exists or the
    allocator does not report pools."""
    ids = {tuple(h) for c in _CACHES for h in c._pools.values()
           if h is not None}
    if not ids:
        return None
    total, found = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            continue
        found = True
        if tuple(pid) in ids:
            total += seg["total_size"]
    return total / 2**20 if found else None


def _label(fn, static, deterministic: bool = False) -> str:
    name = getattr(fn, "__name__", None) or getattr(
        getattr(fn, "func", None), "__name__", type(fn).__name__)
    short = [f"{k}={v}" for k, v in static.items()
             if isinstance(v, (bool, int, str, torch.dtype))]
    if deterministic:
        short.append("deterministic")
    return f"{name}({', '.join(short)})"


class Program:
    """One captured function (see the module notes). Call it with
    arguments of the captured structure, shapes and dtypes."""

    def __init__(self, fn, args, static: dict, carry: bool,
                 device: torch.device, pool, label: Optional[str] = None):
        self.label = label or _label(fn, static)
        self.carry = carry
        self.replays = 0
        body = functools.partial(_body, fn, static, carry)

        def on_device(t):
            return t.to(device, non_blocking=True, copy=True)

        self.inputs = tree_map(on_device, args)
        self._body, self._device = body, device
        if device.type == "cuda":
            _body_counter(device)
        with _cusolver(device), _capture_stream(device) as stream:
            t0 = time.perf_counter()
            before = _read_counts()
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                body(tree_map(on_device, args))
            warm = _gained(before, _read_counts())
            t1 = time.perf_counter()
            mb0 = _reserved_mb(device)
            with held_launches() as held:
                self.outputs, self._replay = capture(body, self.inputs,
                                                     device, pool, stream)
        self._held = held
        _tally(_STATS["launches_warm_up"], warm)
        _STATS["captures"].append({
            "key": self.label, "device": str(device),
            "warm_up_s": t1 - t0, "s": time.perf_counter() - t1,
            "reserved_mb_before": mb0,
            "reserved_mb_after": _reserved_mb(device)})

    def run_eagerly(self, inputs):
        """The captured function run op by op on `inputs` (a tree shaped
        like `self.inputs`; with `carry`, its state is updated in place),
        as the warm-up before the capture runs it: what a replay computes,
        with each op and `torch.profiler.record_function` range on the
        host, where a profiler can attribute the card's work to them."""
        with _cusolver(self._device):
            return self._body(inputs)

    def __call__(self, *args):
        for buf, a in zip(leaves(self.inputs), leaves(args)):
            if a is not buf:
                buf.copy_(a, non_blocking=True)
        self._replay()
        self.replays += 1
        _STATS["replays"] += 1
        for (_, add), d in zip(_COUNTERS, self._held):
            add(d)
        _tally(_STATS["launches_replayed"], self._held)
        if self.carry:
            return self.inputs[0], self.outputs
        return self.outputs


class ProgramCache:
    """Programs keyed like `jax.jit`'s cache. `get(fn, args, device,
    static, carry)` returns the callable to call with `args`: on a device
    that runs graphs (`graphed_on`), the `Program` of that key, captured on
    first use; elsewhere `fn` itself with `static` bound, run eagerly on
    the arguments moved to `device`. The key also holds whether
    `torch.use_deterministic_algorithms` is on: a graph replays the
    kernels it captured, so the two modes get programs of their own."""

    def __init__(self):
        self._programs: Dict = {}
        self._pools: Dict = {}  # device -> graph pool handle
        _CACHES.add(self)

    def __len__(self):
        return len(self._programs)

    def get(self, fn, args, device, static: Optional[dict] = None,
            carry: bool = False, label: Optional[str] = None):
        static = static or {}
        device = torch.device(device)
        if not graphed_on(device):
            return functools.partial(_eager, fn, static, device)
        det = torch.are_deterministic_algorithms_enabled()
        key = (fn, tuple(sorted(static.items())), _signature(args), device,
               det)
        prog = self._programs.get(key)
        if prog is None:
            if device not in self._pools:
                self._pools[device] = (torch.cuda.graph_pool_handle()
                                       if device.type == "cuda" else None)
            prog = self._programs[key] = Program(
                fn, args, static, carry, device, self._pools[device],
                label or _label(fn, static, det))
        return prog


def stats() -> dict:
    """What the programs of this process did since `reset_counts`:
    `graphs_captured` (one record a capture: its warm-up and capture
    seconds), `capture_s` (both, summed), `graph_pool_mb`
    (`pool_mb`), `replays`, and the registered kernels' launches made by
    replays and by the warm-up runs before captures; `if_nodes`, the
    `run_if` nodes captured, and `if_bodies_run`, the recorded bodies the
    replays ran (a read of the device counters)."""
    caps = list(_STATS["captures"])
    return {"graphs_captured": caps,
            "if_nodes": _STATS["if_nodes"],
            "if_bodies_run": sum(int(t) for t in _BODIES.values()),
            "capture_s": sum(c["warm_up_s"] + c["s"] for c in caps),
            "graph_pool_mb": pool_mb(),
            "replays": _STATS["replays"],
            "launches_replayed": dict(_STATS["launches_replayed"]),
            "launches_warm_up": dict(_STATS["launches_warm_up"])}
