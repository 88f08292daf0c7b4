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

`run_while(body, carry, max_trips, handle)` is the one control-flow
primitive (≙ `lax.while_loop`): while a graph is captured it records
`body(carry, handle)` once into a CUDA-graph WHILE node on the
conditional handle `handle` (`while_handle`, made on the captured graph
before the kernel that first sets it), so a replay runs the body while the
handle is non-zero, testing it before each trip; a kernel of the body sets
it again (the LM's accept step, K4). Run eagerly (the warm-up before a
capture, the CPU: `while_handle` gives None) the body runs `max_trips`
times. `body` writes its results into the `carry` tensors in place, and
nothing made inside it is read after it. The installed torch (2.11) has no
conditional node of its own, so the node comes from `csrc/graph_cond.cu`
(built at first use, like the kernels): the body is captured on a stream
of its own, its memory from a graph pool of its own, and added to the
node as a child graph. Each recorded body also adds one to its node's
device counter of trips, so `stats` reports the trips the replays ran.
The counters belong to the program that recorded the nodes: it makes them
before its capture, one for each `run_while` its warm-up ran, and they go
with it.

A kernel wrapper registered with `register_counter` counts its kernel's
launches as they run. A launch made while a graph is captured runs nothing:
its count is taken back, held by the program, and added again on each
replay; a launch recorded into a WHILE node's body is held by the node
instead, and counts once for each trip the node's counter shows when the
counts are settled (`settle`: a read of the device). The reader that
`register_counter` returns, and `stats`, settle first; the trips of a
program collected since are settled too.
`stats` lists the captures (key, seconds, reserved device memory
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
# the live programs that recorded WHILE nodes, and the nodes of programs
# collected since the counts were last settled
_WHILE_PROGRAMS = weakref.WeakSet()
_RETIRED: List = []
# the `run_while` calls of each warm-up running now, and the nodes of each
# capture recording now (innermost last)
_WARM_UPS: List[int] = []
_RECORDING: List = []
# device -> (the stream bodies are captured on, their graph pool)
_BODY_STREAMS: Dict = {}


def register_counter(read: Callable[[], Dict[str, int]],
                     add: Callable[[Dict[str, int]], None]):
    """Register a kernel wrapper's launch counts (see the module notes).
    Returns `read` settling the counts first: the wrapper's `counts`."""
    _COUNTERS.append((read, add))

    @functools.wraps(read)
    def settled():
        settle()
        return read()

    return settled


class _WhileNodes:
    """The WHILE nodes one program records: their device counter of
    trips, one int64 a node, made before the capture (a counter made in
    it would be the graph's memory, zeroed by a kernel of the graph); the
    launches each node's body holds, and its trips already settled."""

    def __init__(self, n: int, device: torch.device):
        self.trips = torch.zeros((n,), dtype=torch.int64, device=device)
        self.held: List = []
        self.settled: List[int] = []


def reset_counts():
    """Forget the recorded captures and set the replay counts to 0 (the
    programs themselves stay captured)."""
    _STATS.clear()
    _STATS.update(captures=[], replays=0, launches_replayed={},
                  launches_warm_up={}, while_nodes=0, trips=0)
    for prog in list(_WHILE_PROGRAMS):
        prog._nodes.trips.zero_()
        prog._nodes.settled = [0] * len(prog._nodes.held)
    _RETIRED.clear()


reset_counts()


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


def _cond_lib():
    """The WHILE-node helper (`csrc/graph_cond.cu`), built at first use."""
    import ctypes

    from . import cuda_build

    lib = cuda_build.load("graph_cond")
    p = ctypes.c_void_p
    lib.cond_stream_create.argtypes = [ctypes.POINTER(p)]
    lib.cond_handle_create.argtypes = [p, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.while_begin.argtypes = [p, ctypes.c_ulonglong, p, ctypes.POINTER(p)]
    lib.while_end.argtypes = [p, p]
    lib.cond_error_string.argtypes = [ctypes.c_int]
    lib.cond_error_string.restype = ctypes.c_char_p
    return lib


def _cond_check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: {lib.cond_error_string(err).decode()}")


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
            _cond_check(lib, lib.cond_stream_create(ctypes.byref(raw)),
                        "creating the body stream")
        _BODY_STREAMS[device] = (torch.cuda.ExternalStream(raw.value,
                                                           device=device),
                                 torch.cuda.graph_pool_handle())
    return _BODY_STREAMS[device]


def while_handle(device) -> Optional[int]:
    """A conditional handle for `run_while`'s node, made on the graph that
    the current stream of `device` is capturing (1 at each replay until a
    kernel sets it); None when no capture is active, where `run_while`
    runs its body eagerly."""
    device = torch.device(device)
    if not (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        return None
    import ctypes

    lib = _cond_lib()
    h = ctypes.c_ulonglong()
    _cond_check(lib, lib.cond_handle_create(
        torch.cuda.current_stream(device).cuda_stream, ctypes.byref(h)),
        "making a conditional handle")
    return h.value


@contextlib.contextmanager
def recorded_node():
    """Record one WHILE node into the program capturing now: yields the
    node's counter of trips (a one-entry view, to which the body adds
    one); on exit the node holds the launches counted inside."""
    nodes = _RECORDING[-1] if _RECORDING else None
    slot = len(nodes.held) if nodes is not None else 0
    if nodes is None or slot >= len(nodes.trips):
        raise RuntimeError("graphs.run_while records a node only in a "
                           "`Program`'s capture, one for each run_while "
                           "of its warm-up")
    with held_launches() as held:
        yield nodes.trips[slot: slot + 1]
    nodes.held.append(held)
    nodes.settled.append(0)
    _STATS["while_nodes"] += 1


def run_while(body: Callable, carry, max_trips: int,
              handle: Optional[int]) -> None:
    """`body(carry, handle)` as a loop: with a `handle` (`while_handle`,
    inside a capture) recorded once into a CUDA-graph WHILE node on it,
    which a replay runs while the handle is non-zero; with None, run
    `max_trips` times (see the module notes). `body` updates the tensors
    of `carry` in place, and a kernel of it sets the handle."""
    if handle is None:
        if _WARM_UPS:
            _WARM_UPS[-1] += 1
        for _ in range(max_trips):
            body(carry, None)
        return
    import ctypes

    lib = _cond_lib()
    device = _indexed(leaves(carry)[0].device)
    side, pool = _body_stream(device)
    with recorded_node() as trips:
        node_body = ctypes.c_void_p()
        _cond_check(lib, lib.while_begin(
            torch.cuda.current_stream(device).cuda_stream, handle,
            side.cuda_stream, ctypes.byref(node_body)),
            "adding a WHILE node")
        torch._C._cuda_beginAllocateCurrentThreadToPool(device.index, pool)
        try:
            with torch.cuda.stream(side):
                body(carry, handle)
                trips.add_(1)
        finally:
            torch._C._cuda_endAllocateToPool(device.index, pool)
            err = lib.while_end(side.cuda_stream, node_body)
        _cond_check(lib, err, "ending a WHILE node's body")


def _settle(groups) -> None:
    for nodes in groups:
        for i, n in enumerate(nodes.trips.tolist()[: len(nodes.held)]):
            gained = n - nodes.settled[i]
            if gained:
                deltas = [{k: v * gained for k, v in d.items()}
                          for d in nodes.held[i]]
                for (_, add), d in zip(_COUNTERS, deltas):
                    add(d)
                _tally(_STATS["launches_replayed"], deltas)
                _STATS["trips"] += gained
                nodes.settled[i] = n


def _settle_retired() -> None:
    retired = _RETIRED[:]
    _RETIRED.clear()
    _settle(retired)


def settle():
    """Add the launches of the WHILE nodes' bodies to the registered
    counts and to the replays' launches, once for each trip the nodes'
    device counters show since the last settle (a read of the device), for
    the live programs and those collected since."""
    _settle_retired()
    _settle([p._nodes for p in list(_WHILE_PROGRAMS)])


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
        _settle_retired()
        with _cusolver(device), _capture_stream(device) as stream:
            t0 = time.perf_counter()
            before = _read_counts()
            _WARM_UPS.append(0)
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    body(tree_map(on_device, args))
            finally:
                n_nodes = _WARM_UPS.pop()
            warm = _gained(before, _read_counts())
            t1 = time.perf_counter()
            mb0 = _reserved_mb(device)
            self._nodes = (_WhileNodes(n_nodes, device) if n_nodes
                           else None)
            _RECORDING.append(self._nodes)
            try:
                with held_launches() as held:
                    self.outputs, self._replay = capture(
                        body, self.inputs, device, pool, stream)
            finally:
                _RECORDING.pop()
        self._held = held
        if self._nodes is not None and self._nodes.held:
            _WHILE_PROGRAMS.add(self)
            weakref.finalize(self, _RETIRED.append, self._nodes)
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
    """What the programs of this process did since `reset_counts`, the
    counts settled first (`settle`): `graphs_captured` (one record a
    capture: its warm-up and capture seconds), `capture_s` (both,
    summed), `graph_pool_mb` (`pool_mb`), `replays`, and the registered
    kernels' launches made by replays (WHILE bodies' once a trip) and by
    the warm-up runs before captures; `while_nodes`, the `run_while`
    nodes captured, and `if_bodies_run`, the trips their bodies ran on
    replays (a read of the device counters)."""
    settle()
    caps = list(_STATS["captures"])
    return {"graphs_captured": caps,
            "while_nodes": _STATS["while_nodes"],
            "if_bodies_run": _STATS["trips"],
            "capture_s": sum(c["warm_up_s"] + c["s"] for c in caps),
            "graph_pool_mb": pool_mb(),
            "replays": _STATS["replays"],
            "launches_replayed": dict(_STATS["launches_replayed"]),
            "launches_warm_up": dict(_STATS["launches_warm_up"])}
