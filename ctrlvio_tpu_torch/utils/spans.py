"""Spans on the host and stamps on the card, on one clock: how the port
times its phases.

**Host spans.** A `Recorder` times the named phases of one object (an
estimator, a front end, a batched coordinator):

    with self._span("pack"):
        ...

Each span adds its host seconds to `Recorder.timing[name]`, the object's
`timing` dict (cumulative seconds a phase, which its readers clear and read
as they like). With recording off that is all it does: a `perf_counter`
pair and one flag test. With recording on (`start`), each span is also
written to a ring of rows allocated at `start`, so nothing grows on the hot
path: its name, its start and end in ns on `time.time_ns()` (the clock
that `torch.profiler`'s events carry), its parent (the span open around
it, or -1) and its frame: a number that every span under one frame root
(the span named `frame_root`, counted from 0) shares, -1 outside any. Once
`capacity` spans have begun, the oldest are overwritten. `record()` gives
the rows. Recording is switched between calls, never inside a span.

**Device stamps.** A `StampRing` is a ring of rows on the card, one row a
stamped run of a captured program (a streamed megastep), one slot a tag
(`TAGS`), and after them one slot a trip of the solve's WHILE node (the
row counts its trips itself: `N_TRIPS`). The program writes it through
the stamp op (`ops/stamp.py`, `csrc/stamp.cu`: the card's
`%globaltimer`), and a program captured with stamps gets the ring as a
static argument, so that stamped and unstamped programs are keyed apart
and an unstamped one holds no stamp node. Device state is made before
any capture: the ring and its head are static tensors of the graphs.
After a stamped run the host queues a copy of its row to pinned memory and
an event (`queue`), and takes the row once the event has completed
(`poll`: `query()`, never a wait). `poll(wait=True)` waits, once, for
what is queued: for `stop` and `flush`, not the hot path.

**One clock.** `Clock.calibrate` brackets 20 synchronized stamps between
two host readings each and keeps the narrowest: the offset from the stamps'
clock to `time.time_ns()`, and its error (half the bracket). Calibrated
when recording starts and when it stops, the offset is interpolated
between the two (the card's timer may drift from the host's). Host spans,
stamped intervals and the profiler's device events then lie on one
timeline.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ctrlvio_tpu_torch.ops import stamp as stamp_op

# the columns of a span row
START, END, NAME, PARENT, FRAME = range(5)
SPAN_CAPACITY = 1 << 18

# a stamped megastep's tags, in the order the megastep runs them (the
# prior's two only on a frame that marginalizes the oldest keyframe)
TAGS = ("start", "merged", "lm_first", "gauge", "prior_begin", "prior_end",
        "slide", "end")
SEQ, N_TRIPS = stamp_op.SEQ, stamp_op.N_TRIPS
SLOT = {tag: 2 + i for i, tag in enumerate(TAGS)}
TRIP0 = 2 + len(TAGS)
MODE = dict.fromkeys(TAGS, stamp_op.MARK)
MODE.update(start=stamp_op.START, end=stamp_op.END)
RING_ROWS = 256
ROW_CAPACITY = 1 << 15


class _Span:
    """One name's span: a context manager, shared by every use of the
    name (the open spans live on the recorder's stack)."""

    __slots__ = ("rec", "name", "code", "root")

    def __init__(self, rec, name, code, root):
        self.rec, self.name, self.code, self.root = rec, name, code, root

    def __enter__(self):
        rec = self.rec
        if rec.on:
            rec._begin(self)
        else:
            rec._stack.append(time.perf_counter())

    def __exit__(self, *exc):
        rec = self.rec
        if rec.on:
            rec._end(self)
        else:
            rec.timing[self.name] += time.perf_counter() - rec._stack.pop()
        return False


class Recorder:
    """The host spans of one object (see the module notes)."""

    def __init__(self, frame_root: Optional[str] = None,
                 capacity: int = SPAN_CAPACITY):
        self.timing = defaultdict(float)
        self.frame_root = frame_root
        self.capacity = capacity
        self.on = False
        self.begun = 0
        self.frames = 0
        self.names: List[str] = []
        self._spans: Dict[str, _Span] = {}
        self._stack: list = []
        # the ring, one list a column (a list's item is the cheapest store)
        self._cols: Optional[List[list]] = None

    def span(self, name: str) -> _Span:
        """The context manager that times `name`."""
        s = self._spans.get(name)
        if s is None:
            s = self._spans[name] = _Span(self, name, len(self.names),
                                          name == self.frame_root)
            self.names.append(name)
        return s

    def start(self):
        """Record spans from now on (the ring is made at the first start;
        a later start goes on writing it)."""
        self._switch(True)
        if self._cols is None:
            self._cols = [[0] * self.capacity for _ in range(5)]

    def stop(self):
        self._switch(False)

    def _switch(self, on: bool):
        if self._stack:
            raise RuntimeError("spans: recording switched inside a span")
        self.on = on

    def _begin(self, span: _Span):
        t = time.time_ns()
        seq = self.begun
        self.begun = seq + 1
        stack = self._stack
        start, end, name, parent, frame = self._cols
        r = seq % self.capacity
        p = stack[-1] if stack else -1
        if span.root:
            frame[r] = self.frames
            self.frames += 1
        else:
            frame[r] = frame[p % self.capacity] if p >= 0 else -1
        start[r], end[r], name[r], parent[r] = t, -1, span.code, p
        stack.append(seq)

    def _end(self, span: _Span):
        t = time.time_ns()
        r = self._stack.pop() % self.capacity
        self._cols[END][r] = t
        self.timing[span.name] += (t - self._cols[START][r]) * 1e-9

    def frame(self) -> int:
        """The frame of the innermost open span while recording (-1
        outside any frame, or with recording off)."""
        if not (self.on and self._stack):
            return -1
        return self._cols[FRAME][self._stack[-1] % self.capacity]

    def record(self) -> dict:
        """The spans held (the newest `capacity`), oldest first, that have
        ended: `names`, and `rows` (n, 5) int64 of start, end (ns,
        `time.time_ns()`), name (an index into `names`), parent (a row of
        `rows`, or -1 where none is held) and frame."""
        lo = max(0, self.begun - self.capacity)
        seqs = np.arange(lo, self.begun)
        if self._cols is None:
            return {"names": list(self.names),
                    "rows": np.zeros((0, 5), np.int64)}
        rows = np.array(self._cols, np.int64).T[seqs % self.capacity]
        parent = rows[:, PARENT]
        rows[:, PARENT] = np.where(parent >= lo, parent - lo, -1)
        done = rows[:, END] >= 0
        # the rows that stay, renumbered
        index = np.cumsum(done) - 1
        keep = rows[done]
        p = keep[:, PARENT]
        ok = p >= 0
        p[ok] = np.where(done[p[ok]], index[p[ok]], -1)
        return {"names": list(self.names), "rows": keep}


class Clock:
    """The offset from the stamps' clock to `time.time_ns()` (see the
    module notes). `calibrations` lists (host ns, offset ns, error ns)."""

    def __init__(self):
        self.calibrations: List[tuple] = []

    def calibrate(self, device, n: int = 20):
        """Bracket `n` synchronized stamps on `device` between two host
        readings each and keep the narrowest (synchronizes `2n` times).
        Each stamp is launched through the kernel's C entry point
        (`stamp.launcher`), so the bracket holds no dispatch."""
        device = torch.device(device)
        ring = torch.zeros((n, 3), dtype=torch.int64, device=device)
        head = torch.zeros((1,), dtype=torch.int64, device=device)
        brackets = []
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            launch = stamp_op.launcher(ring, head, 2, stamp_op.END)
            for _ in range(n):
                _sync(device)
                h0 = time.time_ns()
                launch()
                _sync(device)
                brackets.append((h0, time.time_ns()))
        dev = ring[:, 2].cpu().tolist()
        h0, h1, d = min(((a, b, d) for (a, b), d in zip(brackets, dev)),
                        key=lambda x: x[1] - x[0])
        mid = (h0 + h1) // 2
        self.calibrations.append((mid, mid - d, (h1 - h0 + 1) // 2))
        return self.calibrations[-1]

    def error_ns(self) -> Optional[int]:
        """The largest calibration error, or None before any."""
        return max((c[2] for c in self.calibrations), default=None)

    def to_host(self, t):
        """Stamp times (ns, an int or an array) on the host's clock; 0
        (no stamp) stays 0."""
        if not self.calibrations:
            raise RuntimeError("spans: the clock was never calibrated")
        (h0, o0, _), (h1, o1, _) = (self.calibrations[0],
                                    self.calibrations[-1])
        t = np.asarray(t, np.int64)
        if h1 > h0:
            d0, d1 = h0 - o0, h1 - o1
            off = o0 + (o1 - o0) * ((t - d0) / (d1 - d0))
            off = np.round(off).astype(np.int64)
        else:
            off = o0
        return np.where(t > 0, t + off, 0)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StampRing:
    """The device stamps of one estimator's stamped programs (see the
    module notes): `ring` (rows, slots) and `head` on `device`, the slots
    `SEQ`, `N_TRIPS`, one a tag (`SLOT`) and `max_trips` trip slots from
    `TRIP0`."""

    def __init__(self, device, max_trips: int, rows: int = RING_ROWS,
                 capacity: int = ROW_CAPACITY):
        device = torch.device(device)
        self.device = device
        self.slots = TRIP0 + max(max_trips, 0)
        self.ring = torch.zeros((rows, self.slots), dtype=torch.int64,
                                device=device)
        self.head = torch.zeros((1,), dtype=torch.int64, device=device)
        on_card = device.type == "cuda"
        self._mirror = (torch.zeros((rows, self.slots), dtype=torch.int64,
                                    pin_memory=True) if on_card
                        else self.ring)
        self._events = ([torch.cuda.Event() for _ in range(rows)]
                        if on_card else None)
        self.queued = 0
        self._pending = deque()
        # the rows read back, oldest first (the newest `capacity` kept),
        # with each run's frame and whether it marginalized
        self._rows = np.zeros((capacity, self.slots), np.int64)
        self._meta = np.zeros((capacity, 2), np.int64)
        self.read = 0

    def stamp(self, tag: str):
        """Stamp `tag` (a name of `TAGS`, or "trip") into the head's row:
        called inside the stamped program."""
        if tag == "trip":
            stamp_op.stamp(self.ring, self.head, TRIP0, stamp_op.TRIP)
        else:
            stamp_op.stamp(self.ring, self.head, SLOT[tag], MODE[tag])

    def queue(self, frame: int, marg_old: bool):
        """After a stamped run (on the host, in stream order): queue the
        read of its row, the run's `frame` and `marg_old` beside it."""
        rows = self.ring.shape[0]
        if len(self._pending) >= rows:
            self.poll(wait=True)
        r = self.queued % rows
        if self._events is not None:
            self._mirror[r].copy_(self.ring[r], non_blocking=True)
            self._events[r].record()
        self._pending.append((self.queued, frame, int(marg_old)))
        self.queued += 1
        self.poll()

    def poll(self, wait: bool = False):
        """Take the queued rows whose copies have landed (with `wait`,
        all of them, waiting once for the newest)."""
        rows = self.ring.shape[0]
        if wait and self._pending and self._events is not None:
            self._events[self._pending[-1][0] % rows].synchronize()
        while self._pending:
            n, frame, marg = self._pending[0]
            r = n % rows
            if (self._events is not None and not wait
                    and not self._events[r].query()):
                return
            k = self.read % len(self._rows)
            self._rows[k] = self._mirror[r].numpy()
            self._meta[k] = (frame, marg)
            self.read += 1
            self._pending.popleft()

    def record(self, clock: Optional[Clock] = None) -> dict:
        """The rows read back, oldest first (the newest `capacity`):
        `stamps` (n, slots) int64, on the host's clock where a calibrated
        `clock` is given (0 where a slot holds no stamp); `trips` each
        run's count of trips; `frame` and `marg_old` each run's; `seq`
        each run's number on the card and `index` the host's (equal where
        the two agree)."""
        cap = len(self._rows)
        lo = max(0, self.read - cap)
        idx = np.arange(lo, self.read)
        rows = self._rows[idx % cap]
        meta = self._meta[idx % cap]
        stamps = rows[:, 2:].copy()
        if clock is not None and clock.calibrations:
            stamps = clock.to_host(stamps)
        return {"tags": TAGS, "trip0": TRIP0 - 2, "stamps": stamps,
                "trips": rows[:, N_TRIPS].copy(), "seq": rows[:, SEQ].copy(),
                "index": idx, "frame": meta[:, 0].copy(),
                "marg_old": meta[:, 1].astype(bool)}


def stamp(ring: Optional[StampRing], tag: str):
    """`ring.stamp(tag)`, or nothing for an unstamped program."""
    if ring is not None:
        ring.stamp(tag)
