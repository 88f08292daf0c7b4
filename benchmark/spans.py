"""The port's own spans and device stamps, read for a window.

With recording on (`CtrlVIO.trace(True)`, before the warm-up), the
estimator keeps a span for each host phase of each call and a row of
device stamps for each streamed megastep (`ctrlvio_tpu_torch/utils/
spans.py`), all on `time.time_ns()`, the clock of the profiler's events.
`window(vio, lo, hi, traced, ops)` gathers what the per-layer metrics of
the port's spans read, as `ctx["spans"]`:

- `frames`: one entry a call whose `process_frame` span lies inside the
  window [lo, hi): its start, end and the seconds of its `consume_fetch`
  spans (the blocking pull of a lagged summary);
- `megasteps`: the stamped megasteps those calls dispatched, each a dict
  of its stamps (ns; `trips` the list of trip stamps) and `marg_old`;
- `spans`: every recorded span (start, end, name, depth), for labels;
- `traced`: the profiled sub-window's bounds, `ops` the profiler's device
  operations (start, end, name) in it and `traced_megasteps` the stamped
  megasteps of its calls (None, None and [] without a trace); `ops` are
  moved onto the stamps' clock (`align`: the profiler's device clock
  drifts against the host's), `raw_ops` are as traced;
- `clock_error_ns`: the stamps' clock against the host's.

Nothing here raises where the port records nothing: `window` returns None
for a port without `trace_record`, and each reader then returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# the intervals between a megastep's stamps, named by what runs in them
PHASES = (("start", "merged", "merge"), ("merged", "lm_first", "lm_first"),
          ("gauge", "prior_begin", "gauge"),
          ("prior_begin", "prior_end", "qr_prior"),
          ("slide", "end", "summary"))


def window(vio, lo: int, hi: int, traced: Optional[Tuple[int, int]] = None,
           ops: Optional[List[tuple]] = None) -> Optional[dict]:
    """`ctx["spans"]` for the window [lo, hi) (ns, `time.time_ns()`), or
    None where the estimator records nothing."""
    if not hasattr(vio, "trace_record"):
        return None
    got = vio.trace_record()
    sp, mg = got["spans"], got["megasteps"]
    if mg is None or not len(sp["rows"]):
        return None
    rows, names = sp["rows"], sp["names"]
    name = np.array(names, dtype=object)[rows[:, 2]]
    parent, frame = rows[:, 3], rows[:, 4]
    depth = np.zeros(len(rows), np.int64)
    for i, p in enumerate(parent):
        if p >= 0:
            depth[i] = depth[p] + 1
    fetch: Dict[int, float] = {}
    for i in np.nonzero(name == "consume_fetch")[0]:
        f = int(frame[i])
        fetch[f] = fetch.get(f, 0.0) + (rows[i, 1] - rows[i, 0]) * 1e-9
    roots = np.nonzero(name == "process_frame")[0]

    def calls(a, b):
        return {int(frame[i]): {"frame": int(frame[i]),
                                "start": int(rows[i, 0]),
                                "end": int(rows[i, 1]),
                                "fetch_s": fetch.get(int(frame[i]), 0.0)}
                for i in roots if rows[i, 0] >= a and rows[i, 1] <= b}

    def stamped(frames):
        tags, t0, out = mg["tags"], mg["trip0"], []
        for k in range(len(mg["stamps"])):
            if int(mg["frame"][k]) not in frames:
                continue
            st = mg["stamps"][k]
            m = {tag: int(st[j]) for j, tag in enumerate(tags)}
            n = min(int(mg["trips"][k]), len(st) - t0)
            m.update(trips=[int(x) for x in st[t0:t0 + n]],
                     marg_old=bool(mg["marg_old"][k]),
                     frame=int(mg["frame"][k]))
            out.append(m)
        return out

    frames = calls(lo, hi)
    out = {"frames": [frames[f] for f in sorted(frames)],
           "megasteps": stamped(frames),
           "spans": [(int(a), int(b), str(n), int(d)) for (a, b), n, d
                     in zip(rows[:, :2], name, depth)],
           "traced": traced, "ops": ops, "raw_ops": ops, "align": None,
           "traced_megasteps": ([] if traced is None
                                else stamped(calls(*traced))),
           "clock_error_ns": got["clock_error_ns"]}
    if ops:
        out["align"], out["ops"] = align(ops, out["traced_megasteps"])
    return out


TOP = ("start", "merged", "lm_first", "gauge", "prior_begin", "prior_end",
       "slide", "end")


def align(ops, megasteps, needle: str = "stamp_kernel"):
    """The profiler's device operations moved onto the stamps' clock.

    The profiler traces every stamp launch outside a WHILE node and one
    trip of each node's body, so each traced megastep's stamp launches
    come as one group in time: its first is the megastep's "start" stamp,
    its last the "end" stamp. A line fitted through those pairs (launch
    start, stamp) maps the profiler's clock onto the stamps'. Returns (the
    fit: stamps expected, launches traced, drift in ppm, offset at the
    first launch in ns, largest residual in ns; no drift where the counts
    differ and nothing is moved), and the operations."""
    ms = sorted(megasteps, key=lambda m: m["start"])
    per = [sum(m[k] > 0 for k in TOP) + bool(m["trips"]) for m in ms]
    launch = np.sort(np.array([a for a, _, n in ops if needle in n],
                              np.int64))
    fit = {"stamps": int(sum(per)), "launches": len(launch)}
    if len(ms) < 2 or len(launch) != sum(per):
        return fit, ops
    first = np.cumsum([0] + per[:-1])
    x = np.concatenate([launch[first], launch[first + np.array(per) - 1]])
    y = np.array([m["start"] for m in ms] + [m["end"] for m in ms])
    b, a = np.polyfit(x - launch[0], y - x, 1)
    res = y - x - (a + b * (x - launch[0]))

    def move(t):
        return int(round(t + a + b * (t - launch[0])))

    fit.update(ppm=b * 1e6, offset_ns=float(a),
               resid_ns=float(np.abs(res).max()))
    return fit, [(move(s), move(e), n) for s, e, n in ops]


def window_idle(sp: dict) -> Optional[float]:
    """The share of the window's stamped span (first start to last end)
    that lies between its megasteps, in %: the card's idle time, read
    from the stamps alone (no profiler running)."""
    ms = [(m["start"], m["end"]) for m in sp["megasteps"]
          if m["start"] > 0 and m["end"] > 0]
    if len(ms) < 2:
        return None
    busy, _ = union(ms, ms[0][0], ms[-1][1])
    return (1.0 - busy / (ms[-1][1] - ms[0][0])) * 100.0


def megastep_intervals(m: dict) -> List[Tuple[int, int, str]]:
    """A stamped megastep's phases (start, end, phase), in order."""
    out = []
    for a, b, phase in PHASES:
        if m.get(a, 0) > 0 and m.get(b, 0) > 0:
            out.append((m[a], m[b], phase))
    before = m["lm_first"]
    for t in m["trips"]:
        out.append((before, t, "trip"))
        before = t
    if m["gauge"] > 0:
        out.append((before, m["gauge"], "lm_last"))
    slide_from = m["prior_end"] if m["marg_old"] else m["gauge"]
    if slide_from > 0 and m["slide"] > 0:
        out.append((slide_from, m["slide"], "slide"))
    return out


def union(iv, lo: int, hi: int):
    """Covered length of intervals within [lo, hi], and the gaps."""
    busy, gaps, end = 0, [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in iv
                       if b > lo and a < hi):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < hi:
        gaps.append((end, hi))
    return busy, gaps


def idle_share(sp: dict) -> Optional[float]:
    """The share of the traced sub-window that neither a traced device
    operation nor a stamped megastep covers, in %."""
    if sp is None or sp["traced"] is None or sp["ops"] is None:
        return None
    lo, hi = sp["traced"]
    stamped = [(m["start"], m["end"]) for m in sp["traced_megasteps"]
               if m["start"] > 0 and m["end"] > 0]
    busy, _ = union([(a, b) for a, b, _ in sp["ops"]] + stamped, lo, hi)
    return (1.0 - busy / (hi - lo)) * 100.0


def label(gap, sp: dict) -> str:
    """A gap in the traced device operations: `megastep:<phase>` where a
    stamped megastep's phase overlaps it most (the card was busy and the
    tracer missed it), else the deepest port span that overlaps it, else
    "other"."""
    a, b = gap
    best, most = None, 0
    for m in sp["traced_megasteps"]:
        if m["end"] < a or m["start"] > b:
            continue
        for x, y, phase in megastep_intervals(m):
            o = min(y, b) - max(x, a)
            if o > most:
                best, most = "megastep:" + phase, o
    if best is not None:
        return best
    deep, name = -1, "other"
    for x, y, n, d in sp["spans"]:
        if min(y, b) > max(x, a) and d > deep:
            deep, name = d, n
    return name


def gaps(sp: dict, top: int = 10) -> List[Tuple[str, float]]:
    """The `top` longest gaps of the traced device operations in the
    traced sub-window (label, ms), longest first."""
    if sp is None or sp["traced"] is None or sp["ops"] is None:
        return []
    lo, hi = sp["traced"]
    _, g = union([(a, b) for a, b, _ in sp["ops"]], lo, hi)
    g = sorted(g, key=lambda x: x[0] - x[1])[:top]
    return [(label(x, sp), (x[1] - x[0]) * 1e-6) for x in g]


def device_ms(m: dict) -> Optional[float]:
    if m["start"] > 0 and m["end"] >= m["start"]:
        return (m["end"] - m["start"]) * 1e-6
    return None


def host_ms(f: dict) -> float:
    return (f["end"] - f["start"]) * 1e-6 - f["fetch_s"] * 1e3


def tenths(sp: dict) -> List[Tuple[float, float, float]]:
    """(mean host frame ms, mean device megastep ms, mean WHILE trips a
    megastep) in each tenth of the window's calls."""
    fr = sp["frames"]
    ms = {m["frame"]: m for m in sp["megasteps"]}
    step = max(1, len(fr) // 10)
    out = []
    for i in range(0, len(fr), step):
        part = fr[i:i + step]
        mg = [ms[f["frame"]] for f in part if f["frame"] in ms]
        dev = [d for d in map(device_ms, mg) if d is not None]
        out.append((float(np.mean([host_ms(f) for f in part])),
                    float(np.mean(dev)) if dev else float("nan"),
                    float(np.mean([len(m["trips"]) for m in mg]))
                    if mg else float("nan")))
    return out


def k2_inside(sp: dict, raw: bool = False,
              needle: str = "image_rows_kernel"):
    """Of the megasteps that start inside the traced sub-window, how many
    have a traced K2 launch between their start stamp and their first trip
    (the gauge where none ran), and how many there are; `raw` takes the
    launches as traced, not moved onto the stamps' clock."""
    if sp is None or sp["traced"] is None or sp["ops"] is None:
        return None
    lo, hi = sp["traced"]
    k2 = sorted(a for a, _, n in sp["raw_ops" if raw else "ops"]
                if needle in n)
    inside = total = 0
    for m in sp["traced_megasteps"]:
        if not lo <= m["start"] < hi:
            continue
        total += 1
        upto = m["trips"][0] if m["trips"] else m["gauge"]
        j = np.searchsorted(k2, m["start"])
        inside += int(j < len(k2) and k2[j] <= upto)
    return inside, total

