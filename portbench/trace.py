"""Device busy time, idle share and where the time went, from a
torch.profiler Chrome trace.

Device-busy time is the union of the device intervals, the complete events
of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``: events that
overlap count once. Host stages are the ``user_annotation`` spans (each
``Timings`` stage of the program is a ``record_function`` span). An idle
gap is named after the innermost stage span that encloses it.

Frozen from the program's ``tools/trace_summary.py`` (its interval
arithmetic), so that the benchmark does not move when the program's copy
changes. Times are in microseconds inside, seconds outside.
"""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGE_CAT = "user_annotation"
US = 1e-6
TOP = 10


def load_events(path: str) -> list:
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def complete(events, cats):
    """(start, end, event) of every complete ("X") event in ``cats``."""
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats:
            t = float(e["ts"])
            out.append((t, t + float(e.get("dur", 0.0)), e))
    return out


def merge(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(busy, starts, a, b) -> float:
    """Length of the merged ``busy`` intervals inside [a, b]."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    tot = 0.0
    while i < len(busy) and busy[i][0] < b:
        lo, hi = max(busy[i][0], a), min(busy[i][1], b)
        if hi > lo:
            tot += hi - lo
        i += 1
    return tot


def gaps(busy, starts, a, b) -> list:
    out, t = [], a
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(busy) and busy[i][0] < b:
        lo, hi = busy[i]
        if hi > t:
            if lo > t:
                out.append((t, min(lo, b)))
            t = max(t, hi)
        i += 1
    if t < b:
        out.append((t, b))
    return out


def innermost(spans, a, b):
    best = None
    for s, e, ev in spans:
        if s <= a and e >= b and (best is None or e - s < best[0]):
            best = (e - s, ev["name"])
    return None if best is None else best[1]


class Trace:
    """The device intervals and stage spans of one trace, read inside the
    windows ``hours`` [(start, end)] in trace microseconds."""

    def __init__(self, events, hours):
        self.dev = sorted(complete(events, DEVICE_CATS), key=lambda x: x[0])
        self.busy = merge((a, b) for a, b, _ in self.dev)
        self.starts = [a for a, _ in self.busy]
        self.spans = complete(events, (STAGE_CAT,))
        self.hours = merge(hours)

    def window_s(self) -> float:
        return sum(b - a for a, b in self.hours) * US

    def busy_s(self) -> float:
        return sum(overlap(self.busy, self.starts, a, b)
                   for a, b in self.hours) * US

    def stage_windows(self, name) -> list:
        """The spans of stage ``name`` inside the hours."""
        return merge((max(a, h0), min(b, h1)) for a, b, ev in self.spans
                     if ev["name"] == name for h0, h1 in self.hours
                     if min(b, h1) > max(a, h0))

    def device_time(self, windows, pred) -> float:
        """Seconds of the device events that ``pred(event)`` accepts,
        summed (not merged) over their parts inside ``windows``."""
        tot = 0.0
        for s, e, ev in self.dev:
            if pred(ev):
                tot += sum(max(0.0, min(e, b) - max(s, a))
                           for a, b in windows)
        return tot * US

    def breakdown(self) -> dict:
        """The device operations that took most time inside the hours and
        the longest idle gaps, by the stage that encloses each."""
        ops = {}
        for s, e, ev in self.dev:
            part = sum(max(0.0, min(e, b) - max(s, a)) for a, b in self.hours)
            if part > 0:
                ops[ev["name"]] = ops.get(ev["name"], 0.0) + part
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gl = [g for a, b in self.hours
              for g in gaps(self.busy, self.starts, a, b)]
        gl.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": [[n[:200], t * US] for n, t in top],
                "idle_gaps": [[innermost(self.spans, a, b) or "none",
                               (b - a) * US] for a, b in gl[:TOP]]}
