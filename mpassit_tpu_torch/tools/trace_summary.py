"""Device busy time and idle share of a torch.profiler Chrome trace.

    python -m mpassit_tpu_torch.tools.trace_summary TRACE.json

Reads a trace that ``MPASSIT_PROFILE`` wrote (``run/pipeline.py``:
``trace_<pid>_<n>.json`` for the n-th profiled run of a process, one
``record_function`` event per span of ``spans.Timings``: the eight
top-level stages and the spans inside them) or any other
``export_chrome_trace``. Pure Python; runs anywhere.

Device-busy time is the union of the device intervals, the events of
category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``: events that
overlap (two streams, or a copy beside a kernel) count once. For the whole
run (the profiler's own window) and for each host stage span (category
``user_annotation``; a stage met more than once is the union of its spans)
it reports:

- the window, the busy time within it and the idle share (1 - busy /
  window);
- the top five device operations by total time inside the window, with
  their launch counts;
- the five longest idle gaps inside the window, each named after the
  innermost span that encloses the whole gap (``null`` where none
  does).

Times are in seconds, gap starts relative to the run's window, device
operation totals in ms. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGE_CAT = "user_annotation"
US = 1e-6           # trace timestamps are microseconds
TOP = 5             # device operations and gaps listed per window


def load_events(path: str) -> list:
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _complete(events, cats):
    """(start, end, event) of every complete ("X") event in ``cats``."""
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats:
            t = float(e["ts"])
            out.append((t, t + float(e.get("dur", 0.0)), e))
    return out


def device_events(events) -> list:
    """(start, end, event) of the device intervals, by start."""
    return sorted(_complete(events, DEVICE_CATS), key=lambda x: x[0])


def merge(intervals) -> list:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _run_window(events):
    """The profiler's own window (its "Trace" span), else the extent of
    every complete event."""
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "Trace"
                and str(e.get("name", "")).startswith("PyTorch Profiler")):
            t = float(e["ts"])
            return t, t + float(e["dur"])
    xs = _complete(events, {e.get("cat") for e in events})
    if not xs:
        raise ValueError("trace holds no complete event")
    return min(a for a, _, _ in xs), max(b for _, b, _ in xs)


def _overlap(busy, starts, a, b) -> float:
    """Length of the merged ``busy`` intervals (``starts`` their starts)
    inside [a, b]."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    tot = 0.0
    while i < len(busy) and busy[i][0] < b:
        lo, hi = max(busy[i][0], a), min(busy[i][1], b)
        if hi > lo:
            tot += hi - lo
        i += 1
    return tot


def _gaps(busy, starts, a, b) -> list:
    """The idle intervals of [a, b]: its complement of ``busy``."""
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


def _innermost(spans, a, b):
    """Name of the shortest stage span that encloses [a, b], or None."""
    best = None
    for s, e, ev in spans:
        if s <= a and e >= b and (best is None or e - s < best[0]):
            best = (e - s, ev["name"])
    return None if best is None else best[1]


def _summary(windows, dev, busy, starts, spans, t0) -> dict:
    windows = merge(windows)
    win = sum(b - a for a, b in windows)
    on = sum(_overlap(busy, starts, a, b) for a, b in windows)
    ops = {}
    for s, e, ev in dev:
        part = sum(max(0.0, min(e, b) - max(s, a)) for a, b in windows)
        if part > 0 or (s == e and any(a <= s <= b for a, b in windows)):
            o = ops.setdefault(ev["name"], [0.0, 0])
            o[0] += part
            o[1] += 1
    gaps = [g for a, b in windows for g in _gaps(busy, starts, a, b)]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": win * US, "busy_s": on * US,
        "idle_share": (1.0 - on / win) if win > 0 else None,
        "top_ops": [{"name": n, "total_ms": t * US * 1e3, "launches": c}
                    for n, (t, c) in sorted(ops.items(),
                                            key=lambda kv: -kv[1][0])[:TOP]],
        "longest_gaps": [{"start_s": (a - t0) * US, "s": (b - a) * US,
                          "stage": _innermost(spans, a, b)}
                         for a, b in gaps[:TOP]],
    }


def summarize(events) -> dict:
    """{"run": summary, "stages": {stage: summary}} of a trace's events
    (the list under ``traceEvents``)."""
    dev = device_events(events)
    busy = merge((a, b) for a, b, _ in dev)
    starts = [a for a, _ in busy]
    spans = _complete(events, (STAGE_CAT,))
    t0, t1 = _run_window(events)
    by_stage = {}
    for a, b, ev in spans:
        by_stage.setdefault(ev["name"], []).append((a, b))
    return {
        "run": _summary([(t0, t1)], dev, busy, starts, spans, t0),
        "stages": {name: _summary(w, dev, busy, starts, spans, t0)
                   for name, w in by_stage.items()},
        "device_events": len(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace")
    args = ap.parse_args(argv)
    print(json.dumps(summarize(load_events(args.trace))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
