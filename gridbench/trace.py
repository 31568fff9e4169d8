"""Reduction of the window's profiler trace (the Chrome trace that the
program's ``profile_trace`` writes) to what the per-layer metrics read.

The traced window runs from the start of the benchmark's
``gridbench_window`` range on the host to the end of the last device
operation.  Device work is every ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` event; the device is busy where any of them runs.  An
operation belongs to a program scope when a ``gpu_user_annotation`` range of
that name on its own stream contains it (the innermost wins).  An idle gap
is named by the innermost host event running at its midpoint, or
``host_idle`` where none runs.
"""

from __future__ import annotations

import bisect
import gzip
import json
from collections import defaultdict
from pathlib import Path

WINDOW = "gridbench_window"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION = "gpu_user_annotation"
HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: the program's scopes (``utils/profiling.SCOPE_NAMES``), by prefix
SCOPE_PREFIX = "igg_"


def load_events(logdir: Path) -> list[dict]:
    files = sorted(Path(logdir).glob("*.json*"))
    if not files:
        raise RuntimeError(f"no trace written under {logdir}")
    path = files[-1]
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt", encoding="utf-8") as f:
        doc = json.load(f)
    return [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list[dict], top: int = 10) -> dict:
    """``{window_s, busy_s, ops: {name: [count, s]}, scoped_s: {scope: s},
    idle_gaps: {host name: s}}`` of one window."""
    marks = [e for e in events if e.get("name") == WINDOW and e.get("cat") in HOST]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0 = min(float(m["ts"]) for m in marks)
    w_end = max(float(m["ts"]) + float(m.get("dur", 0)) for m in marks)
    dev = [e for e in events if e.get("cat") in DEVICE and float(e["ts"]) >= w0]
    if not dev:
        raise RuntimeError("the traced window holds no device operation")
    w1 = max(w_end, max(float(e["ts"]) + float(e.get("dur", 0)) for e in dev))
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev])

    # scope of each device op: the innermost program range on its stream
    ann = defaultdict(list)
    for e in events:
        if e.get("cat") == ANNOTATION and str(e.get("name", "")).startswith(SCOPE_PREFIX):
            ann[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]))
    for v in ann.values():
        v.sort()
    starts = {k: [a for a, _, _ in v] for k, v in ann.items()}
    ops = defaultdict(lambda: [0, 0.0])
    scoped = defaultdict(float)
    for e in dev:
        a, dur = float(e["ts"]), float(e.get("dur", 0))
        name = str(e.get("name", "?"))
        ops[name][0] += 1
        ops[name][1] += dur * 1e-6
        key = (e.get("pid"), e.get("tid"))
        scope = None
        if key in ann:
            i = bisect.bisect_right(starts[key], a)
            for s, t, nm in reversed(ann[key][max(0, i - 8):i]):
                if s <= a and a + dur <= t:
                    scope = nm
                    break
        if scope:
            scoped[scope] += dur * 1e-6

    # idle gaps, named by what the host was doing
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), str(e.get("name")))
        for e in events if e.get("cat") in HOST and e.get("name") != WINDOW
    )
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = defaultdict(float)
    j, active = 0, []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        name = max(active)[2] if active else "host_idle"
        idle[name] += (b - a) * 1e-6

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "ops": {k: v for k, v in ops.items()},
        "scoped_s": dict(scoped),
        "idle_gaps": dict(sorted(idle.items(), key=lambda kv: -kv[1])[:top]),
    }


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps."""
    order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": order({k: sec for k, (_, sec) in summary["ops"].items()}),
            "idle_gaps": order(summary["idle_gaps"])}
