"""Host spans, merged timelines, request traces, straggler detection and
the crash flight recorder: the port's counterpart of the JAX package's
``utils/tracing.py``, under the same names and file formats.

* **Spans** — `trace_span("igg.step", step=n)` is a nestable host-side
  context manager recording ``(name, t0, dur, tags)`` into a bounded
  per-process ring buffer (``IGG_TRACE_RING``, default `RING_DEFAULT`).
  A span is host time only: it never synchronises the device, so a span
  around a kernel launch measures the launch, not the kernel.  With
  ``IGG_TELEMETRY=0`` (or ``IGG_TRACE_RING=0``) every call returns one
  shared no-op singleton — no allocation, no clock reads.
* **Merged timeline** — `dump_trace(dir)` writes this rank's spans plus its
  clock-sync anchor as ``trace.p<rank>.json``; `merge_trace_files` joins
  any set of per-rank files into ONE Chrome-trace/Perfetto JSON with one
  track (pid) per rank on a shared clock.  The anchor is the barrier
  `record_clock_sync` takes at `init_global_grid`; the merged trace
  records each rank's offset and its uncertainty (the measured barrier
  duration).
* **Straggler detection** — `skew_probe(step_seconds)` shares each rank's
  last-window mean step wall time with every other rank through one
  ``all_gather`` of one float64 per rank (on the grid's device under NCCL)
  and publishes ``skew.step_seconds_max_over_min`` / ``skew.slowest_rank``
  gauges plus a ``skew.straggler`` event past ``IGG_SKEW_WARN``.  One
  process skips it and touches no transport.  COLLECTIVE: every process
  calls it at the same cadence.
* **Request tracing** — W3C-trace-context identity (`new_trace_id`,
  `parse_traceparent`, `current_context`, `use_context`): a context minted
  (head-sampled, ``IGG_TRACE_SAMPLE``) or adopted at the serving front door
  rides the request ledger, the control broadcast and the checkpoint slot
  metadata, so `request_tree` rebuilds one causal tree from any set of
  per-rank dumps (`critical_path` splits its latency, `otlp_trace`
  exports it).
* **Flight recorder** — `dump_flight_recorder(reason, ...)` appends the
  span ring (plus the open spans), the metrics snapshot and the active
  configuration as ONE crash-safe line of ``flight_<rank>.json``.
  `utils.resilience` calls it on a guard trip, a watchdog deadline, an
  injected worker crash and an audit mismatch.

Layering: imports only `config` and `telemetry` at module scope; torch and
the grid are reached lazily.
"""

from __future__ import annotations

import collections
import json
import os
import random
import threading
import time
from typing import Any, Sequence

from . import config as _config
from . import telemetry as _telemetry

__all__ = [
    "trace_span",
    "record_span",
    "span_records",
    "span_summary",
    "open_spans",
    "span_stats",
    "spans_dropped",
    "new_trace_id",
    "new_span_id",
    "parse_traceparent",
    "format_traceparent",
    "should_sample",
    "current_context",
    "use_context",
    "record_clock_sync",
    "clock_sync",
    "dump_trace",
    "merge_trace_files",
    "validate_chrome_trace",
    "request_tree",
    "request_chrome_trace",
    "critical_path",
    "otlp_trace",
    "validate_otlp",
    "skew_probe",
    "arm_collective_delay",
    "dump_flight_recorder",
    "reset",
]

#: default span ring capacity (``IGG_TRACE_RING`` overrides; 0 disables).
#: 4096 spans ≈ a few hundred KB — bounded however long the run.
RING_DEFAULT = 4096

#: per-rank trace file schema version (`dump_trace` / `merge_trace_files`)
TRACE_SCHEMA = 1


def _ring_capacity() -> int:
    val = _config.trace_ring_env()
    return RING_DEFAULT if val is None else val


def enabled() -> bool:
    """Span recording is on: telemetry master switch AND a nonzero ring."""
    return _telemetry.enabled() and _ring_capacity() > 0


# -- the span ring ------------------------------------------------------------

_lock = threading.Lock()
_ring: collections.deque | None = None
_ring_cap = 0


def _get_ring(cap: int) -> collections.deque:
    """The process ring, re-bounded when ``IGG_TRACE_RING`` changed."""
    global _ring, _ring_cap
    with _lock:
        if _ring is None or _ring_cap != cap:
            _ring = collections.deque(_ring, maxlen=cap) if _ring else \
                collections.deque(maxlen=cap)
            _ring_cap = cap
        return _ring


# Per-thread stacks of the spans currently EXECUTING — the spans a crash
# bundle most wants (the closed-span ring by definition misses them) and
# what the live plane's ``/spans`` endpoint shows as in-flight.  Keyed by
# thread ident; list append/pop are GIL-atomic, so enter/exit pay no lock.
_open_stacks: dict[int, list] = {}


def open_spans() -> list[dict]:
    """Every thread's currently-open spans, innermost last, each marked
    ``open: true`` with its age-so-far as ``dur`` (readers must not
    mistake an in-flight span for a completed one)."""
    now = time.perf_counter()
    out = []
    for ident, stack in list(_open_stacks.items()):
        for name, t0, tags in list(stack):
            rec = {
                "name": name,
                "t0": t0,
                "dur": now - t0,
                "open": True,
                "thread": ident,
            }
            if tags:
                rec["args"] = tags
            out.append(rec)
    return out


# -- request context (W3C trace-context shaped) -------------------------------

# Per-thread stacks of the ACTIVE request context: either one request
# (``{"trace_id", "span_id"}``) or the serving round's multi-request form
# (``{"trace_ids": [...]}`` — one pool round advances MANY requests).
# Same GIL-atomic append/pop discipline as `_open_stacks`.
_ctx_stacks: dict[int, list] = {}

#: spans evicted from the bounded ring since the last `reset` — the
#: silent-truncation ledger every `dump_trace` carries (satellite:
#: a quietly-partial request tree must never look complete)
_spans_dropped = 0


def new_trace_id() -> str:
    """A fresh 128-bit W3C trace id (32 lowercase hex chars)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """A fresh 64-bit span id (16 lowercase hex chars)."""
    return os.urandom(8).hex()


def parse_traceparent(header: str | None) -> dict | None:
    """Parse a W3C ``traceparent`` header into ``{"trace_id", "span_id"}``.

    Returns None for a missing/malformed header, a forbidden version
    (``ff``) or the all-zero ids the spec reserves — the caller then mints
    a fresh context (the W3C "restart the trace" rule) instead of
    propagating garbage."""
    if not header:
        return None
    parts = str(header).strip().lower().split("-")
    if len(parts) < 4:
        return None
    ver, tid, sid = parts[0], parts[1], parts[2]
    if len(ver) != 2 or len(tid) != 32 or len(sid) != 16 or ver == "ff":
        return None
    try:
        int(ver, 16), int(tid, 16), int(sid, 16)
    except ValueError:
        return None
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    return {"trace_id": tid, "span_id": sid}


def format_traceparent(ctx: dict) -> str:
    """``ctx`` -> ``00-<trace_id>-<span_id>-01`` (sampled flag set — a
    context this plane carries is by definition one the head kept)."""
    return f"00-{ctx['trace_id']}-{ctx['span_id']}-01"


def should_sample() -> bool:
    """The head-based sampling verdict for MINTING a trace at the door
    (``IGG_TRACE_SAMPLE``, default 1.0 = every request).  Inbound
    contexts are never re-sampled — upstream already decided.  Rate 0
    returns False without touching the RNG (the pinned no-context path)."""
    rate = _config.trace_sample_env()
    if rate is None or rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return random.random() < rate


def current_context() -> dict | None:
    """This thread's innermost request context (None outside any)."""
    stack = _ctx_stacks.get(threading.get_ident())
    return stack[-1] if stack else None


class use_context:
    """Make ``ctx`` the ambient request context for the with-block (this
    thread): spans opened inside resolve it exactly as if they were passed
    ``parent=``.  ``None`` is a no-op, so call sites need no branching."""

    __slots__ = ("ctx",)

    def __init__(self, ctx: dict | None):
        self.ctx = ctx

    def __enter__(self):
        if self.ctx is not None:
            ident = threading.get_ident()
            stack = _ctx_stacks.get(ident)
            if stack is None:
                stack = _ctx_stacks[ident] = []
            stack.append(self.ctx)
        return self.ctx

    def __exit__(self, *exc) -> None:
        if self.ctx is not None:
            ident = threading.get_ident()
            stack = _ctx_stacks.get(ident)
            if stack:
                stack.pop()
                if not stack:
                    _ctx_stacks.pop(ident, None)


def _ring_push(name: str, t0: float, dur: float, tags: dict | None) -> None:
    """Append one closed span, counting evictions: a deque at maxlen
    silently drops its oldest on append, and a silently-truncated ring
    reconstructs into a silently-partial request tree — so the drop count
    rides every dump and readers can refuse to pretend completeness."""
    global _spans_dropped
    ring = _get_ring(_ring_capacity())
    if ring.maxlen is not None and len(ring) >= ring.maxlen:
        _spans_dropped += 1
        _telemetry.counter("trace.spans_dropped_total").inc()
    ring.append((name, t0, dur, tags))


def spans_dropped() -> int:
    """Ring evictions since the last `reset` (the in-process twin of the
    ``trace.spans_dropped_total`` counter; `dump_trace` ships it as the
    per-dump ``dropped`` field)."""
    return _spans_dropped


class _Span:
    """One live span.  Records itself into the ring on exit; re-entrant
    use records one span per enter/exit pair.  While executing it sits on
    this thread's open-span stack (see `open_spans`); a span that resolved
    a request context additionally pushes its own (child) context so
    anything nested chains under it (`current_context`)."""

    __slots__ = ("name", "tags", "t0", "ctx")

    def __init__(self, name: str, tags: dict | None,
                 ctx: dict | None = None):
        self.name = name
        self.tags = tags
        self.ctx = ctx

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        ident = threading.get_ident()
        stack = _open_stacks.get(ident)
        if stack is None:
            stack = _open_stacks[ident] = []
        stack.append((self.name, self.t0, self.tags))
        if self.ctx is not None:
            cstack = _ctx_stacks.get(ident)
            if cstack is None:
                cstack = _ctx_stacks[ident] = []
            cstack.append(self.ctx)
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        ident = threading.get_ident()
        stack = _open_stacks.get(ident)
        if stack:
            stack.pop()
            if not stack:
                _open_stacks.pop(ident, None)  # no thread-lifetime leak
        if self.ctx is not None:
            cstack = _ctx_stacks.get(ident)
            if cstack:
                cstack.pop()
                if not cstack:
                    _ctx_stacks.pop(ident, None)
        _ring_push(self.name, self.t0, t1 - self.t0, self.tags)


class _NoopSpan:
    """Shared disabled-mode singleton (identity-stable, like
    `telemetry.NOOP`): no clock reads, no allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def trace_span(name: str, *, parent: dict | None = None, **tags: Any):
    """A host-side span context manager recording into the process ring.

    Nestable (Chrome-trace ``X`` events on one track render nesting from
    containment); tags become the span's ``args`` in a merged trace.
    Returns the shared `NOOP_SPAN` when tracing is disabled — the
    zero-overhead contract of the rest of the registry.

    Request context: ``parent=`` (a ``{"trace_id", "span_id"}`` dict) or —
    when omitted — the ambient context (`use_context` / an enclosing
    context-carrying span) threads a request's identity into the span.  A
    single context mints this span a fresh ``span_id`` chained under the
    parent and makes it the ambient parent of anything nested; the
    multi-request form (``{"trace_ids": [...]}``, the serving round's
    shape) tags the span with every live ``trace_id`` without inventing
    per-request spans.  With no context in scope the span records exactly
    as before — no ids, no extra allocation.
    """
    if not enabled():
        return NOOP_SPAN
    ctx = parent if parent is not None else current_context()
    if ctx is None:
        return _Span(name, tags or None)
    if "trace_ids" in ctx:
        tags["trace_ids"] = list(ctx["trace_ids"])
        return _Span(name, tags, ctx=ctx)
    sid = new_span_id()
    tags["trace_id"] = ctx["trace_id"]
    tags["span_id"] = sid
    if ctx.get("span_id"):
        tags["parent_id"] = ctx["span_id"]
    return _Span(
        name, tags, ctx={"trace_id": ctx["trace_id"], "span_id": sid}
    )


def record_span(name: str, *, t0: float, dur: float,
                parent: dict | None = None, span_id: str | None = None,
                **tags: Any) -> dict | None:
    """Record one ALREADY-MEASURED span into the ring (no context-manager
    scope): the retroactive shape queue-wait and submit→result spans need
    — their duration is only known at admission/harvest time, long after
    the interval started.  ``t0`` is in this process's ``perf_counter``
    domain (the ring convention).  ``parent=`` chains the span under a
    request context; ``span_id=`` pins the id when the caller already
    broadcast it to peers (the admit span's id rides the control message,
    so every rank's round spans name the SAME parent).  Returns the
    span's own context for further chaining, or None when tracing is
    disabled (nothing recorded — the zero-overhead contract)."""
    if not enabled():
        return None
    if parent is not None:
        sid = span_id or new_span_id()
        tags["trace_id"] = parent["trace_id"]
        tags["span_id"] = sid
        if parent.get("span_id"):
            tags["parent_id"] = parent["span_id"]
        _ring_push(name, float(t0), float(dur), tags)
        return {"trace_id": parent["trace_id"], "span_id": sid}
    _ring_push(name, float(t0), float(dur), tags or None)
    return None


def span_records() -> list[dict]:
    """The current ring as plain dicts (oldest first; test/dump hook)."""
    with _lock:
        items = list(_ring) if _ring else []
    return [
        {"name": n, "t0": t0, "dur": dur, **({"args": tags} if tags else {})}
        for n, t0, dur, tags in items
    ]


def span_summary() -> dict:
    """``{span name: {count, total_s, mean_s, max_s}}`` over the ring —
    the aggregate view of this process's spans."""
    agg: dict[str, list] = {}
    with _lock:
        items = list(_ring) if _ring else []
    for name, _t0, dur, _tags in items:
        rec = agg.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += dur
        rec[2] = max(rec[2], dur)
    return {
        name: {
            "count": c,
            "total_s": total,
            "mean_s": total / c,
            "max_s": mx,
        }
        for name, (c, total, mx) in sorted(agg.items())
    }


def span_stats(span_lists: Sequence[Sequence[dict]]) -> dict:
    """``{span name: {count, total_s, mean_s, p50_s, p99_s, max_s}}`` over
    any number of span-record lists (the `span_records` / ``trace.p*.json``
    schema) — the per-name aggregate of a set of dumps.
    Quantiles are nearest-rank over ALL matching spans' durations (no
    reservoir: a dump is already bounded by the ring).  Open spans
    (``open: true``) are excluded — their durations are ages, not totals.
    """
    durs: dict[str, list[float]] = {}
    for spans in span_lists:
        for s in spans:
            if s.get("open"):
                continue
            durs.setdefault(s["name"], []).append(float(s["dur"]))
    out = {}
    for name in sorted(durs):
        ds = sorted(durs[name])
        n = len(ds)

        def q(frac: float) -> float:
            return ds[min(n - 1, max(0, round(frac * (n - 1))))]

        out[name] = {
            "count": n,
            "total_s": sum(ds),
            "mean_s": sum(ds) / n,
            "p50_s": q(0.50),
            "p99_s": q(0.99),
            "max_s": ds[-1],
        }
    return out


# -- clock sync ---------------------------------------------------------------

# The barrier-timestamped anchor (set once per grid epoch by
# `record_clock_sync`): {"wall", "perf", "uncertainty_s", "epoch",
# "barrier": bool}.  ``perf`` is this process's perf_counter at barrier
# exit; all ranks' ``perf`` values name (approximately) the same true
# instant, which is what merge alignment uses.
_clock_sync: dict | None = None


def record_clock_sync(barrier_fn=None, *, epoch: int | None = None) -> dict:
    """Take the cross-rank clock-sync sample (called at `init_global_grid`).

    ``barrier_fn`` (multi-process grids): a callable that returns only when
    every process reached it — the ranks' clock samples taken right after
    it anchor one shared instant.  The recorded ``uncertainty_s`` is the
    measured barrier duration: a rank can exit at most one barrier-length
    after the first exiter, so per-rank alignment error is bounded by it
    (document-honest — no ns claims).  Without a barrier (single process)
    the sample is exact by construction (uncertainty 0).
    """
    global _clock_sync
    uncertainty = 0.0
    if barrier_fn is not None:
        tb = time.perf_counter()
        barrier_fn()
        uncertainty = time.perf_counter() - tb
    perf = time.perf_counter()
    wall = time.time()
    _clock_sync = {
        "wall": wall,
        "perf": perf,
        "uncertainty_s": uncertainty,
        "epoch": epoch,
        "barrier": barrier_fn is not None,
    }
    _telemetry.event(
        "clock.sync",
        wall=wall,
        perf=perf,
        uncertainty_s=uncertainty,
        barrier=barrier_fn is not None,
    )
    return _clock_sync


def clock_sync() -> dict:
    """The active sync anchor; synthesized (``barrier: False``) when no
    grid init ran — the merge then aligns by wall clocks only and says so."""
    if _clock_sync is not None:
        return _clock_sync
    return {
        "wall": time.time(),
        "perf": time.perf_counter(),
        "uncertainty_s": None,
        "epoch": None,
        "barrier": False,
    }


# -- per-rank dump + merge ----------------------------------------------------


def trace_filename(rank: int, generation: int | None = None) -> str:
    """``trace.p<rank>.json``, or ``trace.g<gen>.p<rank>.json`` for a
    fenced child (``IGG_GENERATION`` set): a supervised restart's
    generations then coexist in one telemetry dir instead of each
    clobbering its predecessor's dump."""
    if generation is None:
        return f"trace.p{rank}.json"
    return f"trace.g{int(generation)}.p{rank}.json"


def dump_trace(directory: str | os.PathLike | None = None) -> str | None:
    """Write this rank's span file (``trace.p<rank>.json``; generation-
    suffixed under a supervisor, see `trace_filename`) into ``directory``
    (default ``IGG_TELEMETRY_DIR``).  Returns the path, or None when
    telemetry is disabled / no directory resolves.  Exported as
    ``igg.dump_trace``; merge any set of ranks' files with
    `merge_trace_files`."""
    if not _telemetry.enabled():
        return None
    directory = os.fspath(directory) if directory else _config.telemetry_dir_env()
    if not directory:
        return None
    rank = _telemetry._proc_index()
    gen = _config.generation_env()
    doc = {
        "schema": TRACE_SCHEMA,
        "rank": rank,
        "pid": os.getpid(),
        "coords": _telemetry._grid_coords(),
        "gen": gen,
        "dropped": spans_dropped(),
        "clock_sync": clock_sync(),
        "spans": span_records(),
    }
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, trace_filename(rank, generation=gen))
    # Atomic publish: periodic dumpers (the fleet drill's pools) race
    # SIGKILL — a torn write must never leave a truncated JSON where a
    # reconstruction will read it.
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, default=str)
    os.replace(tmp, path)
    return path


def _load_rank_trace(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != TRACE_SCHEMA:
        raise ValueError(
            f"{path}: unsupported trace schema {doc.get('schema')!r} "
            f"(expected {TRACE_SCHEMA})."
        )
    if "rank" not in doc or "spans" not in doc or "clock_sync" not in doc:
        raise ValueError(f"{path}: not a per-rank trace file (missing keys).")
    return doc


#: max wall-clock disagreement (s) between two ranks' barrier-exit samples
#: before the merge refuses to treat them as the SAME barrier.  Same-run
#: samples differ by barrier-exit skew + NTP skew (well under a second);
#: anything bigger means the files come from different runs — the classic
#: stale-dump-in-a-reused-IGG_TELEMETRY_DIR hazard.
BARRIER_WALL_TOL_S = 2.0


#: per-epoch merge: pid stride between generation groups, so every
#: generation's rank tracks form one visually-contiguous band and pids
#: never collide across groups (``pid = gen_index*stride + rank``)
EPOCH_PID_STRIDE = 10000

_ALIGNMENT_NOTE = (
    "per-rank perf_counter timelines are aligned on the barrier "
    "instant recorded at init_global_grid; cross-rank ordering is "
    "trustworthy only beyond each rank's uncertainty_s (the "
    "measured barrier duration) — wall-clock-aligned ranks "
    "(barrier_aligned=false) carry whatever NTP skew the hosts "
    "have."
)


def _check_same_barrier(docs: Sequence[dict]) -> None:
    """Refuse barrier-anchored docs that describe DIFFERENT barriers —
    differing grid epochs or barrier-exit wall samples further apart than
    `BARRIER_WALL_TOL_S` (the stale-dump-in-a-reused-dir hazard)."""
    anchor = docs[0]["clock_sync"]
    for doc in docs[1:]:
        sync = doc["clock_sync"]
        if not (sync.get("barrier") and anchor.get("barrier")):
            continue  # wall-aligned below, flagged — no same-barrier claim
        wall_delta = abs(sync["wall"] - anchor["wall"])
        if (
            sync.get("epoch") != anchor.get("epoch")
            or wall_delta > BARRIER_WALL_TOL_S
        ):
            raise ValueError(
                f"merge_trace_files: rank {doc['rank']}'s barrier anchor "
                f"does not match rank {docs[0]['rank']}'s (epoch "
                f"{sync.get('epoch')} vs {anchor.get('epoch')}, barrier "
                f"wall samples {wall_delta:.1f}s apart > "
                f"{BARRIER_WALL_TOL_S}s) — the files describe different "
                f"runs/barriers and cannot share an aligned clock.  A "
                f"stale trace.p*.json from a previous run in a reused "
                f"telemetry dir looks exactly like this: delete it, or "
                f"merge the current run's files explicitly (or pass "
                f"--per-epoch when the dumps are a supervised restart's "
                f"generations)."
            )


def _aligned_events(
    docs: Sequence[dict],
    *,
    pid_base: int = 0,
    wall_shift: float = 0.0,
    track_suffix: str = "",
) -> tuple[list[dict], dict]:
    """Chrome-trace events for one same-barrier group of docs, plus the
    group's ``per_rank`` alignment metadata.  ``wall_shift`` moves the
    whole group on the merged axis (per-epoch merges place each
    generation at its true wall offset from the earliest group)."""
    anchor = docs[0]["clock_sync"]
    events: list[dict] = []
    per_rank: dict[str, Any] = {}
    for doc in docs:
        sync = doc["clock_sync"]
        barrier_aligned = bool(sync.get("barrier")) and bool(
            anchor.get("barrier")
        )
        if barrier_aligned:
            # span perf t -> seconds since the shared barrier instant.
            offset = -sync["perf"] + wall_shift
        else:
            # No shared barrier: fall back to wall-clock alignment, re-based
            # so the anchor rank's barrier (or sample) instant is still zero.
            offset = (sync["wall"] - anchor["wall"]) - sync["perf"] + wall_shift
        per_rank[str(doc["rank"])] = {
            "barrier_aligned": barrier_aligned,
            "offset_s": offset,
            "uncertainty_s": sync.get("uncertainty_s"),
            "wall_at_sync_unix_s": sync.get("wall"),
        }
        pid = doc["rank"] + pid_base
        coords = doc.get("coords")
        name = (
            f"rank {doc['rank']}"
            + (f" coords {tuple(coords)}" if coords else "")
            + track_suffix
        )
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": name},
            }
        )
        for s in doc["spans"]:
            ev = {
                "ph": "X",
                "name": s["name"],
                "pid": pid,
                "tid": 0,
                "ts": (s["t0"] + offset) * 1e6,
                "dur": s["dur"] * 1e6,
            }
            if s.get("args"):
                ev["args"] = s["args"]
            events.append(ev)
    return events, per_rank


def _finish_trace(events: list[dict], alignment: dict) -> dict:
    # Re-base so the earliest event sits at ts=0 (viewers dislike huge or
    # negative timestamps); the absolute anchor lives in the metadata.
    xs = [e["ts"] for e in events if e["ph"] == "X"]
    base = min(xs) if xs else 0.0
    for e in events:
        if e["ph"] == "X":
            e["ts"] -= base
    alignment["ts_zero_offset_s"] = base / 1e6
    events.sort(key=lambda e: (e["pid"], e.get("ts", -1.0)))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"clock_alignment": alignment},
    }


def _merge_per_epoch(docs: list[dict]) -> dict:
    """Per-epoch merge: group dumps by (generation, grid epoch), align each
    group on its OWN barrier, and place the groups on one shared wall-clock
    axis — the shape a supervised restart leaves in a telemetry dir, where
    the flat merge correctly refuses to pretend one barrier."""
    groups: dict[tuple, list[dict]] = {}
    for doc in docs:
        key = (doc.get("gen"), doc["clock_sync"].get("epoch"))
        groups.setdefault(key, []).append(doc)
    ordered = sorted(
        groups.items(),
        key=lambda kv: min(d["clock_sync"]["wall"] for d in kv[1]),
    )
    base_wall = min(d["clock_sync"]["wall"] for d in docs)
    events: list[dict] = []
    alignment: dict[str, Any] = {
        "per_epoch": True,
        "note": (
            _ALIGNMENT_NOTE
            + "  Groups (generations/epochs) are aligned on their own "
            "barriers and placed relative to each other by wall clock "
            "only — cross-group ordering carries NTP-grade skew."
        ),
        "groups": [],
    }
    for gi, ((gen, epoch), group) in enumerate(ordered):
        group = sorted(group, key=lambda d: d["rank"])
        ranks = [d["rank"] for d in group]
        if len(set(ranks)) != len(ranks):
            raise ValueError(
                f"merge_trace_files: duplicate rank(s) within generation "
                f"{gen!r} / epoch {epoch!r} ({ranks}) — each rank "
                f"contributes exactly one file per generation."
            )
        _check_same_barrier(group)
        anchor = group[0]["clock_sync"]
        suffix = f" gen {gen}" if gen is not None else f" epoch {epoch}"
        evs, per_rank = _aligned_events(
            group,
            pid_base=gi * EPOCH_PID_STRIDE,
            wall_shift=anchor["wall"] - base_wall,
            track_suffix=suffix,
        )
        events.extend(evs)
        alignment["groups"].append(
            {
                "gen": gen,
                "epoch": epoch,
                "anchor_rank": group[0]["rank"],
                "anchor_wall_unix_s": anchor["wall"],
                "pid_base": gi * EPOCH_PID_STRIDE,
                "per_rank": per_rank,
            }
        )
    return _finish_trace(events, alignment)


def merge_trace_files(
    paths: Sequence[str | os.PathLike], *, per_epoch: bool = False
) -> dict:
    """Join per-rank span files into one Chrome-trace/Perfetto JSON object.

    One track (pid) per rank; ``X`` (complete) events carry the span tags
    as ``args``.  Alignment: the lowest rank is the anchor — its
    barrier-exit wall time defines the absolute axis, and every rank's
    spans shift by ``(own perf at barrier exit)`` so all tracks share the
    barrier instant as time zero.  The per-rank offset and its uncertainty
    (the measured barrier duration — the honesty bound on cross-rank
    ordering) land in ``otherData.clock_alignment``; a rank whose sync was
    not barrier-anchored (``barrier: false``) is aligned by wall clock
    instead and flagged, since nothing ties its perf counter to the
    others'.  Events are sorted by (pid, ts), so each track's timestamps
    are monotonic — the tier-1 validity pin.

    Barrier-anchored inputs must describe the SAME barrier, or the merged
    "aligned" clock is a lie: the merge refuses files whose grid epochs
    differ or whose barrier-exit wall samples disagree by more than
    `BARRIER_WALL_TOL_S` (a stale ``trace.p*.json`` from a previous run
    left in a reused telemetry dir is exactly this shape — delete it, or
    pass the current run's files explicitly).  A supervised restart
    legitimately leaves MULTIPLE generations' dumps in one dir; pass
    ``per_epoch=True`` (CLI ``--per-epoch``) to merge each (generation,
    epoch) group under its own alignment — one pid band per group, groups
    placed relative to each other by wall clock — instead of refusing the
    set.
    """
    docs = sorted(
        (_load_rank_trace(os.fspath(p)) for p in paths),
        key=lambda d: d["rank"],
    )
    if not docs:
        raise ValueError("merge_trace_files: no per-rank trace files given.")
    if per_epoch:
        return _merge_per_epoch(docs)
    ranks = [d["rank"] for d in docs]
    if len(set(ranks)) != len(ranks):
        hint = ""
        if len({d.get("gen") for d in docs}) > 1:
            # the supervised-restart shape: each generation re-dumps the
            # same rank set — the remedy is the per-epoch merge, not
            # deleting files
            hint = (
                "  The dumps span multiple generations "
                "(trace.g<gen>.p<rank>.json): pass --per-epoch to merge "
                "each generation under its own alignment."
            )
        raise ValueError(
            f"merge_trace_files: duplicate rank(s) in inputs ({ranks}) — "
            f"each rank contributes exactly one file.{hint}"
        )
    _check_same_barrier(docs)
    anchor = docs[0]["clock_sync"]
    events, per_rank = _aligned_events(docs)
    alignment: dict[str, Any] = {
        "anchor_rank": docs[0]["rank"],
        "anchor_wall_unix_s": anchor["wall"],
        "note": _ALIGNMENT_NOTE,
        "per_rank": per_rank,
    }
    return _finish_trace(events, alignment)


def validate_chrome_trace(doc: dict) -> list[str]:
    """Problems with a merged trace (empty list = valid): the tier-1 /
    soak check that the artifact really is loadable Chrome-trace JSON with
    per-track monotonic timestamps and alignment metadata.  NaN/inf
    timestamps are rejected explicitly — Python's json writes them but
    strict parsers (and the trace viewers) refuse the artifact, and a NaN
    would additionally sail through the monotonicity comparison."""
    import math

    problems: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is missing or not a list"]
    last_ts: dict[Any, float] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e or "pid" not in e:
            problems.append(f"event {i} malformed: {e!r}")
            continue
        if e["ph"] != "X":
            continue
        for key in ("name", "ts", "dur"):
            if key not in e:
                problems.append(f"event {i} missing {key!r}")
        ts = e.get("ts")
        if (
            not isinstance(ts, (int, float))
            or not math.isfinite(ts)
            or ts < 0
        ):
            problems.append(f"event {i} has non-finite/negative ts {ts!r}")
            continue
        dur = e.get("dur")
        if isinstance(dur, (int, float)) and (
            not math.isfinite(dur) or dur < 0
        ):
            problems.append(f"event {i} has non-finite/negative dur {dur!r}")
        if ts < last_ts.get(e["pid"], float("-inf")):
            problems.append(
                f"event {i} breaks track pid={e['pid']} monotonicity "
                f"({ts} after {last_ts[e['pid']]})"
            )
        last_ts[e["pid"]] = ts
    if "clock_alignment" not in doc.get("otherData", {}):
        problems.append("otherData.clock_alignment metadata missing")
    return problems


# -- request-tree reconstruction + critical path ------------------------------


def _trace_match(args: dict | None, trace_id: str) -> tuple[bool, str | None]:
    """Does a span's ``args`` belong to ``trace_id``?  Returns
    ``(matched, member_parent_span_id)`` — the second element is set when
    the match came through a serving-round ``members`` entry, whose
    embedded context names the request-side parent span directly."""
    if not args:
        return False, None
    matched = False
    member_parent = None
    # A round span tags BOTH ``trace_ids`` and ``members``: the member
    # entry must still yield the parent edge, so look for it first.
    for m in args.get("members") or ():
        if isinstance(m, dict):
            ctx = m.get("trace")
            if isinstance(ctx, dict) and ctx.get("trace_id") == trace_id:
                matched = True
                member_parent = ctx.get("span_id")
                break
    if args.get("trace_id") == trace_id:
        matched = True
    ids = args.get("trace_ids")
    if not matched and ids and trace_id in ids:
        matched = True
    return matched, member_parent


def _span_wall(doc: dict, t0: float) -> float:
    """A span's start instant on the wall clock, anchored by its dump's
    clock sync — the one axis per-pool/per-generation dumps share."""
    sync = doc["clock_sync"]
    return sync["wall"] + (float(t0) - sync["perf"])


def request_tree(docs: Sequence[dict], trace_id: str) -> dict:
    """Reconstruct ONE request's causal tree from any set of per-rank
    trace docs (the `dump_trace` schema) — across pools, generations and
    re-routes, since span/parent ids are globally unique and every dump
    carries its own wall anchor.

    Parenting: an explicit ``parent_id`` tag wins (cross-dump — ids are
    global); a tagged-but-unparented span nests under the smallest
    enclosing matching span of its OWN dump (time containment — the
    round-span case, where many requests share one span); anything else
    is a root.  Returns ``{"trace_id", "roots", "spans", "ranks",
    "gens", "dropped", "incomplete"}`` — ``incomplete`` is True when any
    contributing dump reported ring evictions, because a truncated ring
    reconstructs into a silently-partial tree and the reader must know.
    """
    nodes: list[dict] = []
    for di, doc in enumerate(docs):
        for s in doc.get("spans", ()):
            args = s.get("args")
            matched, member_parent = _trace_match(args, trace_id)
            if not matched:
                continue
            args = args or {}
            nodes.append(
                {
                    "name": s["name"],
                    "rank": doc.get("rank"),
                    "gen": doc.get("gen"),
                    "t0_unix_s": _span_wall(doc, s["t0"]),
                    "dur_s": float(s["dur"]),
                    "args": args,
                    "span_id": args.get("span_id"),
                    "parent_id": args.get("parent_id") or member_parent,
                    "children": [],
                    "_doc": di,
                }
            )
    by_span_id = {n["span_id"]: n for n in nodes if n["span_id"]}
    roots: list[dict] = []
    for n in nodes:
        parent = by_span_id.get(n["parent_id"]) if n["parent_id"] else None
        if parent is None and not n["parent_id"]:
            # No explicit link: nest under the smallest enclosing matching
            # span of the same dump (perf clocks only compare in-process).
            t0, t1 = n["t0_unix_s"], n["t0_unix_s"] + n["dur_s"]
            best = None
            for c in nodes:
                if c is n or c["_doc"] != n["_doc"]:
                    continue
                c0, c1 = c["t0_unix_s"], c["t0_unix_s"] + c["dur_s"]
                if c0 <= t0 + 1e-9 and t1 <= c1 + 1e-9 and c["dur_s"] >= n["dur_s"]:
                    if best is None or c["dur_s"] < best["dur_s"]:
                        best = c
            parent = best
        if parent is not None and parent is not n:
            parent["children"].append(n)
        else:
            roots.append(n)

    def _order(ns: list[dict]) -> None:
        ns.sort(key=lambda x: x["t0_unix_s"])
        for x in ns:
            x.pop("_doc", None)
            _order(x["children"])

    _order(roots)
    dropped = sum(int(doc.get("dropped") or 0) for doc in docs)
    return {
        "trace_id": trace_id,
        "roots": roots,
        "spans": len(nodes),
        "ranks": sorted({n["rank"] for n in nodes if n["rank"] is not None}),
        "gens": sorted({n["gen"] for n in nodes if n["gen"] is not None}),
        "dropped": dropped,
        "incomplete": dropped > 0,
    }


#: latency-attribution segments, first match wins per span name: the
#: request's wall time decomposes into queue-wait / admission / re-route /
#: checkpoint / exchange / rounds (residual round time net of nested
#: exchange+checkpoint), with anything uncovered landing in ``other``.
_SEGMENT_OF = (
    ("queue_wait", ("igg.frontdoor.admit",)),
    ("admission", ("igg.serving.admission",)),
    ("reroute", ("igg.fleet.reroute", "igg.fleet.detect")),
    (
        "checkpoint",
        (
            "igg.checkpoint.save",
            "igg.checkpoint.restore",
            "igg.frontdoor.resize",
        ),
    ),
    (
        "exchange",
        (
            "igg_halo_exchange",
            "igg_slab_exchange_begin",
            "igg_slab_exchange_finish",
        ),
    ),
    ("rounds", ("igg.serving.round",)),
)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge overlapping intervals (duplicate round spans from N ranks
    must count the wall-clock once, not N times)."""
    out: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _measure(intervals: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in intervals)


def _subtract(
    intervals: list[tuple[float, float]],
    minus: list[tuple[float, float]],
) -> list[tuple[float, float]]:
    """Interval-set difference (both inputs already unioned/sorted)."""
    out: list[tuple[float, float]] = []
    for a, b in intervals:
        cur = a
        for ma, mb in minus:
            if mb <= cur or ma >= b:
                continue
            if ma > cur:
                out.append((cur, ma))
            cur = max(cur, mb)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def critical_path(tree: dict) -> dict:
    """Attribute a request's latency to segments (`_SEGMENT_OF`), walking
    the `request_tree` output on the shared wall axis.

    Each segment's time is the UNION of its spans' wall intervals (N
    ranks' identical round spans count once); nested double-counting is
    removed (exchange/checkpoint time inside a round is charged to
    exchange/checkpoint, not rounds; admission inside queue-wait to
    admission).  ``total_s`` is the door's submit→result span when present
    (``igg.frontdoor.request``), else the tree's wall extent; the
    uncovered remainder is ``other``.  Returns ``{"total_s", "segments":
    {seg: {"s", "share"}}}``."""
    flat: list[dict] = []

    def _walk(ns) -> None:
        for n in ns:
            flat.append(n)
            _walk(n["children"])

    _walk(tree.get("roots", ()))
    seg_iv: dict[str, list[tuple[float, float]]] = {
        seg: [] for seg, _names in _SEGMENT_OF
    }
    name_to_seg = {
        name: seg for seg, names in _SEGMENT_OF for name in names
    }
    request_spans: list[dict] = []
    for n in flat:
        if n["name"] == "igg.frontdoor.request":
            request_spans.append(n)
        seg = name_to_seg.get(n["name"])
        if seg is not None:
            seg_iv[seg].append(
                (n["t0_unix_s"], n["t0_unix_s"] + n["dur_s"])
            )
    iv = {seg: _union(v) for seg, v in seg_iv.items()}
    # Charge nested time to the inner segment, once.
    iv["rounds"] = _subtract(
        _subtract(iv["rounds"], iv["exchange"]), iv["checkpoint"]
    )
    iv["queue_wait"] = _subtract(iv["queue_wait"], iv["admission"])
    if request_spans:
        total = max(n["dur_s"] for n in request_spans)
    elif flat:
        t0 = min(n["t0_unix_s"] for n in flat)
        t1 = max(n["t0_unix_s"] + n["dur_s"] for n in flat)
        total = t1 - t0
    else:
        total = 0.0
    segments: dict[str, dict] = {}
    covered = 0.0
    for seg, _names in _SEGMENT_OF:
        s = _measure(iv[seg])
        covered += s
        segments[seg] = {
            "s": s,
            "share": (s / total) if total > 0 else 0.0,
        }
    other = max(0.0, total - covered)
    segments["other"] = {
        "s": other,
        "share": (other / total) if total > 0 else 0.0,
    }
    return {"total_s": total, "segments": segments}


#: span-name prefixes highlighted in the `request_chrome_trace` view —
#: the request's control-plane skeleton (door hops, fleet routing,
#: supervised restarts), colored apart from the compute spans they enclose
_REQUEST_SKELETON_PREFIXES = ("igg.frontdoor.", "igg.fleet.", "igg.supervisor.")


def request_chrome_trace(tree: dict) -> dict:
    """One request's causal tree (`request_tree` output) as a Chrome-trace/
    Perfetto JSON object: one track per (generation, rank) the request
    touched, every span placed on the ABSOLUTE wall axis (each dump's own
    clock sync anchors it — the only axis that exists across pools and
    generations), control-plane skeleton spans highlighted via ``cname``.
    The alignment honesty note lands in ``otherData.clock_alignment``;
    the tree's incompleteness verdict rides ``otherData.request``.
    """
    flat: list[dict] = []

    def _walk(ns) -> None:
        for n in ns:
            flat.append(n)
            _walk(n["children"])

    _walk(tree.get("roots", ()))
    if not flat:
        raise ValueError(
            f"request_chrome_trace: no spans for trace "
            f"{tree.get('trace_id')!r}."
        )
    t_zero = min(n["t0_unix_s"] for n in flat)

    def _band(n: dict) -> tuple:
        return (
            n["gen"] if n["gen"] is not None else -1,
            n["rank"] if n["rank"] is not None else -1,
        )

    bands = sorted({_band(n) for n in flat})
    pid_of = {band: i for i, band in enumerate(bands)}
    events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid_of[(gen, rank)],
            "args": {
                "name": f"rank {rank}"
                + (f" (gen {gen})" if gen >= 0 else "")
            },
        }
        for gen, rank in bands
    ]
    spans = []
    for n in flat:
        ev = {
            "name": n["name"],
            "ph": "X",
            "pid": pid_of[_band(n)],
            "tid": 0,
            "ts": (n["t0_unix_s"] - t_zero) * 1e6,
            "dur": n["dur_s"] * 1e6,
            "cat": "igg",
            "args": n["args"],
        }
        if n["name"].startswith(_REQUEST_SKELETON_PREFIXES):
            ev["cname"] = "thread_state_running"  # the highlighted skeleton
        spans.append(ev)
    spans.sort(key=lambda e: (e["pid"], e["ts"]))
    events.extend(spans)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock_alignment": {
                "mode": "wall",
                "note": (
                    "request view: every dump's spans are placed on the "
                    "absolute wall axis via its own clock sync — "
                    "cross-process ordering carries whatever NTP skew "
                    "the hosts have."
                ),
            },
            "request": {
                "trace_id": tree.get("trace_id"),
                "ranks": tree.get("ranks"),
                "gens": tree.get("gens"),
                "dropped": tree.get("dropped"),
                "incomplete": tree.get("incomplete"),
            },
        },
    }


# -- OTLP/JSON export ---------------------------------------------------------

#: span names exported with OTLP ``kind`` SERVER (2) — the ingress edges;
#: everything else is INTERNAL (1)
_OTLP_SERVER_SPANS = frozenset({"igg.frontdoor.request", "igg.fleet.route"})


def _otlp_value(v: Any) -> dict:
    """One OTLP AnyValue.  Deterministic: compound values serialize as
    sorted-key JSON strings, so the export is byte-stable for a fixed
    input (the golden-pin contract)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    if isinstance(v, str):
        return {"stringValue": v}
    return {"stringValue": json.dumps(v, sort_keys=True, default=str)}


def otlp_trace(docs: Sequence[dict], *, trace_id: str | None = None) -> dict:
    """Export per-rank trace docs as OTLP/JSON (``resourceSpans`` —
    the Jaeger/Tempo ingest shape; one resource per dump, resource
    attributes ``service.name=igg`` / ``igg.rank`` / ``igg.gen``).

    ``trace_id=`` exports one request's spans only; otherwise every
    closed span ships, with untagged spans grouped under a deterministic
    per-dump trace id (content-addressed — same dump, same export).
    Timestamps are wall-anchored via each dump's clock sync.  Output is
    deterministic for fixed input: docs sort by (gen, rank), spans by
    (t0, name), attributes by key — serialize with ``sort_keys`` for a
    byte-stable artifact."""
    import hashlib

    resource_spans: list[dict] = []
    for doc in sorted(
        docs, key=lambda d: (d.get("gen") or 0, d.get("rank") or 0)
    ):
        rank = doc.get("rank")
        gen = doc.get("gen")
        local_tid = hashlib.sha256(
            f"igg:{rank}:{gen}".encode()
        ).hexdigest()[:32]
        spans = sorted(
            (s for s in doc.get("spans", ()) if not s.get("open")),
            key=lambda s: (float(s["t0"]), s["name"]),
        )
        out_spans: list[dict] = []
        for i, s in enumerate(spans):
            args = s.get("args") or {}
            member_parent = None
            if trace_id is not None:
                matched, member_parent = _trace_match(args, trace_id)
                if not matched:
                    continue
            tid = args.get("trace_id") or trace_id or local_tid
            sid = args.get("span_id") or hashlib.sha256(
                f"{rank}:{gen}:{s['name']}:{float(s['t0']):.9f}:"
                f"{float(s['dur']):.9f}:{i}".encode()
            ).hexdigest()[:16]
            start = _span_wall(doc, s["t0"])
            end = start + float(s["dur"])
            span_doc: dict[str, Any] = {
                "traceId": tid,
                "spanId": sid,
                "name": s["name"],
                "kind": 2 if s["name"] in _OTLP_SERVER_SPANS else 1,
                "startTimeUnixNano": str(int(round(start * 1e9))),
                "endTimeUnixNano": str(int(round(end * 1e9))),
            }
            parent = args.get("parent_id") or member_parent
            if parent:
                span_doc["parentSpanId"] = parent
            attrs = [
                {"key": k, "value": _otlp_value(v)}
                for k, v in sorted(args.items())
                if k not in ("trace_id", "span_id", "parent_id")
            ]
            if attrs:
                span_doc["attributes"] = attrs
            out_spans.append(span_doc)
        if not out_spans:
            continue
        res_attrs = [
            {"key": "service.name", "value": {"stringValue": "igg"}},
        ]
        if rank is not None:
            res_attrs.append(
                {"key": "igg.rank", "value": {"intValue": str(int(rank))}}
            )
        if gen is not None:
            res_attrs.append(
                {"key": "igg.gen", "value": {"intValue": str(int(gen))}}
            )
        resource_spans.append(
            {
                "resource": {"attributes": res_attrs},
                "scopeSpans": [
                    {
                        "scope": {
                            "name": "igg.tracing",
                            "version": str(TRACE_SCHEMA),
                        },
                        "spans": out_spans,
                    }
                ],
            }
        )
    return {"resourceSpans": resource_spans}


def _hexid(v: Any, width: int) -> bool:
    if not isinstance(v, str) or len(v) != width:
        return False
    try:
        int(v, 16)
        return True
    except ValueError:
        return False


def validate_otlp(doc: dict) -> list[str]:
    """Problems with an OTLP/JSON export (empty list = valid): the schema
    check behind the golden pin — id widths, nano-timestamp strings with
    end >= start, attribute shape, the resourceSpans nesting a collector
    actually accepts."""
    problems: list[str] = []
    rss = doc.get("resourceSpans")
    if not isinstance(rss, list):
        return ["resourceSpans is missing or not a list"]

    def _check_attrs(attrs: Any, where: str) -> None:
        if attrs is None:
            return
        if not isinstance(attrs, list):
            problems.append(f"{where}: attributes not a list")
            return
        for a in attrs:
            if (
                not isinstance(a, dict)
                or not isinstance(a.get("key"), str)
                or not isinstance(a.get("value"), dict)
            ):
                problems.append(f"{where}: malformed attribute {a!r}")

    for ri, rs in enumerate(rss):
        if not isinstance(rs, dict):
            problems.append(f"resourceSpans[{ri}] not an object")
            continue
        _check_attrs(
            rs.get("resource", {}).get("attributes"),
            f"resourceSpans[{ri}].resource",
        )
        sss = rs.get("scopeSpans")
        if not isinstance(sss, list):
            problems.append(f"resourceSpans[{ri}].scopeSpans not a list")
            continue
        for si, ss in enumerate(sss):
            spans = ss.get("spans") if isinstance(ss, dict) else None
            if not isinstance(spans, list):
                problems.append(
                    f"resourceSpans[{ri}].scopeSpans[{si}].spans not a list"
                )
                continue
            for pi, sp in enumerate(spans):
                where = (
                    f"resourceSpans[{ri}].scopeSpans[{si}].spans[{pi}]"
                )
                if not isinstance(sp, dict):
                    problems.append(f"{where} not an object")
                    continue
                if not _hexid(sp.get("traceId"), 32):
                    problems.append(f"{where}: bad traceId")
                if not _hexid(sp.get("spanId"), 16):
                    problems.append(f"{where}: bad spanId")
                if "parentSpanId" in sp and not _hexid(
                    sp["parentSpanId"], 16
                ):
                    problems.append(f"{where}: bad parentSpanId")
                if not sp.get("name"):
                    problems.append(f"{where}: empty name")
                if not isinstance(sp.get("kind"), int):
                    problems.append(f"{where}: kind not an int")
                try:
                    t0 = int(sp.get("startTimeUnixNano"))
                    t1 = int(sp.get("endTimeUnixNano"))
                    if t1 < t0:
                        problems.append(f"{where}: end before start")
                except (TypeError, ValueError):
                    problems.append(f"{where}: non-integer timestamps")
                _check_attrs(sp.get("attributes"), where)
    return problems


# -- straggler detection ------------------------------------------------------

#: default ``IGG_SKEW_WARN`` threshold on max/min per-rank step seconds
SKEW_WARN_DEFAULT = 2.0

#: one-shot latency armed on the next host collective (the ``net_delay``
#: fault kind, `utils.resilience`): seconds slept before this process enters
#: its next halo exchange or control collective — its peers block with it,
#: which is exactly the transient network fault the chaos plane models.
_collective_delay = 0.0


def arm_collective_delay(seconds: float) -> None:
    """Arm one-shot latency on this process's next host collective: its
    next halo exchange (`ops.halo.exchange`), or its next control
    collective (`all_ranks_value`, `serving.frontdoor.broadcast_control`),
    whichever comes first.  The fault-injection hook of ``net_delay``."""
    global _collective_delay
    _collective_delay = max(0.0, float(seconds))


def _consume_collective_delay() -> None:
    global _collective_delay
    delay, _collective_delay = _collective_delay, 0.0
    if delay:
        time.sleep(delay)


def all_ranks_value(value: float):
    """Share one host scalar per process with every process.

    Returns the ``dims``-shaped numpy array of every block's value (one
    block per process), or None on single-process grids — the probe is
    strictly a cross-process diagnostic.  One ``all_gather`` of one
    float64 per rank; under NCCL the tensors live on the grid's device
    (a CPU tensor in an NCCL collective raises).  COLLECTIVE: every
    process must call it together.
    """
    from ..parallel import distributed as _dist
    from ..parallel import grid as _grid

    if not _grid.grid_is_initialized() or _dist.process_count() == 1:
        return None
    _consume_collective_delay()
    import torch
    import torch.distributed as dist

    gg = _grid.global_grid()
    device = gg.device if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.tensor([float(value)], dtype=torch.float64, device=device)
    parts = [torch.empty_like(mine) for _ in range(_dist.process_count())]
    dist.all_gather(parts, mine)
    # one block per process, ranks in C order over the dims
    # (`parallel.topology.coords_of_rank`)
    return torch.cat(parts).cpu().numpy().reshape(tuple(gg.dims))


def skew_probe(step_seconds: float, *, warn: float | None = None) -> dict | None:
    """One all-ranks skew probe over the last window's step wall time.

    Publishes the ``skew.step_seconds_max_over_min`` and
    ``skew.slowest_rank`` gauges on every rank, fires a rank-tagged
    ``skew.straggler`` event (plus the ``skew.straggler_total`` counter)
    when the ratio exceeds ``warn`` (default ``IGG_SKEW_WARN``, built-in
    `SKEW_WARN_DEFAULT`; 0 disables the event).  Returns the probe result
    dict, or None on single-process grids (skipped entirely — no
    collective, no gauges).  Collective; call at a deterministic cadence
    on every process (the heartbeat cadence of the instrumented loops).
    """
    vals = all_ranks_value(float(step_seconds))
    if vals is None:
        return None
    import numpy as np

    vmax = float(np.max(vals))
    vmin = float(np.min(vals))
    ratio = vmax / vmin if vmin > 0 else float("inf") if vmax > 0 else 1.0
    # one block per process, ranks in C order: the flat index is the rank
    slowest_rank = int(np.argmax(vals))
    slow_coords = [int(c) for c in np.unravel_index(slowest_rank, vals.shape)]
    _telemetry.gauge("skew.step_seconds_max_over_min").set(ratio)
    _telemetry.gauge("skew.slowest_rank").set(slowest_rank)
    if warn is None:
        env = _config.skew_warn_env()
        warn = SKEW_WARN_DEFAULT if env is None else env
    result = {
        "ratio": ratio,
        "slowest_rank": slowest_rank,
        "slowest_coords": slow_coords,
        "max_s": vmax,
        "min_s": vmin,
        "mine_s": float(step_seconds),
    }
    if warn and ratio > warn:
        _telemetry.counter("skew.straggler_total").inc()
        _telemetry.event("skew.straggler", warn=warn, **result)
    return result


# -- flight recorder ----------------------------------------------------------


def flight_filename(rank: int) -> str:
    return f"flight_{rank}.json"


def _active_config() -> dict:
    """The run's active configuration for a flight bundle: every ``IGG_*``
    env var plus the live grid's identity (when one is up)."""
    cfg: dict[str, Any] = {
        "env": {k: v for k, v in os.environ.items() if k.startswith("IGG_")},
    }
    try:
        from ..parallel import grid as _grid

        if _grid.grid_is_initialized():
            gg = _grid.global_grid()
            cfg["grid"] = {
                "nxyz_g": list(gg.nxyz_g),
                "nxyz": list(gg.nxyz),
                "dims": list(gg.dims),
                "coords": list(gg.coords),
                "periods": list(gg.periods),
                "overlaps": list(gg.overlaps),
                "nprocs": gg.nprocs,
                "me": gg.me,
                "epoch": gg.epoch,
            }
    except Exception:  # the recorder must never raise out of a crash path
        pass
    return cfg


def dump_flight_recorder(reason: str, **info: Any) -> str | None:
    """Dump the crash flight-recorder bundle for this rank.

    One JSON object — ``{ts, reason, rank, pid, coords, info, config,
    metrics, spans}`` — appended as a single ``O_APPEND`` line to
    ``flight_<rank>.json`` under ``IGG_TELEMETRY_DIR`` (several trips
    append several lines; the last line is the newest bundle).  Crash-safe
    by the event-log discipline: the write is one ``os.write`` of a
    complete line, so a hard ``os._exit`` immediately after loses nothing.
    Returns the path, or None when telemetry is off / no directory is set.
    Never raises: a failing recorder must not mask the fault it records.
    """
    try:
        if not _telemetry.enabled():
            return None
        directory = _config.telemetry_dir_env()
        if not directory:
            return None
        rank = _telemetry._proc_index()
        bundle = {
            "ts": time.time(),
            "reason": reason,
            "rank": rank,
            "pid": os.getpid(),
            "coords": _telemetry._grid_coords(),
            "info": info,
            "config": _active_config(),
            "metrics": _telemetry.snapshot(),
            # Closed ring PLUS the spans currently executing (``open:
            # true``, every thread): the span you most want at crash time
            # is the one that was in flight when the run died.
            "spans": span_records() + open_spans(),
        }
        try:
            # An in-flight device capture (`utils.profiling`): a crash
            # mid-window is explained by its dir, window and step.
            from . import profiling as _profiling

            cap = _profiling.active_capture()
            if cap is not None:
                bundle["profile"] = cap
        except Exception:
            pass
        try:
            line = json.dumps(bundle, default=str) + "\n"
        except (TypeError, ValueError):
            line = json.dumps(
                {k: str(v) for k, v in bundle.items()}
            ) + "\n"
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, flight_filename(rank))
        fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            os.write(fd, line.encode())
        finally:
            os.close(fd)
        _telemetry.counter("resilience.flight_dumps").inc()
        return path
    except Exception:
        return None


def read_flight_bundles(path: str | os.PathLike) -> list[dict]:
    """Parse one ``flight_<rank>.json`` (one bundle per line, torn trailing
    line skipped — the `telemetry.read_events` contract)."""
    return _telemetry.read_events(path)


def reset() -> None:
    """Drop the span ring, open/context stacks, drop counter, clock sync
    and the armed collective delay (test hook)."""
    global _ring, _ring_cap, _clock_sync, _collective_delay, _spans_dropped
    with _lock:
        _ring = None
        _ring_cap = 0
    _open_stacks.clear()
    _ctx_stacks.clear()
    _spans_dropped = 0
    _clock_sync = None
    _collective_delay = 0.0
