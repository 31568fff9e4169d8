"""The port's metrics registry and event sink.

The JAX package's ``utils/telemetry.py`` is a whole observability plane
(step loops, exposition, the live plane).  The port carries what the
guard, checkpoint, integrity and serving code record, under the same
names, so that a test reads ``snapshot()["counters"]["integrity.audits"]``
or ``snapshot()["histograms"]["serving.round_seconds"]`` here as it does
there:

* `counter` ``(name).inc(n)``, `gauge` ``(name).set(v)`` and `histogram`
  ``(name).record(v)`` (count/sum/min/max, a bounded seeded reservoir for
  p50/p90/p99, and the rolling SLO window ring), process-wide;
* the cardinality-capped per-tenant families `tenant_counter`,
  `tenant_histogram` and `frontdoor_tenant_counter`;
* `event` ``(etype, **payload)``: one rank-tagged JSON line appended to
  ``$IGG_TELEMETRY_DIR/events[.p<rank>].jsonl`` (nothing without the
  variable);
* `note_progress`/`last_progress`, `proc_rss_bytes`, `atomic_write_json`,
  `teff_bytes`;
* `snapshot`, `prometheus_text` (a pure function of a snapshot),
  `process_count` and `reset`.

``IGG_TELEMETRY=0`` turns metrics and events into no-ops.  Step telemetry,
spans, the flight recorder and the live plane (scrape server, anomaly
rules) are ROADMAP Queue A item 14; the serving front door serves
``/metrics`` and ``/healthz`` from this registry until then.
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


def enabled() -> bool:
    """The ``IGG_TELEMETRY`` switch (read per call)."""
    return _config.telemetry_enabled_env()


class Counter:
    """Monotonic counter: ``inc`` is its only mutator."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


#: reservoir size of every histogram (stable p50/p90/p99, a few KiB each)
RESERVOIR_SIZE = 512

#: rolling-SLO geometry: `SLO_WINDOWS` windows of ``IGG_SLO_WINDOW_S``
#: seconds each (default `SLO_WINDOW_S_DEFAULT`), `WINDOW_RESERVOIR`
#: samples per window
SLO_WINDOWS = 5
SLO_WINDOW_S_DEFAULT = 30.0
WINDOW_RESERVOIR = 256


def _slo_window_s() -> float:
    val = _config.slo_window_env()
    return SLO_WINDOW_S_DEFAULT if val is None else val


class _Window:
    """One rolling-SLO sub-window: a bounded sample list over a time slice."""

    __slots__ = ("t0", "count", "total", "samples")

    def __init__(self, t0: float):
        self.t0 = t0
        self.count = 0
        self.total = 0.0
        self.samples: list[float] = []

    def add(self, v: float, rng) -> None:
        self.count += 1
        self.total += v
        if len(self.samples) < WINDOW_RESERVOIR:
            self.samples.append(v)
        else:
            j = rng.randrange(self.count)
            if j < WINDOW_RESERVOIR:
                self.samples[j] = v


def _quantile_of(samples: list[float], q: float) -> float | None:
    if not samples:
        return None
    s = sorted(samples)
    return s[min(len(s) - 1, max(0, round(q * (len(s) - 1))))]


class Histogram:
    """Streaming distribution: count/sum/min/max, a bounded reservoir
    (Vitter-R with a seeded PRNG: deterministic for a given record
    sequence), and a ring of rolling sub-windows that `window_summary`
    turns into live p50/p90/p99 over the last `SLO_WINDOWS` windows — the
    SLO surface admission keys on.  Mutators and readers hold the
    instance lock, so a scrape mid-`record` sees a consistent state."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples", "_rng",
                 "_hlock", "_win_cur", "_win_ring", "_win_len")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples: list[float] = []
        self._rng = random.Random(0x1661)
        self._hlock = threading.Lock()
        self._win_cur: _Window | None = None
        self._win_ring: collections.deque | None = None
        self._win_len = 0.0

    def record(self, v: float, now: float | None = None) -> None:
        v = float(v)
        with self._hlock:
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if len(self._samples) < RESERVOIR_SIZE:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < RESERVOIR_SIZE:
                    self._samples[j] = v
            if now is None:
                now = time.monotonic()
            w = self._win_cur
            if w is None:
                self._win_len = _slo_window_s()
                self._win_ring = collections.deque(maxlen=SLO_WINDOWS - 1)
                w = self._win_cur = _Window(now)
            elif now - w.t0 >= self._win_len:
                self._win_ring.append(w)
                self._win_len = _slo_window_s()
                w = self._win_cur = _Window(now)
            w.add(v, self._rng)

    def quantile(self, q: float) -> float | None:
        with self._hlock:
            return _quantile_of(self._samples, q)

    def window_summary(self, now: float | None = None) -> dict | None:
        """Live ``{window_s, windows, count, mean, p50, p90, p99}`` over the
        windows inside the rolling horizon, or None before the first
        record (or once every window aged out)."""
        with self._hlock:
            return self._window_summary_locked(now)

    def _window_summary_locked(self, now: float | None = None) -> dict | None:
        if self._win_cur is None:
            return None
        if now is None:
            now = time.monotonic()
        horizon = now - SLO_WINDOWS * self._win_len
        live = [w for w in (*self._win_ring, self._win_cur) if w.t0 >= horizon]
        samples: list[float] = []
        count, total = 0, 0.0
        for w in live:
            samples.extend(w.samples)
            count += w.count
            total += w.total
        if not count:
            return None
        return {
            "window_s": self._win_len, "windows": len(live), "count": count,
            "mean": total / count, "p50": _quantile_of(samples, 0.50),
            "p90": _quantile_of(samples, 0.90), "p99": _quantile_of(samples, 0.99),
        }

    def summary(self) -> dict:
        with self._hlock:
            out = {
                "count": self.count, "sum": self.total, "min": self.min,
                "max": self.max,
                "mean": (self.total / self.count) if self.count else None,
                "p50": _quantile_of(self._samples, 0.50),
                "p90": _quantile_of(self._samples, 0.90),
                "p99": _quantile_of(self._samples, 0.99),
            }
            win = self._window_summary_locked()
            if win is not None:
                out["window"] = win
            return out


class _Noop:
    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def record(self, v, now=None) -> None:
        pass


NOOP = _Noop()

_lock = threading.Lock()
_counters: dict[str, Counter] = {}
_gauges: dict[str, Gauge] = {}
_histograms: dict[str, Histogram] = {}
_event_fds: dict[tuple[str, str], int] = {}


def counter(name: str) -> Counter | _Noop:
    """The counter ``name`` (created on first use); `NOOP` when off."""
    if not enabled():
        return NOOP
    with _lock:
        m = _counters.get(name)
        if m is None:
            m = _counters[name] = Counter(name)
        return m


def gauge(name: str) -> Gauge | _Noop:
    """The gauge ``name`` (created on first use); `NOOP` when off."""
    if not enabled():
        return NOOP
    with _lock:
        m = _gauges.get(name)
        if m is None:
            m = _gauges[name] = Gauge(name)
        return m


def histogram(name: str) -> Histogram | _Noop:
    """The histogram ``name`` (created on first use); `NOOP` when off."""
    if not enabled():
        return NOOP
    with _lock:
        m = _histograms.get(name)
        if m is None:
            m = _histograms[name] = Histogram(name)
        return m


#: default ``IGG_TELEMETRY_MAX_TENANTS`` (distinct per-tenant series)
MAX_TENANTS_DEFAULT = 64

#: the fold-over series once the tenant cap is hit
TENANT_OVERFLOW = "serving.tenant.__other__.steps"

#: the fold-over series of the front door's per-tenant latency family
FRONTDOOR_TENANT_OVERFLOW = "frontdoor.tenant.__other__.request_seconds"


def _capped_tenant_metric(registry: dict, factory, tenant: str, prefix: str,
                          suffix: str, overflow: str):
    """One cardinality-capped per-tenant series out of ``registry``.

    Tenant strings arrive from requests: at most
    ``IGG_TELEMETRY_MAX_TENANTS`` (default `MAX_TENANTS_DEFAULT`) distinct
    series are created per (prefix, suffix) family; past the cap new
    tenants fold into ``overflow`` (existing tenants keep their own).
    """
    name = f"{prefix}{tenant}{suffix}"
    with _lock:
        m = registry.get(name)
        if m is None:
            env = _config.telemetry_max_tenants_env()
            cap = MAX_TENANTS_DEFAULT if env is None else env
            distinct = sum(1 for k in registry
                           if k.startswith(prefix) and k.endswith(suffix) and k != overflow)
            if name != overflow and distinct >= cap:
                name = overflow
                m = registry.get(name)
            if m is None:
                m = registry[name] = factory(name)
        return m


def tenant_counter(tenant: str) -> Counter | _Noop:
    """The ``serving.tenant.<tenant>.steps`` counter, cardinality-capped."""
    if not enabled():
        return NOOP
    return _capped_tenant_metric(_counters, Counter, tenant, "serving.tenant.", ".steps",
                                 TENANT_OVERFLOW)


def frontdoor_tenant_counter(tenant: str, kind: str) -> Counter | _Noop:
    """``frontdoor.tenant.<tenant>.<kind>`` (``admitted``/``rejected``),
    cardinality-capped like `tenant_counter`."""
    if not enabled():
        return NOOP
    return _capped_tenant_metric(_counters, Counter, tenant, "frontdoor.tenant.", f".{kind}",
                                 f"frontdoor.tenant.__other__.{kind}")


def tenant_histogram(tenant: str) -> Histogram | _Noop:
    """The ``frontdoor.tenant.<tenant>.request_seconds`` histogram,
    cardinality-capped like `tenant_counter`."""
    if not enabled():
        return NOOP
    return _capped_tenant_metric(_histograms, Histogram, tenant, "frontdoor.tenant.",
                                 ".request_seconds", FRONTDOOR_TENANT_OVERFLOW)


# The newest completed unit of work of this process, ``{wall, kind, step,
# init, done}`` (``done``: the loop drained, so a growing age is idleness,
# not a stall); ``/healthz`` serves it as ``last_step``.
_progress: dict | None = None


def note_progress(kind: str, step: int, *, init: bool = False, done: bool = False) -> None:
    """Record the newest completed work unit."""
    global _progress
    _progress = {"wall": time.time(), "kind": kind, "step": int(step), "init": init,
                 "done": done}


def last_progress() -> dict | None:
    """The newest progress record plus its ``age_s``, or None before any."""
    p = _progress
    if p is None:
        return None
    return {**p, "age_s": time.time() - p["wall"]}


def proc_rss_bytes() -> int | None:
    """This process's resident set size in bytes (``/proc/self/statm``),
    or None when unknown."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        return None


def teff_bytes(fields: Sequence) -> int:
    """The bytes-moved-per-step model of the evolving fields: ``2 *
    sum(nbytes)`` (each must-stream field read once and written once).
    Port fields are this rank's blocks, so this is a per-GPU figure."""
    return 2 * sum(int(A.numel()) * A.element_size() for A in fields)


def process_count() -> int:
    """Process count of the running job (1 without a process group)."""
    from ..parallel import distributed as _dist

    return _dist.process_count()


def _rank() -> int:
    from ..parallel import distributed as _dist

    return _dist.process_index()


def _grid_coords() -> list[int] | None:
    from ..parallel import grid as _grid

    return list(_grid.global_grid().coords) if _grid.grid_is_initialized() else None


def event(etype: str, **payload: Any) -> None:
    """Append one rank/coords-tagged event line to this process's log.

    One ``os.write`` on an ``O_APPEND`` descriptor per line, so a line
    survives an ``os._exit`` right after it; values that JSON cannot hold
    are written as strings.  No-op unless telemetry is on and
    ``IGG_TELEMETRY_DIR`` is set.  Where the JAX package also dumps a
    flight-recorder bundle, the port records this event only (the flight
    recorder is ROADMAP Queue A item 14).
    """
    if not enabled():
        return
    directory = _config.telemetry_dir_env()
    if not directory:
        return
    rank = _rank()
    rec = {"ts": time.time(), "type": etype, "rank": rank, "pid": os.getpid(),
           "coords": _grid_coords()}
    gen = _config.generation_env()
    if gen is not None:
        rec["gen"] = gen
    rec.update(payload)
    line = json.dumps(rec, default=str) + "\n"
    key = (directory, "events.jsonl" if rank == 0 else f"events.p{rank}.jsonl")
    try:
        with _lock:
            fd = _event_fds.get(key)
            if fd is None:
                os.makedirs(directory, exist_ok=True)
                fd = _event_fds[key] = os.open(
                    os.path.join(*key), os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        os.write(fd, line.encode())
    except OSError:
        pass  # a full or unwritable disk must not take the run down


def atomic_write_json(path, doc, *, fsync: bool = True, indent: int | None = None) -> str:
    """Publish ``doc`` as JSON at ``path`` whole or not at all: a ``.tmp``
    sibling, flushed and (by default) fsync'd, then one ``os.replace``."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=indent, default=str)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_events(path) -> list[dict]:
    """Parse one JSONL event file, skipping a torn last line."""
    out = []
    with open(os.fspath(path)) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def snapshot() -> dict:
    """The registry as plain data."""
    with _lock:
        return {
            "enabled": enabled(),
            "rank": _rank(),
            "pid": os.getpid(),
            "ts": time.time(),
            "coords": _grid_coords(),
            "counters": {n: c.value for n, c in _counters.items()},
            "gauges": {n: g.value for n, g in _gauges.items()},
            "histograms": {n: h.summary() for n, h in _histograms.items()},
        }


def _prom_name(name: str) -> str:
    """Prometheus metric name: ``igg_`` prefix, other characters to ``_``."""
    return "igg_" + "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def prometheus_text(snap: dict | None = None) -> str:
    """Prometheus text exposition (format 0.0.4) of a registry snapshot:
    counters as ``counter``, gauges as ``gauge``, histograms as ``summary``
    (reservoir quantiles + ``_sum``/``_count``), each with its ``# TYPE``
    line.  A pure function of ``snap`` (default: a fresh `snapshot`)."""
    if snap is None:
        snap = snapshot()
    lines: list[str] = []
    for name, value in sorted(snap.get("counters", {}).items()):
        pn = _prom_name(name) + "_total"
        lines += [f"# TYPE {pn} counter", f"{pn} {value}"]
    for name, value in sorted(snap.get("gauges", {}).items()):
        pn = _prom_name(name)
        lines += [f"# TYPE {pn} gauge", f"{pn} {value}"]
    for name, s in sorted(snap.get("histograms", {}).items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} summary")
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            if s.get(key) is not None:
                lines.append(f'{pn}{{quantile="{q}"}} {s[key]}')
        lines += [f"{pn}_sum {s.get('sum', 0.0)}", f"{pn}_count {s.get('count', 0)}"]
    return "\n".join(lines) + "\n"


def reset() -> None:
    """Drop every metric and the progress record, and close the event logs
    (test hook)."""
    global _progress
    with _lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        for fd in _event_fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        _event_fds.clear()
    _progress = None
