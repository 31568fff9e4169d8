"""The minimal counter, gauge and event sink the resilience layer writes.

The JAX package's ``utils/telemetry.py`` is a whole observability plane
(histograms, step loops, exposition, the live plane).  The port carries
only what the guard, checkpoint and integrity code record, under the same
names, so that a test reads ``snapshot()["counters"]["integrity.audits"]``
here as it does there:

* `counter` ``(name).inc(n)`` and `gauge` ``(name).set(v)``, process-wide;
* `event` ``(etype, **payload)``: one rank-tagged JSON line appended to
  ``$IGG_TELEMETRY_DIR/events[.p<rank>].jsonl`` (nothing without the
  variable);
* `snapshot`, `process_count` and `reset`.

``IGG_TELEMETRY=0`` turns counters and events into no-ops.  The full plane
(step telemetry, exposition, the flight recorder) is ROADMAP Queue A item
14; this module is internal until then.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

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


class _Noop:
    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass


NOOP = _Noop()

_lock = threading.Lock()
_counters: dict[str, Counter] = {}
_gauges: dict[str, Gauge] = {}
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
            "counters": {n: c.value for n, c in _counters.items()},
            "gauges": {n: g.value for n, g in _gauges.items()},
        }


def reset() -> None:
    """Drop every metric and close the event logs (test hook)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        for fd in _event_fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        _event_fds.clear()
