"""The port's telemetry: metrics registry, event log and step loops.

The counterpart of the JAX package's ``utils/telemetry.py``, under the
same names, so that a test reads ``snapshot()["counters"]["integrity.audits"]``
or ``snapshot()["histograms"]["serving.round_seconds"]`` here as it does
there:

* `counter` ``(name).inc(n)``, `gauge` ``(name).set(v)`` and `histogram`
  ``(name).record(v)`` (count/sum/min/max, a bounded seeded reservoir for
  p50/p90/p99, and the rolling SLO window ring), process-wide;
* the cardinality-capped per-tenant families `tenant_counter`,
  `tenant_histogram` and `frontdoor_tenant_counter`;
* `event` ``(etype, **payload)``: one rank-tagged JSON line appended to
  ``$IGG_TELEMETRY_DIR/events[.p<rank>].jsonl`` (nothing without the
  variable); inside a request context the line carries its ``trace_id``;
* `snapshot` (exported as ``telemetry_snapshot``), `prometheus_text` (a
  pure function of a snapshot) and `dump_metrics` (both, to files);
* `step_loop`: the models' per-step recorder — ``<model>.steps``,
  ``.step_seconds``, ``.steps_per_s`` and the built-in ``T_eff`` from the
  solver's bytes model (`teff_bytes`), plus the ``IGG_HEARTBEAT_EVERY``
  heartbeat (the skew probe, ``proc.rss_bytes``, the live plane's tick
  and the rank-0 stderr line);
* `note_progress`/`last_progress`, `proc_rss_bytes`, `atomic_write_json`,
  `set_rank_hint`, `process_count` and `reset`.

``IGG_TELEMETRY=0`` turns metrics and events into no-ops and `step_loop`
returns None: the instrumented loops then allocate nothing per step.
"""

from __future__ import annotations

import collections
import json
import os
import random
import sys
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


def gauge_value(name: str) -> float | None:
    """The value of gauge ``name`` if it exists (never creates one): the
    heartbeat attaches skew and serving context only when published."""
    with _lock:
        g = _gauges.get(name)
        return g.value if g is not None else None


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


# The rank during bring-up, before `torch.distributed` can answer:
# `parallel.distributed.init_distributed` stages ``RANK`` here, so that
# retry and fault events fired mid-bring-up land in the right per-rank file.
_rank_hint: int | None = None


def set_rank_hint(rank: int | None) -> None:
    """Stage the process rank for event tagging during bring-up."""
    global _rank_hint
    _rank_hint = None if rank is None else int(rank)


def _proc_index() -> int:
    """The process rank: the process group's once it is up, else the
    bring-up hint, else 0."""
    from ..parallel import distributed as _dist

    if _dist.is_distributed_initialized():
        return _dist.process_index()
    return _rank_hint if _rank_hint is not None else 0


def _grid_coords() -> list[int] | None:
    from ..parallel import grid as _grid

    return list(_grid.global_grid().coords) if _grid.grid_is_initialized() else None


def event(etype: str, **payload: Any) -> None:
    """Append one rank/coords-tagged event line to this process's log.

    One ``os.write`` on an ``O_APPEND`` descriptor per line, so a line
    survives an ``os._exit`` right after it; values that JSON cannot hold
    are written as strings.  No-op unless telemetry is on and
    ``IGG_TELEMETRY_DIR`` is set.  An event emitted inside a request
    context (`utils.tracing.use_context`, a context-carrying span) carries
    that request's ``trace_id``.
    """
    if not enabled():
        return
    directory = _config.telemetry_dir_env()
    if not directory:
        return
    rank = _proc_index()
    rec = {"ts": time.time(), "type": etype, "rank": rank, "pid": os.getpid(),
           "coords": _grid_coords()}
    gen = _config.generation_env()
    if gen is not None:
        rec["gen"] = gen
    if "trace_id" not in payload:
        from . import tracing as _tracing  # tracing imports this module

        ctx = _tracing.current_context()
        if ctx is not None and "trace_id" in ctx:
            rec["trace_id"] = ctx["trace_id"]
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
            "rank": _proc_index(),
            "pid": os.getpid(),
            "ts": time.time(),
            "coords": _grid_coords(),
            "counters": {n: c.value for n, c in _counters.items()},
            "gauges": {n: g.value for n, g in _gauges.items()},
            "histograms": {n: h.summary() for n, h in _histograms.items()},
        }


#: the public name (``igg.telemetry_snapshot``)
telemetry_snapshot = snapshot


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


def dump_metrics(path) -> tuple[str, str]:
    """Write the registry snapshot as JSON and Prometheus text:
    ``<path>.json`` and ``<path>.prom`` (a ``path`` ending in ``.json``
    keeps that name and the exposition drops the suffix).  Returns
    ``(json_path, prom_path)``.  Exported as ``igg.dump_metrics``."""
    path = os.fspath(path)
    base = path[: -len(".json")] if path.endswith(".json") else path
    json_path, prom_path = base + ".json", base + ".prom"
    snap = snapshot()
    d = os.path.dirname(base)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(snap, f, indent=1, default=str)
    with open(prom_path, "w") as f:
        f.write(prometheus_text(snap))
    return json_path, prom_path


# -- Step-loop instrumentation ------------------------------------------------


class _StepLoop:
    """Per-step recorder handed to the models' time loops (see `step_loop`)."""

    def __init__(self, model: str, bytes_per_step: int | None, start_step: int,
                 total_steps: int, heartbeat_every: int, steps_per_call: int = 1):
        self.model = model
        self.bytes_per_step = bytes_per_step
        self.total_steps = total_steps
        self.heartbeat_every = heartbeat_every
        self._is_rank0 = _proc_index() == 0
        self._steps = counter(f"{model}.steps")
        self._step_s = histogram(f"{model}.step_seconds")
        self._sps = gauge(f"{model}.steps_per_s")
        self._teff = histogram(f"{model}.t_eff_gbs") if bytes_per_step else None
        self._teff_g = gauge(f"{model}.t_eff_gbs_last") if bytes_per_step else None
        self._t_last = time.perf_counter()
        # last-window accumulator of the all-ranks skew probe (one window
        # per heartbeat interval)
        self._win_sum = 0.0
        self._win_n = 0
        # The live plane: the per-rank scrape server (no-op unless
        # IGG_METRICS_PORT is set), and the pre-first-step mark that keeps
        # the step-stall rule quiet through bring-up.
        note_progress(model, start_step, init=True)
        from . import liveplane as _liveplane

        _liveplane.ensure_server()
        # The device-timeline capture (`utils.profiling`): None unless
        # IGG_PROFILE names a step window.
        from . import profiling as _profiling

        self._profile = _profiling.maybe_arm(start_step, steps_per_call)
        event("run.start", model=model, start_step=start_step,
              total_steps=total_steps, bytes_per_step=bytes_per_step)

    def on_step(self, it: int, steps: int = 1) -> None:
        """Record one loop call that advanced ``steps`` steps to step
        ``it`` (wall time since the previous call).  A call of ``steps > 1``
        steps (a fused group) records its time per step ``steps`` times;
        the heartbeat fires when the call crossed a multiple of
        ``IGG_HEARTBEAT_EVERY``.  With ``steps = 1`` this is the JAX
        package's per-step record."""
        now = time.perf_counter()
        dt = (now - self._t_last) / steps
        self._t_last = now
        self._steps.inc(steps)
        for _ in range(steps):
            self._step_s.record(dt)
        self._win_sum += dt * steps
        self._win_n += steps
        if dt > 0:
            self._sps.set(1.0 / dt)
        gbs = None
        if self._teff is not None and dt > 0:
            gbs = self.bytes_per_step / dt / 1e9
            for _ in range(steps):
                self._teff.record(gbs)
            self._teff_g.set(gbs)
        note_progress(self.model, it)
        if self._profile is not None:
            self._profile.on_step(it, steps)
        hb = self.heartbeat_every
        if hb and it // hb > (it - steps) // hb:
            # The skew probe is a collective: every rank runs it at the
            # same step, outside the rank-0 gate (one process: no-op).
            skew = None
            if self._win_n:
                from . import tracing as _tracing

                skew = _tracing.skew_probe(self._win_sum / self._win_n)
            self._win_sum = 0.0
            self._win_n = 0
            # The live-plane tick on every rank (local: no collective).
            rss = proc_rss_bytes()
            if rss is not None:
                gauge("proc.rss_bytes").set(rss)
            from . import liveplane as _liveplane

            _liveplane.heartbeat_tick(model=self.model)
            if self._is_rank0:
                teff_s = f" T_eff {gbs:.2f} GB/s" if gbs is not None else ""
                skew_s = (f" skew {skew['ratio']:.2f} (slowest rank "
                          f"{skew['slowest_rank']})" if skew else "")
                print(
                    f"[igg.telemetry] {self.model} step {it}/{self.total_steps} "
                    f"{dt * 1e3:.2f} ms/step {1.0 / dt if dt > 0 else 0.0:.1f} "
                    f"steps/s{teff_s}{skew_s}",
                    file=sys.stderr, flush=True,
                )
                event("heartbeat", model=self.model, step=it, step_seconds=dt,
                      t_eff_gbs=gbs, **_heartbeat_context(skew))

    def finish(self, it: int) -> None:
        if self._profile is not None:
            # a window still open past the last step stops here
            self._profile.close("run_complete")
        note_progress(self.model, it, done=True)
        event("run.complete", model=self.model, step=it)


def _heartbeat_context(skew: dict | None) -> dict:
    """The heartbeat event's context: the skew gauges (this probe's result,
    else the last published), the serving pool's occupancy and the live
    plane's port — each only when something recorded it."""
    ctx: dict = {}
    if skew is not None:
        ctx["skew"] = {"step_seconds_max_over_min": skew["ratio"],
                       "slowest_rank": skew["slowest_rank"]}
    else:
        ratio = gauge_value("skew.step_seconds_max_over_min")
        if ratio is not None:
            ctx["skew"] = {"step_seconds_max_over_min": ratio,
                           "slowest_rank": gauge_value("skew.slowest_rank")}
    active = gauge_value("serving.active_members")
    if active is not None:
        ctx["serving"] = {"active_members": active,
                          "queue_depth": gauge_value("serving.queue_depth")}
    port = gauge_value("liveplane.port")
    if port is not None:
        ctx["liveplane"] = {"port": int(port)}
    return ctx


def step_loop(model: str, *, bytes_per_step: int | None = None, start_step: int = 0,
              total_steps: int = 0, steps_per_call: int = 1) -> _StepLoop | None:
    """A per-step recorder for a host-side time loop, or ``None`` when
    telemetry is off.

    The ``None`` return is the zero-overhead contract: the caller's loop
    guards every telemetry touch behind ``if tele is not None``.
    ``bytes_per_step`` (`teff_bytes`) switches on the built-in ``T_eff``;
    the heartbeat cadence comes from ``IGG_HEARTBEAT_EVERY``.  The loop's
    wall time per step is host time: on the card the loop never waits for
    the device, so it is the dispatch time until the CUDA queue fills and
    the device's pace after that (amortized, as in the JAX package).
    ``steps_per_call``: the steps one loop call advances, which an
    ``IGG_PROFILE`` window is matched against.
    """
    if not enabled():
        return None
    hb = _config.heartbeat_every_env() or 0
    return _StepLoop(model, bytes_per_step, start_step, total_steps, hb, steps_per_call)


def reset() -> None:
    """Drop every metric, the progress record and the rank hint, and close
    the event logs (test hook)."""
    global _progress, _rank_hint
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
    _rank_hint = None
