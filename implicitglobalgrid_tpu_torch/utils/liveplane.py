"""Live telemetry plane: per-rank scrape endpoints and in-flight anomaly
rules — the port's counterpart of the JAX package's ``utils/liveplane.py``,
with the same rules, thresholds, severities and documents.

* **Per-rank endpoints** — `ensure_server` starts ONE daemon-thread HTTP
  server per process when ``IGG_METRICS_PORT`` is set (port 0 =
  ephemeral; the bound port is published via the ``liveplane.port``
  gauge, the rank-0 heartbeat event and a ``liveplane.p<rank>.json``
  endpoint file under ``IGG_TELEMETRY_DIR``).  Read-only endpoints, no
  collectives: ``/metrics`` (`telemetry.prometheus_text`, byte-identical
  to what `telemetry.dump_metrics` writes for the same snapshot),
  ``/healthz`` (`health_snapshot`) and ``/spans`` (the `utils.tracing`
  ring plus the open spans; ``?name=`` and ``?request=`` narrow it).
  With ``IGG_TELEMETRY=0`` the server never starts.
* **Rolling SLO windows** — `publish_slo_gauges` turns every histogram's
  sliding-window view into the ``slo.<metric>.p50/p90/p99`` gauges for
  ``step_seconds``, ``t_eff_gbs`` and the serving round/request latencies.
* **In-flight anomaly detection** — a `RuleEngine` over `default_rules`
  evaluated at heartbeat cadence on each rank (`heartbeat_tick`, from the
  models' instrumented loops and `serving.ServingLoop`) AND at scrape time
  (``/healthz`` and every admission view — the only vantage that sees a
  stalled loop).  Each rule transition fires ONE ``alert.<rule>`` event
  and lands in the bounded ``alerts`` ring; subscribers
  (`resilience.guarded_time_loop`, the serving front door's autoscaler)
  and the serving loop's alert cursor escalate critical alerts.

Layering: imports `config`, `telemetry` and `tracing` only; torch and the
device are never touched (the plane must serve while the device side is
wedged — that is exactly when an operator scrapes it).
"""

from __future__ import annotations

import collections
import http.server
import json
import os
import socket
import threading
import time
import urllib.parse as _urlparse
from typing import Any, Callable

from . import config as _config
from . import telemetry as _telemetry
from . import tracing as _tracing

__all__ = [
    "enabled",
    "ensure_server",
    "start_server",
    "stop_server",
    "server_port",
    "endpoint_filename",
    "health_snapshot",
    "slo_view",
    "publish_slo_gauges",
    "heartbeat_tick",
    "Rule",
    "RuleEngine",
    "get_engine",
    "register_rule",
    "subscribe",
    "unsubscribe",
    "alerts_since",
    "set_teff_expectation",
    "teff_expectation",
    "reset",
]

#: wall-clock at module import: the uptime baseline ``/healthz`` reports
_T0 = time.time()

#: bound on the recent-alerts ring (`RuleEngine`) and the ``alerts``
#: section of ``/healthz`` — however long the run, however noisy the rules
ALERTS_KEEP = 32


def enabled() -> bool:
    """The live plane can start: telemetry on AND ``IGG_METRICS_PORT`` set."""
    return _telemetry.enabled() and _config.metrics_port_env() is not None


# -- health snapshot ----------------------------------------------------------


def _grid_identity() -> dict | None:
    try:
        from ..parallel import grid as _grid

        if _grid.grid_is_initialized():
            gg = _grid.global_grid()
            return {
                "nxyz_g": list(gg.nxyz_g),
                "nxyz": list(gg.nxyz),
                "dims": list(gg.dims),
                "coords": list(gg.coords),
                "nprocs": gg.nprocs,
                "me": gg.me,
                "epoch": gg.epoch,
            }
    except Exception:  # the health view must never raise out of a scrape
        pass
    return None


def health_snapshot(snap: dict | None = None) -> dict:
    """The ``/healthz`` document: one JSON-serializable dict per scrape.

    ``ok`` is False while any CRITICAL alert is active.  ``slo`` carries
    each histogram's rolling-window quantiles (absent until something
    recorded into a window); ``skew``/``serving`` appear only when their
    gauges were published — absence is meaningful, never zero-filled (the
    heartbeat-event convention).  ``snap`` shares the caller's registry
    snapshot (the scrape handler takes exactly one per request).
    """
    if snap is None:
        snap = _telemetry.snapshot()
    eng = get_engine()
    active = eng.active_alerts()
    doc: dict[str, Any] = {
        "ok": not any(a["severity"] == "critical" for a in active),
        "ts": snap["ts"],
        "rank": snap["rank"],
        "pid": snap["pid"],
        "coords": snap["coords"],
        "uptime_s": time.time() - _T0,
        "telemetry_enabled": snap["enabled"],
    }
    grid = _grid_identity()
    if grid is not None:
        doc["grid"] = grid
    prog = _telemetry.last_progress()
    if prog is not None:
        doc["last_step"] = prog
    doc.update(_health_tail(snap, eng, active))
    return doc


def slo_view(snap: dict) -> dict:
    """``{histogram name: rolling-window summary}`` of a registry snapshot
    — the live-quantile view ``/healthz``'s ``slo`` section serves."""
    return {
        name: s["window"]
        for name, s in snap.get("histograms", {}).items()
        if "window" in s
    }


def _health_tail(snap: dict, eng: "RuleEngine", active: list[dict]) -> dict:
    """The registry-derived sections of the health document (guard/skew/
    serving/slo/liveplane/alerts)."""
    gauges = snap.get("gauges", {})
    counters = snap.get("counters", {})
    doc: dict[str, Any] = {}
    doc["guard"] = {
        "trips": counters.get("resilience.guard_trips", 0),
        "rollbacks": counters.get("resilience.rollbacks", 0),
        "watchdog_deadline_exceeded": counters.get(
            "resilience.watchdog_deadline_exceeded", 0
        ),
        "retries": counters.get("resilience.retries", 0),
        "flight_dumps": counters.get("resilience.flight_dumps", 0),
    }
    ratio = gauges.get("skew.step_seconds_max_over_min")
    if ratio is not None:
        doc["skew"] = {
            "step_seconds_max_over_min": ratio,
            "slowest_rank": gauges.get("skew.slowest_rank"),
            "straggler_total": counters.get("skew.straggler_total", 0),
        }
    if "serving.active_members" in gauges:
        doc["serving"] = {
            "active_members": gauges["serving.active_members"],
            "queue_depth": gauges.get("serving.queue_depth"),
            "capacity": gauges.get("serving.capacity"),
        }
        # Worst in-flight request age, computed at scrape time from the
        # front door's oldest-submit gauge (a precomputed age would go
        # stale between scrapes; a timestamp cannot).
        oldest = gauges.get("frontdoor.oldest_submitted_ts")
        if oldest:
            doc["serving"]["oldest_request_age_s"] = round(
                max(0.0, time.time() - oldest), 3
            )
    if "frontdoor.port" in gauges or "frontdoor.requests_total" in counters:
        # The network-facing plane (serving.frontdoor):
        # admission totals + per-reason rejects + per-tenant counters, so
        # one /healthz scrape answers "who is being turned away and why".
        rejected = {
            name[len("frontdoor.rejected."):]: v
            for name, v in counters.items()
            if name.startswith("frontdoor.rejected.")
        }
        tenants: dict[str, dict] = {}
        for name, v in counters.items():
            if not name.startswith("frontdoor.tenant."):
                continue
            tenant, _, kind = name[len("frontdoor.tenant."):].rpartition(".")
            if tenant:
                tenants.setdefault(tenant, {})[kind] = v
        doc["frontdoor"] = {
            "port": gauges.get("frontdoor.port"),
            "pending": gauges.get("frontdoor.pending"),
            "backpressure": gauges.get("frontdoor.backpressure"),
            "requests_total": counters.get("frontdoor.requests_total", 0),
            "admitted_total": counters.get("frontdoor.admitted_total", 0),
            "rejected_total": counters.get("frontdoor.rejected_total", 0),
            "rejected": rejected,
            "tenants": tenants,
        }
    slo = slo_view(snap)
    if slo:
        doc["slo"] = slo
    port = gauges.get("liveplane.port")
    if port is not None:
        doc["liveplane"] = {"port": int(port)}
    doc["alerts"] = {
        "active": active,
        "recent": eng.recent_alerts(),
        # from the engine, not the counter snapshot: alerts fired by THIS
        # scrape's rule evaluation must already be visible in its response
        "fired_total": eng.fired_total(),
    }
    return doc


# -- rolling SLO gauges -------------------------------------------------------

#: histogram-name suffixes promoted into the ``slo.*`` gauge family — the
#: step-latency, throughput, serving-round and front-door request-latency
#: families admission control keys on
_SLO_SUFFIXES = ("step_seconds", "t_eff_gbs", "round_seconds",
                 "request_seconds")


def publish_slo_gauges(snap: dict | None = None) -> dict:
    """Publish ``slo.<metric>.p50/p90/p99`` gauges from the rolling windows.

    Returns ``{metric: window summary}`` for the histograms that had live
    window data.  No-op (empty dict) when telemetry is disabled.
    """
    if not _telemetry.enabled():
        return {}
    if snap is None:
        snap = _telemetry.snapshot()
    out = {}
    for name, s in snap.get("histograms", {}).items():
        win = s.get("window")
        if not win or not name.endswith(_SLO_SUFFIXES):
            continue
        out[name] = win
        for q in ("p50", "p90", "p99"):
            v = win.get(q)
            if v is not None:
                _telemetry.gauge(f"slo.{name}.{q}").set(v)
    return out


# -- anomaly rules ------------------------------------------------------------

# Explicit T_eff expectations (GB/s) per model: whoever holds a modelled or
# measured figure the convention should sustain (a benchmark harness, a
# deployment config) stages it here and `TeffDropRule` checks live windows
# against it (expectation source ``reconcile``, the JAX package's name).
# Without one, the rule self-calibrates on the run's own lifetime p90 — a
# regression-from-own-baseline alarm.
_teff_expectations: dict[str, float] = {}


def set_teff_expectation(model: str, gbs: float | None) -> None:
    """Stage (or clear, with None) the expected T_eff for ``model``."""
    if gbs is None:
        _teff_expectations.pop(model, None)
    else:
        _teff_expectations[model] = float(gbs)


def teff_expectation(model: str) -> float | None:
    return _teff_expectations.get(model)


class Rule:
    """One anomaly rule: ``check(ctx)`` returns an evidence dict while the
    anomalous condition holds, else None.  ``ctx`` carries ``now``,
    ``source`` (``"heartbeat"`` | ``"scrape"``), ``snapshot`` (the registry),
    ``progress`` (`telemetry.last_progress`) and ``rss``.  The engine
    latches per rule: ONE ``alert.<name>`` event per continuous episode
    (re-arming when the condition clears).  Rules must be cheap and local
    — they run inside the step loop's heartbeat and the scrape handler."""

    name = "rule"
    severity = "warn"

    def check(self, ctx: dict) -> dict | None:  # pragma: no cover - abstract
        raise NotImplementedError


class TeffDropRule(Rule):
    """Windowed T_eff p50 below a fraction of the expectation.

    Expectation: the staged reconcile-derived prior (`set_teff_expectation`)
    when one exists, else the run's own lifetime p90 (self-calibrating).
    Warm-up guarded: needs ``min_total`` lifetime samples and
    ``min_window`` samples in the live window before judging.
    """

    name = "teff_drop"
    severity = "warn"

    def __init__(self, fraction: float = 0.5, *, min_window: int = 4,
                 min_total: int = 20):
        self.fraction = fraction
        self.min_window = min_window
        self.min_total = min_total

    def check(self, ctx: dict) -> dict | None:
        for name, s in ctx["snapshot"].get("histograms", {}).items():
            if not name.endswith(".t_eff_gbs"):
                continue
            win = s.get("window")
            if (
                not win
                or win["count"] < self.min_window
                or s["count"] < self.min_total
            ):
                continue
            model = name[: -len(".t_eff_gbs")]
            expect = teff_expectation(model)
            source = "reconcile" if expect is not None else "lifetime_p90"
            if expect is None:
                expect = s.get("p90")
            if not expect:
                continue
            if win["p50"] < self.fraction * expect:
                return {
                    "metric": name,
                    "window_p50_gbs": win["p50"],
                    "expected_gbs": expect,
                    "expectation_source": source,
                    "fraction": self.fraction,
                }
        return None


class SkewSustainedRule(Rule):
    """Skew ratio past ``IGG_SKEW_WARN`` for ``k`` consecutive heartbeat
    windows, fired ONLY on the rank the probe named slowest — every rank
    sees the same gauges, so firing everywhere would be noise without
    attribution."""

    name = "skew_sustained"
    severity = "warn"

    def __init__(self, k: int = 3):
        self.k = k
        self._streak = 0
        self._ev: dict | None = None

    def check(self, ctx: dict) -> dict | None:
        if ctx["source"] != "heartbeat":
            return self._ev  # gauges only move at heartbeat cadence
        gauges = ctx["snapshot"].get("gauges", {})
        ratio = gauges.get("skew.step_seconds_max_over_min")
        slowest = gauges.get("skew.slowest_rank")
        warn = _config.skew_warn_env()
        if warn is None:
            warn = _tracing.SKEW_WARN_DEFAULT
        if (
            ratio is not None
            and warn
            and ratio > warn
            and slowest == ctx["snapshot"]["rank"]
        ):
            self._streak += 1
        else:
            self._streak = 0
            self._ev = None
            return None
        if self._streak >= self.k:
            self._ev = {
                "ratio": ratio,
                "warn": warn,
                "windows": self._streak,
                "slowest_rank": slowest,
            }
        return self._ev


class ConvergenceStallRule(Rule):
    """A watched residual gauge not improving over ``k`` heartbeat windows.

    Defaults to ``serving.pt_residual_min`` (the porous PT residual
    `serving.ServingLoop` publishes each convergence sweep); quiet when
    the gauge does not exist, or when the companion ``<gauge cut to
    prefix>_watched`` population gauge says nothing is being driven
    toward a tolerance (a retired member's frozen residual is not a
    stall).  "Improving" = dropping by at least ``rel_improve`` relative
    to the best value seen this episode; a JUMP past ``1 + jump`` of the
    best resets the episode instead of counting as stagnation — the
    watched population changed (a fresh member starts at a higher
    residual), it did not stall.
    """

    name = "convergence_stall"
    severity = "warn"

    def __init__(self, k: int = 3, *, gauge: str = "serving.pt_residual_min",
                 rel_improve: float = 1e-3, jump: float = 0.5):
        self.k = k
        self.gauge = gauge
        self.watched_gauge = gauge.rsplit("_min", 1)[0] + "_watched"
        self.rel_improve = rel_improve
        self.jump = jump
        self._best: float | None = None
        self._streak = 0
        self._ev: dict | None = None

    def _reset(self, best: float | None = None) -> None:
        self._best, self._streak, self._ev = best, 0, None

    def check(self, ctx: dict) -> dict | None:
        if ctx["source"] != "heartbeat":
            return self._ev
        gauges = ctx["snapshot"].get("gauges", {})
        cur = gauges.get(self.gauge)
        if cur is None or gauges.get(self.watched_gauge) == 0:
            self._reset()
            return None
        if self._best is None or cur < self._best * (1.0 - self.rel_improve):
            self._reset(cur)
            return None
        if cur > self._best * (1.0 + self.jump):
            # population change, not a stall: restart the episode here
            self._reset(cur)
            return None
        self._streak += 1
        if self._streak >= self.k:
            self._ev = {
                "gauge": self.gauge,
                "residual": cur,
                "best": self._best,
                "windows": self._streak,
            }
        return self._ev


class StepStallRule(Rule):
    """Last-step age past the stall deadline — the rule that catches a hung
    loop, which is precisely why it ALSO evaluates at scrape time: a
    stalled loop never reaches its own heartbeat, but the scrape thread
    stays alive and sees the age grow.

    Deadline: ``IGG_WATCHDOG_S`` when set (> 0), else
    ``max(floor_s, factor * p50 step latency)`` from the rolling window
    (falling back to the lifetime p50).  The MEDIAN deliberately, not p99:
    the first step's compile time is a legitimate tail outlier that would
    stretch a p99-based deadline past any real stall.  Quiet before the
    first completed step (bring-up + first compile are not stalls) and
    after a completed run (the server outlives the loop).
    """

    name = "step_stall"
    severity = "critical"

    def __init__(self, *, floor_s: float = 1.0, factor: float = 20.0):
        self.floor_s = floor_s
        self.factor = factor

    def _deadline(self, ctx: dict, kind: str) -> float:
        wd = _config.watchdog_env()
        if wd:
            return wd
        hist = (
            "serving.round_seconds"
            if kind == "serving.round"
            else f"{kind}.step_seconds"
        )
        s = ctx["snapshot"].get("histograms", {}).get(hist, {})
        p50 = s.get("window", {}).get("p50") or s.get("p50")
        return max(self.floor_s, self.factor * p50) if p50 else self.floor_s

    def check(self, ctx: dict) -> dict | None:
        p = ctx.get("progress")
        if not p or p.get("init") or p.get("done"):
            return None
        deadline = self._deadline(ctx, p["kind"])
        if p["age_s"] > deadline:
            return {
                "kind": p["kind"],
                "step": p["step"],
                "age_s": round(p["age_s"], 3),
                "deadline_s": round(deadline, 3),
            }
        return None


class RssGrowthRule(Rule):
    """Process RSS grown past ``factor`` x the first observation (and by at
    least ``min_bytes`` absolute — small processes breathe).  The leak
    tripwire the ``proc.rss_bytes`` heartbeat gauge exists for."""

    name = "rss_growth"
    severity = "warn"

    def __init__(self, factor: float = 1.5, *, min_bytes: int = 256 << 20):
        self.factor = factor
        self.min_bytes = min_bytes
        self._baseline: int | None = None

    def check(self, ctx: dict) -> dict | None:
        rss = ctx.get("rss")
        if rss is None:
            return None
        if self._baseline is None:
            if ctx["source"] == "heartbeat":
                self._baseline = rss  # first heartbeat = steady-state-ish
            return None
        if (
            rss > self.factor * self._baseline
            and rss - self._baseline > self.min_bytes
        ):
            return {
                "rss_bytes": rss,
                "baseline_bytes": self._baseline,
                "growth": round(rss / self._baseline, 3),
            }
        return None


def default_rules() -> list[Rule]:
    return [
        TeffDropRule(),
        SkewSustainedRule(),
        ConvergenceStallRule(),
        StepStallRule(),
        RssGrowthRule(),
    ]


class RuleEngine:
    """Evaluates the rule set, latches per-rule episodes, fans alerts out.

    Thread-safe: ticks arrive from the step loop (heartbeat) AND the
    scrape handler's thread.  Per alert transition: ONE structured
    ``alert.<rule>`` event (rank-tagged via the event log), the
    ``alerts.fired_total`` counter, a slot in the bounded recent ring, and
    one callback per subscriber (exceptions swallowed — an alert consumer
    must never take down the loop that feeds it).
    """

    def __init__(self, rules: list[Rule] | None = None):
        self.rules: list[Rule] = (
            list(rules) if rules is not None else default_rules()
        )
        self._lock = threading.Lock()
        self._active: dict[str, dict] = {}  # rule name -> active alert
        self._recent: collections.deque = collections.deque(maxlen=ALERTS_KEEP)
        self._subscribers: list[Callable[[dict], None]] = []
        self._seq = 0

    # - wiring -

    def register(self, rule: Rule) -> None:
        with self._lock:
            self.rules.append(rule)

    def subscribe(self, fn: Callable[[dict], None]) -> Callable[[dict], None]:
        with self._lock:
            if fn not in self._subscribers:
                self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    # - evaluation -

    def tick(self, source: str = "heartbeat", model: str | None = None,
             snap: dict | None = None) -> list[dict]:
        """One evaluation pass; returns the alerts that FIRED this tick.
        ``snap`` lets the caller share one registry snapshot across the
        tick and its own rendering (snapshots sort every reservoir under
        the registry lock — one per scrape is enough)."""
        if not _telemetry.enabled():
            return []
        ctx = {
            "now": time.time(),
            "source": source,
            "model": model,
            "snapshot": snap if snap is not None else _telemetry.snapshot(),
            "progress": _telemetry.last_progress(),
            "rss": _telemetry.proc_rss_bytes(),
        }
        fired: list[dict] = []
        with self._lock:
            rules = list(self.rules)
            subscribers = list(self._subscribers)
        for rule in rules:
            try:
                ev = rule.check(ctx)
            except Exception:  # a broken rule must not break the loop/scrape
                continue
            with self._lock:
                was_active = rule.name in self._active
                if ev is None:
                    self._active.pop(rule.name, None)  # episode over: re-arm
                    continue
                if was_active:
                    self._active[rule.name]["evidence"] = ev
                    continue
                self._seq += 1
                alert = {
                    "seq": self._seq,
                    "ts": ctx["now"],
                    "rule": rule.name,
                    "severity": rule.severity,
                    "rank": ctx["snapshot"]["rank"],
                    "source": source,
                    "evidence": ev,
                }
                self._active[rule.name] = alert
                self._recent.append(alert)
            fired.append(alert)
        for alert in fired:
            _telemetry.counter("alerts.fired_total").inc()
            _telemetry.event(
                f"alert.{alert['rule']}",
                severity=alert["severity"],
                source=alert["source"],
                evidence=alert["evidence"],
            )
            for fn in subscribers:
                try:
                    fn(alert)
                except Exception:
                    pass
        return fired

    # - views -

    def active_alerts(self) -> list[dict]:
        with self._lock:
            return [dict(a) for a in self._active.values()]

    def recent_alerts(self) -> list[dict]:
        with self._lock:
            return [dict(a) for a in self._recent]

    def alerts_since(self, seq: int | float) -> tuple[int, list[dict]]:
        """Alerts with ``seq`` greater than the given cursor (the polling
        surface `serving.ServingLoop` uses) and the new cursor."""
        with self._lock:
            new = [dict(a) for a in self._recent if a["seq"] > seq]
            return self._seq, new

    def fired_total(self) -> int:
        """Alerts fired over this engine's lifetime (== the newest seq)."""
        with self._lock:
            return self._seq


_engine: RuleEngine | None = None
_engine_lock = threading.Lock()


def get_engine() -> RuleEngine:
    """The process-wide engine (created with `default_rules` on first use)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = RuleEngine()
        return _engine


def register_rule(rule: Rule) -> None:
    get_engine().register(rule)


def subscribe(fn: Callable[[dict], None]):
    return get_engine().subscribe(fn)


def unsubscribe(fn) -> None:
    get_engine().unsubscribe(fn)


def alerts_since(seq: int) -> tuple[int, list[dict]]:
    return get_engine().alerts_since(seq)


def heartbeat_tick(model: str | None = None) -> list[dict]:
    """The per-rank live-plane tick the instrumented loops drive at
    ``IGG_HEARTBEAT_EVERY`` cadence: publish the rolling ``slo.*`` gauges,
    then evaluate the anomaly rules — over ONE shared registry snapshot.
    Strictly local — no collectives, so ranks need not agree on it
    (unlike the skew probe it rides next to)."""
    if not _telemetry.enabled():
        return []
    snap = _telemetry.snapshot()
    publish_slo_gauges(snap)
    return get_engine().tick("heartbeat", model, snap=snap)


# -- the per-rank HTTP server -------------------------------------------------


def endpoint_filename(rank: int) -> str:
    return f"liveplane.p{rank}.json"


def _span_filter(spans: list[dict], params: dict) -> list[dict]:
    """Apply ``/spans`` query filters: ``name`` is a substring match on the
    span name; ``request`` matches a request's trace_id (single-request
    spans), a multi-request round's ``trace_ids`` entry, or the ``request``
    tag (the front-door request id)."""
    names = params.get("name")
    if names:
        spans = [s for s in spans if names[0] in s.get("name", "")]
    reqs = params.get("request")
    if reqs:
        rid = reqs[0]

        def _matches(s: dict) -> bool:
            args = s.get("args") or {}
            return (
                args.get("trace_id") == rid
                or rid in (args.get("trace_ids") or ())
                or args.get("request") == rid
            )

        spans = [s for s in spans if _matches(s)]
    return spans


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "igg-liveplane/1"
    #: per-connection socket timeout: a stalled scraper drops its
    #: connection instead of pinning a handler thread (the front door's
    #: slow-loris hardening, applied to the scrape plane too)
    timeout = 10

    def do_GET(self):  # noqa: N802 (http.server API)
        path, _, query = self.path.partition("?")
        try:
            if path == "/metrics":
                # Byte-identical to dump_metrics' .prom output for the same
                # snapshot: both render through telemetry.prometheus_text.
                body = _telemetry.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/healthz":
                # Scrape-time rule evaluation: the vantage that can see a
                # stalled step loop from outside it (StepStallRule).  ONE
                # registry snapshot serves both the tick and the document.
                snap = _telemetry.snapshot()
                get_engine().tick("scrape", snap=snap)
                body = json.dumps(
                    health_snapshot(snap), default=str
                ).encode()
                ctype = "application/json"
            elif path == "/spans":
                # ?name=<substring> narrows by span name; ?request=<id>
                # narrows to one request's spans (trace_id, a multi-request
                # round's trace_ids entry, or the request tag) — the live
                # view of a still-running rank's request slice.
                params = _urlparse.parse_qs(query)
                doc = {
                    "rank": _telemetry._proc_index(),
                    "spans": _span_filter(_tracing.span_records(), params),
                    "open": _span_filter(_tracing.open_spans(), params),
                }
                body = json.dumps(doc, default=str).encode()
                ctype = "application/json"
            else:
                self.send_error(404, "unknown endpoint")
                return
        except Exception as e:  # a scrape must never crash the server thread
            self.send_error(500, repr(e))
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrapes must not spam stderr
        pass


class MetricsServer:
    """One live-plane HTTP server: daemon thread, closeable, port-aware."""

    def __init__(self, host: str, port: int):
        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="igg-liveplane",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_server: MetricsServer | None = None
_server_lock = threading.Lock()
_published_rank: int | None = None


def _publish_endpoint(server: MetricsServer) -> None:
    """Publish the bound port: the ``liveplane.port`` gauge (rides the
    rank-0 heartbeat event from there) and — when ``IGG_TELEMETRY_DIR`` is
    set — a ``liveplane.p<rank>.json`` endpoint file, the host:port
    discovery surface a scraper reads."""
    global _published_rank
    _telemetry.gauge("liveplane.port").set(server.port)
    directory = _config.telemetry_dir_env()
    if not directory:
        return
    # Generation fence: a zombie incarnation must not overwrite the live
    # one's discovery file.  Advisory path: refuse (the fence.rejected
    # event is already on the timeline) instead of raising out of the
    # server bring-up.
    from ..supervisor import generation as _generation

    if _generation.fence_refusal("liveplane.endpoint") is not None:
        return
    rank = _telemetry._proc_index()
    _published_rank = rank
    host = server.host
    if host in ("0.0.0.0", "::"):
        host = socket.gethostname()
    doc = {
        "rank": rank,
        "pid": os.getpid(),
        "host": host,
        "port": server.port,
        "ts": time.time(),
    }
    try:
        os.makedirs(directory, exist_ok=True)
        _telemetry.atomic_write_json(
            os.path.join(directory, endpoint_filename(rank)), doc,
            fsync=False,  # advisory discovery file
        )
    except OSError:
        pass  # an unwritable dir must not take the run down


def start_server(port: int | None = None, host: str | None = None) -> MetricsServer:
    """Start (or return) THE per-process server, binding ``port`` (0 =
    ephemeral).  Raises on a bind failure — an explicitly requested
    endpoint that silently is not there is worse than a crash at startup."""
    global _server
    with _server_lock:
        if _server is not None:
            return _server
        if host is None:
            host = _config.metrics_host_env() or "127.0.0.1"
        if port is None:
            port = _config.metrics_port_env() or 0
        _server = MetricsServer(host, int(port))
    _publish_endpoint(_server)
    _telemetry.event("liveplane.start", host=_server.host, port=_server.port)
    return _server


def ensure_server() -> MetricsServer | None:
    """Idempotent opt-in bring-up: start the server iff ``IGG_METRICS_PORT``
    is set AND telemetry is enabled; never raises (an instrumented loop
    must not die because a port was taken — the failure is evented).

    An already-running server re-publishes its endpoint file when the
    process RANK has resolved since the first publication: the models'
    ``run()`` brings the server up BEFORE ``init_global_grid``, where
    every rank still reads as 0 — the next ensure (the instrumented
    loop's) rewrites ``liveplane.p<true rank>.json`` so the discovery
    surface ends up correct on multi-process launches.
    """
    if _server is not None:
        if _telemetry._proc_index() != _published_rank:
            _publish_endpoint(_server)
        return _server
    if not enabled():
        return None
    try:
        return start_server()
    except OSError as e:
        _telemetry.event("liveplane.start_failed", error=repr(e))
        return None


def stop_server() -> None:
    global _server, _published_rank
    with _server_lock:
        server, _server = _server, None
        _published_rank = None
    if server is not None:
        server.close()


def server_port() -> int | None:
    return _server.port if _server is not None else None


def reset() -> None:
    """Stop the server, drop the engine and expectations (test hook)."""
    global _engine
    stop_server()
    with _engine_lock:
        _engine = None
    _teff_expectations.clear()
