"""Admission control for the serving front door (the JAX package's
``serving/admission.py``, host code copied into the port).

The front door must say *no* cheaply, for a reason, with a useful
``Retry-After`` — long before a request can hurt the pool.  Three gates,
evaluated in order over one live VIEW of the telemetry registry:

* **SLO** — while the pool is breaching its latency SLO, new work only
  deepens the breach.  Two signals flip this gate: an active CRITICAL
  anomaly alert (the `utils.liveplane` rule engine — admission runs its
  scrape-source tick, the only vantage that sees a stalled serving loop),
  and the rolling ``serving.round_seconds`` p99 window exceeding
  ``IGG_FRONTDOOR_SLO_P99_S`` when that knob is set.
* **Backpressure** — the ``serving.queue_depth`` gauge at/above
  ``IGG_FRONTDOOR_QUEUE_MAX`` (default 4x the pool capacity): the queue is
  the elastic buffer, but an unbounded one just converts overload into
  unbounded latency.
* **Quota** — per-tenant token buckets (``IGG_TENANT_QUOTA`` =
  ``RATE[:BURST]`` requests/second): one tenant's burst must not starve
  the rest.  Buckets are cardinality-bounded (`MAX_BUCKETS`); overflow
  tenants share one bucket.

`decide` is a PURE function of ``(view, policy)`` — deterministic given a
synthetic gauge snapshot, which is how tier-1 tests pin the accept/reject
matrix without a network, and hold it to the JAX package's
(`tests/test_torch_frontdoor.py`).  `AdmissionController`
owns the impure parts: building the view from the live registry, the
clock-driven buckets, and the telemetry ledger
(``frontdoor.admitted_total``, ``frontdoor.rejected_total`` plus
per-reason ``frontdoor.rejected.<reason>`` and per-tenant counters).

Rejections are cheap 429s whose ``Retry-After`` derives from the current
round cadence (`retry_after_s`): the p50 round latency times the work the
pool must shed before the gate can open again.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from ..utils import config as _config
from ..utils import liveplane as _liveplane
from ..utils import telemetry as _telemetry
from ..utils import tracing as _tracing

#: reject reasons, in evaluation order
REASONS = ("slo", "backpressure", "quota")

#: fallback round cadence for Retry-After before any round has completed
DEFAULT_CADENCE_S = 0.25

#: bound on distinct per-tenant token buckets (overflow shares one bucket,
#: mirroring the telemetry tenant-series cap)
MAX_BUCKETS = 1024

#: how long `AdmissionController` reuses one registry view across requests
#: (a snapshot sorts every reservoir under the registry lock — one per
#: scrape is enough)
VIEW_TTL_S = 0.15


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """The admission thresholds (all optional — None disables a gate).

    ``tenant_rate``/``tenant_burst``: token-bucket arrival limit per
    tenant; ``queue_max``: queue-depth backpressure threshold;
    ``slo_p99_s``: rolling round-p99 ceiling; ``reject_on_critical_alert``:
    whether an active CRITICAL anomaly alert flips the ``slo`` gate.
    """

    tenant_rate: float | None = None
    tenant_burst: float = 1.0
    queue_max: int | None = None
    slo_p99_s: float | None = None
    reject_on_critical_alert: bool = True

    @classmethod
    def from_env(cls, *, capacity: int | None = None) -> "AdmissionPolicy":
        """The env-knob tier: ``IGG_TENANT_QUOTA``,
        ``IGG_FRONTDOOR_QUEUE_MAX`` (default 4x ``capacity``),
        ``IGG_FRONTDOOR_SLO_P99_S``."""
        quota = _config.tenant_quota_env()
        rate, burst = quota if quota else (None, 1.0)
        qmax = _config.frontdoor_queue_max_env()
        if qmax is None and capacity:
            qmax = 4 * int(capacity)
        return cls(
            tenant_rate=rate,
            tenant_burst=burst,
            queue_max=qmax,
            slo_p99_s=_config.frontdoor_slo_p99_env(),
        )


class TokenBucket:
    """Classic token bucket; the caller supplies the clock, so refill math
    is deterministic under an injected time source (tests)."""

    __slots__ = ("rate", "burst", "tokens", "_t")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t: float | None = None

    def refill(self, now: float) -> float:
        if self._t is not None and now > self._t:
            self.tokens = min(self.burst, self.tokens + (now - self._t) * self.rate)
        self._t = now
        return self.tokens

    def take(self) -> bool:
        """Consume one token if available (call `refill` first)."""
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def seconds_until_token(self) -> float:
        return max(0.0, (1.0 - self.tokens) / self.rate)


def decide(view: dict, policy: AdmissionPolicy) -> dict:
    """PURE admission verdict over a gauge view.

    ``view`` keys (all optional): ``queue_depth``, ``active_members``,
    ``capacity``, ``round_p50_s``, ``round_p99_s``, ``critical_alert``
    (bool), ``tenant_tokens`` (the tenant's refilled bucket level, or None
    when unmetered).  Returns ``{"admit": bool, "reason": None | one of
    `REASONS`}`` — same inputs, same verdict, no clocks, no globals.
    """
    if policy.reject_on_critical_alert and view.get("critical_alert"):
        return {"admit": False, "reason": "slo"}
    p99 = view.get("round_p99_s")
    if policy.slo_p99_s is not None and p99 is not None and p99 > policy.slo_p99_s:
        return {"admit": False, "reason": "slo"}
    queue_depth = int(view.get("queue_depth") or 0)
    if policy.queue_max is not None and queue_depth >= policy.queue_max:
        return {"admit": False, "reason": "backpressure"}
    tokens = view.get("tenant_tokens")
    if tokens is not None and tokens < 1.0:
        return {"admit": False, "reason": "quota"}
    return {"admit": True, "reason": None}


def retry_after_s(view: dict, policy: AdmissionPolicy, reason: str,
                  *, bucket_wait_s: float | None = None) -> float:
    """``Retry-After`` for a rejection, derived from the round cadence.

    One serving round retires at most ``capacity`` members and is the unit
    everything queues behind, so the p50 round latency is the natural time
    base: backpressure waits the rounds needed to sink the excess queue,
    an SLO breach waits a few rounds for the window to move, quota waits
    for the token refill (floored at one round).  Always >= the cadence
    and > 0 — a 429 that says "retry immediately" is a retry storm.
    """
    cadence = view.get("round_p50_s") or DEFAULT_CADENCE_S
    if reason == "quota" and bucket_wait_s is not None:
        return max(cadence, bucket_wait_s)
    if reason == "backpressure":
        queue_depth = int(view.get("queue_depth") or 0)
        over = max(1, queue_depth - (policy.queue_max or queue_depth) + 1)
        capacity = max(1, int(view.get("capacity") or 1))
        return cadence * max(1.0, over / capacity)
    # slo: give the rolling window a few rounds to recover
    return max(1.0, 4.0 * cadence)


@dataclasses.dataclass
class Decision:
    """One admission outcome: verdict, reason, Retry-After and the view it
    was decided on (returned so the HTTP layer can echo the evidence)."""

    admit: bool
    reason: str | None
    retry_after_s: float
    view: dict


def _critical_alert() -> bool:
    """Whether the rule engine holds an active CRITICAL alert."""
    return any(a.get("severity") == "critical"
               for a in _liveplane.get_engine().active_alerts())


def gauge_view(*, snap: dict | None = None, tick: bool = True) -> dict:
    """The live admission/autoscale VIEW from the telemetry registry.

    One registry snapshot feeds everything: the serving occupancy gauges,
    the rolling ``serving.round_seconds`` window (falling back to the
    published ``slo.*`` gauges), and — when ``tick`` — a scrape-source
    rule-engine evaluation over the SAME snapshot, so a stalled serving
    loop flips ``critical_alert`` at admission time without waiting for a
    heartbeat the stalled loop can never reach.
    """
    if snap is None:
        snap = _telemetry.snapshot()
    if tick and _telemetry.enabled():
        _liveplane.get_engine().tick("scrape", snap=snap)
    gauges = snap.get("gauges", {})
    win = snap.get("histograms", {}).get("serving.round_seconds", {}).get(
        "window"
    ) or {}
    return {
        # queue depth = the pool's queue PLUS the door's not-yet-synced
        # pending specs: the serving gauge only moves at control syncs, so
        # during a long/stalled round the pending deque is where overload
        # actually accumulates — the backpressure gate must see it
        "queue_depth": (
            gauges.get("serving.queue_depth", 0)
            + gauges.get("frontdoor.pending", 0)
        ),
        "active_members": gauges.get("serving.active_members", 0),
        "capacity": gauges.get("serving.capacity"),
        "round_p50_s": win.get("p50", gauges.get("slo.serving.round_seconds.p50")),
        "round_p99_s": win.get("p99", gauges.get("slo.serving.round_seconds.p99")),
        "critical_alert": _critical_alert(),
    }


class AdmissionController:
    """The impure shell around `decide`: live views, clocked token buckets,
    and the telemetry ledger.  Thread-safe — `check` runs on the front
    door's HTTP handler threads."""

    def __init__(self, policy: AdmissionPolicy | None = None, *,
                 capacity: int | None = None, clock=time.monotonic):
        self.policy = (
            policy if policy is not None
            else AdmissionPolicy.from_env(capacity=capacity)
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}
        self._overflow: TokenBucket | None = None
        self._view: dict | None = None      # TTL-cached registry view
        self._view_at: float | None = None

    def _live_view(self, now: float) -> dict:
        """The registry view, TTL-cached (`VIEW_TTL_S`): under a 429 storm
        the "cheap" rejection path must not sort every histogram reservoir
        per request.  The snapshot-derived numbers age up to one TTL; the
        CRITICAL-alert bit is re-read from the engine on EVERY call, so an
        alert another tick raised is seen immediately and a breach the
        cached view predates is seen within one TTL of the next tick."""
        with self._lock:
            cached = (
                dict(self._view)
                if self._view is not None and self._view_at is not None
                and 0 <= now - self._view_at < VIEW_TTL_S
                else None
            )
        if cached is None:
            cached = gauge_view()  # one snapshot + scrape-source rule tick
            with self._lock:
                self._view, self._view_at = dict(cached), now
        cached["critical_alert"] = _critical_alert()
        return cached

    def _bucket(self, tenant: str) -> TokenBucket | None:
        rate = self.policy.tenant_rate
        if rate is None:
            return None
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                if len(self._buckets) >= MAX_BUCKETS:
                    if self._overflow is None:
                        self._overflow = TokenBucket(rate, self.policy.tenant_burst)
                    return self._overflow
                b = self._buckets[tenant] = TokenBucket(
                    rate, self.policy.tenant_burst
                )
            return b

    def check(self, tenant: str, *, now: float | None = None,
              view: dict | None = None) -> Decision:
        """Decide one request NOW: build the live view (or take the
        caller's), refill the tenant's bucket, run `decide`, consume a
        token only on admission, and account the outcome.  The decision
        runs under an ``igg.serving.admission`` span — inside a request
        context (the front door's submit path) it chains into the
        request's causal tree and `utils.tracing.critical_path` charges
        its time to the ``admission`` segment."""
        with _tracing.trace_span("igg.serving.admission", tenant=tenant):
            if now is None:
                now = self._clock()
            bucket = self._bucket(tenant)
            if view is None:
                view = self._live_view(now)
            wait = None
            if bucket is not None:
                # refill → decide → take under ONE lock acquisition: two
                # concurrent submits must not both observe the same token
                # and both admit (check-then-act) — `decide` is pure and
                # cheap, so holding the lock across it is fine
                with self._lock:
                    view = dict(view, tenant_tokens=bucket.refill(now))
                    verdict = decide(view, self.policy)
                    if verdict["admit"]:
                        bucket.take()
                    elif verdict["reason"] == "quota":
                        wait = bucket.seconds_until_token()
            else:
                verdict = decide(view, self.policy)
            retry = 0.0 if verdict["admit"] else retry_after_s(
                view, self.policy, verdict["reason"], bucket_wait_s=wait
            )
            self._account(tenant, verdict)
            return Decision(
                admit=verdict["admit"], reason=verdict["reason"],
                retry_after_s=retry, view=view,
            )

    def _account(self, tenant: str, verdict: dict) -> None:
        if verdict["admit"]:
            _telemetry.counter("frontdoor.admitted_total").inc()
            _telemetry.frontdoor_tenant_counter(tenant, "admitted").inc()
            _telemetry.gauge("frontdoor.backpressure").set(0)
        else:
            reason = verdict["reason"]
            _telemetry.counter("frontdoor.rejected_total").inc()
            _telemetry.counter(f"frontdoor.rejected.{reason}").inc()
            _telemetry.frontdoor_tenant_counter(tenant, "rejected").inc()
            _telemetry.gauge("frontdoor.backpressure").set(
                1 if reason in ("backpressure", "slo") else 0
            )
