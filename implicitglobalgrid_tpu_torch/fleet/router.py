"""Fleet routing front door: ONE public HTTP endpoint over N pools.

The port's copy of the JAX package's ``fleet/router.py``.  Each pool is a
whole serving stack (ServingLoop + FrontDoor) behind its own rank-0 port;
this module is the tier above: ``POST /v1/submit`` lands here, a pool is
chosen on the
request's routing key (model, size, tenant) and the pools' scraped
``/healthz`` state — occupancy, windowed round p99, active alerts,
reachability — and the request is forwarded to the winner's own front
door.  ``GET /v1/result/<fleet id>`` is STICKY: the router remembers
which pool owns each request and proxies the fetch there; after a
re-route (`evacuate`) the route points at the adoptive pool and the same
fleet id keeps answering.

Replay safety is inherited, not added: requests carry *parameters*, never
arrays (`serving.frontdoor`), so re-submitting a dead pool's unfinished
specs to another pool rebuilds bit-identical members, whose digests equal
an undisturbed run's.

Zombie-result guard: every route carries an ``epoch`` that increments
when the route is evacuated.  A result can only be adopted into the
router's done-cache by the pool that CURRENTLY owns the route at the
epoch the adoption quotes (`adopt_result`) — a chaos-killed pool's
process that outlives its SIGKILL and answers one last fetch is refused
with a ``fleet.zombie_result`` event, the router-tier twin of the
generation fence (`supervisor.generation`).

Host-side only, the `supervisor/` discipline: stdlib HTTP + JSON, never a
device — the router must keep routing while a pool's fabric is wedged.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
import urllib.error
import urllib.request

from ..utils import config as _config
from ..utils import telemetry as _telemetry
from ..utils import tracing as _tracing

__all__ = [
    "FleetRouter",
    "UNREACHABLE",
    "choose_pool",
    "pool_health_view",
    "scrape_health",
]

#: explicit row/pool state for an endpoint that stayed dark through the
#: whole retry budget
UNREACHABLE = "UNREACHABLE"

DEFAULT_SCRAPE_RETRIES = 2
SCRAPE_TIMEOUT_S = 3.0
#: how long one scraped health document keeps feeding routing decisions
HEALTH_TTL_S = 0.25
#: body bound of the router's own POST surface (the per-pool front door
#: re-validates with its full hardening; this only caps the proxy buffer)
MAX_BODY = 1 << 20


def scrape_health(endpoint: str, *, retries: int | None = None,
                  backoff_s: float = 0.05,
                  timeout: float = SCRAPE_TIMEOUT_S) -> dict | None:
    """One pool's ``/healthz`` document, or None after the retry budget.

    ``retries`` (default ``IGG_FLEET_SCRAPE_RETRIES``, else 2) extra
    attempts ride an exponential backoff — one transiently-dropped scrape
    must not mark a healthy pool down.
    """
    if retries is None:
        env = _config.fleet_scrape_retries_env()
        retries = DEFAULT_SCRAPE_RETRIES if env is None else env
    for attempt in range(retries + 1):
        try:
            with urllib.request.urlopen(
                f"http://{endpoint}/healthz", timeout=timeout
            ) as r:
                return json.loads(r.read().decode())
        except (OSError, ValueError):
            if attempt < retries:
                time.sleep(backoff_s * (2 ** attempt))
    return None


def pool_health_view(health: dict | None) -> dict:
    """The routing-relevant slice of one ``/healthz`` document.

    ``state`` is ``"ok"`` | ``"alerting"`` | ``UNREACHABLE``; the latency
    figure is the rolling-window round p99 (`utils.liveplane.slo_view`),
    matching what admission control and the canary gate read.
    """
    if health is None:
        return {"state": UNREACHABLE, "queue_depth": None,
                "active_members": None, "capacity": None,
                "round_p99_s": None, "alerts": ()}
    serving = health.get("serving") or {}
    slo = health.get("slo") or {}
    rnd = next(
        (s for n, s in sorted(slo.items()) if n.endswith("round_seconds")),
        {},
    )
    active = tuple(
        a.get("rule") for a in health.get("alerts", {}).get("active", [])
    )
    return {
        "state": "ok" if health.get("ok") else "alerting",
        "queue_depth": serving.get("queue_depth"),
        "active_members": serving.get("active_members"),
        "capacity": serving.get("capacity"),
        "round_p99_s": rnd.get("p99"),
        "alerts": active,
    }


def choose_pool(doc: dict, candidates: list[dict]) -> str | None:
    """PURE routing decision: the pool name for one submit document.

    ``candidates`` — ``[{name, key, quarantined, health}, ...]`` where
    ``key`` is the pool's (model, size) contract (None entries =
    wildcard) and ``health`` a `pool_health_view`.  Eligibility: key
    matches the request's (model, size), not quarantined, reachable.
    Among the eligible, deterministic least-loaded order — queue depth,
    then occupancy, then windowed round p99, then name — so every caller
    with the same view picks the same pool (rank identity and RNG never
    enter: the `fleet.policy.fleet_plan` census contract).
    """
    model, size = doc.get("model"), doc.get("size")

    def eligible(c):
        if c.get("quarantined"):
            return False
        if c["health"]["state"] == UNREACHABLE:
            return False
        key = c.get("key") or {}
        if model is not None and key.get("model") not in (None, model):
            return False
        if size is not None and key.get("size") is not None \
                and list(key["size"]) != list(size):
            return False
        return True

    pool = sorted(
        (c for c in candidates if eligible(c)),
        key=lambda c: (
            c["health"]["queue_depth"] or 0,
            c["health"]["active_members"] or 0,
            c["health"]["round_p99_s"] or 0.0,
            c["name"],
        ),
    )
    return pool[0]["name"] if pool else None


def _http_transport(endpoint: str, method: str, path: str,
                    doc: dict | None) -> tuple[int, dict]:
    """Default pool transport: ``(status, body)``; (0, {}) when the pool
    is unreachable."""
    url = f"http://{endpoint}{path}"
    try:
        if method == "GET":
            req = urllib.request.Request(url)
        else:
            req = urllib.request.Request(
                url, data=json.dumps(doc or {}).encode(),
                headers={"Content-Type": "application/json"},
            )
        with urllib.request.urlopen(req, timeout=SCRAPE_TIMEOUT_S) as r:
            return r.status, json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode() or "{}")
        except (ValueError, OSError):
            return e.code, {}
    except (OSError, ValueError):
        return 0, {}


def _make_handler(router: "FleetRouter"):
    class _Handler(http.server.BaseHTTPRequestHandler):
        server_version = "igg-fleet/1"
        timeout = 10

        def _reply(self, code: int, body: dict,
                   headers: dict | None = None):
            data = json.dumps(body, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (http.server API)
            path = self.path.split("?", 1)[0]
            try:
                if path.startswith("/v1/result/"):
                    fid = path[len("/v1/result/"):]
                    code, body = router.result(fid)
                    self._reply(code, body, headers=router.trace_header(fid))
                elif path == "/v1/status":
                    self._reply(200, router.status_view())
                elif path == "/healthz":
                    self._reply(200, router.health_view())
                else:
                    self.send_error(404, "unknown endpoint")
            except Exception as e:  # a fetch must never kill the router
                self.send_error(500, repr(e))

        def do_POST(self):  # noqa: N802
            path = self.path.split("?", 1)[0]
            try:
                raw_len = self.headers.get("Content-Length")
                try:
                    length = int(raw_len) if raw_len is not None else 0
                except ValueError:
                    self._reply(400, {"error": f"bad Content-Length {raw_len!r}"})
                    return
                if not 0 <= length <= MAX_BODY:
                    self._reply(413, {"error": "request body too large",
                                      "bytes": length, "max_bytes": MAX_BODY})
                    return
                body = self.rfile.read(length)
                if path == "/v1/submit":
                    try:
                        doc = json.loads(body.decode() or "{}")
                        if not isinstance(doc, dict):
                            raise ValueError("body must be a JSON object")
                    except (ValueError, UnicodeDecodeError) as e:
                        self._reply(400, {"error": f"bad JSON body: {e}"})
                        return
                    tp = self.headers.get("traceparent")
                    code, out = router.submit(doc, traceparent=tp)
                    hdrs = router.trace_header(out.get("request_id"))
                    if hdrs is None and tp:
                        # untraced (sampled-out / error) replies still echo
                        # the caller's context verbatim — pure passthrough
                        hdrs = {"traceparent": tp}
                    self._reply(code, out, headers=hdrs)
                else:
                    self.send_error(404, "unknown endpoint")
            except Exception as e:
                self.send_error(500, repr(e))

        def log_message(self, *args):  # requests must not spam stderr
            pass

    return _Handler


class FleetRouter:
    """The fleet's single public entry (module docstring).

    ``transport(endpoint, method, path, doc) -> (status, body)`` — the
    pool RPC hook (default: stdlib HTTP; tests inject fakes and never
    open a socket).  ``scrape(endpoint) -> health | None`` — the health
    hook (default `scrape_health` with the retry budget).  ``port`` /
    ``host`` override ``IGG_FLEET_PORT`` / loopback; ``serve=False``
    keeps the router a pure in-process object (the unit-test mode).
    """

    def __init__(self, *, port: int | None = None, host: str | None = None,
                 transport=None, scrape=None, serve: bool = True):
        self.transport = transport or _http_transport
        self.scrape = scrape or scrape_health
        self._lock = threading.RLock()
        #: name -> {endpoint, key, quarantined, canary, health, health_ts}
        self.pools: dict[str, dict] = {}
        #: fleet id -> {pool, rid, spec, epoch, done}
        self.routes: dict[str, dict] = {}
        self._next_id = 0
        self._httpd = None
        self._thread = None
        self.port: int | None = None
        if serve:
            self._start_server(port, host)

    # - server lifecycle -

    def _start_server(self, port: int | None, host: str | None) -> None:
        if host is None:
            host = "127.0.0.1"
        if port is None:
            port = _config.fleet_port_env() or 0
        self._httpd = http.server.ThreadingHTTPServer(
            (host, int(port)), _make_handler(self)
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="igg-fleet-router",
            daemon=True,
        )
        self._thread.start()
        _telemetry.gauge("fleet.port").set(self.port)
        _telemetry.event("fleet.router_start", host=host, port=self.port)

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None

    # - pool membership (driven by the FleetController) -

    def register_pool(self, name: str, endpoint: str, *,
                      key: dict | None = None, canary: bool = False) -> None:
        with self._lock:
            prev = self.pools.get(name, {})
            self.pools[name] = {
                "name": name, "endpoint": endpoint, "key": dict(key or {}),
                "quarantined": False, "canary": canary,
                "health": None, "health_ts": 0.0,
            }
            if prev:
                # a respawned pool returns clean: stale health forgotten
                _telemetry.event("fleet.pool_replaced", pool=name,
                                 endpoint=endpoint)

    def quarantine_pool(self, name: str) -> None:
        with self._lock:
            if name in self.pools:
                self.pools[name]["quarantined"] = True

    def unregister_pool(self, name: str) -> None:
        with self._lock:
            self.pools.pop(name, None)

    # - health -

    def _refresh_health(self, pool: dict) -> None:
        now = time.monotonic()
        if now - pool["health_ts"] < HEALTH_TTL_S:
            return
        pool["health"] = pool_health_view(self.scrape(pool["endpoint"]))
        pool["health_ts"] = now

    def _candidates(self) -> list[dict]:
        with self._lock:
            pools = list(self.pools.values())
        for p in pools:
            self._refresh_health(p)
        return pools

    # - the routed surface -

    def submit(self, doc: dict,
               *, traceparent: str | None = None) -> tuple[int, dict]:
        """Route one submit: choose a pool, forward, record the sticky
        route.  A pool that drops the forward (transport (0, _)) is
        marked unreachable for this pass and the next-best pool tried —
        a wedged pool costs one timeout, never a failed request.

        Trace context: an inbound ``doc["trace"]`` (a replayed spec) or a
        W3C ``traceparent`` header is adopted; otherwise one is minted
        here, head-sampled (`tracing.should_sample`).  The routing hop
        records an ``igg.fleet.route`` span and the doc forwarded to the
        pool carries that span's context as ``doc["trace"]`` — the pool's
        front door chains under it, and a later `evacuate` re-submits the
        same spec, so re-routes inherit the request's identity for free."""
        inbound = doc.get("trace") if isinstance(doc.get("trace"), dict) \
            else None
        if inbound is None:
            inbound = _tracing.parse_traceparent(traceparent)
        ctx = None
        t0 = 0.0
        if _tracing.enabled() and (
            inbound is not None or _tracing.should_sample()
        ):
            tid = inbound["trace_id"] if inbound else _tracing.new_trace_id()
            ctx = {"trace_id": tid, "span_id": _tracing.new_span_id()}
            if inbound and inbound.get("span_id"):
                ctx["parent_id"] = inbound["span_id"]
            doc = dict(doc)
            doc["trace"] = {"trace_id": tid, "span_id": ctx["span_id"]}
            t0 = time.perf_counter()
        tried: set[str] = set()
        while True:
            cands = [
                dict(c, health=c["health"] or pool_health_view(None))
                for c in self._candidates() if c["name"] not in tried
            ]
            name = choose_pool(doc, cands)
            if name is None:
                _telemetry.counter("fleet.unroutable_total").inc()
                return 503, {"error": "no reachable pool for this request",
                             "tried": sorted(tried)}
            pool = self.pools[name]
            code, body = self.transport(
                pool["endpoint"], "POST", "/v1/submit", doc
            )
            if code == 0:
                tried.add(name)
                pool["health"] = pool_health_view(None)
                pool["health_ts"] = time.monotonic()
                _telemetry.event("fleet.pool_unreachable", pool=name)
                continue
            if code != 202:
                return code, body  # the pool's own 400/429 passes through
            with self._lock:
                fid = f"f{self._next_id:06d}"
                self._next_id += 1
                self.routes[fid] = {
                    "pool": name, "rid": body["request_id"],
                    "spec": dict(doc), "epoch": 0, "done": None,
                    "trace": ctx,
                }
            _telemetry.counter("fleet.routed_total").inc()
            trace_tags = {"trace_id": ctx["trace_id"]} if ctx else {}
            _telemetry.event("fleet.route", request=fid, pool=name,
                             rid=body["request_id"],
                             tenant=doc.get("tenant", "default"),
                             **trace_tags)
            if ctx is not None:
                _tracing.record_span(
                    "igg.fleet.route",
                    t0=t0, dur=time.perf_counter() - t0,
                    parent={"trace_id": ctx["trace_id"],
                            "span_id": ctx.get("parent_id")},
                    span_id=ctx["span_id"],
                    request=fid, pool=name,
                    tenant=doc.get("tenant", "default"),
                )
            return 202, {"request_id": fid, "pool": name}

    def trace_header(self, fid: str | None) -> dict | None:
        """The ``traceparent`` echo header for a routed request (None when
        the route is unknown or untraced) — every response that names a
        fleet id carries the request's context back to the caller."""
        if not fid:
            return None
        with self._lock:
            route = self.routes.get(fid)
            ctx = route.get("trace") if route else None
        if not ctx:
            return None
        return {"traceparent": _tracing.format_traceparent(ctx)}

    def adopt_result(self, fid: str, pool: str, epoch: int,
                     body: dict) -> bool:
        """Cache one done result IF ``(pool, epoch)`` still own the route.

        The zombie guard (module docstring): a superseded owner — the
        route was evacuated, or the answer arrived from a pool the route
        no longer names — is refused, its result dropped, and a
        ``fleet.zombie_result`` event marks the attempt.
        """
        with self._lock:
            route = self.routes.get(fid)
            if route is None:
                return False
            if route["pool"] != pool or route["epoch"] != epoch:
                _telemetry.counter("fleet.zombie_results_total").inc()
                _telemetry.event(
                    "fleet.zombie_result", request=fid, pool=pool,
                    epoch=epoch, owner=route["pool"],
                    owner_epoch=route["epoch"],
                )
                return False
            route["done"] = dict(body)
            return True

    def result(self, fid: str) -> tuple[int, dict]:
        """Sticky fetch: proxy to the owning pool, caching done results
        through the epoch-checked `adopt_result` path."""
        with self._lock:
            route = self.routes.get(fid)
            if route is None:
                return 404, {"error": f"unknown request {fid!r}"}
            if route["done"] is not None:
                return 200, {**route["done"], "request_id": fid,
                             "pool": route["pool"]}
            pool, rid, epoch = route["pool"], route["rid"], route["epoch"]
        endpoint = None
        with self._lock:
            if pool in self.pools:
                endpoint = self.pools[pool]["endpoint"]
        if endpoint is None:
            return 200, {"request_id": fid, "status": "pending",
                         "detail": "owning pool is being replaced"}
        code, body = self.transport(endpoint, "GET", f"/v1/result/{rid}", None)
        if code == 0:
            # the owner is dark: the controller's evacuation will re-route;
            # to the client this is still just in flight
            return 200, {"request_id": fid, "status": "pending",
                         "detail": f"pool {pool} unreachable"}
        if code == 200 and body.get("status") == "done":
            self.adopt_result(fid, pool, epoch, body)
            return 200, {**body, "request_id": fid, "pool": pool}
        if code == 404:
            # the pool lost the rid (a respawn without replay yet): pending
            return 200, {"request_id": fid, "status": "pending",
                         "detail": f"pool {pool} has no ledger entry yet"}
        body = dict(body)
        body["request_id"] = fid
        return code, body

    # - evacuation (the replay half of a respawn/quarantine) -

    def evacuate(self, name: str, *, exclude: set | None = None) -> list[str]:
        """Re-route every unfinished request owned by ``name``: bump each
        route's epoch (disowning late answers from the old incarnation),
        re-submit the spec to the best surviving pool, and point the
        route there.  Returns the re-routed fleet ids; emits ONE
        ``fleet.reroute`` event naming them (the drill's ordered middle
        marker between ``fleet.detect`` and ``fleet.recovered``).
        ``exclude`` — pools never chosen as the target (default: the
        evacuated pool itself; pass ``set()`` after a respawn to re-home
        leftover routes onto the fresh incarnation)."""
        base_exclude = {name} if exclude is None else set(exclude)
        with self._lock:
            victims = [
                (fid, route) for fid, route in self.routes.items()
                if route["pool"] == name and route["done"] is None
            ]
            for _fid, route in victims:
                route["epoch"] += 1  # late answers are zombies from here on
        # The re-route hop is part of every evacuated request's causal
        # tree: one span tagged with ALL victims' trace ids (the
        # multi-request form, like a serving round).
        trace_ids = sorted({
            route["trace"]["trace_id"] for _fid, route in victims
            if route.get("trace")
        })
        span_tags = {"trace_ids": trace_ids} if trace_ids else {}
        moved: list[str] = []
        with _tracing.trace_span("igg.fleet.reroute", pool=name,
                                 victims=len(victims), **span_tags):
            for fid, route in victims:
                tried = set(base_exclude)
                while True:
                    cands = [
                        dict(c, health=c["health"] or pool_health_view(None))
                        for c in self._candidates() if c["name"] not in tried
                    ]
                    target = choose_pool(route["spec"], cands)
                    if target is None:
                        break  # unroutable now; the next evacuate retries
                    code, body = self.transport(
                        self.pools[target]["endpoint"], "POST", "/v1/submit",
                        route["spec"],
                    )
                    if code != 202:
                        tried.add(target)
                        continue
                    with self._lock:
                        route["pool"] = target
                        route["rid"] = body["request_id"]
                    moved.append(fid)
                    break
        _telemetry.counter("fleet.rerouted_total").inc(len(moved))
        _telemetry.event("fleet.reroute", pool=name, requests=moved,
                         count=len(moved))
        return moved

    # - views -

    def status_view(self) -> dict:
        with self._lock:
            done = sum(1 for r in self.routes.values() if r["done"])
            return {
                "pools": {
                    n: {"endpoint": p["endpoint"], "key": p["key"],
                        "quarantined": p["quarantined"],
                        "canary": p["canary"],
                        "health": p["health"]}
                    for n, p in self.pools.items()
                },
                "requests": {"total": len(self.routes), "done": done},
            }

    def health_view(self) -> dict:
        cands = self._candidates()
        reachable = sum(
            1 for c in cands
            if (c["health"] or {}).get("state") not in (None, UNREACHABLE)
        )
        return {
            "ok": reachable > 0,
            "pools": {c["name"]: c["health"] for c in cands},
            "reachable": reachable,
        }
