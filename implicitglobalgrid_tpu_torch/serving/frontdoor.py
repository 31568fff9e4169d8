"""The network-facing serving plane: HTTP in front of one `ServingLoop`.

Counterpart of the JAX package's ``serving/frontdoor.py``.

**HTTP surface** (stdlib ``http.server`` daemon thread; ``IGG_SERVE_PORT``,
0 = ephemeral, bind address ``IGG_SERVE_HOST``; rank 0 only — the front
door is the cluster's single network entry):

- ``POST /v1/submit`` — ``{"tenant", "model", "size", "params":
  {"ic_scale", "max_steps", "tol"}}`` → 202 ``{"request_id"}``.  Requests
  carry *parameters*, never arrays: every rank rebuilds the member's
  initial state locally from the spec (the model ``setup`` is a pure
  function of the implicit global grid), which is what lets one rank's
  network traffic drive an SPMD pool.  Invalid → 400; admission-rejected
  → a cheap 429 with a ``Retry-After`` derived from the current round
  cadence (`admission.retry_after_s`) and a machine-readable ``reason``
  (``quota`` | ``backpressure`` | ``slo``); an oversize body → 413.
- ``GET /v1/result/<id>`` — ``pending`` | ``accepted`` | ``done`` (final
  status, step count, residual, and a per-field sha256 digest of the
  de-duplicated global state — computed collectively at retirement, so a
  client can verify bit-identity without shipping fields over HTTP);
  410 once pruned under the retention knobs, 404 for an unknown id.
- ``GET /v1/status`` — occupancy, admission/autoscaler state, request
  ledger counts.  ``GET /metrics`` (Prometheus text of the registry) and
  ``GET /healthz`` (`utils.liveplane.health_snapshot` after a scrape-source
  rule tick: ``ok`` is False while a CRITICAL alert is active, and the
  ``alerts`` section lists them).
- ``POST /v1/shutdown`` — broadcast a clean stop.

**Control plane.**  `ServingLoop` state is SPMD: every rank must submit
the same members in the same order, yet only rank 0 hears the network.
`serve_rounds` therefore runs one control sync per iteration,
`broadcast_control`: rank 0 drains its pending specs (plus drain/resize/
shutdown directives) into one JSON message and broadcasts it over
`torch.distributed` (a length, then the bytes), and every rank applies it
identically.

**Elastic autoscaling.**  The `autoscale.Autoscaler` verdict (rank 0, over
the same gauge view admission uses) becomes a ``resize`` directive: every
rank checkpoints the batched pool (slot metadata and the request ledger
ride ``extra``), rank 0 atomically publishes ``resize.json``, and
`serve_rounds` returns ``"resize"`` so the process can exit with
`RESIZE_STATUS` for its supervisor to relaunch at the target topology.
On relaunch `elastic_resume` validates the topology change
(`parallel.grid.elastic_topology_error`), reshards the pool through the
checkpoint's elastic path (leading ensemble axis included), re-`adopt`\\ s
every live member with its step count and budget intact, and rebuilds
still-queued members from their specs.  Scale-downs drain first.

Request tracing: `handle_submit` adopts an inbound ``traceparent`` (or a
router-forwarded ``doc["trace"]``) or mints a head-sampled context
(``IGG_TRACE_SAMPLE``); the member-level child context rides the control
broadcast into every rank's rounds, the queue wait and the submit→result
span are recorded retroactively, and each retiring member's digest is an
``igg.frontdoor.digest`` span under its request — so
`utils.tracing.request_tree` rebuilds one request's tree from the door to
the halo exchange.  The door's autoscaler subscribes to the live plane's
rule engine.
"""

from __future__ import annotations

import collections
import hashlib
import http.server
import json
import os
import socket
import threading
import time

import numpy as np
import torch

from ..utils import config as _config
from ..utils import liveplane as _liveplane
from ..utils import telemetry as _telemetry
from ..utils import tracing as _tracing
from . import admission as _admission
from .loop import Request, ServingLoop

__all__ = [
    "FrontDoor",
    "RESIZE_STATUS",
    "RESIZE_PLAN",
    "broadcast_control",
    "endpoint_filename",
    "state_digest",
]

#: exit status a serving process uses after writing a resize plan — the
#: supervisor's signal to relaunch at the plan's topology (distinct from
#: the fault injector's CRASH_STATUS 17)
RESIZE_STATUS = 19

#: the resize plan file rank 0 publishes into the checkpoint directory
RESIZE_PLAN = "resize.json"

#: request-body bound in bytes (``IGG_SERVE_MAX_BODY`` overrides): a POST
#: past it is refused with a structured 413 before the handler buffers it
MAX_BODY_DEFAULT = 1 << 20

#: per-connection socket timeout in seconds — a slow-loris client times
#: out and drops instead of pinning a rank-0 handler thread forever
SOCKET_TIMEOUT_S = 10

#: padding quantum of the control broadcast's byte buffer
_BCAST_PAD = 1024


def endpoint_filename(rank: int) -> str:
    return f"frontdoor.p{rank}.json"


def _member_ctx(rec_trace: dict | None) -> dict | None:
    """The member-level trace context from a ledgered request's trace
    record (the shape checkpoints persist) — what a rebuilt `Request`
    carries so a restored member keeps its trace."""
    if rec_trace and rec_trace.get("member_span_id"):
        return {"trace_id": rec_trace["trace_id"], "span_id": rec_trace["member_span_id"]}
    return None


def state_digest(state) -> dict | None:
    """Per-field sha256 of the de-duplicated GLOBAL state.

    COLLECTIVE (rides `ops.gather.gather(dedup=True)`): every rank must
    call it together; returns the digest dict on rank 0 and None
    elsewhere.  The hashed bytes are a header ``str((shape, numpy dtype
    name))`` and the array's C-order bytes, as in the JAX package, so two
    packages' digests of the same global arrays are equal, and two runs'
    digests are equal iff their global fields are bit-identical.
    """
    from ..ops import gather as _gather

    hashes = []
    on_root = True
    for A in state:
        dd = _gather.gather(A, dedup=True, root=0)
        if dd is None:
            on_root = False
            continue
        h = hashlib.sha256()
        h.update(str((tuple(dd.shape), str(dd.dtype))).encode())
        h.update(np.ascontiguousarray(dd).tobytes())
        hashes.append(h.hexdigest())
    if not on_root:
        return None
    return {"algo": "sha256", "fields": hashes}


# -- control-plane broadcast --------------------------------------------------


def broadcast_control(doc: dict | None) -> dict:
    """Share rank 0's control message with every rank (rank 0 passes the
    message, everyone else None).  COLLECTIVE at a deterministic cadence:
    `FrontDoor.serve_rounds` calls it exactly once per iteration on every
    rank.  Single-process grids return the message directly.  Over
    `torch.distributed`: one broadcast of the length (0 ends the exchange:
    nothing to apply), then one of the bytes padded to `_BCAST_PAD`; under
    NCCL both tensors live on the grid's device.  An armed ``net_delay``
    (`utils.tracing.arm_collective_delay`) sleeps first."""
    if _telemetry.process_count() == 1:
        return doc or {}
    _tracing._consume_collective_delay()
    import torch.distributed as dist

    from ..parallel import distributed as _dist
    from ..parallel import grid as _grid

    device = torch.device("cpu")
    if dist.get_backend() == "nccl":
        device = _grid.global_grid().device
    is_root = _dist.process_index() == 0
    data = json.dumps(doc, default=str).encode() if (is_root and doc) else b""
    length = torch.tensor([len(data)], dtype=torch.int64, device=device)
    dist.broadcast(length, src=0)
    n = int(length.item())
    if n == 0:
        return {}
    buf = torch.zeros(-(-n // _BCAST_PAD) * _BCAST_PAD, dtype=torch.uint8)
    if is_root:
        buf[:n] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    buf = buf.to(device)
    dist.broadcast(buf, src=0)
    return json.loads(buf[:n].cpu().numpy().tobytes().decode())


# -- the HTTP layer -----------------------------------------------------------


def _make_handler(fd: "FrontDoor"):
    class _Handler(http.server.BaseHTTPRequestHandler):
        server_version = "igg-frontdoor/1"
        timeout = SOCKET_TIMEOUT_S

        def _reply(self, code: int, body: dict, headers: dict | None = None,
                   raw: bytes | None = None, ctype: str = "application/json"):
            data = raw if raw is not None else json.dumps(
                body, default=str
            ).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 (http.server API)
            path = self.path.split("?", 1)[0]
            try:
                if path.startswith("/v1/result/"):
                    rid = path[len("/v1/result/"):]
                    doc = fd.result_view(rid)
                    hdrs = fd.trace_header(rid)
                    if doc is None:
                        self._reply(404, {"error": f"unknown request {rid!r}"})
                    elif doc.get("status") == "expired":
                        # pruned by IGG_RESULT_KEEP / IGG_RESULT_TTL_S:
                        # Gone, with the knobs named so the client knows
                        # which retention bound to raise
                        _telemetry.counter("frontdoor.results_expired").inc()
                        self._reply(410, {
                            "error": f"result {rid!r} expired",
                            "status": "expired",
                            "detail": "pruned under IGG_RESULT_KEEP/"
                                      "IGG_RESULT_TTL_S retention",
                        })
                    else:
                        self._reply(200, doc, headers=hdrs)
                elif path == "/v1/status":
                    self._reply(200, fd.status_view())
                elif path == "/metrics":
                    self._reply(
                        200, {}, raw=_telemetry.prometheus_text().encode(),
                        ctype="text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/healthz":
                    snap = _telemetry.snapshot()
                    _liveplane.get_engine().tick("scrape", snap=snap)
                    self._reply(200, _liveplane.health_snapshot(snap))
                else:
                    self.send_error(404, "unknown endpoint")
            except Exception as e:  # a scrape must never kill the server
                self.send_error(500, repr(e))

        def do_POST(self):  # noqa: N802
            path = self.path.split("?", 1)[0]
            try:
                # Request hardening: a malformed length
                # header or an oversize body is a cheap structured refusal,
                # never a 500 and never an unbounded buffer.
                raw_len = self.headers.get("Content-Length")
                try:
                    length = int(raw_len) if raw_len is not None else 0
                except ValueError:
                    self._reply(400, {
                        "error": f"malformed Content-Length {raw_len!r}",
                    })
                    return
                if length < 0:
                    self._reply(400, {
                        "error": f"negative Content-Length {length}",
                    })
                    return
                max_body = _config.serve_max_body_env() or MAX_BODY_DEFAULT
                if length > max_body:
                    _telemetry.counter("frontdoor.oversize_total").inc()
                    self._reply(413, {
                        "error": "request body too large",
                        "bytes": length,
                        "max_bytes": max_body,
                    })
                    return
                # Chunked read under a TOTAL wall-clock budget: the socket
                # timeout alone only bounds per-recv idle time — a client
                # trickling one byte per 9 s would reset it forever.  The
                # budget bounds the whole body, so a slow-loris gets a
                # structured 408 (best effort — it may be gone) and its
                # connection dropped; never the generic 500.
                body = b""
                deadline = time.monotonic() + SOCKET_TIMEOUT_S
                try:
                    while len(body) < length:
                        if time.monotonic() > deadline:
                            raise TimeoutError
                        # read1 = at most ONE underlying recv (a plain
                        # read(n) would loop recv until n bytes, resetting
                        # the socket timer per byte — the loris hole again)
                        chunk = self.rfile.read1(
                            min(64 << 10, length - len(body))
                        )
                        if not chunk:
                            break  # client hung up: the truncated-body 400
                        body += chunk
                except TimeoutError:
                    self._reply(408, {
                        "error": (
                            f"body read exceeded the {SOCKET_TIMEOUT_S}s "
                            f"budget ({len(body)} of {length} declared "
                            f"bytes arrived)"
                        ),
                    })
                    self.close_connection = True
                    return
                if len(body) < length:
                    # the client hung up mid-body: a truncated document
                    self._reply(400, {
                        "error": (
                            f"truncated body: {len(body)} of {length} "
                            f"declared bytes arrived"
                        ),
                    })
                    return
                if path == "/v1/submit":
                    try:
                        doc = json.loads(body.decode() or "{}")
                        if not isinstance(doc, dict):
                            raise ValueError("body must be a JSON object")
                    except (ValueError, UnicodeDecodeError) as e:
                        self._reply(400, {"error": f"bad JSON body: {e}"})
                        return
                    self._reply(*fd.handle_submit(
                        doc, traceparent=self.headers.get("traceparent")
                    ))
                elif path == "/v1/shutdown":
                    fd.request_shutdown()
                    self._reply(200, {"ok": True})
                else:
                    self.send_error(404, "unknown endpoint")
            except Exception as e:
                self.send_error(500, repr(e))

        def log_message(self, *args):  # requests must not spam stderr
            pass

    return _Handler


# -- the front door -----------------------------------------------------------


class FrontDoor:
    """One network entry in front of one `ServingLoop` (module docstring).

    ``loop`` — the pool; ``admission`` — an `admission.AdmissionController`
    (default: env-policy for the pool's capacity); ``autoscaler`` — an
    `autoscale.Autoscaler` (None = fixed capacity); ``checkpoint_dir`` —
    where resizes checkpoint and `elastic_resume` restores (required for
    autoscaling); ``setup_kwargs`` — extra model ``setup`` kwargs every
    member spec shares (``npt`` for porous, dtype overrides...);
    ``digest_results`` — compute the collective per-field digest at each
    retirement; ``port``/``host`` — override ``IGG_SERVE_PORT`` /
    ``IGG_SERVE_HOST``.
    """

    def __init__(self, loop: ServingLoop, *, admission=None, autoscaler=None,
                 port: int | None = None, host: str | None = None,
                 checkpoint_dir: str | None = None,
                 setup_kwargs: dict | None = None,
                 digest_results: bool = True):
        self.loop = loop
        self.model = loop.model
        self.checkpoint_dir = checkpoint_dir or loop.checkpoint_dir
        self.admission = (
            admission if admission is not None
            else _admission.AdmissionController(capacity=loop.capacity)
        )
        self.autoscaler = autoscaler
        self.setup_kwargs = dict(setup_kwargs or {})
        self.digest_results = digest_results
        self._lock = threading.RLock()
        self._pending: collections.deque = collections.deque()
        self._requests: dict[str, dict] = {}
        self._next_request = 0
        self._seen_results: set[int] = set()
        # Bounded result retention: request ids are
        # monotonic, so one integer horizon distinguishes "expired under
        # IGG_RESULT_KEEP / IGG_RESULT_TTL_S" (structured 410) from
        # "never existed" (404) without keeping a tombstone per request.
        self._expired_before = 0
        self._shutdown = False
        self._refusing: str | None = None  # "resizing": reject all submits
        self._drain_target: dict | None = None
        self._as_round = -1
        self._as_t = 0.0
        self._httpd = None
        self._thread = None
        self.port: int | None = None
        self.rank = _telemetry._proc_index()
        if self.autoscaler is not None:
            if not self.checkpoint_dir:
                raise ValueError(
                    "autoscaling needs a checkpoint_dir: a resize IS a "
                    "checkpoint + supervised restart."
                )
            # the RunGuard subscription mechanism: anomaly alerts reach the
            # autoscaler's status view through the rule engine
            _liveplane.subscribe(self.autoscaler.on_alert)
        if self.rank == 0:
            self._start_server(port, host)

    # - server lifecycle -

    def _start_server(self, port: int | None, host: str | None) -> None:
        if host is None:
            host = _config.serve_host_env() or "127.0.0.1"
        if port is None:
            port = _config.serve_port_env() or 0
        self._httpd = http.server.ThreadingHTTPServer(
            (host, int(port)), _make_handler(self)
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="igg-frontdoor",
            daemon=True,
        )
        self._thread.start()
        _telemetry.gauge("frontdoor.port").set(self.port)
        _telemetry.event("frontdoor.start", host=host, port=self.port)
        from ..supervisor import generation as _generation

        directory = _config.telemetry_dir_env()
        if _generation.fence_refusal("frontdoor.endpoint") is not None:
            # a superseded incarnation must not steal the discovery file
            # from the door that replaced it (advisory path: refuse, the
            # fence.rejected event is already on the timeline)
            directory = None
        if directory:
            pub_host = socket.gethostname() if host in ("0.0.0.0", "::") else host
            doc = {"rank": self.rank, "pid": os.getpid(), "host": pub_host,
                   "port": self.port, "ts": time.time()}
            try:
                os.makedirs(directory, exist_ok=True)
                _telemetry.atomic_write_json(
                    os.path.join(directory, endpoint_filename(self.rank)),
                    doc, fsync=False,  # advisory discovery file
                )
            except OSError:
                pass  # an unwritable dir must not take serving down

    def close(self) -> None:
        """Stop the HTTP server and drop the engine subscription (the pool
        itself is untouched — a closed door does not evict anyone)."""
        if self.autoscaler is not None:
            _liveplane.unsubscribe(self.autoscaler.on_alert)
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None

    # - HTTP-side (rank 0, handler threads) -

    def _validate(self, doc: dict) -> str | None:
        from ..parallel import grid as _grid

        model = doc.get("model")
        if model is not None and model != self.loop.model_name:
            return (
                f"this pool serves {self.loop.model_name!r}, not {model!r}"
            )
        size = doc.get("size")
        if size is not None:
            gg = _grid.global_grid()
            if list(size) != list(gg.nxyz_g):
                return (
                    f"size {list(size)} does not match the pool's global "
                    f"grid {list(gg.nxyz_g)}"
                )
        params = doc.get("params")
        if not isinstance(params, dict):
            return "params must be an object with at least max_steps"
        try:
            if int(params.get("max_steps", 0)) < 1:
                return f"params.max_steps must be >= 1 (got {params.get('max_steps')!r})"
        except (TypeError, ValueError):
            return f"params.max_steps must be an integer (got {params.get('max_steps')!r})"
        tol = params.get("tol")
        if tol is not None:
            if not self.loop.info["residual"]:
                return (
                    f"{self.loop.model_name} has no PT residual; tol applies "
                    f"to residual models only (use max_steps)"
                )
            try:
                float(tol)
            except (TypeError, ValueError):
                return f"params.tol must be a number (got {tol!r})"
        ic = params.get("ic_scale", 1.0)
        try:
            float(ic)
        except (TypeError, ValueError):
            return f"params.ic_scale must be a number (got {ic!r})"
        return None

    def handle_submit(self, doc: dict, *, traceparent: str | None = None):
        """One ``POST /v1/submit`` → ``(code, body, headers)``.  Validation
        → 400 before admission ever runs; admission → 429 with
        ``Retry-After``; accepted specs land in the pending queue the next
        control sync broadcasts.

        Trace context: an inbound ``doc["trace"]`` (a router-forwarded or
        replayed spec — wins) or W3C ``traceparent`` header is adopted;
        otherwise one is minted, head-sampled (``IGG_TRACE_SAMPLE``).  A
        traced request's every response carries ``traceparent`` back; the
        accepted spec carries a member-level child context into the
        control broadcast, so every rank's serving rounds tag the
        request.  Untraced requests pay nothing beyond echoing an inbound
        header verbatim."""
        tenant = str(doc.get("tenant") or "default")
        _telemetry.counter("frontdoor.requests_total").inc()
        inbound = doc.get("trace") if isinstance(doc.get("trace"), dict) else None
        if inbound is None:
            inbound = _tracing.parse_traceparent(traceparent)
        ctx = None
        t0 = 0.0
        if _tracing.enabled() and (inbound is not None or _tracing.should_sample()):
            tid = inbound["trace_id"] if inbound else _tracing.new_trace_id()
            ctx = {"trace_id": tid, "span_id": _tracing.new_span_id()}
            if inbound and inbound.get("span_id"):
                ctx["parent_id"] = inbound["span_id"]
            t0 = time.perf_counter()
        if ctx is not None:
            echo = {"traceparent": _tracing.format_traceparent(ctx)}
        elif traceparent:
            echo = {"traceparent": str(traceparent)}  # pure passthrough
        else:
            echo = {}
        err = self._validate(doc)
        if err is not None:
            _telemetry.counter("frontdoor.invalid_total").inc()
            return 400, {"error": err}, echo
        # Decision + append run under the SAME lock `_directives` holds
        # when it flips `_refusing` and drains pending: every request is
        # accounted exactly once (admitted XOR rejected), and every 202
        # ever issued is either in the resize drain or was refused.
        with self._lock:
            if self._refusing:
                code, body, hdrs = self._reject_resizing(tenant)
                return code, body, {**hdrs, **echo}
            with _tracing.use_context(ctx):
                decision = self.admission.check(tenant)
            if not decision.admit:
                _telemetry.event(
                    "frontdoor.reject", tenant=tenant, reason=decision.reason,
                    retry_after_s=round(decision.retry_after_s, 3),
                )
                return (
                    429,
                    {
                        "error": "admission rejected",
                        "reason": decision.reason,
                        "retry_after_s": round(decision.retry_after_s, 3),
                    },
                    {"Retry-After": str(max(1, int(-(-decision.retry_after_s // 1)))),
                     **echo},
                )
            params = doc.get("params", {})
            spec = {
                "tenant": tenant,
                "params": {
                    "max_steps": int(params["max_steps"]),
                    "ic_scale": float(params.get("ic_scale", 1.0)),
                    "tol": None if params.get("tol") is None else float(params["tol"]),
                },
            }
            rid = f"r{self._next_request:06d}"
            self._next_request += 1
            spec["id"] = rid
            rec_trace = None
            if ctx is not None:
                # The member-level child context: rides the spec through
                # the control broadcast (every rank tags its rounds with
                # it), the checkpoint slot metadata (a trace survives a
                # generation bump) and any re-routed replay of the spec.
                member_ctx = {"trace_id": ctx["trace_id"], "span_id": _tracing.new_span_id()}
                spec["trace"] = member_ctx
                rec_trace = {**ctx, "member_span_id": member_ctx["span_id"]}
            self._requests[rid] = {
                "id": rid, "tenant": tenant, "params": spec["params"],
                "submitted_ts": time.time(), "member": None, "done": None,
                "trace": rec_trace,
            }
            self._pending.append(spec)
            _telemetry.gauge("frontdoor.pending").set(len(self._pending))
        self._publish_oldest_gauge()
        trace_tags = {"trace_id": ctx["trace_id"]} if ctx else {}
        _telemetry.event("frontdoor.admit", request=rid, tenant=tenant,
                         **spec["params"], **trace_tags)
        if ctx is not None:
            # The HTTP-handler hop (validation + admission + enqueue),
            # chained under the request span recorded at harvest.
            _tracing.record_span(
                "igg.frontdoor.submit", t0=t0, dur=time.perf_counter() - t0,
                parent={"trace_id": ctx["trace_id"], "span_id": ctx["span_id"]},
                request=rid, tenant=tenant,
            )
        return 202, {"request_id": rid}, echo

    def trace_header(self, rid: str) -> dict | None:
        """The ``traceparent`` echo header for a ledgered request (None
        when unknown or untraced)."""
        with self._lock:
            rec = self._requests.get(rid)
            tr = rec.get("trace") if rec else None
        if not tr:
            return None
        return {"traceparent": _tracing.format_traceparent(
            {"trace_id": tr["trace_id"], "span_id": tr["span_id"]})}

    def _reject_resizing(self, tenant: str):
        """Mid-resize 429: the pool is checkpointing for a restart — turn
        traffic away cheaply (same ledger as every admission rejection)
        until the relaunched door opens."""
        retry = 5.0
        _telemetry.counter("frontdoor.rejected_total").inc()
        _telemetry.counter("frontdoor.rejected.resizing").inc()
        _telemetry.frontdoor_tenant_counter(tenant, "rejected").inc()
        _telemetry.gauge("frontdoor.backpressure").set(1)
        _telemetry.event("frontdoor.reject", tenant=tenant,
                         reason="resizing", retry_after_s=retry)
        return (
            429,
            {"error": "resizing", "reason": "resizing",
             "retry_after_s": retry},
            {"Retry-After": str(int(-(-retry // 1)))},
        )

    def request_shutdown(self) -> None:
        self._shutdown = True

    def result_view(self, rid: str) -> dict | None:
        with self._lock:
            rec = self._requests.get(rid)
            if rec is None:
                try:
                    n = int(rid.lstrip("r"))
                except ValueError:
                    return None
                if rid.startswith("r") and n < self._expired_before:
                    # pruned under the retention knobs: a structured 410,
                    # distinct from "never existed"
                    return {"request_id": rid, "status": "expired"}
                return None
            if rec["done"] is not None:
                return {"request_id": rid, "status": "done", **rec["done"]}
            if rec["member"] is None:
                return {"request_id": rid, "status": "pending"}
            return {
                "request_id": rid, "status": "accepted",
                "member": rec["member"],
            }

    def status_view(self) -> dict:
        with self._lock:
            total = len(self._requests)
            done = sum(1 for r in self._requests.values() if r["done"])
            pending = len(self._pending)
        doc = {
            "rank": self.rank,
            "model": self.loop.model_name,
            "rounds": self.loop.rounds,
            "capacity": self.loop.capacity,
            "queue_depth": len(self.loop.queue),
            "active_members": self.loop.active_members,
            "pending": pending,
            "requests": {"total": total, "done": done},
            "draining": self._drain_target,
            "resizing": bool(self._refusing),
        }
        if self.autoscaler is not None:
            doc["autoscaler"] = self.autoscaler.status()
        return doc

    # - the serving thread (every rank) -

    def _build_state(self, ic_scale: float) -> tuple:
        from ..parallel import grid as _grid

        gg = _grid.global_grid()
        state, _params = self.model.setup(
            *gg.nxyz, init_grid=False, ic_scale=float(ic_scale),
            **self.setup_kwargs,
        )
        return tuple(state)

    def _directives(self) -> dict | None:
        """Rank 0: compose this iteration's control message."""
        doc: dict = {}
        resize = self._maybe_autoscale()
        with self._lock:
            if resize is not None and "resize" in resize:
                # refuse new submissions UNDER THE SAME LOCK that drains
                # pending: `handle_submit` re-checks `_refusing` inside its
                # locked append, so every 202 ever issued is either in this
                # drain or was refused — nothing can slip into the gap
                # behind the checkpointed ledger
                self._refusing = "resizing"
            if self._pending:
                doc["admit"] = list(self._pending)
                self._pending.clear()
                _telemetry.gauge("frontdoor.pending").set(0)
        if resize is not None:
            doc.update(resize)
        if self._shutdown:
            doc["shutdown"] = True
        if doc:
            # thread the incarnation's generation token through the
            # control plane: receivers verify it in
            # `_apply` — a directive from another incarnation is refused
            from ..supervisor import generation as _generation

            gen = _generation.current_generation()
            if gen is not None:
                doc["gen"] = gen
        return doc or None

    def _maybe_autoscale(self) -> dict | None:
        """Rank 0, heartbeat cadence: one autoscaler observation over the
        live gauge view; returns ``{"drain": cap}`` or ``{"resize": plan}``
        directives (or None)."""
        if self.autoscaler is None:
            return None
        now = time.monotonic()
        if self.loop.rounds == self._as_round and now - self._as_t < 0.25:
            return None
        self._as_round, self._as_t = self.loop.rounds, now
        view = _admission.gauge_view(tick=False)
        if self._drain_target is not None:
            target = self._drain_target
            # drained() = no member left in a retiring slot (which implies
            # occupancy fits the target): the documented "stop admitting,
            # finish in-flight, then reshard" readiness
            if self.loop.drained(int(target["capacity"])):
                plan = dict(target, reason="scale_down_drained")
                return {"resize": plan}
            return None
        action = self.autoscaler.observe(view)
        if action is None:
            return None
        plan = {
            "nproc": action["target"]["nproc"],
            "capacity": action["target"]["capacity"],
            "rung": action["rung"],
            "reason": action["action"],
            "evidence": action["evidence"],
        }
        if action["action"] == "up":
            return {"resize": plan}
        # scale-down: drain first — stop admitting into retiring slots,
        # let in-flight members finish, resize once occupancy fits
        return {"drain": plan}

    def _apply(self, msg: dict) -> str | None:
        """Every rank: apply one control message in a fixed order
        (admissions → drain → resize → shutdown).  A message stamped with
        a DIFFERENT generation than this incarnation's is refused whole —
        rank-uniformly (every rank of one incarnation carries the same
        token and reads the same stamp), so the refusal can never split
        the collectives a directive implies)."""
        from ..supervisor import generation as _generation

        gen = _generation.current_generation()
        msg_gen = msg.get("gen")
        if gen is not None and msg_gen is not None and msg_gen != gen:
            _telemetry.counter("fence.rejected_total").inc()
            _telemetry.event(
                "fence.rejected", what="frontdoor.control",
                generation=gen, authoritative=msg_gen,
            )
            return None
        for spec in msg.get("admit", []):
            self._admit_spec(spec)
        if "drain" in msg:
            plan = msg["drain"]
            self.loop.drain_above = int(plan["capacity"])
            if self.rank == 0:
                self._drain_target = plan
            _telemetry.event("frontdoor.drain", **{
                k: plan[k] for k in ("nproc", "capacity", "reason")
                if k in plan
            })
        if "resize" in msg:
            self._execute_resize(msg["resize"])
            return "resize"
        if msg.get("shutdown"):
            _telemetry.event("frontdoor.shutdown")
            return "shutdown"
        return None

    def _admit_spec(self, spec: dict) -> None:
        params = spec["params"]
        trace = spec.get("trace") if isinstance(spec.get("trace"), dict) \
            else None
        state = self._build_state(params.get("ic_scale", 1.0))
        request = Request(
            state=state,
            max_steps=int(params["max_steps"]),
            tenant=spec.get("tenant", "default"),
            tol=params.get("tol"),
            trace=trace,
        )
        member = self.loop.submit(request)
        if self.rank == 0:
            with self._lock:
                rec = self._requests.get(spec.get("id"))
                if rec is not None:
                    rec["member"] = member
            rtr = rec.get("trace") if rec else None
            if trace is not None and rtr is not None:
                # Queue wait, retroactively: submit→admission into the
                # pool, under the PRE-BROADCAST member span id, so every
                # rank's round spans (which carry the same member context)
                # parent here without any cross-process id exchange.
                wait = time.time() - rec["submitted_ts"]
                _tracing.record_span(
                    "igg.frontdoor.admit", t0=time.perf_counter() - wait, dur=wait,
                    parent={"trace_id": rtr["trace_id"], "span_id": rtr.get("span_id")},
                    span_id=trace.get("span_id"), request=spec.get("id"), member=member,
                    tenant=spec.get("tenant", "default"),
                )

    def _harvest(self) -> None:
        """Collect newly retired members: the collective digest, the
        request ledger update and the latency ledger.  Iteration order is
        the member id — deterministic on every rank, so the digest
        collectives stay aligned."""
        fresh = sorted(
            m for m in self.loop.results if m not in self._seen_results
        )
        for member in fresh:
            self._seen_results.add(member)
            res = self.loop.results[member]
            rec = None
            if self.rank == 0:
                with self._lock:
                    rec = next(
                        (r for r in self._requests.values()
                         if r["member"] == member),
                        None,
                    )
            digest = None
            if self.digest_results and res.state is not None:
                # The digest gathers every field to the host on the serving
                # thread: its own span, under the member's request context
                # where this rank ledgered one.
                tr = rec.get("trace") if rec else None
                ctx = ({"trace_id": tr["trace_id"], "span_id": tr["member_span_id"]}
                       if tr else None)
                with _tracing.use_context(ctx), \
                        _tracing.trace_span("igg.frontdoor.digest", member=member):
                    digest = state_digest(res.state)
            # Every rank consumed the result (the digest is the read):
            # under the retention knobs the pool may now prune the member
            # state at the next round end, uniformly across ranks.
            self.loop.mark_consumed(member)
            if rec is None:
                continue
            latency = time.time() - rec["submitted_ts"]
            rec["done_ts"] = time.time()
            rec["done"] = {
                "result": res.status,
                "steps": res.steps,
                "residual": res.residual,
                "digest": digest,
                "latency_s": round(latency, 6),
            }
            _telemetry.counter("frontdoor.completed_total").inc()
            _telemetry.histogram("frontdoor.request_seconds").record(latency)
            _telemetry.tenant_histogram(rec["tenant"]).record(latency)
            tr = rec.get("trace")
            trace_tags = {"trace_id": tr["trace_id"]} if tr else {}
            _telemetry.event(
                "frontdoor.complete", request=rec["id"], member=member,
                tenant=rec["tenant"], result=res.status, steps=res.steps,
                latency_s=round(latency, 6), **trace_tags,
            )
            if tr is not None:
                # The request's root-side span: submit→result on the door,
                # recorded retroactively under the ledgered request span id
                # so the whole tree (submit hop, queue wait, rounds on every
                # rank) hangs off one span.
                _tracing.record_span(
                    "igg.frontdoor.request", t0=time.perf_counter() - latency,
                    dur=latency,
                    parent={"trace_id": tr["trace_id"], "span_id": tr.get("parent_id")},
                    span_id=tr["span_id"], request=rec["id"], member=member,
                    tenant=rec["tenant"], result=res.status,
                )
        # The loop prunes consumed member states at round end; mirror the
        # bound here so a request flood cannot grow the door either —
        # member ids never repeat, so the intersection is monotone-safe.
        self._seen_results &= set(self.loop.results)
        if self.rank == 0:
            self._prune_requests()
            self._publish_oldest_gauge()

    def _publish_oldest_gauge(self) -> None:
        """Rank 0: publish the oldest in-flight submit timestamp as the
        ``frontdoor.oldest_submitted_ts`` gauge (0 = nothing in flight).
        ``/healthz`` and ``igg_top`` turn it into the worst in-flight
        request AGE at scrape time — publishing the timestamp rather than
        a precomputed age keeps the reading fresh between publishes."""
        if self.rank != 0:
            return
        with self._lock:
            inflight = [
                r["submitted_ts"] for r in self._requests.values()
                if r["done"] is None
            ]
        _telemetry.gauge("frontdoor.oldest_submitted_ts").set(
            min(inflight) if inflight else 0
        )

    def _prune_requests(self) -> None:
        """Expire DONE ledger records under the retention knobs (rank 0).

        Same bounds as `ServingLoop._prune_results` — ``IGG_RESULT_KEEP``
        keeps the newest N done records, ``IGG_RESULT_TTL_S`` drops done
        records older than the bound — and the same invariant: a record
        nobody could still need (done = the result has been delivered into
        the ledger) is the only thing ever dropped; pending/accepted
        records are immortal until they complete.  Expired rids advance
        `_expired_before`, so a late fetch gets a structured 410 instead
        of a lying 404.
        """
        keep = _config.result_keep_env() or 0
        ttl = _config.result_ttl_env()
        if not keep and ttl is None:
            return
        with self._lock:
            done = sorted(
                (r for r in self._requests.values() if r["done"] is not None),
                key=lambda r: r["id"],
            )
            doomed = []
            if ttl is not None:
                now = time.time()
                doomed = [
                    r for r in done if now - r.get("done_ts", now) > ttl
                ]
            if keep:
                fresh = [r for r in done if r not in doomed]
                if len(fresh) > keep:
                    doomed += fresh[:-keep]
            for rec in doomed:
                del self._requests[rec["id"]]
                self._expired_before = max(
                    self._expired_before, int(rec["id"][1:]) + 1
                )
        if doomed:
            _telemetry.counter("frontdoor.requests_pruned_total").inc(
                len(doomed)
            )
            _telemetry.event(
                "frontdoor.requests_pruned",
                requests=[r["id"] for r in doomed],
                horizon=self._expired_before,
            )

    def serve_rounds(self, max_rounds: int | None = None, *,
                     idle_sleep: float = 0.02) -> str:
        """Drive the pool until a directive ends it: returns ``"shutdown"``,
        ``"resize"`` (checkpoint + plan written — exit with `RESIZE_STATUS`)
        or ``"rounds"`` (``max_rounds`` iterations elapsed).  One control
        sync per iteration on EVERY rank — the collective cadence is the
        iteration count, which the synced state keeps rank-uniform.
        """
        from ..utils import resilience as _resilience

        n = 0
        while True:
            directive = self._directives() if self.rank == 0 else None
            msg = broadcast_control(directive)
            outcome = self._apply(msg)
            if outcome is not None:
                return outcome
            if self.loop.queue or self.loop.active_members:
                # the stall injector hook (`IGG_FAULT_INJECT=stall:stepN`):
                # the SLO-breach drill wedges the serving thread HERE and
                # the admission thread must flip to 429s on its own
                _resilience.get_fault_injector().maybe_stall(self.loop.rounds)
                self.loop.run_round()
                self._harvest()
            else:
                # a drained pool is idle, not stalled: keep the step-stall
                # rule quiet while the door waits for traffic
                if _telemetry.enabled():
                    _telemetry.note_progress(
                        "serving.round", self.loop.rounds, done=True
                    )
                time.sleep(idle_sleep)
            n += 1
            if max_rounds is not None and n >= max_rounds:
                return "rounds"

    # - resize execution + elastic resume -

    def _frontdoor_meta(self) -> dict:
        with self._lock:
            return {
                "next_request": self._next_request,
                "expired_before": self._expired_before,
                "requests": {
                    rid: {
                        "tenant": r["tenant"], "params": r["params"],
                        "submitted_ts": r["submitted_ts"],
                        "member": r["member"], "done": r["done"],
                        "trace": r.get("trace"),
                    }
                    for rid, r in self._requests.items()
                },
            }

    def _execute_resize(self, plan: dict) -> None:
        """Every rank: checkpoint the pool + ledgers, publish the plan
        (rank 0, atomically), stop the HTTP server.  The caller exits with
        `RESIZE_STATUS`; the supervisor relaunches at ``plan``'s topology
        and the new process runs `elastic_resume`."""
        from ..supervisor import generation as _generation
        from ..utils import checkpoint as _checkpoint

        # Generation fence: a zombie incarnation publishing a resize plan
        # would steer the supervisor at a topology the LIVE incarnation
        # never asked for — the split-brain hole fencing closes.  Checked
        # before the checkpoint too (save_checkpoint re-checks; this names
        # the resize in the refusal).  Rank-uniform, so the raise cannot
        # split the collective save.
        _generation.check_fence("frontdoor.resize")
        with _tracing.trace_span("igg.frontdoor.resize", nproc=plan.get("nproc"),
                                 capacity=plan.get("capacity")):
            if self.loop._state is None:
                # an empty pool still resizes (scale-down at idle): prime
                # it so there is a (blank) pool to checkpoint and restore
                self.loop.prime(self._build_state(1.0))
            extra = {
                **self.loop._serving_meta(),
                "frontdoor": self._frontdoor_meta(),
                "resize": {k: plan[k] for k in ("nproc", "capacity", "rung",
                                                "reason") if k in plan},
            }
            path = _checkpoint.save_checkpoint(
                self.checkpoint_dir, self.loop._state, self.loop.rounds,
                extra=extra,
            )
            if self.rank == 0:
                plan_doc = {
                    **{k: plan[k] for k in ("nproc", "capacity", "rung",
                                            "reason") if k in plan},
                    "checkpoint": path,
                    "rounds": self.loop.rounds,
                    "ts": time.time(),
                }
                # fsync'd: the supervisor's ONLY relaunch instruction — it
                # must never be readable half-written after a power cut
                _telemetry.atomic_write_json(
                    os.path.join(self.checkpoint_dir, RESIZE_PLAN), plan_doc
                )
            _telemetry.counter("frontdoor.resizes_total").inc()
            _telemetry.event(
                "frontdoor.resize", checkpoint=path,
                **{k: plan[k] for k in ("nproc", "capacity", "rung", "reason")
                   if k in plan},
            )
        self.close()

    def elastic_resume(self) -> bool:
        """Restore pool + ledgers from the newest valid checkpoint onto the
        CURRENT topology/capacity (module docstring).  Every rank calls it
        (the restore and re-admissions are collective-bearing and driven
        from the shared checkpoint metadata, so they are rank-uniform by
        construction).  Returns False when no checkpoint exists."""
        from ..models import _batched
        from ..parallel import grid as _grid
        from ..utils import checkpoint as _checkpoint

        if not self.checkpoint_dir:
            raise ValueError("elastic_resume needs a checkpoint_dir")
        latest = _checkpoint.latest_checkpoint(self.checkpoint_dir)
        if latest is None:
            return False
        meta = _checkpoint.checkpoint_meta(latest)
        serving_meta = meta.get("extra", {}).get("serving", {})
        if serving_meta.get("model") != self.loop.model_name:
            raise ValueError(
                f"checkpoint {latest!r} is a {serving_meta.get('model')!r} "
                f"pool; this loop serves {self.loop.model_name!r}"
            )
        gg = _grid.global_grid()
        err = _grid.elastic_topology_error(meta["grid"], gg.checkpoint_meta())
        if err is not None:
            raise ValueError(
                f"checkpoint {latest!r} cannot be elastically restored on "
                f"the current grid: {err}"
            )
        saved_slots = serving_meta.get("slots", [])
        blank = self._build_state(1.0)
        self.loop.prime(blank)
        zeros = tuple(torch.zeros_like(A) for A in blank)
        like = _batched.stack_states([zeros] * max(1, len(saved_slots)))
        state, step, extra = _checkpoint.restore_checkpoint(
            latest, like=like, strict=False, verify=True
        )
        active = [
            (k, rec) for k, rec in enumerate(extra["serving"]["slots"])
            if rec["active"]
        ]
        if len(active) > self.loop.capacity:
            raise RuntimeError(
                f"checkpoint holds {len(active)} live member(s) but the "
                f"resized pool has capacity {self.loop.capacity} — drain "
                f"below the target before scaling down."
            )
        for k, rec in active:
            self.loop.adopt(rec, _batched.member_state(state, k))
        self.loop.rounds = int(step)
        fd_meta = extra.get("frontdoor", {})
        adopted = {int(rec["member"]) for _, rec in active}
        requests = fd_meta.get("requests", {})
        # Still-QUEUED members (admitted by the door, never slotted, not
        # done) are rebuilt from their specs under their original ids —
        # the member state is a pure function of (grid, ic_scale), so
        # nothing is lost with the queue.  Sorted by member id: the
        # rank-uniform order every rank replays identically.
        queued = sorted(
            (
                (int(rec["member"]), rid, rec)
                for rid, rec in requests.items()
                if rec.get("member") is not None
                and rec.get("done") is None
                and int(rec["member"]) not in adopted
            ),
        )
        for member, _rid, rec in queued:
            params = rec["params"]
            self.loop.enqueue_restored(
                member,
                Request(
                    state=self._build_state(params.get("ic_scale", 1.0)),
                    max_steps=int(params["max_steps"]),
                    tenant=rec.get("tenant", "default"),
                    tol=params.get("tol"),
                    trace=_member_ctx(rec.get("trace")),
                ),
            )
        self.loop._next_member = max(
            self.loop._next_member,
            int(serving_meta.get("next_member", 0)),
        )
        # Belt and braces: a 202-accepted request with NO member yet (its
        # spec was still pending when the resize checkpointed — the drain
        # normally empties that set under the refusal lock) is submitted
        # fresh from its spec; member-id assignment is deterministic, so
        # every rank replaying the same sorted ledger agrees.
        unsynced = sorted(
            (rid, rec) for rid, rec in requests.items()
            if rec.get("member") is None and rec.get("done") is None
        )
        for rid, rec in unsynced:
            params = rec["params"]
            member = self.loop.submit(Request(
                state=self._build_state(params.get("ic_scale", 1.0)),
                max_steps=int(params["max_steps"]),
                tenant=rec.get("tenant", "default"),
                tol=params.get("tol"),
                trace=_member_ctx(rec.get("trace")),
            ))
            rec["member"] = member
        if self.rank == 0:
            with self._lock:
                self._next_request = max(
                    self._next_request, int(fd_meta.get("next_request", 0))
                )
                self._expired_before = max(
                    self._expired_before,
                    int(fd_meta.get("expired_before", 0)),
                )
                for rid, rec in requests.items():
                    self._requests[rid] = {
                        "id": rid,
                        "tenant": rec.get("tenant", "default"),
                        "params": rec["params"],
                        "submitted_ts": rec.get("submitted_ts", time.time()),
                        "member": rec.get("member"),
                        "done": rec.get("done"),
                        "trace": rec.get("trace"),
                    }
            # members that already retired stay harvested; the restored
            # ledger answers /v1/result for them without their states
        self._seen_results.update(
            int(rec["member"]) for rec in requests.values()
            if rec.get("done") is not None and rec.get("member") is not None
        )
        self._publish_oldest_gauge()
        _telemetry.counter("frontdoor.resumes_total").inc()
        _telemetry.event(
            "frontdoor.resume", checkpoint=latest, mode="elastic",
            adopted=len(active), requeued=len(queued), rounds=int(step),
        )
        return True
