"""The port's serving front door, admission and autoscaler
(`implicitglobalgrid_tpu_torch.serving`) against the JAX package's.

* The JAX package's front-door tests (`tests/test_frontdoor.py`) on the
  port: the admission accept/reject matrix, the token bucket, Retry-After,
  the controller's ledger, the autoscaler's verdicts and sustain gate, the
  HTTP surface on a loopback ephemeral port (roundtrip, validation 400s,
  429s, the p99 SLO gate, 413/400 hardening, socket timeouts), graceful
  drain, resize + `elastic_resume` bit-identical, retention bounds.  The
  JAX tests that arm an anomaly rule have their counterparts in
  `tests/test_torch_liveplane.py`, beside the port's rule engine.
* The pure functions against JAX's on identical synthetic views:
  `admission.decide`, `retry_after_s`, `autoscale.decide`; the knobs'
  parsing and errors; `prometheus_text` of the same snapshot; and
  `state_digest` of the same numpy arrays.
* Two gloo ranks (one spawn, `_workers` task ``"serving"``):
  `broadcast_control` and a ``dimx=2`` pool behind the door give the
  1-rank pool's member digests.
"""

import itertools
import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.serving import admission as jadm
from implicitglobalgrid_tpu.serving import autoscale as jasc
from implicitglobalgrid_tpu.serving import frontdoor as jfdm
from implicitglobalgrid_tpu.utils import config as jconfig
from implicitglobalgrid_tpu.utils import telemetry as jtele
from implicitglobalgrid_tpu_torch._workers import spawn
from implicitglobalgrid_tpu_torch.models import diffusion3d
from implicitglobalgrid_tpu_torch.serving import (
    AdmissionController,
    AdmissionPolicy,
    AutoscalePolicy,
    Autoscaler,
    FrontDoor,
    Request,
    Rung,
    ServingLoop,
)
from implicitglobalgrid_tpu_torch.serving import admission as adm
from implicitglobalgrid_tpu_torch.serving import autoscale as asc
from implicitglobalgrid_tpu_torch.serving import frontdoor as fdm
from implicitglobalgrid_tpu_torch.utils import config as tconfig
from implicitglobalgrid_tpu_torch.utils import liveplane
from implicitglobalgrid_tpu_torch.utils import resilience
from implicitglobalgrid_tpu_torch.utils import telemetry as tele
from implicitglobalgrid_tpu_torch.utils import tracing

KNOBS = ("IGG_TENANT_QUOTA", "IGG_FRONTDOOR_QUEUE_MAX", "IGG_FRONTDOOR_SLO_P99_S",
         "IGG_AUTOSCALE_QUEUE_HIGH", "IGG_AUTOSCALE_SUSTAIN", "IGG_SERVE_PORT",
         "IGG_SERVE_HOST", "IGG_RESULT_KEEP", "IGG_RESULT_TTL_S", "IGG_SERVE_MAX_BODY",
         "IGG_TELEMETRY_MAX_TENANTS", "IGG_FAULT_INJECT", "IGG_BATCH", "IGG_BATCH_ROUND_STEPS",
         "IGG_HEARTBEAT_EVERY", "IGG_TRACE_RING", "IGG_TRACE_SAMPLE")


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    tele.reset()
    tracing.reset()
    liveplane.reset()
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()
    tele.reset()
    tracing.reset()
    liveplane.reset()


NX = 8
F64 = torch.float64


def _pool(capacity=2, steps_per_round=1, **kw):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    _, params = diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64)
    return ServingLoop(diffusion3d, params, capacity=capacity, steps_per_round=steps_per_round,
                       **kw)


def _door(loop, **kw):
    return FrontDoor(loop, port=0, setup_kwargs={"dtype": F64}, **kw)


def _member(scale=1.0):
    state, _ = diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64, ic_scale=scale)
    return state


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        return e.code, {}


def _post(port, path, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode() or "{}"), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}"), dict(e.headers)
    except OSError:
        return 0, {}, {}  # door closed (mid-resize)


# -- admission: the pure decision function ------------------------------------


def test_decide_accept_reject_matrix():
    policy = AdmissionPolicy(tenant_rate=1.0, tenant_burst=2.0, queue_max=4, slo_p99_s=0.5)
    ok = {"queue_depth": 1, "round_p99_s": 0.1, "tenant_tokens": 2.0, "critical_alert": False}
    assert adm.decide(ok, policy) == {"admit": True, "reason": None}
    # evaluation order: slo (alert) > slo (p99) > backpressure > quota
    assert adm.decide(dict(ok, critical_alert=True), policy)["reason"] == "slo"
    assert adm.decide(dict(ok, round_p99_s=0.9), policy)["reason"] == "slo"
    assert adm.decide(dict(ok, queue_depth=4), policy)["reason"] == "backpressure"
    assert adm.decide(dict(ok, queue_depth=9), policy)["reason"] == "backpressure"
    assert adm.decide(dict(ok, tenant_tokens=0.3), policy)["reason"] == "quota"
    open_policy = AdmissionPolicy()
    assert adm.decide({"queue_depth": 10**6, "round_p99_s": 10**3, "tenant_tokens": None},
                      open_policy)["admit"] is True
    view = dict(ok, queue_depth=4)
    first = adm.decide(view, policy)
    assert first == adm.decide(view, policy)
    assert view == dict(ok, queue_depth=4)


def test_token_bucket_deterministic_refill():
    b = adm.TokenBucket(rate=2.0, burst=2.0)
    assert b.refill(0.0) == 2.0
    assert b.take() and b.take() and not b.take()
    assert b.refill(0.25) == pytest.approx(0.5)
    assert not b.take()
    assert b.seconds_until_token() == pytest.approx(0.25)
    assert b.refill(1.0) == pytest.approx(2.0)
    assert b.take()


def test_retry_after_sanity():
    policy = AdmissionPolicy(queue_max=4)
    view = {"round_p50_s": 0.2, "queue_depth": 8, "capacity": 2}
    ra = adm.retry_after_s(view, policy, "backpressure")
    assert ra >= 0.2
    assert adm.retry_after_s(dict(view, queue_depth=20), policy, "backpressure") > ra
    assert adm.retry_after_s(view, policy, "quota", bucket_wait_s=3.0) == 3.0
    assert adm.retry_after_s(view, policy, "quota", bucket_wait_s=0.01) == 0.2
    assert adm.retry_after_s({}, policy, "slo") >= 1.0


def test_controller_quota_and_ledger():
    ctl = AdmissionController(AdmissionPolicy(tenant_rate=1.0, tenant_burst=1.0),
                              clock=lambda: 0.0)
    view = {"queue_depth": 0}
    assert ctl.check("tA", now=0.0, view=view).admit
    d = ctl.check("tA", now=0.0, view=view)
    assert not d.admit and d.reason == "quota" and d.retry_after_s > 0
    assert ctl.check("tB", now=0.0, view=view).admit
    assert ctl.check("tA", now=5.0, view=view).admit
    c = tele.snapshot()["counters"]
    assert c["frontdoor.admitted_total"] == 3
    assert c["frontdoor.rejected_total"] == 1
    assert c["frontdoor.rejected.quota"] == 1
    assert c["frontdoor.tenant.tA.admitted"] == 2
    assert c["frontdoor.tenant.tA.rejected"] == 1
    assert c["frontdoor.tenant.tB.admitted"] == 1


def test_gauge_view_reads_live_registry():
    tele.gauge("serving.queue_depth").set(7)
    tele.gauge("frontdoor.pending").set(2)
    tele.gauge("serving.active_members").set(3)
    tele.gauge("serving.capacity").set(4)
    for v in (0.1, 0.2, 0.3):
        tele.histogram("serving.round_seconds").record(v)
    view = adm.gauge_view()
    assert view["queue_depth"] == 9 and view["active_members"] == 3
    assert view["capacity"] == 4 and view["round_p50_s"] == 0.2
    assert view["round_p99_s"] == 0.3
    assert view["critical_alert"] is False  # no progress record: no rule fires


# -- the pure functions against the JAX package's -------------------------------


def _views():
    """A grid of synthetic views covering every gate's both sides."""
    for q, p99, tokens, alert, cap, active, p50 in itertools.product(
            (0, 2, 4, 9), (None, 0.1, 0.9, 3.0), (None, 0.3, 2.0), (False, True), (None, 2, 4),
            (0, 2, 3), (None, 0.05, 0.4)):
        yield {"queue_depth": q, "round_p99_s": p99, "tenant_tokens": tokens,
               "critical_alert": alert, "capacity": cap, "active_members": active,
               "round_p50_s": p50}


def test_admission_and_autoscale_verdicts_equal_jax():
    kw_policies = [dict(), dict(tenant_rate=1.0, tenant_burst=2.0, queue_max=4, slo_p99_s=0.5),
                   dict(queue_max=1, reject_on_critical_alert=False)]
    ladder = ((1, 2), (2, 4), (4, 8))
    scale_kw = [dict(queue_high=None, p99_high_s=None, sustain=1),
                dict(queue_high=3, p99_high_s=1.0, sustain=2)]
    n = 0
    for view in _views():
        for kw in kw_policies:
            tp, jp = adm.AdmissionPolicy(**kw), jadm.AdmissionPolicy(**kw)
            assert adm.decide(view, tp) == jadm.decide(view, jp)
            for reason in adm.REASONS:
                for wait in (None, 0.01, 3.0):
                    assert adm.retry_after_s(view, tp, reason, bucket_wait_s=wait) == \
                        jadm.retry_after_s(view, jp, reason, bucket_wait_s=wait)
        for kw in scale_kw:
            tpol = asc.AutoscalePolicy(ladder=tuple(asc.Rung(*r) for r in ladder), **kw)
            jpol = jasc.AutoscalePolicy(ladder=tuple(jasc.Rung(*r) for r in ladder), **kw)
            for rung in range(len(ladder)):
                assert asc.decide(view, tpol, rung) == jasc.decide(view, jpol, rung)
                n += 1
    assert n > 1000
    assert adm.REASONS == jadm.REASONS and asc.VERDICTS == jasc.VERDICTS


@pytest.mark.parametrize("name,values", [
    ("tenant_quota", ["5", "5:10", "0.5", "x", "1:2:3", "0", "2:0.5", ""]),
    ("frontdoor_queue_max", ["3", "0", "x"]),
    ("frontdoor_slo_p99", ["0.5", "0", "-1", "x"]),
    ("autoscale_queue_high", ["7", "0"]),
    ("autoscale_sustain", ["5", "0"]),
    ("serve_port", ["0", "8080", "-1"]),
    ("serve_max_body", ["64", "0"]),
    ("result_keep", ["0", "4", "-1"]),
    ("result_ttl", ["0.001", "0", "x"]),
    ("batch", ["4", "0"]),
    ("batch_round_steps", ["2", "0"]),
    ("telemetry_max_tenants", ["2", "0"]),
    ("heartbeat_every", ["0", "3", "-2"]),
    ("slo_window", ["30", "0"]),
])
def test_knobs_parse_like_jax(name, values, monkeypatch):
    env = {"tenant_quota": "IGG_TENANT_QUOTA", "frontdoor_queue_max": "IGG_FRONTDOOR_QUEUE_MAX",
           "frontdoor_slo_p99": "IGG_FRONTDOOR_SLO_P99_S",
           "autoscale_queue_high": "IGG_AUTOSCALE_QUEUE_HIGH",
           "autoscale_sustain": "IGG_AUTOSCALE_SUSTAIN", "serve_port": "IGG_SERVE_PORT",
           "serve_max_body": "IGG_SERVE_MAX_BODY", "result_keep": "IGG_RESULT_KEEP",
           "result_ttl": "IGG_RESULT_TTL_S", "batch": "IGG_BATCH",
           "batch_round_steps": "IGG_BATCH_ROUND_STEPS",
           "telemetry_max_tenants": "IGG_TELEMETRY_MAX_TENANTS",
           "heartbeat_every": "IGG_HEARTBEAT_EVERY", "slo_window": "IGG_SLO_WINDOW_S"}[name]
    for val in values:
        monkeypatch.setenv(env, val)
        outs = []
        for mod in (tconfig, jconfig):
            try:
                outs.append(("ok", getattr(mod, f"{name}_env")()))
            except ValueError as e:
                outs.append(("error", str(e)))
        assert outs[0] == outs[1], (env, val, outs)
    monkeypatch.delenv(env)
    assert getattr(tconfig, f"{name}_env")() is None


def test_prometheus_text_equals_jax_for_one_snapshot():
    tele.counter("serving.rounds").inc(3)
    tele.gauge("serving.capacity").set(4)
    tele.tenant_counter("tA").inc(2)
    for v in (0.5, 0.25, 1.0):
        tele.histogram("serving.round_seconds").record(v)
    snap = tele.snapshot()
    assert tele.prometheus_text(snap) == jtele.prometheus_text(snap)
    assert "igg_serving_round_seconds_count 3" in tele.prometheus_text(snap)


def test_state_digest_equals_jax_for_the_same_arrays():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((NX, NX, NX)), rng.standard_normal((NX, NX, NX)).astype(
        np.float32), rng.standard_normal((NX + 1, NX, NX))]
    jigg.init_global_grid(NX, NX, NX, quiet=True, devices=jax.devices()[:1])
    want = jfdm.state_digest(tuple(jax.numpy.asarray(a) for a in arrays))
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    got = fdm.state_digest(tuple(torch.from_numpy(a) for a in arrays))
    assert got == want and len(got["fields"]) == 3
    arrays[0][1, 2, 3] += 1e-15
    assert fdm.state_digest(tuple(torch.from_numpy(a) for a in arrays)) != want


# -- autoscaler -----------------------------------------------------------------


def test_autoscale_decide_pure_and_deterministic():
    policy = AutoscalePolicy(ladder=(Rung(1, 2), Rung(2, 4)), queue_high=3, p99_high_s=1.0,
                             sustain=2)
    idle = {"queue_depth": 0, "active_members": 0, "capacity": 2}
    busy = {"queue_depth": 5, "active_members": 2, "capacity": 2}
    slow = {"queue_depth": 0, "active_members": 2, "capacity": 2, "round_p99_s": 3.0}
    assert asc.decide(idle, policy, 0) == "hold"
    assert asc.decide(busy, policy, 0) == "up"
    assert asc.decide(slow, policy, 0) == "up"
    assert asc.decide(busy, policy, 1) == "hold"
    assert asc.decide(idle, policy, 1) == "down"
    assert asc.decide(dict(idle, active_members=3), policy, 1) == "hold"
    view = dict(busy)
    assert asc.decide(view, policy, 0) == asc.decide(view, policy, 0)
    assert view == busy
    with pytest.raises(ValueError):
        asc.decide(idle, policy, 5)


def test_autoscaler_sustain_gates_the_action():
    policy = AutoscalePolicy(ladder=(Rung(1, 2), Rung(2, 4)), queue_high=3, sustain=2)
    scaler = Autoscaler(policy, rung=0)
    busy = {"queue_depth": 5, "active_members": 2, "capacity": 2}
    idle = {"queue_depth": 0, "active_members": 0, "capacity": 2}
    assert scaler.observe(busy) is None
    assert scaler.observe(idle) is None
    assert scaler.observe(busy) is None
    action = scaler.observe(busy)
    assert action and action["action"] == "up" and action["rung"] == 1
    assert action["target"] == {"nproc": 2, "capacity": 4}
    assert scaler.observe(busy) is None
    down = Autoscaler(policy, rung=1)
    down.observe(idle)
    action = down.observe(idle)
    assert action and action["action"] == "down"
    assert action["target"] == {"nproc": 1, "capacity": 2}
    assert down.status()["rung"] == 1 and down.status()["last_verdict"] == "down"


def test_autoscale_policy_env_tier(monkeypatch):
    monkeypatch.setenv("IGG_AUTOSCALE_QUEUE_HIGH", "7")
    monkeypatch.setenv("IGG_AUTOSCALE_SUSTAIN", "5")
    policy = AutoscalePolicy.from_env([Rung(1, 2)])
    assert policy.queue_high == 7 and policy.sustain == 5
    policy = AutoscalePolicy.from_env([Rung(1, 2)], sustain=1)
    assert policy.sustain == 1


# -- the HTTP surface -----------------------------------------------------------


def test_http_submit_result_status_roundtrip():
    loop = _pool(capacity=2)
    fd = _door(loop)
    try:
        code, body, _ = _post(fd.port, "/v1/submit", {
            "tenant": "tA", "model": "diffusion3d", "params": {"max_steps": 3, "ic_scale": 1.1},
        })
        assert code == 202 and body["request_id"] == "r000000"
        rid = body["request_id"]
        code, view = _get(fd.port, f"/v1/result/{rid}")
        assert view["status"] == "pending"
        assert fd.serve_rounds(max_rounds=5) == "rounds"
        code, view = _get(fd.port, f"/v1/result/{rid}")
        assert view["status"] == "done" and view["result"] == "completed"
        assert view["steps"] == 3
        assert len(view["digest"]["fields"]) == 2
        res = loop.results[0]
        assert view["digest"] == fdm.state_digest(res.state)
        # ... which is the standalone run's
        s = _member(1.1)
        for _ in range(3):
            s = diffusion3d.make_step(loop.params)(*s)
        assert view["digest"] == fdm.state_digest(s)
        code, status = _get(fd.port, "/v1/status")
        assert status["requests"] == {"total": 1, "done": 1}
        assert status["active_members"] == 0 and status["rounds"] >= 3
        code, view = _get(fd.port, "/v1/result/nope")
        assert code == 404
        code, health = _get(fd.port, "/healthz")
        assert health["frontdoor"]["admitted_total"] == 1
        assert health["serving"]["capacity"] == 2
        assert "serving.round_seconds" in health["slo"]
        assert health["last_step"]["kind"] == "serving.round"
        snap = tele.snapshot()
        assert snap["histograms"]["frontdoor.request_seconds"]["count"] == 1
        assert snap["histograms"]["frontdoor.tenant.tA.request_seconds"]["count"] == 1
        assert "window" in snap["histograms"]["frontdoor.request_seconds"]
        with urllib.request.urlopen(f"http://127.0.0.1:{fd.port}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "igg_frontdoor_completed_total_total 1" in text
        for line in text.splitlines():
            assert line.startswith("# TYPE igg_") or line.startswith("igg_"), line
    finally:
        fd.close()


def test_http_traceparent_is_echoed_verbatim(monkeypatch):
    """With span recording off (``IGG_TRACE_RING=0``) the door echoes an
    inbound ``traceparent`` verbatim and ledgers no context (the JAX
    door's pure passthrough); with it on, the echo keeps the trace id under
    the door's own span id, which `trace_header` serves."""
    loop = _pool(capacity=1)
    fd = _door(loop)
    tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"

    def submit():
        req = urllib.request.Request(
            f"http://127.0.0.1:{fd.port}/v1/submit",
            data=json.dumps({"params": {"max_steps": 1}}).encode(),
            headers={"Content-Type": "application/json", "traceparent": tp})
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers["traceparent"], json.loads(r.read())["request_id"]

    try:
        monkeypatch.setenv("IGG_TRACE_RING", "0")
        code, echo, rid = submit()
        assert code == 202 and echo == tp
        assert fd.trace_header(rid) is None
        monkeypatch.delenv("IGG_TRACE_RING")
        code, echo, rid = submit()
        got = tracing.parse_traceparent(echo)
        assert code == 202 and got["trace_id"] == tp.split("-")[1]
        assert got["span_id"] != tp.split("-")[2]
        assert fd.trace_header(rid) == {"traceparent": echo}
    finally:
        fd.close()


def test_http_validation_rejects_before_admission():
    loop = _pool(capacity=1)
    fd = _door(loop)
    try:
        bad = [
            {"params": {}},
            {"params": {"max_steps": 0}},
            {"params": {"max_steps": 2, "tol": 0.1}},
            {"model": "porous_convection3d", "params": {"max_steps": 2}},
            {"size": [1, 2, 3], "params": {"max_steps": 2}},
            {"params": {"max_steps": 2, "ic_scale": "x"}},
        ]
        for doc in bad:
            code, body, _ = _post(fd.port, "/v1/submit", doc)
            assert code == 400, (doc, code, body)
        assert tele.snapshot()["counters"]["frontdoor.invalid_total"] == len(bad)
        assert "frontdoor.admitted_total" not in tele.snapshot()["counters"]
    finally:
        fd.close()


def test_http_429_retry_after_on_quota_and_backpressure(monkeypatch):
    monkeypatch.setenv("IGG_TENANT_QUOTA", "0.001:1")
    monkeypatch.setenv("IGG_FRONTDOOR_QUEUE_MAX", "3")
    loop = _pool(capacity=1)
    fd = _door(loop)
    try:
        doc = {"tenant": "tA", "params": {"max_steps": 2}}
        code, body, _ = _post(fd.port, "/v1/submit", doc)
        assert code == 202
        code, body, headers = _post(fd.port, "/v1/submit", doc)
        assert code == 429 and body["reason"] == "quota"
        assert int(headers["Retry-After"]) >= 1
        assert body["retry_after_s"] > 0
        fd.serve_rounds(max_rounds=1)
        tele.gauge("serving.queue_depth").set(5)
        fd.admission._view_at = None  # bust the TTL view cache
        code, body, headers = _post(fd.port, "/v1/submit",
                                    {"tenant": "tB", "params": {"max_steps": 2}})
        assert code == 429 and body["reason"] == "backpressure"
        assert int(headers["Retry-After"]) >= 1
        c = tele.snapshot()["counters"]
        assert c["frontdoor.rejected.quota"] == 1
        assert c["frontdoor.rejected.backpressure"] == 1
        assert c["frontdoor.rejected_total"] == 2
    finally:
        fd.close()


def test_slo_p99_window_flips_backpressure_live(monkeypatch):
    """The ``slo`` gate over the rolling ``serving.round_seconds`` p99
    window (``IGG_FRONTDOOR_SLO_P99_S``): slow rounds turn submissions into
    429 reason="slo"; once the window has only fast rounds, the door opens."""
    monkeypatch.setenv("IGG_FRONTDOOR_SLO_P99_S", "0.5")
    monkeypatch.setenv("IGG_SLO_WINDOW_S", "0.2")
    loop = _pool(capacity=1)
    fd = _door(loop)
    try:
        doc = {"tenant": "tA", "params": {"max_steps": 2}}
        code, _, _ = _post(fd.port, "/v1/submit", doc)
        assert code == 202
        tele.histogram("serving.round_seconds").record(2.0)  # a wedged round
        fd.admission._view_at = None
        code, body, headers = _post(fd.port, "/v1/submit", doc)
        assert code == 429 and body["reason"] == "slo"
        assert int(headers["Retry-After"]) >= 1
        assert tele.snapshot()["counters"]["frontdoor.rejected.slo"] == 1
        time.sleep(1.1)  # the slow window leaves the rolling horizon
        tele.histogram("serving.round_seconds").record(0.01)
        fd.admission._view_at = None
        code, _, _ = _post(fd.port, "/v1/submit", doc)
        assert code == 202
    finally:
        fd.close()


def test_stall_hook_wedges_the_serving_thread(monkeypatch):
    """``IGG_FAULT_INJECT=stall:step1`` sleeps the serving thread in
    `serve_rounds` before the round after round 1 (the SLO-breach drill)."""
    monkeypatch.setattr(resilience.FaultInjector, "STALL_S", 0.3)
    monkeypatch.setenv("IGG_FAULT_INJECT", "stall:step1")
    resilience.reset_fault_injector()
    try:
        loop = _pool(capacity=1)
        loop.submit(Request(state=_member(), max_steps=3))
        fd = _door(loop)
        try:
            t0 = time.perf_counter()
            fd.serve_rounds(max_rounds=3)
            assert time.perf_counter() - t0 >= 0.3
            assert resilience.get_fault_injector().injectors[0].fired
            assert loop.results[0].status == "completed"
        finally:
            fd.close()
    finally:
        resilience.reset_fault_injector()


# -- graceful drain -------------------------------------------------------------


def test_drain_leaves_zero_orphaned_slots():
    loop = _pool(capacity=3)
    members = [loop.submit(Request(state=_member(1.0 + 0.1 * i), max_steps=2)) for i in range(3)]
    extra = loop.submit(Request(state=_member(1.5), max_steps=2))
    assert loop.active_members == 3 and len(loop.queue) == 1
    loop.drain_above = 1
    for _ in range(8):
        loop.run_round()
        if len(loop.results) == 4:
            break
    assert loop.drained(1)
    assert all(not s.active for s in loop.slots[1:])
    assert set(loop.results) == {*members, extra}
    assert all(r.status == "completed" for r in loop.results.values())
    assert loop.results[extra].steps == 2


# -- resize checkpoint + elastic resume -----------------------------------------


def test_resize_and_elastic_resume_bit_identical(tmp_path):
    specs = [(1.0, 6), (1.1, 6), (1.2, 6)]
    oracle_loop = _pool(capacity=4)
    oracle_ids = [oracle_loop.submit(Request(state=_member(s), max_steps=m)) for s, m in specs]
    oracle_loop.run(max_rounds=30)
    oracle = {(s, m): fdm.state_digest(oracle_loop.results[mid].state)
              for (s, m), mid in zip(specs, oracle_ids)}
    tigg.finalize_global_grid()

    loop = _pool(capacity=2)
    fd = _door(loop, checkpoint_dir=str(tmp_path))
    rids = []
    try:
        for s, m in specs:
            code, body, _ = _post(fd.port, "/v1/submit", {
                "tenant": "t", "params": {"max_steps": m, "ic_scale": s}})
            assert code == 202
            rids.append(body["request_id"])
        fd.serve_rounds(max_rounds=3)
        assert loop.active_members == 2 and len(loop.queue) == 1
        fd._execute_resize({"nproc": 1, "capacity": 3, "rung": 1, "reason": "up"})
        plan = json.loads((tmp_path / fdm.RESIZE_PLAN).read_text())
        assert plan["capacity"] == 3 and plan["reason"] == "up"
    finally:
        fd.close()
    tigg.finalize_global_grid()

    loop2 = _pool(capacity=3)
    fd2 = _door(loop2, checkpoint_dir=str(tmp_path))
    try:
        assert fd2.elastic_resume() is True
        assert loop2.active_members == 3
        assert sorted(s.steps for s in loop2.slots if s.active) == [0, 3, 3]
        fd2.serve_rounds(max_rounds=10)
        for rid, (s, m) in zip(rids, specs):
            view = fd2.result_view(rid)
            assert view and view["status"] == "done", (rid, view)
            assert view["steps"] == m
            assert view["digest"] == oracle[(s, m)], f"{rid} not bit-identical"
        counters = tele.snapshot()["counters"]
        assert counters["frontdoor.resizes_total"] == 1
        assert counters["frontdoor.resumes_total"] == 1
    finally:
        fd2.close()


def test_resume_refuses_overfull_pool(tmp_path):
    loop = _pool(capacity=2)
    fd = _door(loop, checkpoint_dir=str(tmp_path))
    try:
        for i in range(2):
            loop.submit(Request(state=_member(1.0 + i / 10), max_steps=9))
        fd.serve_rounds(max_rounds=1)
        fd._execute_resize({"nproc": 1, "capacity": 1, "rung": 0, "reason": "down"})
    finally:
        fd.close()
    tigg.finalize_global_grid()
    loop2 = _pool(capacity=1)
    fd2 = _door(loop2, checkpoint_dir=str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="drain"):
            fd2.elastic_resume()
    finally:
        fd2.close()


def test_frontdoor_requires_checkpoint_dir_for_autoscaling():
    loop = _pool(capacity=1)
    policy = AutoscalePolicy(ladder=(Rung(1, 1),), sustain=1)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        FrontDoor(loop, port=0, autoscaler=Autoscaler(policy))


def test_serve_rounds_resize_outcome_via_autoscaler(tmp_path, monkeypatch):
    monkeypatch.setenv("IGG_AUTOSCALE_SUSTAIN", "1")
    loop = _pool(capacity=1)
    policy = AutoscalePolicy.from_env([Rung(1, 1), Rung(1, 2)], queue_high=2)
    fd = _door(loop, checkpoint_dir=str(tmp_path), autoscaler=Autoscaler(policy, rung=0))
    try:
        for i in range(4):
            code, _, _ = _post(fd.port, "/v1/submit", {
                "tenant": "t", "params": {"max_steps": 8, "ic_scale": 1 + i / 10}})
            assert code == 202
        outcome = fd.serve_rounds(max_rounds=50)
        assert outcome == "resize"
        plan = json.loads((tmp_path / fdm.RESIZE_PLAN).read_text())
        assert plan["capacity"] == 2 and plan["reason"] == "up"
        code, body, _ = _post(fd.port, "/v1/submit", {"tenant": "t", "params": {"max_steps": 1}})
        assert code in (429, 0) or body.get("reason") == "resizing"
    finally:
        fd.close()


# -- cross-layer wiring ---------------------------------------------------------


def test_publish_gauges_single_writer():
    loop = _pool(capacity=2)
    g = tele.snapshot()["gauges"]
    assert g["serving.capacity"] == 2 and g["serving.queue_depth"] == 0
    m = loop.submit(Request(state=_member(), max_steps=1))
    assert tele.snapshot()["gauges"]["serving.active_members"] == 1
    loop.run_round()
    assert tele.snapshot()["gauges"]["serving.active_members"] == 0
    assert loop.results[m].status == "completed"


def test_tenant_histogram_cardinality_cap(monkeypatch):
    monkeypatch.setenv("IGG_TELEMETRY_MAX_TENANTS", "2")
    for t, v in zip("abcd", (0.1, 0.2, 0.3, 0.4)):
        tele.tenant_histogram(t).record(v)
    hists = tele.snapshot()["histograms"]
    assert hists["frontdoor.tenant.a.request_seconds"]["count"] == 1
    assert hists["frontdoor.tenant.b.request_seconds"]["count"] == 1
    assert hists[tele.FRONTDOOR_TENANT_OVERFLOW]["count"] == 2
    assert not any("tenant.c" in k or "tenant.d" in k for k in hists)
    for t in "xyz":
        tele.tenant_counter(t).inc()
    assert tele.snapshot()["counters"][tele.TENANT_OVERFLOW] == 1


def test_endpoint_file_published(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    loop = _pool(capacity=1)
    fd = _door(loop)
    try:
        doc = json.loads((tmp_path / fdm.endpoint_filename(0)).read_text())
        assert doc["port"] == fd.port and doc["rank"] == 0
        assert tele.snapshot()["gauges"]["frontdoor.port"] == fd.port
    finally:
        fd.close()


# -- HTTP hardening -------------------------------------------------------------


def _raw_post(port, length_header):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.putrequest("POST", "/v1/submit")
    conn.putheader("Content-Type", "application/json")
    conn.putheader("Content-Length", length_header)
    conn.endheaders()
    resp = conn.getresponse()
    body = json.loads(resp.read().decode())
    conn.close()
    return resp.status, body


def test_http_oversize_body_refused_with_structured_413():
    loop = _pool(capacity=1)
    fd = _door(loop)
    try:
        status, body = _raw_post(fd.port, str(fdm.MAX_BODY_DEFAULT + 1))
        assert status == 413
        assert body["max_bytes"] == fdm.MAX_BODY_DEFAULT
        assert body["bytes"] == fdm.MAX_BODY_DEFAULT + 1
        assert tele.snapshot()["counters"]["frontdoor.oversize_total"] == 1
    finally:
        fd.close()


def test_http_malformed_content_length_is_structured_400():
    loop = _pool(capacity=1)
    fd = _door(loop)
    try:
        for bad in ("abc", "-5"):
            status, body = _raw_post(fd.port, bad)
            assert status == 400, bad
            assert "Content-Length" in body["error"], body
    finally:
        fd.close()


def test_http_max_body_env_tier(monkeypatch):
    monkeypatch.setenv("IGG_SERVE_MAX_BODY", "64")
    loop = _pool(capacity=1)
    fd = _door(loop)
    try:
        doc = {"tenant": "t", "model": "diffusion3d",
               "params": {"max_steps": 1, "ic_scale": 1.0, "padding": "x" * 256}}
        code, body, _ = _post(fd.port, "/v1/submit", doc)
        assert code == 413 and body["max_bytes"] == 64
        code, body, _ = _post(fd.port, "/v1/submit", {"params": {"max_steps": 1}})
        assert code == 202
    finally:
        fd.close()


def test_http_malformed_json_and_missing_fields_are_structured_400s():
    loop = _pool(capacity=1)
    fd = _door(loop)
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{fd.port}/v1/submit", data=b"{not json",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        assert "bad JSON body" in json.loads(e.value.read().decode())["error"]
        code, body, _ = _post(fd.port, "/v1/submit", {"tenant": "t"})
        assert code == 400 and "params" in body["error"]
    finally:
        fd.close()


def test_handler_socket_timeouts_armed():
    handler = fdm._make_handler(object())
    assert handler.timeout == fdm.SOCKET_TIMEOUT_S == jfdm.SOCKET_TIMEOUT_S > 0
    assert fdm.MAX_BODY_DEFAULT == jfdm.MAX_BODY_DEFAULT
    assert fdm.RESIZE_STATUS == jfdm.RESIZE_STATUS and fdm.RESIZE_PLAN == jfdm.RESIZE_PLAN


def test_result_retention_bounds_a_flood(monkeypatch):
    monkeypatch.setenv("IGG_RESULT_KEEP", "4")
    loop = _pool(capacity=2)
    fd = _door(loop)
    try:
        for _ in range(12):
            code, body, _ = _post(fd.port, "/v1/submit", {
                "tenant": "t", "model": "diffusion3d", "params": {"max_steps": 1}})
            assert code == 202
        fd.serve_rounds(max_rounds=40)
        assert fd._seen_results <= set(loop.results)
        loop._prune_results()
        assert len(loop.results) <= 4
        code, view = _get(fd.port, "/v1/result/r000011")
        assert code == 200 and view["status"] == "done"
        assert view["result"] == "completed" and "digest" in view
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{fd.port}/v1/result/r000000", timeout=10)
        assert e.value.code == 410
        view = json.loads(e.value.read().decode())
        assert view["status"] == "expired" and "IGG_RESULT_KEEP" in view["detail"]
        assert tele.snapshot()["counters"]["frontdoor.results_expired"] >= 1
        code, view = _get(fd.port, "/v1/result/r999999")
        assert code == 404
        snap = tele.snapshot()["counters"]
        assert snap["frontdoor.requests_pruned_total"] >= 8
        assert snap["serving.results_pruned_total"] >= 8
    finally:
        fd.close()


def test_unconsumed_results_survive_the_ttl(monkeypatch):
    monkeypatch.setenv("IGG_RESULT_TTL_S", "0.001")
    loop = _pool(capacity=2)
    fd = _door(loop)
    try:
        for _ in range(2):
            code, _, _ = _post(fd.port, "/v1/submit", {
                "tenant": "t", "model": "diffusion3d", "params": {"max_steps": 1}})
            assert code == 202
        fd.serve_rounds(max_rounds=6)
        assert sorted(loop.results) == [0, 1]
        for m in loop.results:
            loop._result_ts[m] = time.monotonic() - 99.0
        loop._consumed.discard(0)
        loop._prune_results()
        assert 0 in loop.results and 1 not in loop.results
    finally:
        fd.close()


# -- two gloo ranks ---------------------------------------------------------------

SPECS = [{"tenant": f"t{i}", "params": {"max_steps": m, "ic_scale": s}}
         for i, (s, m) in enumerate(((1.0, 4), (1.1, 6), (0.9, 2), (1.2, 4)))]
MESSAGE = {"admit": [{"id": "r000007", "tenant": "x", "params": {"max_steps": 2}}], "gen": 3}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn: `broadcast_control` and a dimx=2 pool behind the door
    (global 8^3: local (5, 8, 8) per rank, overlap 2)."""
    task = {"kind": "serving", "inputs": {}, "nxyz": [5, NX, NX], "grid": {"dimx": 2},
            "message": MESSAGE, "capacity": 2, "steps_per_round": 2, "rounds": 8,
            "specs": SPECS}
    return spawn(task, 2, tmp_path_factory.mktemp("serving"), timeout=180)


def _doc(arr):
    return json.loads(bytes(arr).decode())


def test_two_ranks_broadcast_control(two_ranks):
    for out in two_ranks:
        assert _doc(out["bcast"]) == MESSAGE
        assert _doc(out["bcast_empty"]) == {}
        assert _doc(out["outcome"]) == "shutdown"
    assert "results" not in two_ranks[1]  # the ledger is rank 0's


def test_two_ranks_digests_equal_the_one_rank_pool(two_ranks):
    got = _doc(two_ranks[0]["results"])
    loop = _pool(capacity=2, steps_per_round=2)
    fd = _door(loop)
    try:
        rids = [fd.handle_submit(doc)[1]["request_id"] for doc in SPECS]
        fd.serve_rounds(max_rounds=8)
        want = {rid: fd.result_view(rid) for rid in rids}
    finally:
        fd.close()
    assert sorted(got) == rids
    for rid in rids:
        assert got[rid]["status"] == want[rid]["status"] == "done"
        for key in ("result", "steps", "digest"):
            assert got[rid][key] == want[rid][key], (rid, key)
