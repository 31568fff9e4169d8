"""The port's live plane (`implicitglobalgrid_tpu_torch.utils.liveplane`)
against the JAX package's.

* The cases of the JAX package's ``tests/test_liveplane.py`` that have a
  meaning in the port (``igg_top.py`` is the JAX package's own tool): the
  per-rank scrape server (``/metrics`` byte-identical to `dump_metrics`,
  ``/healthz``, ``/spans``, the ``IGG_TELEMETRY=0`` never-starts contract,
  the ephemeral port's publication), the rolling SLO gauges, the rule
  engine (latching, events, subscribers, the alert cursor) and every
  built-in rule, and the escalation into `RunGuard` and the serving loop.
* The JAX front-door tests that arm a `Rule` (PR 9 of the port had
  p99-window stand-ins for them): the admission view's alert bit and a
  critical alert flipping submissions to 429 ``slo`` and back.
* Across packages: both packages' default rules, fed the same sequence of
  contexts, give the same evidence, and both `RuleEngine`s, ticked over
  the same registry records, fire the same alerts.
* The step-stall drill on both packages' front doors: ``stall:step3``
  wedges the serving thread, a POST during the stall is refused with 429
  ``slo`` by the critical ``step_stall`` rule (its floor of 1 s and its
  severity unchanged), the POST after it is admitted, and each door's log
  holds exactly one ``alert.step_stall`` event.

Everything runs on the CPU (``device="cpu"``) in float64 at 8^3.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import implicitglobalgrid_tpu as jigg
import implicitglobalgrid_tpu_torch as tigg
from implicitglobalgrid_tpu.models import diffusion3d as jdiffusion
from implicitglobalgrid_tpu.serving import FrontDoor as JFrontDoor
from implicitglobalgrid_tpu.serving import Request as JRequest
from implicitglobalgrid_tpu.serving import ServingLoop as JServingLoop
from implicitglobalgrid_tpu.utils import liveplane as jlp
from implicitglobalgrid_tpu.utils import resilience as jres
from implicitglobalgrid_tpu.utils import telemetry as jtele
from implicitglobalgrid_tpu.utils import tracing as jtracing
from implicitglobalgrid_tpu_torch.models import diffusion3d, porous_convection3d
from implicitglobalgrid_tpu_torch.serving import FrontDoor, Request, ServingLoop
from implicitglobalgrid_tpu_torch.serving import admission as adm
from implicitglobalgrid_tpu_torch.utils import liveplane as lp
from implicitglobalgrid_tpu_torch.utils import resilience as res
from implicitglobalgrid_tpu_torch.utils import telemetry as tele
from implicitglobalgrid_tpu_torch.utils import tracing

NX = 8
F64 = torch.float64
KW = dict(quiet=True, device="cpu", dtype=F64)


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for k in list(os.environ):
        if k.startswith("IGG_"):
            monkeypatch.delenv(k)
    for mod in (tele, tracing, lp, jtele, jtracing, jlp):
        mod.reset()
    res.reset_fault_injector()
    jres.reset_fault_injector()
    yield
    if tigg.grid_is_initialized():
        tigg.finalize_global_grid()
    if jigg.grid_is_initialized():
        jigg.finalize_global_grid()
    for mod in (lp, tele, tracing, jlp, jtele, jtracing):
        mod.reset()
    res.reset_fault_injector()
    jres.reset_fault_injector()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read()


def _post(port, doc):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/submit",
                                 data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# -- the per-rank server ---------------------------------------------------------------


def test_server_absent_without_port():
    assert not lp.enabled()
    assert lp.ensure_server() is None and lp.server_port() is None


def test_server_never_starts_when_telemetry_disabled(monkeypatch):
    monkeypatch.setenv("IGG_METRICS_PORT", "0")
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    assert not lp.enabled() and lp.ensure_server() is None
    assert lp.heartbeat_tick() == []
    assert tele.snapshot()["gauges"] == {}


def test_ephemeral_port_published(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_METRICS_PORT", "0")
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    server = lp.ensure_server()
    assert server is not None and server.port > 0
    assert lp.ensure_server() is server and lp.server_port() == server.port
    assert tele.snapshot()["gauges"]["liveplane.port"] == server.port
    doc = json.loads((tmp_path / lp.endpoint_filename(0)).read_text())
    assert doc["port"] == server.port and doc["rank"] == 0 and doc["host"] == "127.0.0.1"
    # the server thread is a daemon, and stop_server ends it
    assert server._thread.daemon
    lp.stop_server()
    assert lp.server_port() is None and not server._thread.is_alive()


def test_metrics_endpoint_byte_identical_to_dump(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_METRICS_PORT", "0")
    tele.counter("lp.test_total").inc(3)
    tele.gauge("lp.gauge").set(2.5)
    for v in (1.0, 2.0, 3.0):
        tele.histogram("lp.hist").record(v)
    port = lp.start_server().port
    body = _get(port, "/metrics").decode()
    _json_path, prom_path = tele.dump_metrics(str(tmp_path / "m"))
    assert body == open(prom_path).read()
    assert "igg_lp_test_total_total" in body


def test_healthz_and_spans_endpoints(monkeypatch):
    monkeypatch.setenv("IGG_METRICS_PORT", "0")
    tele.note_progress("diffusion3d", 7)
    with tracing.trace_span("lp.done", step=1):
        pass
    port = lp.start_server().port
    h = json.loads(_get(port, "/healthz"))
    assert h["ok"] is True and h["rank"] == 0 and h["uptime_s"] >= 0
    assert h["last_step"]["kind"] == "diffusion3d" and h["last_step"]["step"] == 7
    assert h["guard"]["trips"] == 0
    assert h["alerts"] == {"active": [], "recent": [], "fired_total": 0}
    assert "skew" not in h and "serving" not in h
    s = json.loads(_get(port, "/spans"))
    assert [x["name"] for x in s["spans"]] == ["lp.done"] and s["open"] == []


def test_unknown_endpoint_404(monkeypatch):
    monkeypatch.setenv("IGG_METRICS_PORT", "0")
    port = lp.start_server().port
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nope")
    assert e.value.code == 404


def test_health_snapshot_equals_jax_on_the_same_snapshot():
    """`health_snapshot` of one registry snapshot is the JAX package's
    document (up to the process's uptime), sections and all."""
    for mod in (tele, jtele):
        mod.gauge("serving.active_members").set(2)
        mod.gauge("serving.capacity").set(4)
        mod.gauge("frontdoor.port").set(1234)
        mod.counter("frontdoor.requests_total").inc(3)
        mod.counter("frontdoor.rejected.slo").inc(1)
        mod.counter("frontdoor.tenant.tA.admitted").inc(2)
        mod.gauge("skew.step_seconds_max_over_min").set(1.5)
        for v in (0.1, 0.2):
            mod.histogram("serving.round_seconds").record(v)
    snap = tele.snapshot()
    mine, ref = lp.health_snapshot(snap), jlp.health_snapshot(snap)
    for doc in (mine, ref):
        doc.pop("uptime_s")
    assert mine == ref
    assert {"serving", "frontdoor", "skew", "slo", "alerts"} <= set(mine)


# -- rolling SLO gauges ---------------------------------------------------------------


def test_publish_slo_gauges():
    for v in (0.1, 0.2, 0.3):
        tele.histogram("m.step_seconds").record(v)
    tele.histogram("m.unrelated").record(1.0)
    assert set(lp.publish_slo_gauges()) == {"m.step_seconds"}
    g = tele.snapshot()["gauges"]
    assert g["slo.m.step_seconds.p50"] == pytest.approx(0.2)
    assert g["slo.m.step_seconds.p99"] == pytest.approx(0.3)
    assert not any(k.startswith("slo.m.unrelated") for k in g)


def test_publish_slo_gauges_disabled_is_noop(monkeypatch):
    monkeypatch.setenv("IGG_TELEMETRY", "0")
    assert lp.publish_slo_gauges() == {}


# -- the rule engine ------------------------------------------------------------------


class _FlagRule(lp.Rule):
    name = "flag"
    severity = "critical"

    def __init__(self):
        self.on = False

    def check(self, ctx):
        return {"why": "flag"} if self.on else None


def test_engine_latches_one_event_per_episode(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    rule = _FlagRule()
    eng = lp.RuleEngine(rules=[rule])
    assert eng.tick() == []
    rule.on = True
    (a,) = eng.tick()
    assert a["rule"] == "flag" and a["severity"] == "critical"
    assert a["rank"] == 0 and a["evidence"] == {"why": "flag"}
    assert eng.tick() == []
    assert [x["rule"] for x in eng.active_alerts()] == ["flag"]
    rule.on = False
    eng.tick()
    assert eng.active_alerts() == []
    rule.on = True
    assert len(eng.tick()) == 1
    alerts = [e for e in tele.read_events(tmp_path / "events.jsonl") if e["type"] == "alert.flag"]
    assert len(alerts) == 2
    assert alerts[0]["severity"] == "critical" and alerts[0]["evidence"] == {"why": "flag"}
    assert tele.snapshot()["counters"]["alerts.fired_total"] == 2


def test_engine_subscribers_and_cursor():
    rule = _FlagRule()
    eng = lp.RuleEngine(rules=[rule])
    seen = []
    eng.subscribe(seen.append)
    rule.on = True
    eng.tick()
    assert len(seen) == 1 and seen[0]["rule"] == "flag"
    seq, fresh = eng.alerts_since(0)
    assert len(fresh) == 1 and seq == 1
    assert eng.alerts_since(seq) == (seq, [])
    eng.unsubscribe(seen.append)
    rule.on = False
    eng.tick()
    rule.on = True
    eng.tick()
    assert len(seen) == 1


def test_module_level_engine_wiring():
    rule = _FlagRule()
    lp.get_engine().rules[:] = []
    lp.register_rule(rule)
    seen = []
    lp.subscribe(seen.append)
    rule.on = True
    assert lp.heartbeat_tick(model="m")[0]["rule"] == "flag"
    assert lp.alerts_since(0)[0] == 1 and len(seen) == 1
    lp.unsubscribe(seen.append)


def test_broken_rule_never_breaks_the_tick():
    class Broken(lp.Rule):
        name = "broken"

        def check(self, ctx):
            raise RuntimeError("boom")

    rule = _FlagRule()
    rule.on = True
    assert [a["rule"] for a in lp.RuleEngine(rules=[Broken(), rule]).tick()] == ["flag"]


def _ctx(histograms=None, gauges=None, progress=None, rss=None, source="heartbeat", rank=0):
    return {"now": 0.0, "source": source, "model": None,
            "snapshot": {"rank": rank, "histograms": histograms or {}, "gauges": gauges or {},
                         "counters": {}},
            "progress": progress, "rss": rss}


def test_default_rules_keep_the_jax_names_severities_and_thresholds():
    def spec(rule):
        return (type(rule).__name__, rule.name, rule.severity,
                {k: v for k, v in vars(rule).items() if not k.startswith("_")})

    assert [spec(r) for r in lp.default_rules()] == [spec(r) for r in jlp.default_rules()]
    assert lp.ALERTS_KEEP == jlp.ALERTS_KEEP


def test_teff_drop_rule_self_prior_and_reconcile_prior():
    rule = lp.TeffDropRule(0.5)
    hist = {"diffusion3d.t_eff_gbs": {"count": 50, "p90": 100.0,
                                      "window": {"count": 10, "p50": 30.0}}}
    ev = rule.check(_ctx(histograms=hist))
    assert ev and ev["expectation_source"] == "lifetime_p90" and ev["expected_gbs"] == 100.0
    lp.set_teff_expectation("diffusion3d", 40.0)
    assert rule.check(_ctx(histograms=hist)) is None
    lp.set_teff_expectation("diffusion3d", 200.0)
    ev = rule.check(_ctx(histograms=hist))
    assert ev and ev["expectation_source"] == "reconcile"
    assert lp.teff_expectation("diffusion3d") == 200.0
    hist["diffusion3d.t_eff_gbs"]["window"]["count"] = 2
    assert rule.check(_ctx(histograms=hist)) is None
    lp.set_teff_expectation("diffusion3d", None)
    assert lp.teff_expectation("diffusion3d") is None


def test_skew_sustained_rule_fires_on_slowest_rank_only():
    rule = lp.SkewSustainedRule(k=2)
    gauges = {"skew.step_seconds_max_over_min": 5.0, "skew.slowest_rank": 0}
    assert rule.check(_ctx(gauges=gauges)) is None
    assert rule.check(_ctx(gauges=gauges, source="scrape")) is None
    ev = rule.check(_ctx(gauges=gauges))
    assert ev and ev["ratio"] == 5.0 and ev["windows"] == 2
    gauges["skew.slowest_rank"] = 1
    assert rule.check(_ctx(gauges=gauges)) is None
    assert rule.check(_ctx(gauges=gauges)) is None


def test_convergence_stall_rule():
    rule = lp.ConvergenceStallRule(k=2, gauge="serving.pt_residual_min")
    g = {"serving.pt_residual_min": 1.0}
    assert rule.check(_ctx(gauges=g)) is None
    g["serving.pt_residual_min"] = 0.5
    assert rule.check(_ctx(gauges=g)) is None
    assert rule.check(_ctx(gauges=g)) is None
    ev = rule.check(_ctx(gauges=g))
    assert ev and ev["residual"] == 0.5 and ev["windows"] == 2
    g.clear()
    assert rule.check(_ctx(gauges=g)) is None


def test_convergence_stall_rule_population_changes():
    rule = lp.ConvergenceStallRule(k=2, gauge="serving.pt_residual_min")
    g = {"serving.pt_residual_min": 0.5, "serving.pt_residual_watched": 0}
    for _ in range(4):
        assert rule.check(_ctx(gauges=g)) is None
    g["serving.pt_residual_watched"] = 1
    assert rule.check(_ctx(gauges=g)) is None
    assert rule.check(_ctx(gauges=g)) is None
    assert rule.check(_ctx(gauges=g))
    g["serving.pt_residual_min"] = 5.0
    assert rule.check(_ctx(gauges=g)) is None
    assert rule.check(_ctx(gauges=g)) is None
    assert rule.check(_ctx(gauges=g))


def test_step_stall_rule_deadline_and_gates(monkeypatch):
    rule = lp.StepStallRule(floor_s=1.0, factor=20.0)
    prog = {"kind": "m", "step": 3, "age_s": 5.0, "init": False, "done": False}
    ev = rule.check(_ctx(progress=dict(prog), source="scrape"))
    assert ev and ev["age_s"] == 5.0 and ev["deadline_s"] == 1.0
    hist = {"m.step_seconds": {"p50": 0.5, "count": 9, "window": {"p50": 0.5, "count": 9}}}
    assert rule.check(_ctx(histograms=hist, progress=dict(prog))) is None
    monkeypatch.setenv("IGG_WATCHDOG_S", "2")
    ev = rule.check(_ctx(histograms=hist, progress=dict(prog)))
    assert ev and ev["deadline_s"] == 2.0
    monkeypatch.delenv("IGG_WATCHDOG_S")
    assert rule.check(_ctx(progress={**prog, "init": True})) is None
    assert rule.check(_ctx(progress={**prog, "done": True})) is None
    assert rule.check(_ctx(progress=None)) is None
    # a serving round's deadline reads the round latency histogram
    rounds = {"serving.round_seconds": {"p50": 0.2, "window": {"p50": 0.2}}}
    sprog = {**prog, "kind": "serving.round", "age_s": 3.5}
    assert rule.check(_ctx(histograms=rounds, progress=sprog)) is None
    assert rule.check(_ctx(histograms=rounds, progress={**sprog, "age_s": 4.5}))


def test_rss_growth_rule():
    rule = lp.RssGrowthRule(factor=1.5, min_bytes=1000)
    base = 100_000
    assert rule.check(_ctx(rss=base)) is None
    assert rule.check(_ctx(rss=base + 500)) is None
    ev = rule.check(_ctx(rss=base * 2))
    assert ev and ev["baseline_bytes"] == base and ev["growth"] == 2.0
    small = lp.RssGrowthRule(factor=1.5, min_bytes=10**9)
    assert small.check(_ctx(rss=base)) is None and small.check(_ctx(rss=base * 10)) is None


def _random_contexts(seed: int, n: int = 300):
    """A seeded walk of rule contexts that crosses every default rule's
    threshold both ways."""
    rng = np.random.default_rng(seed)
    out, rss, resid, age = [], 10**8, 1.0, 0.0
    for _ in range(n):
        rss = int(rss * rng.choice([1.0, 1.0, 1.3, 0.8]))
        resid = float(resid * rng.choice([1.0, 1.0, 1.0, 0.5, 3.0]))
        age = float(rng.choice([0.0, 0.2, 1.5, 30.0]))
        teff = {"count": int(rng.integers(0, 60)), "p90": 100.0,
                "window": {"count": int(rng.integers(0, 12)),
                           "p50": float(rng.uniform(10, 120))}}
        gauges = {"skew.step_seconds_max_over_min": float(rng.choice([0.5, 3.0, 3.0, 4.0])),
                  "skew.slowest_rank": int(rng.choice([0, 0, 0, 1])),
                  "serving.pt_residual_min": resid,
                  "serving.pt_residual_watched": int(rng.choice([0, 1, 1, 2]))}
        hist = {"diffusion3d.t_eff_gbs": teff,
                "diffusion3d.step_seconds": {"p50": float(rng.uniform(0.001, 0.2))}}
        progress = {"kind": "diffusion3d", "step": 1, "age_s": age,
                    "init": bool(rng.random() < 0.1), "done": bool(rng.random() < 0.1)}
        out.append(_ctx(histograms=hist, gauges=gauges, progress=progress, rss=rss,
                        source=str(rng.choice(["heartbeat", "heartbeat", "scrape"]))))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_default_rules_give_jax_evidence_on_the_same_contexts(seed):
    mine, ref = lp.default_rules(), jlp.default_rules()
    fired = set()
    for ctx in _random_contexts(seed):
        for a, b in zip(mine, ref):
            ev = a.check(ctx)
            assert ev == b.check(ctx), (a.name, ctx)
            if ev is not None:
                fired.add(a.name)
    assert fired == {r.name for r in mine}  # every rule crossed its threshold


@pytest.mark.parametrize("seed", range(2))
def test_rule_engines_fire_the_same_alerts_over_the_same_records(seed, monkeypatch):
    """Both engines, ticked over registries fed the same records (and the
    same progress record), fire the same alert sequence."""
    monkeypatch.setenv("IGG_SLO_WINDOW_S", "1000")
    rng = np.random.default_rng(seed)
    engines = (lp.RuleEngine(), jlp.RuleEngine())
    fired = ([], [])
    for i in range(60):
        # T_eff drops to a fifth after 25 steps; a straggler streak at 10-19
        gbs = (100.0 if i < 25 else 20.0) * float(rng.uniform(0.9, 1.1))
        ratio = 3.0 if 10 <= i < 20 else 1.0
        done = bool(rng.random() < 0.2)
        for mod in (tele, jtele):
            mod.histogram("diffusion3d.t_eff_gbs").record(gbs)
            mod.histogram("diffusion3d.step_seconds").record(0.01)
            mod.gauge("skew.step_seconds_max_over_min").set(ratio)
            mod.gauge("skew.slowest_rank").set(0)
            mod.note_progress("diffusion3d", i, done=done)
        source = "heartbeat" if i % 3 else "scrape"
        for eng, got, mod in zip(engines, fired, (tele, jtele)):
            snap = mod.snapshot()
            got.extend((a["rule"], a["severity"], a["source"], json.dumps(a["evidence"]))
                       for a in eng.tick(source, snap=snap))
    assert fired[0] == fired[1]
    assert {f[0] for f in fired[0]} >= {"teff_drop", "skew_sustained"}


# -- escalation -------------------------------------------------------------------------


def test_critical_alert_forces_guard_probe(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    T = torch.ones((NX, NX, NX), dtype=F64)
    T[2, 2, 2] = float("nan")
    guard = res.RunGuard(guard_every=0, policy="raise", names=("T",))
    guard.start((T,))
    assert guard.on_step((T,), 1)[1] == 1
    guard.on_alert({"severity": "warn", "rule": "x"})
    assert guard.on_step((T,), 2)[1] == 2
    guard.on_alert({"severity": "critical", "rule": "step_stall"})
    with pytest.raises(res.GuardError):
        guard.on_step((T,), 3)
    probe = [e for e in tele.read_events(tmp_path / "events.jsonl")
             if e["type"] == "guard.alert_probe"]
    assert len(probe) == 1 and probe[0]["rule"] == "step_stall"
    snap = tele.snapshot()
    assert snap["counters"]["resilience.alert_probes"] == 1
    assert snap["counters"]["resilience.guard_trips"] == 1


def test_guarded_time_loop_subscribes_for_loop_lifetime(monkeypatch):
    state, params = diffusion3d.setup(NX, NX, NX, **KW)
    eng = lp.get_engine()
    seen_during = []

    class Probe(lp.Rule):
        name = "probe"
        severity = "warn"

        def check(self, ctx):
            seen_during.append(len(eng._subscribers))

    eng.register(Probe())
    monkeypatch.setenv("IGG_HEARTBEAT_EVERY", "1")
    res.guarded_time_loop(diffusion3d.make_step(params), state, 2,
                          guard=res.RunGuard(guard_every=1, names=("T", "Cp")),
                          model="diffusion3d")
    assert seen_during and all(n == 1 for n in seen_during)
    assert eng._subscribers == []


def test_serving_escalation_evicts_on_single_process(monkeypatch, tmp_path):
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    _, params = diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64)
    loop = ServingLoop(diffusion3d, params, capacity=1, guard_policy="off")
    state, _ = diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64)
    state[0][1, 1, 1] = float("nan")
    m = loop.submit(Request(state=state, max_steps=99))
    loop.run_round()
    assert loop.active_members == 1
    loop._escalate({"rule": "step_stall", "severity": "critical", "evidence": {}})
    assert loop.active_members == 0 and loop.results[m].status == "evicted"
    esc = [e for e in tele.read_events(tmp_path / "events.jsonl")
           if e["type"] == "serving.alert_escalation"]
    assert len(esc) == 1 and esc[0]["rule"] == "step_stall"
    assert tele.snapshot()["counters"]["serving.alert_escalations"] == 1


def test_serving_loop_polls_the_alert_stream_each_round(monkeypatch):
    """A critical alert fired while the pool runs reaches `_escalate` at
    the next round; alerts older than the pool never replay."""
    rule = _FlagRule()
    lp.get_engine().rules[:] = [rule]
    rule.on = True
    lp.get_engine().tick()  # fired before the pool exists
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    _, params = diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64)
    loop = ServingLoop(diffusion3d, params, capacity=1)
    seen = []
    monkeypatch.setattr(loop, "_escalate", seen.append)
    loop.submit(Request(state=diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64)[0],
                        max_steps=3))
    loop.run_round()
    assert seen == []
    rule.on = False
    lp.get_engine().tick()
    rule.on = True
    lp.get_engine().tick()
    loop.run_round()
    assert [a["rule"] for a in seen] == ["flag"]


def test_serving_round_records_latency_and_residual_gauge():
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    s, params = porous_convection3d.setup(NX, NX, NX, init_grid=False, npt=3, dtype=F64)
    loop = ServingLoop(porous_convection3d, params, capacity=1, steps_per_round=1)
    loop.submit(Request(state=s, max_steps=2, tol=1e-30, tenant="t"))
    loop.run(max_rounds=3)
    snap = tele.snapshot()
    assert snap["histograms"]["serving.round_seconds"]["count"] >= 2
    assert "window" in snap["histograms"]["serving.round_seconds"]
    assert snap["gauges"]["serving.pt_residual_min"] > 0
    assert snap["gauges"]["serving.pt_residual_watched"] == 0


def test_serving_heartbeat_ticks_the_live_plane(monkeypatch):
    monkeypatch.setenv("IGG_HEARTBEAT_EVERY", "1")
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    _, params = diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64)
    loop = ServingLoop(diffusion3d, params, capacity=1)
    loop.submit(Request(state=diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64)[0],
                        max_steps=2))
    loop.run(max_rounds=3)
    g = tele.snapshot()["gauges"]
    assert g["proc.rss_bytes"] > 0 and "slo.serving.round_seconds.p50" in g


def test_healthz_reflects_alerts_and_slo(monkeypatch):
    monkeypatch.setenv("IGG_METRICS_PORT", "0")
    rule = _FlagRule()
    lp.get_engine().rules[:] = [rule]
    for v in (0.1, 0.2):
        tele.histogram("m.step_seconds").record(v)
    rule.on = True
    port = lp.start_server().port
    doc = json.loads(_get(port, "/healthz"))
    assert doc["ok"] is False
    assert [a["rule"] for a in doc["alerts"]["active"]] == ["flag"]
    assert doc["alerts"]["fired_total"] == 1
    assert doc["slo"]["m.step_seconds"]["count"] == 2


# -- the front door's rule-armed tests ---------------------------------------------------


def _pool(capacity=2, steps_per_round=1):
    tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu")
    _, params = diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64)
    return ServingLoop(diffusion3d, params, capacity=capacity, steps_per_round=steps_per_round)


def test_gauge_view_reads_live_registry_and_alerts():
    tele.gauge("serving.queue_depth").set(7)
    tele.gauge("serving.active_members").set(3)
    tele.gauge("serving.capacity").set(4)
    view = adm.gauge_view(tick=False)
    assert view["queue_depth"] == 7 and view["active_members"] == 3
    assert view["capacity"] == 4 and view["critical_alert"] is False

    class Critical(lp.Rule):
        name = "crit"
        severity = "critical"

        def check(self, ctx):
            return {"why": "test"}

    lp.get_engine().rules[:] = [Critical()]
    assert adm.gauge_view(tick=False)["critical_alert"] is False
    assert adm.gauge_view()["critical_alert"] is True


def test_slo_breach_flips_backpressure_live():
    fd = FrontDoor(_pool(capacity=1), port=0, setup_kwargs={"dtype": F64})
    try:
        class Critical(lp.Rule):
            name = "step_stall"
            severity = "critical"
            on = False

            def check(self, ctx):
                return {"why": "wedged"} if self.on else None

        rule = Critical()
        lp.get_engine().rules[:] = [rule]
        doc = {"tenant": "tA", "params": {"max_steps": 2}}
        assert _post(fd.port, doc)[0] == 202
        rule.on = True
        lp.get_engine().tick()
        code, body = _post(fd.port, doc)
        assert code == 429 and body["reason"] == "slo"
        assert tele.snapshot()["counters"]["frontdoor.rejected.slo"] == 1
        health = json.loads(_get(fd.port, "/healthz"))
        assert health["ok"] is False and health["alerts"]["active"][0]["rule"] == "step_stall"
        rule.on = False
        lp.get_engine().tick()
        assert _post(fd.port, doc)[0] == 202
    finally:
        fd.close()


def test_autoscaler_sees_alerts_through_the_door_subscription(tmp_path):
    from implicitglobalgrid_tpu_torch.serving import AutoscalePolicy, Autoscaler, Rung

    asc = Autoscaler(AutoscalePolicy(ladder=(Rung(1, 1), Rung(1, 2))))
    fd = FrontDoor(_pool(capacity=1), port=0, autoscaler=asc, checkpoint_dir=str(tmp_path),
                   setup_kwargs={"dtype": F64})
    rule = _FlagRule()
    lp.get_engine().rules[:] = [rule]
    try:
        rule.on = True
        lp.get_engine().tick()
        assert asc.status()["last_alert"]["rule"] == "flag"
    finally:
        fd.close()
    assert asc.on_alert not in lp.get_engine()._subscribers


# -- the step-stall drill on both doors --------------------------------------------------

#: the two packages' pieces of the drill
PACKAGES = {
    "torch": SimpleNamespace(
        igg=tigg, tele=tele, lp=lp, res=res, Loop=ServingLoop, Door=FrontDoor,
        Request=Request,
        pool=lambda: (tigg.init_global_grid(NX, NX, NX, quiet=True, device="cpu"),
                      diffusion3d.setup(NX, NX, NX, init_grid=False, dtype=F64))[1],
        model=diffusion3d, door_kw={"setup_kwargs": {"dtype": F64}}),
    "jax": SimpleNamespace(
        igg=jigg, tele=jtele, lp=jlp, res=jres, Loop=JServingLoop, Door=JFrontDoor,
        Request=JRequest,
        pool=lambda: (jigg.init_global_grid(NX, NX, NX, quiet=True),
                      jdiffusion.setup(NX, NX, NX, init_grid=False))[1],
        model=jdiffusion, door_kw={}),
}

DRILL_SUBMIT = {"tenant": "drill", "model": "diffusion3d", "params": {"max_steps": 8}}


def stall_drill(pkg, tmp_path, monkeypatch, warm_rounds=3, stall_round=3):
    """``IGG_FAULT_INJECT=stall:step<stall_round>`` on a door of one
    package: POST, ``warm_rounds`` rounds (so the round latency's p50 is a
    warm round's), then the serving thread wedges in the stall while the
    main thread POSTs once the last round is older than the step-stall
    rule's deadline (read from the rule, floor 1 s), and POSTs again after
    the stalled round.  Returns the verdicts and the alert events."""
    monkeypatch.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("IGG_FAULT_INJECT", f"stall:step{stall_round}")
    pkg.res.reset_fault_injector()
    _, params = pkg.pool()
    loop = pkg.Loop(pkg.model, params, capacity=2, steps_per_round=1)
    fd = pkg.Door(loop, port=0, **pkg.door_kw)
    verdicts = []

    def post():
        code, body = _post(fd.port, DRILL_SUBMIT)
        verdicts.append((code, body.get("reason")))

    try:
        post()
        assert fd.serve_rounds(max_rounds=warm_rounds) == "rounds"
        snap = pkg.tele.snapshot()
        rule = pkg.lp.StepStallRule()
        deadline = rule._deadline({"snapshot": snap}, "serving.round")
        monkeypatch.setattr(pkg.res.FaultInjector, "STALL_S", deadline + 2.5)
        stalled = threading.Thread(target=fd.serve_rounds, kwargs={"max_rounds": 1},
                                   daemon=True)
        stalled.start()
        while pkg.tele.last_progress()["age_s"] < deadline + 0.5:
            time.sleep(0.02)
        assert stalled.is_alive()
        post()
        stalled.join(timeout=60)
        assert not stalled.is_alive() and loop.rounds == warm_rounds + 1
        time.sleep(0.2)  # past the admission view's cache
        post()
    finally:
        fd.close()
    events = pkg.tele.read_events(tmp_path / "events.jsonl")
    alerts = [(e["type"], e["severity"], e["source"]) for e in events
              if e["type"].startswith("alert.")]
    return verdicts, alerts, deadline


def test_step_stall_drill_gives_the_same_verdicts_on_both_doors(tmp_path, monkeypatch):
    got = {}
    for name, pkg in PACKAGES.items():
        got[name] = stall_drill(pkg, tmp_path / name, monkeypatch)
        if pkg.igg.grid_is_initialized():
            pkg.igg.finalize_global_grid()
    for verdicts, alerts, deadline in got.values():
        assert deadline >= 1.0  # the rule's floor (20 warm rounds' p50 sets it if above)
        assert verdicts == [(202, None), (429, "slo"), (202, None)]
        assert alerts == [("alert.step_stall", "critical", "scrape")]
    assert got["torch"][:2] == got["jax"][:2]
