"""The port's fleet tier (`fleet`) against the JAX package's.

Every scenario of the JAX package's ``tests/test_fleet.py`` runs through
both packages, with fakes at every I/O seam (spawn, transport, scrape: no
sockets, no subprocesses), and the host records must agree exactly: the
decisions, the routed pools and request ids, the canary states and
breaches, the event sequences (types and their pool, kind and epoch
fields) and the counters.  The JAX test's own assertions then run on the
port's record.  Port-only: a pool's device subset becomes its process's
``CUDA_VISIBLE_DEVICES``, and the port's front door refuses a superseded
pool's endpoint file.
"""

import itertools
import json
import os
import time
import types

import pytest

import implicitglobalgrid_tpu.fleet as jfleet
import implicitglobalgrid_tpu_torch.fleet as tfleet
from implicitglobalgrid_tpu.fleet import canary as jcan
from implicitglobalgrid_tpu.fleet import controller as jctl
from implicitglobalgrid_tpu.fleet import policy as jpol
from implicitglobalgrid_tpu.fleet import router as jrtr
from implicitglobalgrid_tpu.supervisor import generation as jgen
from implicitglobalgrid_tpu.supervisor.classify import Incident as JIncident
from implicitglobalgrid_tpu.utils import telemetry as jtele
from implicitglobalgrid_tpu_torch.fleet import canary as tcan
from implicitglobalgrid_tpu_torch.fleet import controller as tctl
from implicitglobalgrid_tpu_torch.fleet import policy as tpol
from implicitglobalgrid_tpu_torch.fleet import router as trtr
from implicitglobalgrid_tpu_torch.supervisor import generation as tgen
from implicitglobalgrid_tpu_torch.supervisor.classify import Incident as TIncident
from implicitglobalgrid_tpu_torch.utils import telemetry as ttele

JAX = types.SimpleNamespace(name="jax", fleet=jfleet, can=jcan, ctl=jctl, pol=jpol, rtr=jrtr,
                            gen=jgen, Incident=JIncident, tele=jtele)
PORT = types.SimpleNamespace(name="port", fleet=tfleet, can=tcan, ctl=tctl, pol=tpol, rtr=trtr,
                             gen=tgen, Incident=TIncident, tele=ttele)


@pytest.fixture
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("IGG_"):
            monkeypatch.delenv(k)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    ttele.reset()
    jtele.reset()
    yield monkeypatch
    ttele.reset()
    jtele.reset()


def both(run, clean_env, tmp_path):
    """``run(pkg, dir)`` for each package in a directory and telemetry dir
    of its own; returns (port record, JAX record)."""
    out = {}
    for pkg in (PORT, JAX):
        d = tmp_path / pkg.name
        d.mkdir()
        clean_env.setenv("IGG_TELEMETRY_DIR", str(d / "fleet-telem"))
        pkg.tele.reset()
        out[pkg.name] = run(pkg, d)
        clean_env.delenv("IGG_TELEMETRY_DIR")
    return out["port"], out["jax"]


_EVENT_KEYS = ("type", "pool", "kind", "action", "requests", "owner", "owner_epoch",
               "observations", "spill", "canary", "state", "streak")


def events(pkg, d):
    """The fleet events of ``d`` without timestamps, pids or paths."""
    path = d / "fleet-telem" / "events.jsonl"
    if not path.is_file():
        return []
    return [{k: e[k] for k in _EVENT_KEYS if k in e} for e in pkg.tele.read_events(path)]


def counters(pkg):
    return {k: v for k, v in pkg.tele.snapshot()["counters"].items() if k.startswith(("fleet",
                                                                                       "fence"))}


def _incident(pkg, kind, pool="a", **detail):
    return pkg.Incident(kind=kind, ranks=(), rcs=(), detail={"pool": pool, **detail})


def _health(queue=0, members=1, cap=2, p99=0.01, ok=True, alerts=()):
    return {
        "ok": ok,
        "serving": {"queue_depth": queue, "active_members": members, "capacity": cap},
        "slo": {"slo.serving.round_seconds": {"p99": p99, "count": 5}},
        "alerts": {"active": [{"rule": r, "severity": "critical"} for r in alerts]},
    }


def _decision(d):
    return (d.action, d.pool, d.reason, d.quarantined)


def _route(route):
    """A route without its minted trace context (random ids)."""
    out = {k: v for k, v in route.items() if k not in ("trace", "t0")}
    out["spec"] = {k: v for k, v in route["spec"].items() if k != "trace"}
    return out


# -- policy -------------------------------------------------------------------


def test_fleet_policy_env_tier_and_validation(clean_env):
    assert tpol.FleetPolicy() == tpol.FleetPolicy.from_env()
    clean_env.setenv("IGG_FLEET_RESPAWN_LIMIT", "5")
    clean_env.setenv("IGG_FLEET_SPILL_QUEUE", "9")
    clean_env.setenv("IGG_FLEET_CANARY_P99_S", "0.75")
    pol = tpol.FleetPolicy.from_env(canary_streak=4)
    assert pol.respawn_limit == 5 and pol.spill_queue == 9
    assert pol.canary_p99_s == 0.75 and pol.canary_streak == 4 and pol.idle_retire is None
    assert vars(pol) == vars(jpol.FleetPolicy.from_env(canary_streak=4))
    for bad in ({"respawn_limit": -1}, {"spill_queue": 0}, {"idle_retire": 0},
                {"canary_streak": 0}, {"canary_p99_s": 0.0}):
        with pytest.raises(ValueError):
            tpol.FleetPolicy(**bad)
    clean_env.setenv("IGG_FLEET_IDLE_RETIRE", "0")
    with pytest.raises(ValueError, match="IGG_FLEET_IDLE_RETIRE"):
        tpol.FleetPolicy.from_env()


def _respawn_run(pkg):
    policy, state = pkg.pol.FleetPolicy(respawn_limit=2), pkg.pol.FleetState()
    out = []
    for kind in ("died", "died", "wedged"):
        d = pkg.fleet.decide_pool(_incident(pkg, kind, devices="devA"), state, policy)
        out.append(_decision(d))
        state.apply(d)
    out.append(sorted(state.quarantined_devices))
    state.apply(pkg.pol.FleetDecision(action="none", pool="a", reason="ok"))
    out.append(_decision(pkg.fleet.decide_pool(_incident(pkg, "died"), state, policy)))
    out.append(_decision(pkg.fleet.decide_pool(_incident(pkg, "sdc", devices="devB"), state,
                                               policy)))
    return out


def _spill_run(pkg):
    state = pkg.pol.FleetState()
    spill = pkg.pol.FleetPolicy(spill_queue=4, idle_retire=2)
    out = [_decision(pkg.fleet.decide_pool(_incident(pkg, "hot", queue_depth=6), state, spill)),
           _decision(pkg.fleet.decide_pool(_incident(pkg, "hot"), state, pkg.pol.FleetPolicy()))]
    for _ in range(2):
        state.record_health("a", queue_depth=0, active_members=0)
    for spilled in (False, True):
        out.append(_decision(pkg.fleet.decide_pool(_incident(pkg, "idle"), state, spill,
                                                   spilled=spilled)))
    state.record_health("a", queue_depth=1, active_members=1)
    out.append(_decision(pkg.fleet.decide_pool(_incident(pkg, "idle"), state, spill,
                                               spilled=True)))
    return out


@pytest.mark.parametrize("run", [_respawn_run, _spill_run], ids=["respawn", "spill"])
def test_decide_pool_matches_jax(run):
    got = run(PORT)
    assert got == run(JAX)
    if run is _respawn_run:
        assert [g[0] for g in got[:3]] == ["respawn", "respawn", "quarantine"]
        assert got[2][3] == ("devA",) and got[3] == ["devA"] and got[4][0] == "respawn"
        assert got[5][0] == "quarantine"  # sdc skips the strikes
    else:
        assert [g[0] for g in got] == ["spill", "none", "none", "retire", "none"]
    with pytest.raises(ValueError, match="pool"):
        tfleet.decide_pool(TIncident(kind="died", ranks=(), rcs=(), detail={}),
                           tpol.FleetState(), tpol.FleetPolicy())


def test_fleet_plan_matches_jax():
    assert tpol.FLEET_ACTIONS == jpol.FLEET_ACTIONS
    for action in tpol.FLEET_ACTIONS:
        for root in (True, False):
            for stale in (True, False):
                assert tfleet.fleet_plan(root, action, stale) == \
                    jfleet.fleet_plan(root, action, stale)
        assert tfleet.fleet_plan(True, action, True) == ()
    assert tfleet.fleet_plan(True, "respawn", False) == (("broadcast_control", "adopt-replay"),)


# -- router -------------------------------------------------------------------


class _FakeDoor:
    def __init__(self):
        self.next_rid = 0
        self.submits = []
        self.results = {}
        self.dead = False


def _fake_fleet(pkg, healths):
    doors = {}

    def transport(endpoint, method, path, doc):
        door = doors.setdefault(endpoint, _FakeDoor())
        if door.dead:
            return 0, {}
        if method == "POST" and path == "/v1/submit":
            rid = f"r{door.next_rid:06d}"
            door.next_rid += 1
            door.submits.append((rid, dict(doc)))
            return 202, {"request_id": rid}
        if method == "GET" and path.startswith("/v1/result/"):
            rid = path.rsplit("/", 1)[1]
            if rid in door.results:
                return 200, {"status": "done", **door.results[rid]}
            return 200, {"request_id": rid, "status": "pending"}
        if method == "POST" and path == "/v1/shutdown":
            return 200, {}
        return 404, {}

    router = pkg.rtr.FleetRouter(serve=False, transport=transport,
                                 scrape=lambda ep: healths.get(ep))
    return router, doors


def _choose_run(pkg):
    def cand(name, *, q=0, m=0, p99=0.0, quarantined=False, key=None, unreachable=False):
        return {"name": name, "key": key or {}, "quarantined": quarantined,
                "health": pkg.rtr.pool_health_view(
                    None if unreachable else _health(queue=q, members=m, p99=p99))}

    doc = {"model": "diffusion3d", "tenant": "t"}
    cands = [cand("c", q=1), cand("b"), cand("a"), cand("quar", quarantined=True),
             cand("dark", unreachable=True), cand("other", key={"model": "acoustic3d"})]
    sized = [cand("s", key={"model": "diffusion3d", "size": [8, 8, 8]})]
    return [
        pkg.rtr.choose_pool(doc, cands), pkg.rtr.choose_pool(doc, cands),
        pkg.rtr.choose_pool(doc, [cand("b", q=2, m=2), cand("c", q=2, m=1)]),
        pkg.rtr.choose_pool(doc, [cand("x", key={"model": "acoustic3d"})]),
        pkg.rtr.choose_pool(dict(doc, size=[8, 8, 8]), sized),
        pkg.rtr.choose_pool(dict(doc, size=[16, 8, 8]), sized),
        pkg.rtr.choose_pool(doc, [cand("p", p99=0.5), cand("q", p99=0.1)]),
        [pkg.rtr.pool_health_view(h) for h in (None, _health(queue=3, p99=0.2),
                                                _health(ok=False, alerts=("step_stall",)))],
    ]


def test_choose_pool_matches_jax():
    got = _choose_run(PORT)
    assert got == _choose_run(JAX)
    assert got[:6] == ["a", "a", "c", None, "s", None]


def _router_run(pkg, d):
    healths = {"a:1": _health(queue=0), "b:2": _health(queue=3)}
    router, doors = _fake_fleet(pkg, healths)
    router.register_pool("a", "a:1", key={"model": "diffusion3d"})
    router.register_pool("b", "b:2", key={"model": "diffusion3d"})
    doc = {"tenant": "t", "model": "diffusion3d", "params": {"max_steps": 2}}
    out = [router.submit(doc), router.result("f000000")]
    doors["a:1"].results["r000000"] = {"result": "completed", "steps": 2}
    out.append(router.result("f000000"))
    doors["a:1"].dead = True
    out += [router.result("f000000"), router.result("f999999")[0], router.submit(doc)]
    doors["b:2"].dead = True
    out.append(router.submit(doc))
    return out, events(pkg, d), counters(pkg)


def test_router_submit_sticky_result_and_failover_match_jax(clean_env, tmp_path):
    got, want = both(_router_run, clean_env, tmp_path)
    assert got == want
    out, evs, cnt = got
    assert out[0] == (202, {"request_id": "f000000", "pool": "a"})
    assert out[1][0] == 200 and out[1][1]["status"] == "pending"
    assert out[2][1]["status"] == "done" and out[2][1]["pool"] == "a"
    assert out[3][0] == 200 and out[3][1]["result"] == "completed"  # cached
    assert out[4] == 404 and out[5][0] == 202 and out[5][1]["pool"] == "b"
    assert out[6][0] == 503 and "tried" in out[6][1]
    assert [e["pool"] for e in evs if e["type"] == "fleet.route"] == ["a", "b"]
    assert any(e["type"] == "fleet.pool_unreachable" and e["pool"] == "a" for e in evs)
    assert cnt["fleet.routed_total"] == 2 and cnt["fleet.unroutable_total"] == 1


def _evacuate_run(pkg, d):
    router, doors = _fake_fleet(pkg, {"a:1": _health(), "b:2": _health(queue=1)})
    router.register_pool("a", "a:1")
    router.register_pool("b", "b:2")
    fid = router.submit({"tenant": "t", "params": {"max_steps": 2}})[1]["request_id"]
    out = [fid, _route(router.routes[fid]), router.evacuate("a"), _route(router.routes[fid]),
           {k: v for k, v in doors["b:2"].submits[-1][1].items() if k != "trace"},
           router.adopt_result(fid, "a", 0, {"result": "completed"}),
           router.routes[fid]["done"],
           router.adopt_result(fid, "b", 1, {"result": "completed"})]
    return out, events(pkg, d), counters(pkg)


def test_router_evacuate_rejects_zombie_result_matches_jax(clean_env, tmp_path):
    got, want = both(_evacuate_run, clean_env, tmp_path)
    assert got == want
    (fid, before, moved, after, spec, zombie, done, adopted), evs, cnt = got
    assert before["pool"] == "a" and moved == [fid]
    assert after["pool"] == "b" and after["epoch"] == 1
    assert spec["params"] == {"max_steps": 2}
    assert not zombie and done is None and adopted
    assert [e["requests"] for e in evs if e["type"] == "fleet.reroute"][0] == [fid]
    z = [e for e in evs if e["type"] == "fleet.zombie_result"]
    assert z and (z[0]["pool"], z[0]["owner"], z[0]["owner_epoch"]) == ("a", "b", 1)
    assert cnt["fleet.zombie_results_total"] == 1 and cnt["fleet.rerouted_total"] == 1


# -- canary -------------------------------------------------------------------


def _canary_run(pkg, d, observations, streak):
    tr = pkg.can.CanaryTracker(pool="c", candidate={"overlay": "v2"},
                               policy=pkg.pol.FleetPolicy(canary_streak=streak,
                                                          canary_p99_s=1.0))
    states = [tr.observe(h) for h in observations]
    return states, tr.breach, tr.doc()["state"], events(pkg, d), counters(pkg)


def test_canary_promotes_after_healthy_streak_matches_jax(clean_env, tmp_path):
    obs = [_health(p99=0.2)] * 3 + [None]
    got, want = both(lambda p, d: _canary_run(p, d, obs, 3), clean_env, tmp_path)
    assert got == want
    states, breach, state, evs, cnt = got
    assert states == ["baking", "baking", "promoted", "promoted"] and breach is None
    types = [e["type"] for e in evs]
    assert types[0] == "fleet.canary.start" and types[-1] == "fleet.canary.promote"
    assert types.count("fleet.canary.observe") == 3
    assert cnt["fleet.canary.promotions_total"] == 1


@pytest.mark.parametrize("health,kind", [
    (None, "unreachable"),
    (_health(p99=2.0), "slo"),
    (_health(ok=False, alerts=("step_stall",)), "alert"),
])
def test_canary_rolls_back_on_any_breach_matches_jax(clean_env, tmp_path, health, kind):
    obs = [_health(p99=0.2), health, _health(p99=0.2)]
    got, want = both(lambda p, d: _canary_run(p, d, obs, 2), clean_env, tmp_path)
    assert got == want
    states, breach, state, evs, cnt = got
    assert states == ["baking", "rolled_back", "rolled_back"] and breach["kind"] == kind
    roll = [e for e in evs if e["type"] == "fleet.canary.rollback"]
    assert roll and roll[0]["kind"] == kind and roll[0]["observations"] == 2
    assert cnt["fleet.canary.rollbacks_total"] == 1


def _canary_fence_run(pkg, d, clean_env):
    work, fence = d / "work", d / "fence"
    work.mkdir()
    out = [pkg.can.publish_canary_state(str(work), {"state": "baking"})]
    pkg.gen.publish_generation(2, str(fence))
    clean_env.setenv("IGG_FENCE_DIR", str(fence))
    clean_env.setenv("IGG_GENERATION", "1")
    out.append(pkg.can.publish_canary_state(str(work), {"state": "rolled_back"}))
    out.append(json.loads((work / pkg.can.CANARY_STATE).read_text()))
    clean_env.setenv("IGG_GENERATION", "2")
    out.append(pkg.can.publish_canary_state(str(work), {"state": "promoted"}))
    clean_env.delenv("IGG_FENCE_DIR")
    clean_env.delenv("IGG_GENERATION")
    return out, [e for e in events(pkg, d) if e["type"] == "fence.rejected"], counters(pkg)


def test_superseded_controller_canary_write_refused_matches_jax(clean_env, tmp_path):
    got, want = both(lambda p, d: _canary_fence_run(p, d, clean_env), clean_env, tmp_path)
    assert got == want
    out, rej, cnt = got
    assert out == [True, False, {"state": "baking"}, True]
    assert len(rej) == 1 and cnt["fence.rejected_total"] == 1


def test_superseded_pool_endpoint_file_refused(clean_env, tmp_path):
    """The port's front door of a superseded pool incarnation writes no
    endpoint file (``fence.rejected``)."""
    import torch

    import implicitglobalgrid_tpu_torch as tigg
    from implicitglobalgrid_tpu_torch.models import diffusion3d
    from implicitglobalgrid_tpu_torch.serving import FrontDoor, ServingLoop
    from implicitglobalgrid_tpu_torch.serving import frontdoor as fdm
    from implicitglobalgrid_tpu_torch.utils import liveplane

    telem, fence = tmp_path / "telem", tmp_path / "fence"
    clean_env.setenv("IGG_TELEMETRY_DIR", str(telem))
    tgen.publish_generation(2, str(fence))
    clean_env.setenv("IGG_FENCE_DIR", str(fence))
    clean_env.setenv("IGG_GENERATION", "1")
    tigg.init_global_grid(8, 8, 8, quiet=True, device="cpu")
    try:
        _, params = diffusion3d.setup(8, 8, 8, init_grid=False, dtype=torch.float64)
        loop = ServingLoop(diffusion3d, params, capacity=1, steps_per_round=1)
        fd = FrontDoor(loop, port=0, host="127.0.0.1")
        try:
            assert not (telem / fdm.endpoint_filename(0)).exists()
            rej = [e for e in ttele.read_events(telem / "events.jsonl")
                   if e["type"] == "fence.rejected"]
            assert rej and rej[-1]["what"] == "frontdoor.endpoint"
        finally:
            fd.close()
            liveplane.reset()
    finally:
        tigg.finalize_global_grid()


# -- controller ---------------------------------------------------------------


class _FakeProc:
    def __init__(self):
        self.rc = None

    def poll(self):
        return self.rc

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


def _fleet_fixture(pkg, d, *, pools=("a", "b"), policy=None, healths=None, devices=None):
    healths = healths if healths is not None else {}
    procs, envs = {}, {}
    ports = itertools.count(40001)

    def spawn(argv, env, log_path):
        tdir = env["IGG_TELEMETRY_DIR"]
        os.makedirs(tdir, exist_ok=True)
        port = next(ports)
        with open(os.path.join(tdir, "frontdoor.p0.json"), "w") as f:
            json.dump({"rank": 0, "pid": 1, "host": "127.0.0.1", "port": port,
                       "ts": time.time() + 5.0}, f)
        proc = _FakeProc()
        procs[tdir] = procs[f"127.0.0.1:{port}"] = proc
        envs[argv[1]] = env
        return proc

    def scrape(endpoint):
        if procs.get(endpoint) is not None and procs[endpoint].rc is not None:
            return None
        return healths.get(endpoint, _health())

    router, doors = _fake_fleet(pkg, {})
    router.scrape = scrape
    specs = [
        pkg.ctl.PoolSpec(name=name, command_for=lambda spec, gen: ["pool", spec.name, str(gen)],
                         workdir=str(d / name), telemetry_dir=str(d / name / "telemetry"),
                         key={"model": "diffusion3d"},
                         devices=(devices or {}).get(name, f"dev-{name}"))
        for name in pools
    ]
    fc = pkg.ctl.FleetController(specs, router=router,
                                 policy=policy or pkg.pol.FleetPolicy(respawn_limit=2),
                                 poll_s=0.01, spawn=spawn, scrape=scrape)
    return fc, router, doors, procs, envs


def _launch_run(pkg, d):
    fc, router, _, _, envs = _fleet_fixture(pkg, d, devices={"a": "0", "b": "1"})
    fc.launch(wait_s=5.0)
    return ([sorted(router.pools), fc.handles["a"].endpoint,
             [pkg.gen.authoritative_generation(str(d / n)) for n in ("a", "b")],
             events(pkg, d)], {n: e.get("CUDA_VISIBLE_DEVICES") for n, e in envs.items()})


def test_controller_launch_discovers_and_registers_matches_jax(clean_env, tmp_path):
    (got, got_env), (want, want_env) = both(_launch_run, clean_env, tmp_path)
    assert got == want
    pools, endpoint, gens, evs = got
    assert pools == ["a", "b"] and endpoint == "127.0.0.1:40001" and gens == [0, 0]
    assert [e["type"] for e in evs].count("fleet.pool_up") == 2
    # the device subset is the child's CUDA_VISIBLE_DEVICES in the port
    assert got_env == {"a": "0", "b": "1"}
    assert want_env == {"a": None, "b": None}


@pytest.mark.parametrize("parent, devices, want", [
    (None, {"a": "0", "b": "1"}, {"a": "0", "b": "1"}),
    ("2,3", {"a": "1", "b": "0"}, {"a": "3", "b": "2"}),
    ("GPU-x, GPU-y,GPU-z", {"a": "2,0", "b": "1"}, {"a": "GPU-z,GPU-x", "b": "GPU-y"}),
    ("2,3", {"a": "0", "b": "2"}, ValueError),
    ("2,3", {"a": "0", "b": "dev-b"}, ValueError),
    ("", {"a": "0", "b": "0"}, ValueError),
])
def test_pool_devices_index_the_controllers_visible_devices(clean_env, tmp_path, parent,
                                                             devices, want):
    """Port-only: a pool's device subset indexes the controller's own
    ``CUDA_VISIBLE_DEVICES`` when that is set, so a pool stays on the cards
    its controller was given; an index outside that list is refused when
    the controller is built, before any pool is launched."""
    if parent is not None:
        clean_env.setenv("CUDA_VISIBLE_DEVICES", parent)
    if want is ValueError:
        with pytest.raises(ValueError, match="not an index"):
            _fleet_fixture(PORT, tmp_path, devices=devices)
        return
    fc, _, _, _, envs = _fleet_fixture(PORT, tmp_path, devices=devices)
    fc.launch(wait_s=5.0)
    assert {n: e["CUDA_VISIBLE_DEVICES"] for n, e in envs.items()} == want


def _death_run(pkg, d):
    fc, router, _, procs, _ = _fleet_fixture(pkg, d)
    fc.launch(wait_s=5.0)
    code, body = router.submit({"tenant": "t", "params": {"max_steps": 2}})
    fid, victim = body["request_id"], body["pool"]
    procs[fc.handles[victim].endpoint].rc = 9  # a killed pool
    out = [code, victim, [_decision(x) for x in fc.poll_once()], _route(router.routes[fid]),
           pkg.gen.authoritative_generation(str(d / victim)), fc.handles[victim].generation,
           fc.poll_once(), fc.state.respawns[victim]]
    return out, [e["type"] for e in events(pkg, d)]


def test_controller_death_recovery_order_and_fence_matches_jax(clean_env, tmp_path):
    got, want = both(_death_run, clean_env, tmp_path)
    assert got == want
    (code, victim, decisions, route, auth, gen, again, strikes), types = got
    assert code == 202 and [x[0] for x in decisions] == ["respawn"]
    assert route["pool"] != victim and route["epoch"] == 1
    assert auth == 1 and gen == 1 and again == [] and strikes == 0
    assert types.index("fleet.detect") < types.index("fleet.reroute") \
        < types.index("fleet.recovered")


def _strike_run(pkg, d):
    fc, router, _, procs, _ = _fleet_fixture(pkg, d, policy=pkg.pol.FleetPolicy(respawn_limit=0))
    fc.launch(wait_s=5.0)
    procs[fc.handles["a"].endpoint].rc = 7
    out = [[_decision(x) for x in fc.poll_once()], sorted(fc.state.quarantined_devices),
           router.pools["a"]["quarantined"],
           router.submit({"tenant": "t", "params": {"max_steps": 1}})]
    return out, [e["type"] for e in events(pkg, d)]


def test_controller_strike_exhaustion_quarantines_devices_matches_jax(clean_env, tmp_path):
    got, want = both(_strike_run, clean_env, tmp_path)
    assert got == want
    (decisions, quarantined, flag, (code, body)), types = got
    assert [x[0] for x in decisions] == ["quarantine"] and quarantined == ["dev-a"] and flag
    assert code == 202 and body["pool"] == "b"
    assert "fleet.quarantine" in types and "fleet.recovered" not in types


def _canary_controller_run(pkg, d, breach):
    healths = {}
    fc, router, _, _, _ = _fleet_fixture(
        pkg, d, pools=("a",), healths=healths,
        policy=pkg.pol.FleetPolicy(canary_streak=2 if not breach else 3,
                                   canary_p99_s=1.0 if not breach else 0.5))
    fc.launch(wait_s=5.0)
    overlay = "doctored" if breach else str(d / "overlay")
    spec = pkg.ctl.PoolSpec(name="canary", command_for=lambda s, g: ["pool", s.name, str(g)],
                            workdir=str(d / "canary"),
                            telemetry_dir=str(d / "canary" / "telemetry"),
                            env={"IGG_TUNE_CACHE": overlay})
    fc.start_canary(spec, {"overlay": overlay})
    out = []
    if breach:
        fc.poll_once()
        healths[fc.handles["canary"].endpoint] = _health(p99=2.0)
        fc.poll_once()
        out += [fc.canary.state, fc.canary.breach["kind"], router.pools["canary"]["quarantined"]]
    else:
        with pytest.raises(RuntimeError, match="already baking"):
            fc.start_canary(spec, {"overlay": "v3"})
        out += [fc.poll_once(), fc.canary.state, fc.poll_once(), fc.canary.state]
    doc = json.loads((d / "canary" / pkg.can.CANARY_STATE).read_text())
    out += [fc.specs["a"].env.get("IGG_TUNE_CACHE") == overlay, doc["state"],
            doc.get("streak"), (doc.get("breach") or {}).get("kind")]
    return out, [e["type"] for e in events(pkg, d)]


@pytest.mark.parametrize("breach", [False, True], ids=["promote", "rollback"])
def test_controller_canary_matches_jax(clean_env, tmp_path, breach):
    got, want = both(lambda p, d: _canary_controller_run(p, d, breach), clean_env, tmp_path)
    assert got == want
    out, types = got
    if breach:
        assert out[:3] == ["rolled_back", "slo", True]
        assert out[3] is False and out[4] == "rolled_back" and out[6] == "slo"
        assert "fleet.canary.rollback" in types and "fleet.quarantine" in types
        assert types.index("fleet.canary.start") < types.index("fleet.canary.observe") \
            < types.index("fleet.canary.rollback")
        assert "fleet.canary.promote" not in types
    else:
        # the overlay rides untouched to the seed pool on promotion
        assert out == [[], "baking", [], "promoted", True, "promoted", 2, None]


def _spill_controller_run(pkg, d):
    healths = {}
    fc, router, _, _, _ = _fleet_fixture(pkg, d, pools=("a",), healths=healths,
                                         policy=pkg.pol.FleetPolicy(spill_queue=4,
                                                                    idle_retire=2))
    fc.launch(wait_s=5.0)
    healths[fc.handles["a"].endpoint] = _health(queue=6, members=2)
    out = [[_decision(x) for x in fc.poll_once()]]
    spill = next(iter(fc.spilled))
    healths[fc.handles["a"].endpoint] = _health(queue=1, members=1)
    healths[fc.discover_endpoint(spill)] = _health(queue=0, members=0)
    out += [spill, fc.poll_once(), [_decision(x) for x in fc.poll_once()],
            spill in router.pools]
    healths[fc.handles["a"].endpoint] = _health(queue=0, members=0)
    out.append([fc.poll_once() for _ in range(4)])
    return out, [e["type"] for e in events(pkg, d)]


def test_controller_spill_and_retire_lifecycle_matches_jax(clean_env, tmp_path):
    got, want = both(_spill_controller_run, clean_env, tmp_path)
    assert got == want
    (spilled, name, idle1, retired, still, seed_idle), types = got
    assert [x[0] for x in spilled] == ["spill"] and name.startswith("a-spill")
    assert idle1 == [] and [x[0] for x in retired] == ["retire"] and not still
    assert seed_idle == [[], [], [], []]  # the seed pool never retires
    assert "fleet.spill" in types and "fleet.retire" in types
