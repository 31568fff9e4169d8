"""The port's run supervisor (`supervisor`) against the JAX package's.

* Generation fencing: publish and read round-trip, monotonicity, the
  corrupt-file event, stale tokens refused with a rank-tagged
  ``fence.rejected`` event, and one ``generation.json`` read by both
  packages.
* `classify` on the JAX package's evidence bundles: the same kinds, suspect
  ranks, exit pictures and details as JAX's; `collect_evidence` of one
  directory equal in both.
* `decide` and `recovery_plan` on the same incidents, state and policy: the
  same decision sequence as JAX's, step for step.
* `RunSupervisor` over stdlib-only fake workers (no torch import): the
  restart → shrink flow with fired-fault pruning, the resize flow, giving
  up, a give-up that reports its quarantine, and each rank's own
  ``RANK``/``WORLD_SIZE`` with a fresh ``MASTER_PORT`` per incarnation.
* One real port rank on the CPU (two torch processes): diffusion
  ``run()`` crashed by ``worker_crash:step8`` resumes at step 8 in the
  second incarnation and ends bit for bit where an uncrashed run ends.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from implicitglobalgrid_tpu import supervisor as jsup
from implicitglobalgrid_tpu.utils import telemetry as jtele
from implicitglobalgrid_tpu_torch import supervisor as sup
from implicitglobalgrid_tpu_torch.supervisor import generation as gen_mod
from implicitglobalgrid_tpu_torch.utils import resilience as res
from implicitglobalgrid_tpu_torch.utils import telemetry as tele
from implicitglobalgrid_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("IGG_"):
            monkeypatch.delenv(k)
    res.reset_fault_injector()
    tele.reset()
    jtele.reset()
    yield monkeypatch
    res.reset_fault_injector()
    tele.reset()
    jtele.reset()
    tracing.reset()


def _events(path):
    return tele.read_events(path)


# -- generation tokens and fencing --------------------------------------------


def test_generation_publish_read_roundtrip_across_packages(clean_env, tmp_path):
    from implicitglobalgrid_tpu.supervisor import generation as jgen

    d = str(tmp_path)
    assert gen_mod.authoritative_generation(d) is None
    gen_mod.publish_generation(3, d, reason="test")
    assert gen_mod.authoritative_generation(d) == jgen.authoritative_generation(d) == 3
    gen_mod.publish_generation(3, d)
    with pytest.raises(ValueError, match="monotonic") as got:
        gen_mod.publish_generation(2, d)
    with pytest.raises(ValueError) as want:
        jgen.publish_generation(2, d)
    assert str(got.value) == str(want.value)
    jgen.publish_generation(5, d)
    assert gen_mod.authoritative_generation(d) == 5
    with pytest.raises(ValueError, match="fence directory"):
        gen_mod.publish_generation(1)


def test_corrupt_fence_file_reads_absent_but_is_evented(clean_env, tmp_path):
    telem = tmp_path / "telemetry"
    clean_env.setenv("IGG_TELEMETRY_DIR", str(telem))
    assert gen_mod.authoritative_generation(str(tmp_path)) is None
    (tmp_path / gen_mod.GENERATION_FILE).write_text("{torn mid-write")
    assert gen_mod.authoritative_generation(str(tmp_path)) is None
    assert tele.snapshot()["counters"]["fence.corrupt_total"] == 1
    assert any(e["type"] == "fence.corrupt" for e in _events(telem / "events.jsonl"))


def test_fence_verdicts(clean_env, tmp_path):
    fence, telem = tmp_path / "fence", tmp_path / "telemetry"
    gen_mod.publish_generation(2, str(fence))
    clean_env.setenv("IGG_FENCE_DIR", str(fence))
    clean_env.setenv("IGG_TELEMETRY_DIR", str(telem))
    assert gen_mod.fence_dir() == str(fence)
    assert not gen_mod.fence_refused("anything")  # unfenced: never refused
    clean_env.setenv("IGG_GENERATION", "2")
    assert not gen_mod.fence_refused("anything")
    clean_env.setenv("IGG_GENERATION", "1")
    assert gen_mod.fence_refused("fleet.canary")
    with pytest.raises(gen_mod.FenceError) as e:
        gen_mod.check_fence("checkpoint.save")
    assert (e.value.generation, e.value.authoritative) == (1, 2)
    rej = [x for x in _events(telem / "events.jsonl") if x["type"] == "fence.rejected"]
    assert [x["what"] for x in rej] == ["fleet.canary", "checkpoint.save"]
    assert all("rank" in x and x["gen"] == 1 for x in rej)
    assert tele.snapshot()["counters"]["fence.rejected_total"] == 2


# -- classification -----------------------------------------------------------


def test_exit_status_constants_agree():
    # (the packages re-export the `classify` function over its module's name)
    from implicitglobalgrid_tpu.supervisor.classify import CRASH_STATUS as J_CRASH
    from implicitglobalgrid_tpu.supervisor.classify import RESIZE_STATUS as J_RESIZE
    from implicitglobalgrid_tpu_torch.serving.frontdoor import RESIZE_STATUS
    from implicitglobalgrid_tpu_torch.supervisor.classify import CRASH_STATUS, RESIZE_STATUS as R

    assert CRASH_STATUS == res.FaultInjector.CRASH_STATUS == J_CRASH == 17
    assert R == RESIZE_STATUS == J_RESIZE == 19
    assert sup.FAILURE_KINDS == jsup.FAILURE_KINDS


def _ev(kind, ts=None, **kw):
    return {"type": kind, "ts": 1000.0 if ts is None else ts, "rank": kw.pop("rank", 0), **kw}


def _bundles(rank, reason, **rec):
    return {"bundles": {rank: [dict(_ev(None, reason=reason), **rec)]}, "alerts": [],
            "events": []}


def _alerts(*evs):
    return {"bundles": {}, "alerts": [e for e in evs if e["type"].startswith("alert.")],
            "events": list(evs)}


_STALL = _ev("alert.step_stall", rank=1)
_SKEW = _ev("skew.straggler", rank=1)
#: (rcs, evidence, since_ts): the JAX package's classification cases
CLASSIFY_CASES = [
    ([0, 0], None, None), ([19, 19], None, None), ([0, 17], None, None),
    ([1, 0], None, None), ([0, 19], None, None),
    ([0, 1], _bundles(1, "gather_tripwire"), None),
    ([1, 0], _bundles(0, "guard.trip"), None),
    ([None, None], _bundles(0, "watchdog.deadline_exceeded"), None),
    ([0, 0], _bundles(0, "guard.trip"), None),
    ([19, 19], _bundles(1, "watchdog.deadline_exceeded"), None),
    ([-9, -9], _alerts(_STALL), None), ([-9, None], _alerts(_SKEW), None),
    ([-11, -9], _alerts(_STALL), None),
    ([17, 0], _alerts(_ev("checkpoint.fallback", problem="shard corrupt")), None),
    ([None, None], _alerts(_STALL), None), ([0, 0], _alerts(_STALL), None),
    ([19, 19], _alerts(_STALL), None), ([None, None], _alerts(_SKEW), None),
    ([0, 17], _alerts(_ev("checkpoint.fallback",
                          problem="shard shards_p0.npz corrupt: CRC32 0x1 on disk vs 0x2")),
     None),
    ([0, 1], _bundles(0, "gather_tripwire"), None),
    ([17, 0], _alerts(_ev("checkpoint.fallback", ts=100.0)), 200.0),
    ([17, 0], _alerts(_ev("checkpoint.fallback", ts=100.0)), 50.0),
    ([1, 0], _bundles(0, "sdc", info={"detector": "transport_checksum",
                                      "implicated_rank": 1}), None),
    ([17, 0], _alerts(_ev("fault.worker_crash", step=8, status=17)), None),
]


@pytest.mark.parametrize("case", range(len(CLASSIFY_CASES)))
def test_classify_matches_jax(case):
    rcs, ev, since = CLASSIFY_CASES[case]
    got = sup.classify(rcs, ev, since_ts=since)
    want = jsup.classify(rcs, ev, since_ts=since)
    assert (got.kind, got.ranks, got.rcs, got.detail, got.failed) == \
        (want.kind, want.ranks, want.rcs, want.detail, want.failed)


def test_collect_evidence_matches_jax_and_reads_incrementally(tmp_path, clean_env):
    clean_env.setenv("IGG_TELEMETRY_DIR", str(tmp_path))
    tele.event("alert.step_stall", severity="critical")
    tele.event("fault.worker_crash", step=2)
    tracing.dump_flight_recorder("gather_tripwire", round=2)
    got = sup.collect_evidence(str(tmp_path))
    assert got == jsup.collect_evidence(str(tmp_path))
    assert got["bundles"][0][-1]["reason"] == "gather_tripwire"
    assert [a["type"] for a in got["alerts"]] == ["alert.step_stall"]
    offsets: dict = {}
    sup.collect_evidence(str(tmp_path), offsets=offsets)
    assert sup.collect_evidence(str(tmp_path), offsets=offsets)["events"] == []
    with open(tmp_path / "events.jsonl", "a") as f:
        f.write('{"type": "fault.stall", "ts": 1.0, "rank": 0}')  # torn: no newline
    assert sup.collect_evidence(str(tmp_path), offsets=offsets)["events"] == []
    with open(tmp_path / "events.jsonl", "a") as f:
        f.write("\n")
    assert [e["type"] for e in sup.collect_evidence(str(tmp_path), offsets=offsets)["events"]] \
        == ["fault.stall"]
    assert sup.collect_evidence(str(tmp_path / "missing")) == {"bundles": {}, "alerts": [],
                                                               "events": []}


# -- recovery policy ----------------------------------------------------------

#: (policy kwargs, start state kwargs, ladder_len, preferred, [(kind, ranks, rcs, detail)])
POLICY_CASES = [
    (dict(max_restarts=2, backoff_s=0.01), {}, 2, 0, [("crash", (1,), (0, 17), {})] * 7),
    (dict(max_restarts=1, backoff_s=0.01, scale_up_after=2), dict(rung=1), 2, 0,
     [("healthy", (), (0,), {})] * 3),
    (dict(max_restarts=0, backoff_s=0.01, quarantine_after=2), {}, 3, 0,
     [("gather_tripwire", (1,), (0, 1), {})] * 3),
    (dict(max_restarts=2, backoff_s=0.25, seed=3), {}, 3, 0,
     [("silent_corruption", (1,), (0, 1), {"detector": "shadow_audit"}),
      ("crash", (0,), (17,), {}), ("corrupt_checkpoint", (0,), (17,), {}),
      ("step_stall", (0,), (None,), {}), ("resize", (), (19,), {}),
      ("straggler", (0,), (-9,), {}), ("guard_trip", (0,), (1,), {}),
      ("healthy", (), (0,), {})]),
    (dict(max_restarts=1, backoff_s=0.5), {}, 1, 0,
     [("crash", (0,), (1,), {}), ("crash", (0,), (1,), {})]),
]


def _drive(pkg, pol_kw, st_kw, ladder_len, preferred, incidents):
    pol, st = pkg.RecoveryPolicy(**pol_kw), pkg.SupervisorState(**st_kw)
    out = []
    for kind, ranks, rcs, detail in incidents:
        inc = pkg.Incident(kind=kind, ranks=ranks, rcs=rcs, detail=dict(detail))
        st.record_incident(inc)
        d = pkg.decide(inc, st, pol, ladder_len=ladder_len, preferred_rung=preferred)
        out.append((d.action, d.rung, d.delay_s, d.reason, d.quarantined))
        if d.action == "give_up":
            break
        st.apply(d)
        out.append((st.rung, st.generation, st.restarts, dict(st.suspect_strikes),
                    sorted(st.quarantined), st.healthy_streak))
    return out


@pytest.mark.parametrize("case", range(len(POLICY_CASES)))
def test_decide_sequence_matches_jax(case):
    got = _drive(sup, *POLICY_CASES[case])
    assert got == _drive(jsup, *POLICY_CASES[case])
    assert got  # a non-empty decision sequence


def test_policy_env_tier_and_recovery_plan_match_jax(clean_env):
    clean_env.setenv("IGG_SUPERVISE_MAX_RESTARTS", "7")
    clean_env.setenv("IGG_SUPERVISE_BACKOFF_S", "0.125")
    assert sup.RecoveryPolicy.from_env() == sup.RecoveryPolicy(max_restarts=7, backoff_s=0.125)
    assert sup.RecoveryPolicy.from_env(max_restarts=1).max_restarts == 1
    clean_env.setenv("IGG_SUPERVISE_BACKOFF_S", "0")
    with pytest.raises(ValueError, match="IGG_SUPERVISE_BACKOFF_S"):
        sup.RecoveryPolicy.from_env()
    assert sup.ACTIONS == jsup.ACTIONS
    for action in sup.ACTIONS:
        for root in (True, False):
            for stale in (True, False):
                assert sup.recovery_plan(root, action, stale) == \
                    jsup.recovery_plan(root, action, stale)
        assert sup.recovery_plan(True, action, True) == ()


# -- RunSupervisor over fake workers (stdlib only) -----------------------------

_FAKE_WORKER = r"""
import json, os, sys, time
gen = int(os.environ["IGG_GENERATION"])
rank = int(sys.argv[1])
tele = os.environ["IGG_TELEMETRY_DIR"]
os.makedirs(tele, exist_ok=True)
def event(etype, **kw):
    rec = {"ts": time.time(), "type": etype, "rank": rank, "gen": gen, **kw}
    name = "events.jsonl" if rank == 0 else f"events.p{rank}.jsonl"
    with open(os.path.join(tele, name), "a") as f:
        f.write(json.dumps(rec) + "\n")
event("worker.env", env={k: os.environ.get(k) for k in
                          ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")})
faults = os.environ.get("IGG_FAULT_INJECT", "")
if gen == 0 and rank == 1 and "worker_crash:step2" in faults:
    event("fault.worker_crash", step=2, status=17)
    sys.exit(17)
if gen == 1 and rank == 1 and "worker_crash:step4" in faults:
    event("fault.worker_crash", step=4, status=17)
    sys.exit(17)
event("run.complete", step=6)
sys.exit(0)
"""


def test_run_supervisor_restart_shrink_pruning_and_rank_env(clean_env, tmp_path):
    workdir, tele_dir = tmp_path / "run", tmp_path / "telemetry"
    script = tmp_path / "worker.py"
    script.write_text(_FAKE_WORKER)
    rsup = sup.RunSupervisor(
        lambda rank, nranks, rung, gen: [sys.executable, str(script), str(rank)],
        ladder=[2, 1], workdir=str(workdir), telemetry_dir=str(tele_dir),
        policy=sup.RecoveryPolicy(max_restarts=1, backoff_s=0.01),
        fault_spec="worker_crash:step2:proc1,worker_crash:step4:proc1,stall:step9",
        poll_s=0.05, grace_s=2.0, name="fake",
    )
    report = rsup.run(timeout=30)
    assert report.ok, report
    assert [i["decision"]["action"] for i in report.incidents][:2] == ["restart", "shrink"]
    assert report.generations == 2 and report.final_rung == 1
    assert rsup._fault_specs == ["stall:step9"]  # fired faults pruned
    assert gen_mod.authoritative_generation(str(workdir)) == 2
    events = _events(tele_dir / "events.jsonl") + _events(tele_dir / "events.p1.jsonl")
    types = [e["type"] for e in _events(tele_dir / "events.jsonl")]
    assert types.index("supervisor.detect") < types.index("supervisor.classify") \
        < types.index("supervisor.recover")
    assert [e["ok"] for e in events if e["type"] == "supervisor.done"] == [True]
    # every rank its own RANK/LOCAL_RANK/WORLD_SIZE; a fresh port each incarnation
    envs = {(e["gen"], e["rank"]): e["env"] for e in events if e["type"] == "worker.env"}
    assert sorted(envs) == [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0)]
    for (g, r), env in envs.items():
        assert (env["RANK"], env["LOCAL_RANK"]) == (str(r), str(r))
        assert env["WORLD_SIZE"] == ("1" if g == 2 else "2")
        assert env["MASTER_ADDR"] == "127.0.0.1"
    ports = {g: {envs[k]["MASTER_PORT"] for k in envs if k[0] == g} for g in range(3)}
    assert all(len(p) == 1 for p in ports.values())  # one rendezvous per incarnation
    assert len(set.union(*ports.values())) == 3       # never reused across incarnations
    launches = [e for e in events if e["type"] == "supervisor.launch"]
    assert [str(e["master_port"]) for e in launches] == [ports[g].pop() for g in range(3)]


def test_run_supervisor_resize_flow(clean_env, tmp_path):
    plan_path = tmp_path / "resize.json"
    script = tmp_path / "worker.py"
    script.write_text(r"""
import json, os, sys
if int(os.environ["IGG_GENERATION"]) == 0:
    if int(sys.argv[1]) == 0:
        with open(sys.argv[2], "w") as f:
            json.dump({"nproc": 1, "capacity": 2, "rung": 0, "reason": "down"}, f)
    sys.exit(19)
sys.exit(0)
""")
    seen = []
    rsup = sup.RunSupervisor(
        lambda rank, nranks, rung, gen: [sys.executable, str(script), str(rank), str(plan_path)],
        ladder=[2, 1], workdir=str(tmp_path / "run"), telemetry_dir=str(tmp_path / "tele"),
        policy=sup.RecoveryPolicy(max_restarts=0, backoff_s=0.01),
        on_resize=lambda plan: seen.append(plan) or 1, resize_plan_path=str(plan_path),
        poll_s=0.05, grace_s=2.0, name="resize",
    )
    report = rsup.run(timeout=30)
    assert report.ok, report
    assert [i["kind"] for i in report.incidents] == ["resize", "healthy"]
    assert seen and seen[0]["reason"] == "down" and not plan_path.exists()


@pytest.mark.parametrize("flow", ["give_up", "quarantine"])
def test_run_supervisor_gives_up(clean_env, tmp_path, flow):
    script = tmp_path / "worker.py"
    if flow == "give_up":
        script.write_text("import sys; sys.exit(3)\n")
        policy = sup.RecoveryPolicy(max_restarts=1, backoff_s=0.01)
    else:  # rank 0 leaves a gather_tripwire bundle and dies, every incarnation
        script.write_text(r"""
import json, os, sys, time
tele = os.environ["IGG_TELEMETRY_DIR"]
os.makedirs(tele, exist_ok=True)
with open(os.path.join(tele, "flight_0.json"), "a") as f:
    f.write(json.dumps({"ts": time.time(), "rank": 0, "reason": "gather_tripwire"}) + "\n")
sys.exit(1)
""")
        policy = sup.RecoveryPolicy(max_restarts=2, backoff_s=0.01, quarantine_after=2)
    rsup = sup.RunSupervisor(
        lambda rank, nranks, rung, gen: [sys.executable, str(script)], ladder=[1],
        workdir=str(tmp_path / "run"), telemetry_dir=str(tmp_path / "tele"), policy=policy,
        poll_s=0.05, name=flow,
    )
    report = rsup.run(timeout=30)
    assert not report.ok
    assert [i["decision"]["action"] for i in report.incidents] == ["restart", "give_up"]
    if flow == "give_up":
        assert "no smaller rung" in report.reason and report.quarantined == ()
    else:
        assert report.quarantined == (0,)
        assert [i["kind"] for i in report.incidents] == ["gather_tripwire"] * 2


# -- one real port rank, supervised, on the CPU --------------------------------


def test_supervised_port_rank_resumes_bit_for_bit(clean_env, tmp_path):
    """A port rank running diffusion ``run()`` (float64, 16^3, fused_k=4,
    checkpoint_every=4) under ``worker_crash:step8:proc0``: the first
    incarnation exits with the crash status after its step-8 checkpoint,
    the second resumes at step 8 and ends bit for bit where an uncrashed
    in-process run ends (the CPU twin of `chip_smoke.py` phase 14a).  Both
    sides run on one intra-op thread, as the port's CPU children do: a fresh
    process's first threaded float64 ``torch.exp`` is sometimes wrong past
    its first chunk (ROADMAP Queue C)."""
    from implicitglobalgrid_tpu_torch.models import diffusion3d

    work = tmp_path / "run"
    work.mkdir()
    task = {"kind": "run", "model": "diffusion3d", "args": [16, 16, 16, 16],
            "kw": {"fused_k": 4, "checkpoint_every": 4, "checkpoint_dir": str(work / "ckpt"),
                   "periodx": 1, "periody": 1, "periodz": 1, "overlapx": 8, "overlapy": 8,
                   "overlapz": 8},
            "device": "cpu", "dtype": "float64", "workdir": str(work)}
    (work / "task.json").write_text(json.dumps(task))
    rsup = sup.RunSupervisor(
        lambda rank, nranks, rung, gen: [sys.executable, "-m",
                                         "implicitglobalgrid_tpu_torch._workers",
                                         str(work / "task.json")],
        ladder=[1], workdir=str(work), telemetry_dir=str(tmp_path / "tele"),
        policy=sup.RecoveryPolicy(max_restarts=1, backoff_s=0.01),
        fault_spec="worker_crash:step8:proc0", env={"PYTHONPATH": str(REPO)},
        poll_s=0.05, name="diffusion",
    )
    report = rsup.run(timeout=120)
    logs = {p.name: p.read_text()[-2000:] for p in work.glob("*.log")}
    assert report.ok, (report, logs)
    assert [(i["kind"], i["rcs"], i["decision"]["action"]) for i in report.incidents] == \
        [("crash", [17], "restart"), ("healthy", [0], "none")]
    events = _events(tmp_path / "tele" / "events.jsonl")
    crash = [e for e in events if e["type"] == "fault.worker_crash"]
    starts = [(e["gen"], e["start_step"]) for e in events if e["type"] == "run.start"]
    assert [e["step"] for e in crash] == [8] and starts == [(0, 0), (1, 8)]
    got = np.load(work / "out_rank0.npz")["out"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = diffusion3d.run(16, 16, 16, 16, device="cpu", dtype=torch.float64, quiet=True,
                               **dict(task["kw"], checkpoint_dir=str(tmp_path / "uncrashed")))
    finally:
        torch.set_num_threads(threads)
    diff = got != want.numpy()
    assert not diff.any(), (
        f"{int(diff.sum())} cells differ (max {float(np.abs(got - want.numpy()).max())!r}, "
        f"first at {np.argwhere(diff)[:4].tolist()}); events "
        f"{[(e['type'], e.get('gen'), e.get('step'), e.get('start_step')) for e in events]}; "
        f"logs {logs}")
