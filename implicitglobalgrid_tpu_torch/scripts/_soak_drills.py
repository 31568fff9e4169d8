"""The soak's supervised and multi-process drills (`scripts.soak`).

Each ``supervise_*`` is the port's twin of the JAX soak's drill of the same
name: the same legs, faults and acceptance checks, over the port's
`supervisor`, `fleet`, `serving`, `utils.tracing` and `utils.liveplane`.
The pairs' rendezvous (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, a fresh
``MASTER_PORT`` per incarnation) comes from `supervisor.RunSupervisor`;
servers bind port 0 and publish their endpoint files.  Each drill takes
the parsed soak arguments and a dict it fills with its record for
``soak_summary.json``, and returns its verdict.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

from .soak import (
    CHAOS_DRILL_KINDS,
    CHAOS_DRILL_RATE,
    CRASH_STATUS,
    _chaos_pick_seed,
    _child_cmd,
    _dump_output,
    _env,
    _launch_note,
    _launch_problem,
    _read_report,
    _report,
    _run_child,
    _verify_chaos_events,
    _verify_elastic_telemetry,
    _verify_sdc_events,
)


def _sup_env(args, extra: dict | None = None) -> dict:
    """The supervised children's extra environment: the repo on
    ``PYTHONPATH`` and one OpenMP thread on the CPU."""
    env = {"PYTHONPATH": _env(args)["PYTHONPATH"]}
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def _per_step(args):
    """The 2-rank drills step one step at a time: their faults are keyed to
    single steps, and a kernel group across ranks would need a deep halo
    (overlap >= 2K), i.e. another implicit global grid than the one-rank
    twin's.  ``--fused-k`` applies to the single-process scenarios."""
    return argparse.Namespace(**{**vars(args), "fused_k": 0})


def _pair_cmd(args, mode, *, nproc, rank, ckpt=None, out=None, expect_resume=-1, steps=None):
    a = argparse.Namespace(**vars(args))
    if steps is not None:
        a.steps = steps
    return _child_cmd(a, mode, "--nproc", nproc, "--pair-id", rank, "--ckpt-dir", ckpt or "",
                      "--out", out or "", "--expect-resume-step", expect_resume)


def _dump_run_logs(run_dir: str) -> None:
    for path in sorted(glob.glob(os.path.join(run_dir, "*.log"))):
        print(f"----- {path}", file=sys.stderr)
        with open(path) as f:
            print(f.read(), file=sys.stderr)


def _fresh(*dirs) -> None:
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def _same_field(got_out: str, oracle_out: str):
    """``(equal, detail)``: the two saved fields bit for bit."""
    import numpy as np

    oracle, got = np.load(oracle_out), np.load(got_out)
    if got.shape != oracle.shape:
        return False, "shape mismatch"
    if np.array_equal(got, oracle):
        return True, "max |err| 0.0"
    return False, f"max |err| {np.max(np.abs(got - oracle))}"


# ---------------------------------------------------------------------------
# elastic_failover
# ---------------------------------------------------------------------------


def supervise_elastic_failover(args, rec: dict) -> bool:
    """The supervised-failover drill: `RunSupervisor` launches the pair
    with the crash + corrupt-newest-generation faults armed, detects the
    crash, classifies it and — ``max_restarts=0`` — drops straight to the
    shrunk one-rank rung, relaunching from the latest VALID checkpoint.
    Held against a never-crashed oracle in de-duplicated space, plus the
    telemetry, flight-bundle and merged-trace acceptance."""
    args = _per_step(args)
    from .. import supervisor as sup

    workdir = args.workdir
    ckpt = os.path.join(workdir, "ckpt_elastic")
    run_dir = os.path.join(workdir, "elastic_run")
    tele_dir = os.path.join(workdir, "telemetry_elastic")
    _fresh(ckpt, run_dir, tele_dir)
    if args.steps < 6:
        return _report("elastic", False,
                       f"--steps {args.steps} too small: the drill needs a valid "
                       f"generation BEFORE the corrupted crash checkpoint (>= 6 steps)")
    mid = max(4, (args.steps // 2) // 2 * 2)

    oracle_out = os.path.join(workdir, "elastic_oracle.npy")
    proc = _run_child(_pair_cmd(args, "elastic-child", nproc=1, rank=0, out=oracle_out),
                      _env(args), args.timeout)
    if proc.returncode != 0:
        _dump_output(proc)
        return _report("elastic", False, f"oracle rc={proc.returncode}")

    got_out = os.path.join(workdir, "elastic_resumed.npy")

    def command_for(rank, nranks, rung, gen):
        return _pair_cmd(args, "elastic-child", nproc=nranks, rank=rank, ckpt=ckpt,
                         out=got_out, expect_resume=(mid - 2) if nranks == 1 else -1)

    rsup = sup.RunSupervisor(
        command_for, ladder=[2, 1], workdir=run_dir, telemetry_dir=tele_dir,
        policy=sup.RecoveryPolicy(max_restarts=0, backoff_s=0.2),
        fault_spec=f"worker_crash:step{mid}:proc1,ckpt_corrupt:step{mid}",
        env=_sup_env(args, {"IGG_TELEMETRY": "1"}),
        grace_s=30.0, poll_s=0.3, name="elastic",
    )
    report = rsup.run(timeout=args.timeout)
    if not report.ok:
        _dump_run_logs(run_dir)
        return _report("elastic", False, f"supervisor: {report.summary()}")
    kinds = [i["kind"] for i in report.incidents]
    actions = [i["decision"]["action"] for i in report.incidents]
    rec.update(incidents=list(zip(kinds, actions)))
    if "shrink" not in actions:
        return _report("elastic", False, f"supervisor never took the shrink leg "
                                         f"(kinds {kinds}, actions {actions})")
    if CRASH_STATUS not in report.incidents[0]["rcs"]:
        _dump_run_logs(run_dir)
        return _report("elastic", False, f"expected crash rc={CRASH_STATUS} in the first "
                                         f"incident, got {report.incidents[0]['rcs']}")
    ok, err = _same_field(got_out, oracle_out)
    tele_ok, tele_detail = _verify_elastic_telemetry(tele_dir, got_out)
    if not tele_ok:
        return _report("elastic", False, f"telemetry: {tele_detail}")
    return _report(
        "elastic", ok,
        f"supervised: {' -> '.join(f'{k}/{a}' for k, a in zip(kinds, actions))} "
        f"across {report.generations + 1} generation(s) ({err}); telemetry: {tele_detail}",
    )


# ---------------------------------------------------------------------------
# live_plane
# ---------------------------------------------------------------------------


def supervise_live_plane(args, rec: dict) -> bool:
    """The live-plane drill: one incarnation of the pair (launched by
    `RunSupervisor.launch`, which gives each rank its environment and the
    rendezvous) with ephemeral scrape servers and a stall armed on rank 1;
    discover the endpoints from the ``liveplane.p*.json`` files, scrape
    both ranks mid-run until the stall's alert shows in rank 1's live
    health view, render one `igg_top` cluster view, then verify rank 1's
    event log."""
    args = _per_step(args)
    from .. import supervisor as sup
    from ..utils.telemetry import read_events
    from . import igg_top

    workdir = args.workdir
    tele_dir = os.path.join(workdir, "telemetry_live")
    run_dir = os.path.join(workdir, "live_run")
    _fresh(tele_dir, run_dir)
    mid = max(2, args.steps // 2)
    rsup = sup.RunSupervisor(
        lambda rank, nranks, rung, gen: _pair_cmd(args, "live-child", nproc=nranks, rank=rank),
        ladder=[2], workdir=run_dir, telemetry_dir=tele_dir,
        fault_spec=f"stall:step{mid}:proc1",
        env=_sup_env(args, {"IGG_TELEMETRY": "1", "IGG_METRICS_PORT": "0",
                            "IGG_HEARTBEAT_EVERY": "2"}),
        name="live",
    )
    inc = rsup.launch()
    procs = inc.procs

    def _fail(detail: str) -> bool:
        inc.kill()
        _dump_run_logs(run_dir)
        return _report("live_plane", False, detail)

    deadline = time.monotonic() + args.timeout
    endpoints = None
    while time.monotonic() < deadline:
        try:
            endpoints = igg_top.discover_endpoints(
                argparse.Namespace(endpoints=[], endpoints_file=None, dir=tele_dir))
            if len(endpoints) == 2:
                break
        except (OSError, ValueError):
            pass
        if any(q.poll() is not None for q in procs):
            return _fail("a child exited before publishing its endpoint")
        time.sleep(0.1)
    if not endpoints or len(endpoints) != 2:
        return _fail(f"endpoint discovery timed out ({endpoints})")

    metrics_ok = {0: False, 1: False}
    stall_seen = None
    cluster = None
    while time.monotonic() < deadline:
        by_rank, _errors = igg_top.scrape_cluster(endpoints)
        for rank, res in by_rank.items():
            if "igg_diffusion3d_steps_total" in res["metrics"]:
                metrics_ok[rank] = True
            alerts = res["health"].get("alerts", {})
            for a in alerts.get("active", []) + alerts.get("recent", []):
                if a.get("rule") == "step_stall" and rank == 1:
                    stall_seen = a
                    cluster = by_rank
        if stall_seen and all(metrics_ok.values()):
            break
        if all(q.poll() is not None for q in procs):
            break
        time.sleep(0.1)
    for q in procs:
        try:
            q.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            return _fail("pair did not finish after the stall")
    if any(q.returncode != 0 for q in procs):
        return _fail(f"child rc={[q.returncode for q in procs]}")
    if not all(metrics_ok.values()):
        return _report("live_plane", False, f"/metrics never scraped from both ranks {metrics_ok}")
    if stall_seen is None:
        return _report("live_plane", False,
                       "alert.step_stall never appeared in rank 1's scraped /healthz "
                       "during the injected stall")

    merged = igg_top.merge_expositions({r: res["metrics"] for r, res in cluster.items()})
    if 'rank="0"' not in merged or 'rank="1"' not in merged:
        return _report("live_plane", False, "merged exposition lacks per-rank labels")
    rows = igg_top.summary_rows({r: res["health"] for r, res in cluster.items()})
    if len(rows) != 2:
        return _report("live_plane", False, f"cluster view rows: {rows}")
    table = igg_top.render_table(rows)
    rec.update(view=table)
    print(table, flush=True)

    p1 = os.path.join(tele_dir, "events.p1.jsonl")
    if not os.path.isfile(p1):
        return _report("live_plane", False, f"no {p1}")
    events = read_events(p1)
    if not [e for e in events if e.get("type") == "fault.stall"]:
        return _report("live_plane", False, "no fault.stall event on rank 1")
    alerts = [e for e in events if e.get("type") == "alert.step_stall"]
    if not any(e.get("rank") == 1 for e in alerts):
        return _report("live_plane", False,
                       f"no rank-1-tagged alert.step_stall event (saw "
                       f"{[(e.get('type'), e.get('rank')) for e in events][:20]})")
    return _report(
        "live_plane", True,
        f"2 ranks scraped live; stall at step {mid} -> alert.step_stall on "
        f"rank 1 (age {stall_seen['evidence'].get('age_s')}s > deadline "
        f"{stall_seen['evidence'].get('deadline_s')}s) seen in /healthz "
        f"mid-stall AND in events.p1.jsonl; igg_top merged view spans both ranks",
    )


# ---------------------------------------------------------------------------
# frontdoor
# ---------------------------------------------------------------------------


class _DoorClient:
    """Tiny HTTP client for the drills: submit, poll results, scrape
    metrics — everything deadline-bounded."""

    def __init__(self, endpoint: str):
        self.endpoint = endpoint

    def _url(self, path):
        return f"http://{self.endpoint}{path}"

    def post(self, path, doc):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self._url(path), data=json.dumps(doc).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.load(e)
            except ValueError:
                return e.code, {}
        except OSError:
            # door down (mid-resize restart): unreachable, the caller
            # retries against the next phase's endpoint
            return 0, {}

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self._url(path), timeout=5) as r:
            body = r.read()
        try:
            return json.loads(body)
        except ValueError:
            return body.decode()

    def metrics_text(self) -> str:
        import urllib.request

        with urllib.request.urlopen(self._url("/metrics"), timeout=5) as r:
            return r.read().decode()


def _oracle_digests(args, name: str, specs) -> dict | None:
    """The undisturbed one-process oracle's digests of ``specs``."""
    specs_path = os.path.join(args.workdir, f"{name}_specs.json")
    oracle_out = os.path.join(args.workdir, f"{name}_oracle.json")
    with open(specs_path, "w") as f:
        json.dump([list(s) for s in specs], f)
    proc = _run_child(_child_cmd(args, "frontdoor-oracle", "--specs", specs_path,
                                 "--out", oracle_out), _env(args), args.timeout)
    if proc.returncode != 0:
        _dump_output(proc)
        return None
    with open(oracle_out) as f:
        return json.load(f)


def supervise_frontdoor(args, rec: dict) -> bool:
    """The frontdoor drill: three phases across two elastic resizes under
    `RunSupervisor` (a ``resize`` classification maps onto the ladder
    through ``on_resize``); this wrapper keeps the load generator, the
    stall-driven backpressure check and the digest acceptance, injected per
    incarnation through the ``drive`` hook."""
    args = _per_step(args)
    from .. import supervisor as sup

    workdir = args.workdir
    ckpt = os.path.join(workdir, "ckpt_frontdoor")
    run_dir = os.path.join(workdir, "frontdoor_run")
    tele_dir = os.path.join(workdir, "telemetry_frontdoor")
    _fresh(ckpt, run_dir, tele_dir)
    steps = max(4, args.steps)
    cap1, cap2 = 2, 4
    ladder = f"1:{cap1},2:{cap2}"
    # (tenant, ic_scale, max_steps): the burst outruns cap1 so the queue
    # drives the scale-up; the two long members are still live when the
    # queue later drains, so the scale-down carries them mid-budget
    burst = [("tA", 1.0, steps), ("tB", 1.05, steps), ("tA", 1.1, steps),
             ("tC", 1.15, steps), ("tB", 1.2, steps), ("tC", 1.25, steps)]
    long_jobs = [("tA", 1.3, 3 * steps), ("tB", 1.35, 3 * steps)]
    mid_traffic = [("t2proc", 1.4, steps)]  # submitted while 2-process
    probe = ("probe", 1.0, 1)               # the stall-window hammer
    all_specs = sorted({(ic, ms) for _, ic, ms in burst + long_jobs + mid_traffic + [probe]})

    oracle = _oracle_digests(args, "frontdoor", all_specs)
    if oracle is None:
        return _report("frontdoor", False, "oracle failed")

    endpoint_file = os.path.join(tele_dir, "frontdoor.p0.json")
    accepted: dict[str, dict] = {}
    done: dict[str, dict] = {}
    to_submit: list[tuple] = []
    resize_plans: list[dict] = []
    state = {"phase": 0, "capacity": cap1, "as_rung": 0, "resume": False,
             "slo_429": None, "slo_metrics_seen": False, "shutdown_sent": False,
             "final_status": None}

    def command_for(rank, nranks, rung, gen):
        return _child_cmd(
            args, "frontdoor-child", "--nproc", nranks, "--pair-id", rank,
            "--ckpt-dir", ckpt, "--capacity", state["capacity"], "--rung", state["as_rung"],
            "--resume", int(state["resume"]), "--ladder", ladder)

    def on_resize(plan):
        resize_plans.append({k: plan[k] for k in ("nproc", "capacity", "rung", "reason")
                             if k in plan})
        state["capacity"] = int(plan["capacity"])
        state["as_rung"] = int(plan["rung"])
        state["resume"] = True
        # manager ladder: rung 0 = the 2-process topology, rung 1 = 1-process
        return 0 if int(plan["nproc"]) == 2 else 1

    def _try_submit(client, tenant, ic, ms, phase_no) -> bool:
        code, body = client.post("/v1/submit", {
            "tenant": tenant, "model": "diffusion3d",
            "params": {"ic_scale": ic, "max_steps": ms},
        })
        if code == 202:
            accepted[body["request_id"]] = {"tenant": tenant, "ic": ic, "ms": ms,
                                            "t": time.monotonic(), "phase": phase_no}
            return True
        return False

    def _poll_done(client):
        for rid in list(accepted):
            if rid in done:
                continue
            try:
                view = client.get(f"/v1/result/{rid}")
            except OSError:
                return
            if isinstance(view, dict) and view.get("status") == "done":
                view["t_done"] = time.monotonic()
                done[rid] = view

    t_drill0 = time.monotonic()

    def drive(inc):
        """One incarnation's client work (raises RuntimeError on a drill
        failure; the supervisor reaps and reports).  Runs until every child
        of the incarnation exited, resize exits included."""
        state["phase"] += 1
        phase_no = state["phase"]
        deadline = time.monotonic() + args.timeout
        client = None
        while time.monotonic() < deadline:
            if any(q.poll() is not None for q in inc.procs):
                raise RuntimeError(f"phase {phase_no}: a child exited before opening "
                                   f"the front door")
            if os.path.isfile(endpoint_file):
                try:
                    with open(endpoint_file) as f:
                        doc = json.load(f)
                    if float(doc.get("ts") or 0) >= inc.t0:
                        client = _DoorClient(f"{doc['host']}:{doc['port']}")
                        client.get("/v1/status")
                        break
                    client = None
                except (OSError, ValueError):
                    client = None
            time.sleep(0.1)
        if client is None:
            raise RuntimeError(f"phase {phase_no}: front-door endpoint never became reachable")

        if phase_no == 1:
            # two requests arm the pool (the stall fires after round 1)...
            armed = 0
            while armed < 2 and time.monotonic() < deadline:
                if _try_submit(client, *burst[armed], phase_no):
                    armed += 1
                else:
                    time.sleep(0.1)
            if armed < 2:
                raise RuntimeError(f"phase {phase_no}: initial submissions never accepted")
            # ...wait for round 1 (the stall wedges right after it)...
            while time.monotonic() < deadline:
                try:
                    if (client.get("/v1/status").get("rounds") or 0) >= 1:
                        break
                except OSError:
                    pass
                time.sleep(0.05)
            # ...then hammer the door until the wedged serving thread shows
            # up as a live 429 reason="slo" + the counter in /metrics
            while time.monotonic() < deadline and state["slo_429"] is None:
                if any(q.poll() is not None for q in inc.procs):
                    raise RuntimeError(f"phase {phase_no}: children exited before the "
                                       f"stall produced a 429")
                code, body = client.post("/v1/submit", {
                    "tenant": probe[0], "model": "diffusion3d",
                    "params": {"ic_scale": probe[1], "max_steps": probe[2]},
                })
                if code == 202:
                    accepted[body["request_id"]] = {
                        "tenant": probe[0], "ic": probe[1], "ms": probe[2],
                        "t": time.monotonic(), "phase": phase_no,
                    }
                elif code == 429 and body.get("reason") == "slo":
                    state["slo_429"] = body
                    if "igg_frontdoor_rejected_slo" in client.metrics_text():
                        state["slo_metrics_seen"] = True
                time.sleep(0.1)
            if state["slo_429"] is None:
                raise RuntimeError(f"phase {phase_no}: injected stall never produced a "
                                   f"429 reason=slo")
            to_submit.extend(burst[2:] + long_jobs)
        elif inc.nranks > 1:
            to_submit.extend(mid_traffic)

        while time.monotonic() < deadline:
            if to_submit and _try_submit(client, *to_submit[0], phase_no):
                to_submit.pop(0)
            _poll_done(client)
            if not inc.alive():
                break
            if (not state["shutdown_sent"] and phase_no >= 3 and not to_submit
                    and len(done) == len(accepted)):
                try:
                    status = client.get("/v1/status")
                    # a resumed door answers /v1/status before elastic_resume
                    # restores the round counter: wait for the restored figure
                    if status.get("rounds"):
                        state["final_status"] = status
                        client.post("/v1/shutdown", {})
                        state["shutdown_sent"] = True
                except OSError:
                    pass
            time.sleep(0.1)
        if inc.alive():
            raise RuntimeError(f"phase {phase_no}: children did not exit")

    rsup = sup.RunSupervisor(
        command_for, ladder=[2, 1], initial_rung=1, preferred_rung=0,
        workdir=run_dir, telemetry_dir=tele_dir,
        policy=sup.RecoveryPolicy(max_restarts=0, backoff_s=0.2),
        # the SLO-breach leg: wedge the serving thread after round 1 (pruned
        # from every later incarnation)
        fault_spec="stall:step1",
        env=_sup_env(args, {
            "IGG_TELEMETRY": "1", "IGG_HEARTBEAT_EVERY": "1", "IGG_SERVE_PORT": "0",
            "IGG_AUTOSCALE_QUEUE_HIGH": "3", "IGG_AUTOSCALE_SUSTAIN": "1",
            "IGG_FRONTDOOR_QUEUE_MAX": "64",
        }),
        drive=drive, on_resize=on_resize,
        resize_plan_path=os.path.join(ckpt, "resize.json"),
        grace_s=30.0, poll_s=0.3, name="frontdoor",
    )
    report = rsup.run(timeout=args.timeout + 60, max_incarnations=6)
    if not report.ok:
        _dump_run_logs(run_dir)
        return _report("frontdoor", False, f"supervisor: {report.summary()}")
    bad_kinds = [i["kind"] for i in report.incidents if i["kind"] not in ("healthy", "resize")]
    if bad_kinds:
        _dump_run_logs(run_dir)
        return _report("frontdoor", False, f"unexpected incident kind(s) {bad_kinds}")
    if not state["shutdown_sent"]:
        return _report("frontdoor", False, "the drill never reached the clean-shutdown phase")

    ups = [p for p in resize_plans if p["reason"] == "up"]
    downs = [p for p in resize_plans if "down" in p["reason"]]
    if not (ups and ups[0]["nproc"] == 2):
        return _report("frontdoor", False, f"no scale-UP to 2 processes (plans: {resize_plans})")
    if not (downs and downs[0]["nproc"] == 1):
        return _report("frontdoor", False,
                       f"no scale-DOWN back to 1 process (plans: {resize_plans})")
    if not state["slo_metrics_seen"]:
        return _report("frontdoor", False, "frontdoor.rejected.slo never visible in /metrics")
    missing = [rid for rid in accepted if rid not in done]
    if missing:
        return _report("frontdoor", False, f"{len(missing)} accepted request(s) never "
                                           f"completed (dropped members?): {missing[:5]}")
    bad = [rid for rid, meta in accepted.items()
           if (done[rid].get("digest") or {}).get("fields")
           != oracle.get(f"{meta['ic']}:{meta['ms']}")]
    if bad:
        return _report("frontdoor", False, f"digest mismatch vs the undisturbed oracle: {bad}")
    if not any(m["phase"] == 2 for m in accepted.values()):
        return _report("frontdoor", False, "no request was accepted during the 2-process phase")

    lat = sorted(done[rid]["t_done"] - accepted[rid]["t"] for rid in accepted)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(0.99 * (len(lat) - 1)))]
    rounds = (state["final_status"] or {}).get("rounds") or 0
    rps = rounds / max(1e-9, time.monotonic() - t_drill0)
    record = {
        "requests": len(accepted),
        "submit_to_result_p50_s": round(p50, 4),
        "submit_to_result_p99_s": round(p99, 4),
        "rounds": rounds,
        "rounds_per_s": round(rps, 3),
        "resizes": len(resize_plans),
        "plans": resize_plans,
        "incidents": report.incidents,
    }
    with open(os.path.join(workdir, "frontdoor_soak.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    rec.update({k: record[k] for k in ("requests", "submit_to_result_p50_s",
                                       "submit_to_result_p99_s", "rounds_per_s", "resizes")})
    return _report(
        "frontdoor", True,
        f"{len(accepted)} requests across {len(report.incidents)} supervised phases "
        f"(up@2proc + drain/down@1proc), all digests == oracle; stall -> 429 "
        f"reason=slo (+/metrics counter); p50 {p50:.2f}s p99 {p99:.2f}s {rps:.2f} rounds/s",
    )


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------


def supervise_chaos(args, rec: dict) -> bool:
    """The chaos drill: a seeded storm over the pair, owned by
    `RunSupervisor` — detect (liveness + live ``/healthz`` scrapes),
    classify, restart in place, then shrink once the strikes are spent;
    the final de-duplicated field bit-identical to an undisturbed
    oracle."""
    args = _per_step(args)
    from .. import supervisor as sup

    workdir = args.workdir
    ckpt = os.path.join(workdir, "ckpt_chaos")
    run_dir = os.path.join(workdir, "chaos_run")
    tele_dir = os.path.join(workdir, "telemetry_chaos")
    _fresh(ckpt, run_dir, tele_dir)
    steps = max(6, args.steps)
    seed, storm = _chaos_pick_seed(steps)
    print(f"[soak] chaos storm (seed {seed}): {', '.join(storm)}", flush=True)
    rec.update(seed=seed, storm=storm)

    oracle_out = os.path.join(workdir, "chaos_oracle.npy")
    proc = _run_child(_pair_cmd(args, "elastic-child", nproc=1, rank=0, out=oracle_out,
                                steps=steps), _env(args), args.timeout)
    if proc.returncode != 0:
        _dump_output(proc)
        return _report("chaos", False, f"oracle rc={proc.returncode}")

    got_out = os.path.join(workdir, "chaos_resumed.npy")
    rsup = sup.RunSupervisor(
        lambda rank, nranks, rung, gen: _pair_cmd(
            args, "elastic-child", nproc=nranks, rank=rank, ckpt=ckpt, out=got_out,
            steps=steps),
        ladder=[2, 1], workdir=run_dir, telemetry_dir=tele_dir,
        policy=sup.RecoveryPolicy(max_restarts=1, backoff_s=0.2, seed=seed),
        fault_spec=(f"chaos:seed={seed}:rate={CHAOS_DRILL_RATE}:steps={steps}"
                    f":kinds={'+'.join(CHAOS_DRILL_KINDS)}"),
        env=_sup_env(args, {"IGG_TELEMETRY": "1", "IGG_METRICS_PORT": "0",
                            "IGG_HEARTBEAT_EVERY": "1"}),
        grace_s=30.0, poll_s=0.3, name="chaos",
    )
    report = rsup.run(timeout=args.timeout, max_incarnations=6)
    if not report.ok:
        _dump_run_logs(run_dir)
        return _report("chaos", False, f"supervisor: {report.summary()}")
    actions = [i["decision"]["action"] for i in report.incidents]
    kinds = [i["kind"] for i in report.incidents]
    rec.update(incidents=list(zip(kinds, actions)))
    if "restart" not in actions or "shrink" not in actions:
        return _report("chaos", False, f"storm did not exercise both recovery legs "
                                       f"(kinds {kinds}, actions {actions})")
    same, err = _same_field(got_out, oracle_out)
    if not same:
        return _report("chaos", False, f"final dedup field differs from the oracle ({err})")
    ev_ok, ev_detail = _verify_chaos_events(tele_dir)
    if not ev_ok:
        return _report("chaos", False, f"events: {ev_detail}")
    return _report(
        "chaos", True,
        f"seed {seed}: {len(storm)} faults -> "
        f"{' -> '.join(f'{k}/{a}' for k, a in zip(kinds, actions))} across "
        f"{report.generations + 1} generation(s), final field bit-identical "
        f"to the oracle; {ev_detail}",
    )


# ---------------------------------------------------------------------------
# sdc
# ---------------------------------------------------------------------------


def supervise_sdc(args, rec: dict) -> bool:
    """The silent-data-corruption drill: one bit_flip per integrity-plane
    placement over a supervised pair running the host-path step, each
    caught by its own detector, the implicated rank quarantined on the
    first offense, the poisoned generation skipped on relaunch — and the
    final field bit-identical to an undisturbed oracle that doubles as the
    clean leg (whole plane armed, zero false positives)."""
    args = _per_step(args)
    from .. import supervisor as sup

    workdir = args.workdir
    ckpt = os.path.join(workdir, "ckpt_sdc")
    run_dir = os.path.join(workdir, "sdc_run")
    tele_dir = os.path.join(workdir, "telemetry_sdc")
    tele_clean = os.path.join(workdir, "telemetry_sdc_clean")
    _fresh(ckpt, run_dir, tele_dir, tele_clean)
    steps = max(8, args.steps)
    integrity = {"IGG_INTEGRITY": "1", "IGG_INTEGRITY_EVERY": "1"}

    oracle_out = os.path.join(workdir, "sdc_oracle.npy")
    proc = _run_child(
        _pair_cmd(args, "sdc-child", nproc=1, rank=0, out=oracle_out, steps=steps),
        _env(args, {**integrity, "IGG_TELEMETRY": "1", "IGG_TELEMETRY_DIR": tele_clean}),
        args.timeout,
    )
    if proc.returncode != 0:
        _dump_output(proc)
        return _report("sdc", False, f"clean leg rc={proc.returncode}")
    try:
        with open(oracle_out + ".metrics.json") as f:
            counters = json.load(f).get("counters", {})
    except (OSError, ValueError) as e:
        return _report("sdc", False, f"clean-leg metrics unreadable ({e!r})")
    false_pos = {k: counters.get(k, 0)
                 for k in ("integrity.audit_mismatches", "integrity.transport_mismatches")
                 if counters.get(k, 0)}
    if not counters.get("integrity.audits"):
        return _report("sdc", False, "clean leg ran zero shadow audits")
    if false_pos:
        return _report("sdc", False, f"clean-leg FALSE POSITIVES: {false_pos}")
    rec.update(clean_audits=counters.get("integrity.audits"))

    # transport flip on rank 0's wire (step 2 arm -> step 3 trip on rank 1),
    # state flip at step 4 (fires only in the shrunk restart), ckpt flip
    # poisoning the step-6 generation, then a crash so the relaunch walks
    # past it
    got_out = os.path.join(workdir, "sdc_resumed.npy")
    rsup = sup.RunSupervisor(
        lambda rank, nranks, rung, gen: _pair_cmd(
            args, "sdc-child", nproc=nranks, rank=rank, ckpt=ckpt, out=got_out, steps=steps),
        ladder=[2, 1, 1],  # two quarantine shrinks must not exhaust it
        workdir=run_dir, telemetry_dir=tele_dir,
        policy=sup.RecoveryPolicy(max_restarts=1, backoff_s=0.2),
        fault_spec=("bit_flip:step2:transport:proc0,bit_flip:step4:T,"
                    "bit_flip:step6:ckpt,worker_crash:step7:proc0"),
        env=_sup_env(args, {**integrity, "IGG_TELEMETRY": "1", "IGG_METRICS_PORT": "0",
                            "IGG_HEARTBEAT_EVERY": "1"}),
        grace_s=15.0, poll_s=0.3, name="sdc",
    )
    report = rsup.run(timeout=args.timeout, max_incarnations=6)
    if not report.ok:
        _dump_run_logs(run_dir)
        return _report("sdc", False, f"supervisor: {report.summary()}")
    sdc_inc = [i for i in report.incidents if i["kind"] == "silent_corruption"]
    detectors = [i["detail"].get("detector") for i in sdc_inc]
    kinds = [i["kind"] for i in report.incidents]
    actions = [i["decision"]["action"] for i in report.incidents]
    rec.update(incidents=list(zip(kinds, actions)))
    if detectors != ["transport_checksum", "shadow_audit"]:
        return _report("sdc", False, f"expected transport_checksum then shadow_audit "
                                     f"convictions, got {detectors} (kinds {kinds})")
    if any(i["decision"]["action"] != "quarantine" for i in sdc_inc):
        return _report("sdc", False, f"silent_corruption must quarantine on the FIRST "
                                     f"offense, got {[i['decision']['action'] for i in sdc_inc]}")
    transport_inc = sdc_inc[0]
    if (transport_inc["detail"].get("implicated_rank") != 0
            or transport_inc["detail"].get("bundle_rank") != 1):
        return _report("sdc", False, f"transport conviction must come from the RECEIVER's "
                                     f"bundle (rank 1) and implicate the SENDER (rank 0), got "
                                     f"detail {transport_inc['detail']}")
    if 0 not in report.quarantined:
        return _report("sdc", False, f"rank 0 not quarantined ({report.quarantined})")
    crash_actions = [i["decision"]["action"] for i in report.incidents if i["kind"] == "crash"]
    if crash_actions != ["restart"]:
        return _report("sdc", False, f"the post-poisoning crash should restart in place, "
                                     f"got {crash_actions}")
    same, err = _same_field(got_out, oracle_out)
    if not same:
        return _report("sdc", False, f"final dedup field differs from the oracle ({err})")
    ev_ok, ev_detail = _verify_sdc_events(tele_dir)
    if not ev_ok:
        return _report("sdc", False, f"events: {ev_detail}")
    return _report(
        "sdc", True,
        f"{' -> '.join(f'{k}/{a}' for k, a in zip(kinds, actions))} across "
        f"{report.generations + 1} generation(s), clean leg pinned zero false "
        f"positives, final field bit-identical to the oracle; {ev_detail}",
    )


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------


def _dump_fleet_logs(fleet_dir: str) -> None:
    for path in sorted(glob.glob(os.path.join(fleet_dir, "*", "*.log"))):
        try:
            with open(path) as f:
                tail = f.read()[-2000:]
        except OSError:
            continue
        print(f"---- {path} ----\n{tail}", file=sys.stderr)


def supervise_fleet(args, rec: dict) -> bool:
    """The fleet drill: two live one-process pools behind ONE
    `FleetRouter`, owned by a `FleetController` in this process.  Leg 1:
    traffic, one pool SIGKILLed with a long job in flight — every request
    completes with digests equal to the oracle, zero failed requests,
    ``fleet.detect`` -> ``fleet.reroute`` -> ``fleet.recovered`` in order,
    the respawned pool's log carrying the bumped generation, and every
    request's causal tree rebuilt from the dumps (both victim generations,
    the detect->reroute hop, OTLP and Chrome exports schema-clean).  Leg
    2: a healthy canary promotes and its overlay spreads.  Leg 3: a slow
    canary breaches the round-p99 bar and rolls back through quarantine."""
    from .. import fleet as flt
    from ..fleet.router import pool_health_view
    from ..utils import telemetry as tele
    from ..utils import tracing as trc
    from . import igg_top

    workdir = args.workdir
    fleet_dir = os.path.join(workdir, "fleet_run")
    tele_dir = os.path.join(workdir, "telemetry_fleet")
    _fresh(fleet_dir, tele_dir)
    os.makedirs(tele_dir)

    steps = max(4, args.steps)
    traffic = [("tA", 1.0, steps), ("tB", 1.05, steps), ("tA", 1.1, steps),
               ("tC", 1.15, steps), ("tB", 1.2, steps)]
    long_job = ("tA", 1.3, 40 * steps)
    during_outage = [("tC", 1.05, steps), ("tB", 1.1, steps)]
    canary_job = ("tA", 1.0, steps)
    all_specs = sorted({(ic, ms) for _, ic, ms in
                        traffic + during_outage + [long_job, canary_job]})
    oracle = _oracle_digests(args, "fleet", all_specs)
    if oracle is None:
        return _report("fleet", False, "oracle failed")
    oracle_report = _read_report(os.path.join(workdir, "fleet_oracle.json"))

    # fleet.* events land in this process's own event log
    saved_env = {k: os.environ.get(k) for k in ("IGG_TELEMETRY", "IGG_TELEMETRY_DIR")}
    os.environ["IGG_TELEMETRY"] = "1"
    os.environ["IGG_TELEMETRY_DIR"] = tele_dir
    pool_env = _sup_env(args, {"IGG_SERVE_PORT": "0"})

    def pool_spec(name, round_sleep=0.0, env_extra=None):
        pdir = os.path.join(fleet_dir, name)

        def command_for(spec, gen):
            return _child_cmd(args, "fleet-pool-child", "--capacity", 2,
                              "--round-sleep", round_sleep,
                              "--out", os.path.join(pdir, f"pool_g{gen}"))

        return flt.PoolSpec(
            name=name, command_for=command_for, workdir=pdir,
            telemetry_dir=os.path.join(pdir, "telemetry"),
            key={"model": "diffusion3d"},
            # one card holds every pool; on the CPU no device subset applies
            devices="0" if args.device == "cuda" else None,
            env={**pool_env, **(env_extra or {})},
        )

    router = flt.FleetRouter(port=0)
    fc = flt.FleetController(
        [pool_spec("a"), pool_spec("b")], router=router,
        policy=flt.FleetPolicy(respawn_limit=2, canary_streak=2, canary_p99_s=0.25),
        poll_s=0.2,
    )
    accepted: dict[str, dict] = {}
    done: dict[str, dict] = {}
    failed: list = []
    client = None
    victim = None

    def _submit(tenant, ic, ms):
        code, body = client.post("/v1/submit", {
            "tenant": tenant, "model": "diffusion3d",
            "params": {"ic_scale": ic, "max_steps": ms},
        })
        if code != 202:
            failed.append((tenant, ic, ms, code, body))
            return None
        route = router.routes.get(body["request_id"]) or {}
        accepted[body["request_id"]] = {
            "tenant": tenant, "ic": ic, "ms": ms, "pool": body["pool"],
            "trace_id": (route.get("trace") or {}).get("trace_id"),
        }
        return body

    def _poll_done():
        for fid in list(accepted):
            if fid in done:
                continue
            try:
                view = client.get(f"/v1/result/{fid}")
            except OSError:
                return
            if isinstance(view, dict) and view.get("status") == "done":
                done[fid] = view

    def _fail(msg):
        _dump_fleet_logs(fleet_dir)
        return _report("fleet", False, msg)

    try:
        # -- leg 1: traffic + a killed pool -----------------------------------
        t_leg = time.monotonic()
        fc.launch(wait_s=min(120.0, args.timeout))
        if sorted(router.pools) != ["a", "b"]:
            return _fail(f"pools never registered: {sorted(router.pools)}")
        client = _DoorClient(f"127.0.0.1:{router.port}")
        for t in traffic:
            if _submit(*t) is None:
                return _fail(f"submit refused: {failed}")
        body = _submit(*long_job)
        if body is None:
            return _fail(f"submit refused: {failed}")
        victim = body["pool"]
        long_tid = accepted[body["request_id"]]["trace_id"]
        # hold the kill until the victim's periodic trace dump carries a
        # span of the long job: the SIGKILL erases the ring
        victim_tele = os.path.join(fleet_dir, victim, "telemetry")
        dump_deadline = time.monotonic() + min(30.0, args.timeout)
        seen = long_tid is None
        while not seen and time.monotonic() < dump_deadline:
            for p in glob.glob(os.path.join(victim_tele, "trace.g*.p*.json")):
                try:
                    with open(p) as f:
                        pool_doc = json.load(f)
                except (OSError, ValueError):
                    continue
                if any(trc._trace_match(s.get("args"), long_tid)[0]
                       for s in pool_doc.get("spans", ())):
                    seen = True
                    break
            if not seen:
                time.sleep(0.1)
        if not seen:
            return _fail("the victim pool never published a trace dump carrying the "
                         "long job's spans")
        t_kill = time.monotonic()
        fc.handles[victim].kill()  # one whole failure domain SIGKILLed
        for t in during_outage:
            if _submit(*t) is None:
                return _fail(f"submit failed during the outage: {failed}")
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            fc.poll_once()
            _poll_done()
            if len(done) == len(accepted):
                break
            time.sleep(0.1)
        rec.update(kill_to_all_done_s=time.monotonic() - t_kill)
        missing = [f for f in accepted if f not in done]
        if missing:
            return _fail(f"{len(missing)} accepted request(s) never completed after the "
                         f"kill: {missing}")
        if failed:
            return _fail(f"failed request(s): {failed}")
        bad = [fid for fid, meta in accepted.items()
               if (done[fid].get("digest") or {}).get("fields")
               != oracle.get(f"{meta['ic']}:{meta['ms']}")]
        if bad:
            return _fail(f"digest mismatch vs the undisturbed oracle: {bad}")
        events = tele.read_events(os.path.join(tele_dir, "events.jsonl"))

        def _first(etype):
            for i, e in enumerate(events):
                if e["type"] == etype and e.get("pool") == victim:
                    return i
            return None

        i_det, i_rr, i_rec = _first("fleet.detect"), _first("fleet.reroute"), \
            _first("fleet.recovered")
        if not (i_det is not None and i_rr is not None and i_rec is not None
                and i_det < i_rr < i_rec):
            return _fail(f"detect->reroute->recovered order broken: ({i_det}, {i_rr}, {i_rec})")
        pool_events = tele.read_events(os.path.join(fleet_dir, victim, "telemetry",
                                                    "events.jsonl"))
        gens = {e.get("gen") for e in pool_events if e.get("gen") is not None}
        if not {0, 1} <= gens:
            return _fail(f"victim pool log gens {sorted(gens)}: the bumped generation never "
                         f"reached the per-pool log")

        # -- request-tree reconstruction ----------------------------------
        post_rid = None
        deadline = time.monotonic() + args.timeout
        for _attempt in range(8):
            body = _submit("tA", 1.0, steps)
            if body is None:
                return _fail(f"post-recovery submit refused: {failed}")
            if body["pool"] == victim:
                post_rid = body["request_id"]
                break
            _poll_done()
            time.sleep(0.2)
        if post_rid is None:
            return _fail(f"no post-recovery submit ever routed onto the respawned pool "
                         f"{victim!r}")
        while time.monotonic() < deadline:
            fc.poll_once()
            _poll_done()
            if len(done) == len(accepted):
                break
            time.sleep(0.1)
        if len(done) != len(accepted):
            return _fail("post-recovery request(s) never completed")
        rerouted = sorted({
            tid for s in trc.span_records() if s["name"] == "igg.fleet.detect"
            for tid in (s.get("args") or {}).get("trace_ids", ())
        })
        if not rerouted:
            return _fail("the fleet.detect span carries no trace ids: the in-flight victim "
                         "requests left no causal link")
        trc.dump_trace(tele_dir)  # route/detect/reroute spans live here

        def _load_dumps(d):
            docs = []
            for pat in ("trace.p*.json", "trace.g*.p*.json"):
                for p in sorted(glob.glob(os.path.join(d, pat))):
                    try:
                        docs.append(trc._load_rank_trace(p))
                    except (OSError, ValueError):
                        pass  # a dump mid-publish: the retry loop re-reads
            return docs

        def _span_names(tree):
            names = set()

            def walk(ns):
                for nd in ns:
                    names.add(nd["name"])
                    walk(nd["children"])

            walk(tree["roots"])
            return names

        problems = ["dumps not read yet"]
        all_docs: list = []
        check_deadline = time.monotonic() + 20.0
        while problems and time.monotonic() < check_deadline:
            problems = []
            victim_docs = _load_dumps(os.path.join(fleet_dir, victim, "telemetry"))
            all_docs = list(victim_docs)
            for pname in ("a", "b"):
                if pname != victim:
                    all_docs += _load_dumps(os.path.join(fleet_dir, pname, "telemetry"))
            all_docs += _load_dumps(tele_dir)
            victim_gens: set = set()
            for fid, meta in accepted.items():
                tid = meta.get("trace_id")
                if not tid:
                    problems.append(f"{fid}: no trace context on its route")
                    continue
                tree = trc.request_tree(all_docs, tid)
                names = _span_names(tree)
                if (not tree["spans"] or "igg.frontdoor.request" not in names
                        or "igg.fleet.route" not in names):
                    problems.append(f"{fid}: tree incomplete (spans={tree['spans']}, "
                                    f"names={sorted(names)})")
                if tid in rerouted and not ({"igg.fleet.detect", "igg.fleet.reroute"} <= names):
                    problems.append(f"{fid}: re-routed but its tree lacks the "
                                    f"detect→reroute hop ({sorted(names)})")
                victim_gens |= set(trc.request_tree(victim_docs, tid)["gens"])
            if not {0, 1} <= victim_gens:
                problems.append(f"victim-pool generations in the trees: {sorted(victim_gens)} "
                                f"— both generations of the killed pool must contribute spans")
            if problems:
                time.sleep(0.5)
        if problems:
            return _fail("request-tree check: " + "; ".join(problems[:4]))
        otlp_problems = trc.validate_otlp(trc.otlp_trace(all_docs))
        if otlp_problems:
            return _fail(f"OTLP export not schema-clean: {otlp_problems[:3]}")
        view = trc.request_chrome_trace(trc.request_tree(all_docs, rerouted[0]))
        view_problems = trc.validate_chrome_trace(view)
        if view_problems:
            return _fail(f"request Chrome view invalid: {view_problems[:3]}")
        rec.update(leg1_s=time.monotonic() - t_leg)
        # one igg_top view over the two pools' doors, keyed by pool (every
        # pool is a rank 0)
        pools = ("a", "b")
        try:
            healths = {i: igg_top.scrape(fc.discover_endpoint(p))["health"]
                       for i, p in enumerate(pools)}
        except (OSError, ValueError) as e:
            return _fail(f"igg_top could not scrape the pools' doors: {e!r}")
        table = igg_top.render_table(igg_top.summary_rows(healths))
        rec.update(view=table, view_pools=list(pools))
        print(table, flush=True)

        # -- canary legs ------------------------------------------------------
        def _bake_canary(name, tenant, ic, ms):
            """Drive one canary bake honestly: wait for the pool's door, put
            real traffic through it, wait until its rolling round p99 is a
            measurement, and only then let the controller's gate observe."""
            deadline = time.monotonic() + args.timeout
            ep = None
            while time.monotonic() < deadline and ep is None:
                if fc.handles[name].poll() is not None:
                    return None
                ep = fc.discover_endpoint(name)
                time.sleep(0.1)
            if ep is None:
                return None
            rid = None
            while time.monotonic() < deadline and rid is None:
                code, b = _DoorClient(ep).post("/v1/submit", {
                    "tenant": tenant, "model": "diffusion3d",
                    "params": {"ic_scale": ic, "max_steps": ms},
                })
                if code == 202:
                    rid = b["request_id"]
                else:
                    time.sleep(0.2)
            while time.monotonic() < deadline:
                if pool_health_view(flt.scrape_health(ep)).get("round_p99_s"):
                    break
                time.sleep(0.2)
            while time.monotonic() < deadline and fc.canary.state == "baking":
                fc.poll_once()
                time.sleep(0.2)
            return rid

        t_leg = time.monotonic()
        fc.start_canary(pool_spec("canary-good", env_extra={"SOAK_CANARY_OVERLAY": "good"}),
                        {"overlay": "good"})
        if _bake_canary("canary-good", *canary_job) is None:
            return _fail("the healthy canary pool never served")
        if fc.canary.state != "promoted":
            return _fail(f"healthy canary never promoted (state={fc.canary.state}, "
                         f"breach={fc.canary.breach})")
        if fc.specs["a"].env.get("SOAK_CANARY_OVERLAY") != "good":
            return _fail("promoted overlay never spread to the seed specs")
        with open(os.path.join(fleet_dir, "canary-good", "canary.json")) as f:
            doc = json.load(f)
        if doc["state"] != "promoted":
            return _fail(f"canary.json says {doc['state']!r}, not promoted")

        fc.start_canary(pool_spec("canary-bad", round_sleep=0.6,
                                  env_extra={"SOAK_CANARY_OVERLAY": "bad"}),
                        {"overlay": "doctored-slow"})
        if _bake_canary("canary-bad", "tCanary", 1.0, steps) is None:
            return _fail("the doctored canary pool never served")
        if fc.canary.state != "rolled_back":
            return _fail(f"doctored canary never rolled back (state={fc.canary.state})")
        if (fc.canary.breach or {}).get("kind") != "slo":
            return _fail(f"expected an slo breach, got {fc.canary.breach}")
        if not router.pools["canary-bad"]["quarantined"]:
            return _fail("rolled-back canary not quarantined")
        if fc.specs["a"].env.get("SOAK_CANARY_OVERLAY") != "good":
            return _fail("the bad overlay reached the seed specs")
        with open(os.path.join(fleet_dir, "canary-bad", "canary.json")) as f:
            doc = json.load(f)
        if doc["state"] != "rolled_back" or doc["breach"]["kind"] != "slo":
            return _fail(f"canary.json verdict wrong: {doc}")

        events = tele.read_events(os.path.join(tele_dir, "events.jsonl"))

        def _order(pool, *etypes):
            idx = []
            for et in etypes:
                found = [i for i, e in enumerate(events)
                         if e["type"] == et and e.get("pool") == pool]
                if not found:
                    return f"{pool}: no {et}"
                idx.append(found[0])
            if idx != sorted(idx):
                return f"{pool}: {list(zip(etypes, idx))} out of order"
            return None

        for problem in (
            _order("canary-good", "fleet.canary.start", "fleet.canary.observe",
                   "fleet.canary.promote"),
            _order("canary-bad", "fleet.canary.start", "fleet.canary.rollback",
                   "fleet.quarantine"),
        ):
            if problem:
                return _fail(f"canary event order: {problem}")
        rec.update(canary_legs_s=time.monotonic() - t_leg)
    finally:
        try:
            fc.shutdown()
        except Exception as e:  # noqa: BLE001 — teardown must not mask
            print(f"[soak] fleet shutdown: {e}", file=sys.stderr)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # the pools that shut down cleanly report their kernel launches
    reports = [oracle_report] + [
        _read_report(p[: -len(".json")])
        for p in sorted(glob.glob(os.path.join(fleet_dir, "*", "pool_g*.json")))
    ]
    rec.update(launches=[r.get("launches") for r in reports])
    problem = _launch_problem(args, reports, "fused_diffusion_steps")
    if problem:
        return _report("fleet", False, problem)
    record = {
        "requests": len(accepted),
        "rerouted_pool": victim,
        "traced_requests": sum(1 for m in accepted.values() if m.get("trace_id")),
        "canary": {"promoted": "canary-good", "rolled_back": "canary-bad"},
    }
    with open(os.path.join(workdir, "fleet_soak.json"), "w") as f:
        json.dump(record, f, indent=1)
    return _report(
        "fleet", True,
        f"{len(accepted)} requests, pool {victim!r} chaos-killed -> "
        f"detect/reroute/recovered with zero failed requests, all digests "
        f"== oracle; every request's causal tree reconstructed across "
        f"pools/generations (detect→reroute hop + both victim gens); "
        f"canary promote + doctored-slow rollback (breach=slo); "
        f"{_launch_note(reports, 'fused_diffusion_steps')}",
    )

