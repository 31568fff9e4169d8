"""`RunSupervisor`: launch and own a multi-process run end to end.

The port's copy of the JAX package's ``supervisor/manager.py``.  One
difference: each rank of an incarnation gets its own ``RANK``,
``LOCAL_RANK`` and ``WORLD_SIZE`` (the port's processes join a
`torch.distributed` group, where the JAX package's children share one
environment), and every incarnation gets a fresh ``MASTER_ADDR`` /
``MASTER_PORT`` rendezvous, so a restarted gloo or NCCL group never meets
the dead group's port.

The orchestration loop of the subsystem: spawn the ranks of one
*incarnation*, watch them — process
liveness plus each rank's liveplane ``/healthz`` endpoint (discovered via
the ``liveplane.p<rank>.json`` endpoint files) — collect the evidence
(flight bundles, latched ``alert.*`` events, checkpoint-integrity events),
classify what failed (`supervisor.classify`), ask the policy engine what
to do (`supervisor.policy.decide`), and execute: fence the superseded
generation (`supervisor.generation.publish_generation` BEFORE the kill —
a zombie that outlives its SIGKILL is refused at every publish path), then
relaunch in place, shrink a rung, scale back up, or give up.  Each
transition lands as ``supervisor.detect`` → ``supervisor.classify`` →
``supervisor.recover`` events in the shared telemetry dir, so the recovery
timeline is machine-verifiable next to the workers' own events.

Fault-spec hygiene across incarnations: the supervisor owns the
``IGG_FAULT_INJECT`` spec (including ``chaos:`` expansion,
`utils.resilience.chaos_schedule`) and prunes faults that already FIRED —
matched against the workers' ``fault.*`` events — from the next
incarnation's environment, extending the injector's fire-once semantics
across restarts (a crash at step N must not re-crash the incarnation that
resumes from the step-N checkpoint).

This module runs strictly host-side: subprocesses, files, HTTP scrapes —
never a device, never a collective (the supervisor must keep deciding
while the fabric it supervises is wedged).
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import json
import os
import socket
import subprocess
import time
import urllib.request
from typing import Callable, Sequence

from ..utils import config as _config
from ..utils import telemetry as _telemetry
from ..utils import tracing as _tracing
# NOTE: the package __init__ re-exports the `classify` FUNCTION under the
# same name as its module, so names must be imported from the module by
# its dotted path, never via a package attribute.
from .classify import RESIZE_STATUS as _RESIZE_STATUS
from .classify import classify as _classify_incident
from .classify import collect_evidence as _collect_evidence
from . import generation as _generation
from . import policy as _policy

__all__ = [
    "Incarnation",
    "RunSupervisor",
    "SupervisorReport",
]

DEFAULT_POLL_S = 0.5
#: grace given to surviving ranks after a peer died before they are reaped
DEFAULT_GRACE_S = 20.0


@dataclasses.dataclass
class Incarnation:
    """One generation's live processes (+ their logs and endpoints)."""

    generation: int
    rung: int
    nranks: int
    procs: list
    log_paths: list
    t0: float
    endpoints: dict = dataclasses.field(default_factory=dict)
    observations: list = dataclasses.field(default_factory=list)

    def poll(self) -> list:
        return [p.poll() for p in self.procs]

    def alive(self) -> bool:
        return any(rc is None for rc in self.poll())

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass


@dataclasses.dataclass
class SupervisorReport:
    """What one supervised run did, incident by incident."""

    ok: bool
    reason: str
    incidents: list
    generations: int
    final_rung: int
    quarantined: tuple

    def summary(self) -> str:
        legs = ",".join(
            i["decision"]["action"] for i in self.incidents
        ) or "clean"
        return (
            f"{'OK' if self.ok else 'FAILED'} after "
            f"{self.generations + 1} incarnation(s) [{legs}] "
            f"({self.reason})"
        )


def _free_port(host: str) -> int:
    """A port no process listens on now: one incarnation's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _scrape_health(host: str, port: int, timeout: float = 2.0) -> dict | None:
    try:
        with urllib.request.urlopen(
            f"http://{host}:{port}/healthz", timeout=timeout
        ) as r:
            return json.loads(r.read().decode())
    except (OSError, ValueError):
        return None


class RunSupervisor:
    """Failure-domain manager for one multi-process run (module docstring).

    ``command_for(rank, nranks, rung, generation)`` — argv of one rank of
    one incarnation (the supervisor adds the generation/fence/telemetry/
    fault environment and the rank's process-group variables, see
    `_child_env`).  ``ladder`` — process count per rung, rung 0 the
    preferred (largest) topology; shrink walks down the list.  ``workdir``
    — logs + the fence file; ``telemetry_dir`` — the shared evidence dir
    the workers write (armed in their env).  ``fault_spec`` — the
    ``IGG_FAULT_INJECT`` value the FIRST incarnation runs under (chaos
    specs expand; fired faults are pruned per relaunch).  ``env`` — extra
    child environment.  ``drive`` — optional per-incarnation callable
    ``(incarnation) -> None`` run after spawn (a load generator); when
    given, the supervisor's own health polling is skipped while it runs.
    ``on_resize(plan) -> rung`` — maps a workload-published ``resize.json``
    onto the ladder (required to supervise a front door).
    """

    def __init__(
        self,
        command_for: Callable[[int, int, int, int], Sequence[str]],
        *,
        ladder: Sequence[int],
        workdir: str,
        telemetry_dir: str,
        policy: "_policy.RecoveryPolicy | None" = None,
        fault_spec: str | None = None,
        env: dict | None = None,
        drive: Callable | None = None,
        on_resize: Callable[[dict], int] | None = None,
        resize_plan_path: str | None = None,
        initial_rung: int = 0,
        preferred_rung: int = 0,
        poll_s: float | None = None,
        grace_s: float = DEFAULT_GRACE_S,
        name: str = "run",
    ):
        if not ladder or any(int(n) < 1 for n in ladder):
            raise ValueError(f"ladder must be >= 1 process per rung: {ladder}")
        if not 0 <= initial_rung < len(ladder):
            raise ValueError(
                f"initial_rung {initial_rung} outside the ladder ({ladder})"
            )
        self.command_for = command_for
        self.ladder = [int(n) for n in ladder]
        self.workdir = os.fspath(workdir)
        self.telemetry_dir = os.fspath(telemetry_dir)
        self.policy = (
            policy if policy is not None else _policy.RecoveryPolicy.from_env()
        )
        self.env = dict(env or {})
        self.drive = drive
        self.on_resize = on_resize
        self.resize_plan_path = resize_plan_path
        self.preferred_rung = preferred_rung
        env_poll = _config.supervise_poll_env()
        self.poll_s = (
            poll_s if poll_s is not None
            else (env_poll if env_poll is not None else DEFAULT_POLL_S)
        )
        self.grace_s = grace_s
        self.name = name
        self.state = _policy.SupervisorState(rung=initial_rung)
        # the armed fault schedule, pruned of fired faults per relaunch
        from ..utils import resilience as _resilience

        self._fault_specs = list(_resilience.expand_fault_spec(fault_spec))
        # per-file byte offsets for incremental evidence reads: each
        # incident parses only the lines appended since the last one
        self._evidence_offsets: dict = {}

    # - events (the supervisor's own timeline) -

    def _event(self, etype: str, **payload) -> None:
        _telemetry.event(etype, supervisor=self.name, **payload)

    # - launch -

    def _child_env(self, rank: int, nranks: int, master_port: int) -> dict:
        """One rank's environment: the supervisor's generation, fence,
        telemetry and fault knobs, and the rank's own ``RANK`` /
        ``LOCAL_RANK`` / ``WORLD_SIZE`` with the incarnation's rendezvous
        (``MASTER_ADDR``, a fresh ``MASTER_PORT``)."""
        env = dict(os.environ)
        env.pop("IGG_FAULT_INJECT", None)
        env.update(self.env)
        env["IGG_TELEMETRY"] = env.get("IGG_TELEMETRY", "1")
        env["IGG_TELEMETRY_DIR"] = self.telemetry_dir
        env["IGG_GENERATION"] = str(self.state.generation)
        env["IGG_FENCE_DIR"] = self.workdir
        if self._fault_specs:
            env["IGG_FAULT_INJECT"] = ",".join(self._fault_specs)
        env.setdefault("MASTER_ADDR", "127.0.0.1")
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nranks),
                   MASTER_PORT=str(master_port))
        return env

    def launch(self) -> Incarnation:
        """Spawn one incarnation at the current rung/generation (fence
        published first: the authoritative token always leads the procs
        that carry it).  Spawning runs under an ``igg.supervisor.launch``
        span: a request context active across a restart (the serving
        resize path) ties the relaunch into the affected requests'
        causal trees."""
        gen, rung = self.state.generation, self.state.rung
        nranks = self.ladder[rung]
        with _tracing.trace_span("igg.supervisor.launch", generation=gen,
                                 rung=rung, nranks=nranks):
            _generation.publish_generation(
                gen, self.workdir, rung=rung, nranks=nranks
            )
            os.makedirs(self.workdir, exist_ok=True)
            master_port = _free_port(self.env.get("MASTER_ADDR", "127.0.0.1"))
            procs, logs = [], []
            t0 = time.time()
            for rank in range(nranks):
                env = self._child_env(rank, nranks, master_port)
                log_path = os.path.join(
                    self.workdir, f"{self.name}_g{gen}_r{rank}.log"
                )
                logs.append(log_path)
                f = open(log_path, "w")
                try:
                    procs.append(subprocess.Popen(
                        list(self.command_for(rank, nranks, rung, gen)),
                        env=env, stdout=f, stderr=subprocess.STDOUT, text=True,
                    ))
                finally:
                    f.close()  # the child holds its own descriptor
            inc = Incarnation(
                generation=gen, rung=rung, nranks=nranks, procs=procs,
                log_paths=logs, t0=t0,
            )
        self._event(
            "supervisor.launch", generation=gen, rung=rung, nranks=nranks,
            faults=list(self._fault_specs), master_port=master_port,
        )
        return inc

    # - monitoring -

    def _discover_endpoints(self, inc: Incarnation) -> None:
        for path in _glob.glob(
            os.path.join(self.telemetry_dir, "liveplane.p*.json")
        ):
            try:
                with open(path) as f:
                    doc = json.load(f)
                if float(doc.get("ts") or 0) < inc.t0:
                    continue  # a previous incarnation's endpoint file
                inc.endpoints[int(doc["rank"])] = (doc["host"], doc["port"])
            except (OSError, ValueError, KeyError, TypeError):
                continue

    def _health_pass(self, inc: Incarnation) -> None:
        """One scrape sweep: live CRITICAL alerts become ``supervisor.detect``
        observations (once per (rule, rank) per incarnation)."""
        self._discover_endpoints(inc)
        for rank, (host, port) in sorted(inc.endpoints.items()):
            doc = _scrape_health(host, port)
            if not doc:
                continue
            for alert in doc.get("alerts", {}).get("active", []):
                key = (alert.get("rule"), rank)
                if key in {(o["rule"], o["rank"]) for o in inc.observations}:
                    continue
                obs = {
                    "rule": alert.get("rule"),
                    "severity": alert.get("severity"),
                    "rank": rank,
                    "source": "healthz",
                    "evidence": alert.get("evidence"),
                }
                inc.observations.append(obs)
                self._event(
                    "supervisor.detect", generation=inc.generation, **obs
                )

    def monitor(self, inc: Incarnation, timeout: float) -> list:
        """Watch one incarnation until every rank exited: liveness polling
        + liveplane health scrapes.  A rank dying puts the survivors on a
        grace clock (they are stranded mid-collective) before the reap.
        Returns the per-rank exit statuses (None = killed while running).
        """
        deadline = time.monotonic() + timeout
        first_death: float | None = None
        while True:
            rcs = inc.poll()
            if all(rc is not None for rc in rcs):
                return rcs
            now = time.monotonic()
            # RESIZE_STATUS is a clean, REQUESTED exit (the workload asked
            # for a new topology): it must not start the grace clock —
            # SIGKILLing the peers mid-resize-teardown would turn the
            # resize into a phantom crash and orphan the published plan.
            bad = [
                rc for rc in rcs if rc not in (None, 0, _RESIZE_STATUS)
            ]
            if bad and first_death is None:
                first_death = now
                self._event(
                    "supervisor.detect", generation=inc.generation,
                    source="liveness", rcs=rcs,
                )
            if first_death is not None and now - first_death > self.grace_s:
                inc.kill()
                return inc.poll()
            if now > deadline:
                self._event(
                    "supervisor.detect", generation=inc.generation,
                    source="timeout", rcs=rcs,
                )
                inc.kill()
                return inc.poll()
            if self.drive is None:
                self._health_pass(inc)
            time.sleep(self.poll_s)

    # - fault hygiene -

    def _prune_fired_faults(self, evidence: dict, since_ts: float) -> None:
        """Drop faults whose ``fault.*`` event is on this incarnation's
        timeline.  Reads the ALREADY-collected evidence (one JSONL parse
        per incident, shared with classification) — the event history
        grows with every incarnation, so re-scanning it here would double
        an unbounded cost."""
        from ..utils import resilience as _resilience

        if not self._fault_specs:
            return
        fired = [
            e for e in evidence.get("events", [])
            if str(e.get("type", "")).startswith("fault.")
            and float(e.get("ts") or 0) >= since_ts
        ]
        remaining = [
            spec for spec in self._fault_specs
            if not _resilience.fault_event_matches_spec(fired, spec)
        ]
        if remaining != self._fault_specs:
            self._event(
                "supervisor.faults_pruned",
                fired=[s for s in self._fault_specs if s not in remaining],
                remaining=remaining,
            )
            self._fault_specs = remaining

    # - the loop -

    def run(self, *, timeout: float = 600.0,
            max_incarnations: int = 16) -> SupervisorReport:
        """Drive the run to completion (module docstring).  ``timeout`` is
        per incarnation; ``max_incarnations`` bounds the whole loop (a
        backstop far above any sane recovery sequence)."""
        incidents: list = []
        prev_dir = os.environ.get("IGG_TELEMETRY_DIR")
        os.environ["IGG_TELEMETRY_DIR"] = self.telemetry_dir
        try:
            return self._run(timeout, max_incarnations, incidents)
        finally:
            if prev_dir is None:
                os.environ.pop("IGG_TELEMETRY_DIR", None)
            else:
                os.environ["IGG_TELEMETRY_DIR"] = prev_dir

    def _run(self, timeout, max_incarnations, incidents) -> SupervisorReport:
        for _ in range(max_incarnations):
            inc = self.launch()
            if self.drive is not None:
                try:
                    self.drive(inc)
                except Exception as e:
                    inc.kill()
                    return self._report(
                        False, f"drive hook failed: {e!r}", incidents
                    )
            rcs = self.monitor(inc, timeout)
            # the reap-time detection marker: whatever the liveness/health
            # polling saw mid-flight, the timeline ALWAYS carries detect →
            # classify → recover in order for every incident
            self._event(
                "supervisor.detect", generation=inc.generation,
                source="exit", rcs=list(rcs),
            )
            evidence = _collect_evidence(
                self.telemetry_dir, offsets=self._evidence_offsets
            )
            incident = _classify_incident(rcs, evidence, since_ts=inc.t0)
            # fold the incident into the strike bookkeeping BEFORE the
            # decision (integrity failures accumulate toward quarantine)
            self.state.record_incident(incident)
            # observations the health scrapes made while the loop was
            # still wedged ride into the record (the classifier already
            # sees their event-log twins)
            self._event(
                "supervisor.classify", generation=inc.generation,
                kind=incident.kind, ranks=list(incident.ranks),
                rcs=list(rcs), detail=incident.detail,
            )
            decision = _policy.decide(
                incident, self.state, self.policy,
                ladder_len=len(self.ladder),
                preferred_rung=self.preferred_rung,
            )
            if incident.kind == "resize":
                decision = self._resize_decision(decision)
                if decision is None:
                    return self._report(
                        False, "resize exit without a readable plan",
                        incidents,
                    )
            incidents.append({
                "generation": inc.generation,
                "rung": inc.rung,
                "kind": incident.kind,
                "rcs": list(rcs),
                "detail": incident.detail,
                "observations": list(inc.observations),
                "decision": {
                    "action": decision.action,
                    "rung": decision.rung,
                    "reason": decision.reason,
                },
            })
            self._event(
                "supervisor.recover", generation=inc.generation,
                action=decision.action, rung=decision.rung,
                reason=decision.reason,
                quarantined=list(decision.quarantined),
            )
            if decision.action == "none":
                return self._report(True, "run completed", incidents)
            if decision.action == "give_up":
                # the terminal verdict's quarantine still lands in the
                # state so the report / supervisor.done name the bad ranks
                self.state.quarantined.update(decision.quarantined)
                return self._report(False, decision.reason, incidents)
            if decision.action == "scale_up" and incident.kind == "healthy":
                # a bounded job that finished healthy has nothing left to
                # scale for; a service workload signals growth via resize
                return self._report(True, "run completed", incidents)
            if decision.delay_s:
                time.sleep(decision.delay_s)
            self.state.apply(decision)
            # Fence FIRST, then reap: a zombie that survives the kill is
            # refused at every publish path by the already-moved token.
            _generation.publish_generation(
                self.state.generation, self.workdir,
                rung=self.state.rung, reason=decision.action,
            )
            inc.kill()
            self._prune_fired_faults(evidence, inc.t0)
        return self._report(
            False, f"gave up after {max_incarnations} incarnations",
            incidents,
        )

    def _resize_decision(self, decision) -> "_policy.Decision | None":
        """Resolve a workload-requested resize into a concrete next rung
        via the ``resize.json`` plan + the ``on_resize`` mapping."""
        plan_path = self.resize_plan_path
        if plan_path is None or self.on_resize is None:
            return None
        try:
            with open(plan_path) as f:
                plan = json.load(f)
            os.remove(plan_path)
            rung = int(self.on_resize(plan))
        except (OSError, ValueError, TypeError, KeyError):
            # KeyError included: on_resize callbacks index the plan's
            # fields directly — a plan missing one must become the
            # designed failure report, not a traceback out of run()
            return None
        if not 0 <= rung < len(self.ladder):
            return None
        return dataclasses.replace(
            decision, rung=rung,
            reason=f"workload resize plan -> rung {rung} "
                   f"({plan.get('reason')})",
        )

    def _report(self, ok: bool, reason: str, incidents) -> SupervisorReport:
        report = SupervisorReport(
            ok=ok,
            reason=reason,
            incidents=incidents,
            generations=self.state.generation,
            final_rung=self.state.rung,
            quarantined=tuple(sorted(self.state.quarantined)),
        )
        self._event(
            "supervisor.done", ok=ok, reason=reason,
            generations=report.generations,
            quarantined=list(report.quarantined),
        )
        return report
