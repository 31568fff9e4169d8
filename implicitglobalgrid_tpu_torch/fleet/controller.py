"""`FleetController`: launch and own N serving pools as one fleet.

The port's copy of the JAX package's ``fleet/controller.py``.  Where the
run supervisor owns the RANKS of one pool, the fleet controller owns the
POOLS of one fleet.  Each pool is a supervised incarnation in its own
failure domain — its own generation fence (a per-pool fence directory,
`supervisor.generation`), its own device subset (its process's
``CUDA_VISIBLE_DEVICES``, where the JAX package partitions ``XLA_FLAGS``),
its own telemetry dir, and its own front-door port, discovered through
the pool's ``frontdoor.p0.json`` endpoint file.

The state machine per pool is the supervisor's, one level up: **detect**
(process liveness + endpoint reachability) → **classify** (``died`` /
``wedged`` / ``hot`` / ``idle``) → **policy** (`fleet.policy.decide_pool`
— pure) → **fence + execute** (publish the bumped generation BEFORE the
kill, evacuate the pool's unfinished routes through the router, relaunch,
re-register).  Every transition is a structured event, in the order
``fleet.detect → fleet.reroute → fleet.recovered`` on the event log.

Canary rollout rides the same machinery (`fleet.canary.CanaryTracker`):
`start_canary` launches one extra pool under a candidate config (its env
carries the overlay, e.g. ``IGG_TUNE_CACHE``), the
controller's poll gates it on the canary's scraped SLO windows, and a
breach executes the rollback THROUGH the strike machinery — the canary
pool is struck to its respawn limit and quarantined, so a bad config's
blast radius is one pool for one streak window.

Host-side only, the `supervisor/` discipline: subprocesses, files, HTTP
scrapes — never a device.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import json
import os
import subprocess
import time
from typing import Callable, Sequence

from ..supervisor.classify import Incident
from ..supervisor import generation as _generation
from ..utils import config as _config
from ..utils import telemetry as _telemetry
from ..utils import tracing as _tracing
from . import canary as _canary
from . import policy as _policy
from .router import FleetRouter, scrape_health

__all__ = [
    "FleetController",
    "PoolSpec",
]

DEFAULT_POLL_S = 0.5
#: consecutive dark endpoint sweeps (process alive) before a pool is
#: classified ``wedged`` — one transient scrape drop must not kill a pool
WEDGE_AFTER = 2


@dataclasses.dataclass
class PoolSpec:
    """One pool's identity and isolation (the fleet's unit of failure).

    ``command_for(spec, generation) -> argv`` — how to launch the pool's
    serving process (the child runs its own ServingLoop + FrontDoor and
    writes its endpoint file); ``workdir`` — the pool's fence dir (its
    ``generation.json`` lives here) and log home; ``telemetry_dir`` — the
    pool's OWN evidence/event dir (per-pool event logs are what the drill
    audits); ``devices`` — the device subset (``"0"``, ``"2,3"``), the
    pool's ``CUDA_VISIBLE_DEVICES`` taken within the controller's own
    (`visible_devices`), quarantined as a unit; ``key`` — the
    routing contract (``{"model": ..., "size": ...}``); ``env`` — extra
    child environment (the canary's config overlay rides here).
    """

    name: str
    command_for: Callable[["PoolSpec", int], Sequence[str]]
    workdir: str
    telemetry_dir: str
    key: dict = dataclasses.field(default_factory=dict)
    devices: str | None = None
    env: dict = dataclasses.field(default_factory=dict)


def visible_devices(subset: str, parent: str | None) -> str:
    """The ``CUDA_VISIBLE_DEVICES`` of a pool whose device subset is
    ``subset``.  When the controller's own process has
    ``CUDA_VISIBLE_DEVICES`` set (``parent``), the subset's entries are
    indices into that list (parent ``"2,3"``, subset ``"1"`` gives
    ``"3"``), so a pool never leaves the cards its controller was given;
    an entry that is not an index into it raises `ValueError`.  With no
    ``parent`` the subset names the cards as given."""
    if parent is None:
        return subset
    visible = [d.strip() for d in parent.split(",") if d.strip()]
    out = []
    for entry in subset.split(","):
        entry = entry.strip()
        if not entry.isdigit() or int(entry) >= len(visible):
            raise ValueError(
                f"device subset {subset!r}: {entry!r} is not an index into "
                f"the controller's CUDA_VISIBLE_DEVICES={parent!r}"
            )
        out.append(visible[int(entry)])
    return ",".join(out)


class _PoolHandle:
    """One pool incarnation's live process (+ log and discovery state)."""

    def __init__(self, proc, log_path: str, generation: int, t0: float):
        self.proc = proc
        self.log_path = log_path
        self.generation = generation
        self.t0 = t0
        self.endpoint: str | None = None

    def poll(self):
        return self.proc.poll()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def _popen_spawn(argv: Sequence[str], env: dict, log_path: str):
    f = open(log_path, "w")
    try:
        return subprocess.Popen(
            list(argv), env=env, stdout=f, stderr=subprocess.STDOUT,
            text=True,
        )
    finally:
        f.close()  # the child holds its own descriptor


class FleetController:
    """Failure-domain manager for a fleet of pools (module docstring).

    ``specs`` — the seed pools; ``router`` — the `FleetRouter` front door
    (constructed here when None); ``policy`` — `fleet.policy.FleetPolicy`
    (env tier when None); ``spawn(argv, env, log_path) -> proc`` — the
    process hook (subprocess.Popen by default; tests inject fakes);
    ``scrape(endpoint) -> health | None`` — the health hook.
    """

    def __init__(self, specs: Sequence[PoolSpec], *,
                 router: FleetRouter | None = None,
                 policy: "_policy.FleetPolicy | None" = None,
                 poll_s: float | None = None,
                 spawn=None, scrape=None):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"pool names must be unique: {names}")
        parent = os.environ.get("CUDA_VISIBLE_DEVICES")
        for s in specs:  # refuse a subset off the controller's cards up front
            if s.devices is not None:
                visible_devices(str(s.devices), parent)
        self.specs: dict[str, PoolSpec] = {s.name: s for s in specs}
        self.router = router if router is not None else FleetRouter()
        self.policy = (
            policy if policy is not None else _policy.FleetPolicy.from_env()
        )
        env_poll = _config.fleet_poll_env()
        self.poll_s = (
            poll_s if poll_s is not None
            else (env_poll if env_poll is not None else DEFAULT_POLL_S)
        )
        self.spawn = spawn or _popen_spawn
        self.scrape = scrape or scrape_health
        self.state = _policy.FleetState()
        self.handles: dict[str, _PoolHandle] = {}
        self.generations: dict[str, int] = {}
        #: pools the fleet itself spawned (spill targets) — only these retire
        self.spilled: set[str] = set()
        #: pools told to shut down (a clean exit is not an incident)
        self._retiring: set[str] = set()
        self._dark: dict[str, int] = {}
        self._spill_serial = 0
        self.canary: "_canary.CanaryTracker | None" = None

    # - events -

    def _event(self, etype: str, **payload) -> None:
        _telemetry.event(etype, fleet="fleet", **payload)

    # - launch / discovery -

    def _child_env(self, spec: PoolSpec, generation: int) -> dict:
        env = dict(os.environ)
        env.update(spec.env)
        env["IGG_TELEMETRY"] = env.get("IGG_TELEMETRY", "1")
        env["IGG_TELEMETRY_DIR"] = spec.telemetry_dir
        env["IGG_GENERATION"] = str(generation)
        env["IGG_FENCE_DIR"] = spec.workdir
        if spec.devices is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible_devices(
                str(spec.devices), os.environ.get("CUDA_VISIBLE_DEVICES"))
        return env

    def launch_pool(self, name: str, *, canary: bool = False) -> _PoolHandle:
        """Spawn one pool incarnation (fence published FIRST: the
        authoritative token always leads the processes that carry it —
        the `RunSupervisor.launch` discipline)."""
        spec = self.specs[name]
        gen = self.generations.setdefault(name, 0)
        _generation.publish_generation(gen, spec.workdir, pool=name)
        os.makedirs(spec.workdir, exist_ok=True)
        os.makedirs(spec.telemetry_dir, exist_ok=True)
        log_path = os.path.join(spec.workdir, f"{name}_g{gen}.log")
        proc = self.spawn(
            list(spec.command_for(spec, gen)),
            self._child_env(spec, gen), log_path,
        )
        handle = _PoolHandle(proc, log_path, gen, time.time())
        self.handles[name] = handle
        self._dark[name] = 0
        self._event(
            "fleet.pool_launch", pool=name, generation=gen,
            devices=spec.devices, canary=canary,
        )
        return handle

    def discover_endpoint(self, name: str) -> str | None:
        """The pool's front-door ``host:port`` from its endpoint file
        (``frontdoor.p*.json`` under the pool's OWN telemetry dir).  Files
        older than the
        current incarnation's launch are a superseded door's leftovers
        and are skipped (the ``ts >= t0`` staleness check)."""
        handle = self.handles.get(name)
        if handle is None:
            return None
        if handle.endpoint is not None:
            return handle.endpoint
        spec = self.specs[name]
        for path in sorted(_glob.glob(
            os.path.join(spec.telemetry_dir, "frontdoor.p*.json")
        )):
            try:
                with open(path) as f:
                    doc = json.load(f)
                if float(doc.get("ts") or 0) < handle.t0:
                    continue
                handle.endpoint = f"{doc['host']}:{doc['port']}"
            except (OSError, ValueError, KeyError, TypeError):
                continue
        if handle.endpoint is not None:
            self.router.register_pool(
                name, handle.endpoint, key=self.specs[name].key,
                canary=(self.canary is not None
                        and self.canary.pool == name),
            )
        return handle.endpoint

    def launch(self, *, wait_s: float = 60.0) -> None:
        """Bring the seed fleet up: spawn every pool, then wait for each
        endpoint file (a pool that never opens its door within ``wait_s``
        is classified ``died`` on the first poll)."""
        for name in list(self.specs):
            self.launch_pool(name)
        deadline = time.monotonic() + wait_s
        pending = set(self.specs)
        while pending and time.monotonic() < deadline:
            for name in sorted(pending):
                if self.discover_endpoint(name) is not None:
                    pending.discard(name)
                    self._event("fleet.pool_up", pool=name,
                                endpoint=self.handles[name].endpoint)
                elif self.handles[name].poll() is not None:
                    pending.discard(name)  # died during bring-up: poll_once
            if pending:
                time.sleep(min(0.2, self.poll_s))

    # - detect / classify -

    def _pool_incident(self, name: str) -> Incident | None:
        handle = self.handles.get(name)
        spec = self.specs[name]
        if handle is None:
            return None
        rc = handle.poll()
        if rc is not None:
            if name in self._retiring and rc == 0:
                return None  # a requested shutdown is a retirement, not a death
            return Incident(
                kind="died", ranks=(), rcs=(rc,),
                detail={"pool": name, "devices": spec.devices, "rc": rc},
            )
        endpoint = self.discover_endpoint(name)
        if endpoint is None:
            return None  # still booting; `launch` bounded the wait
        health = self.scrape(endpoint)
        if health is None:
            self._dark[name] = self._dark.get(name, 0) + 1
            if self._dark[name] >= WEDGE_AFTER:
                return Incident(
                    kind="wedged", ranks=(), rcs=(None,),
                    detail={"pool": name, "devices": spec.devices,
                            "dark_sweeps": self._dark[name]},
                )
            return None
        self._dark[name] = 0
        serving = health.get("serving") or {}
        queue = serving.get("queue_depth") or 0
        members = serving.get("active_members") or 0
        self.state.record_health(
            name, queue_depth=queue, active_members=members
        )
        if (
            self.policy.spill_queue is not None
            and queue >= self.policy.spill_queue
        ):
            return Incident(
                kind="hot", ranks=(), rcs=(),
                detail={"pool": name, "queue_depth": queue},
            )
        if not queue and not members:
            return Incident(kind="idle", ranks=(), rcs=(),
                            detail={"pool": name})
        return Incident(kind="healthy", ranks=(), rcs=(),
                        detail={"pool": name})

    # - execute -

    def _respawn(self, name: str, reason: str) -> None:
        """Fence → evacuate → kill → relaunch → re-adopt: the ordered
        recovery one pool death costs.  The generation moves FIRST so a
        zombie that outlives its SIGKILL is refused at every publish
        path; the routes move BEFORE the relaunch so no request ever
        waits on the reboot."""
        spec = self.specs[name]
        handle = self.handles.get(name)
        # The detection→evacuation hop belongs to every stranded request's
        # causal tree: one span tagged with the victim routes' trace ids
        # (the reroute span `evacuate` opens nests under it).
        with self.router._lock:
            trace_ids = sorted({
                r["trace"]["trace_id"] for r in self.router.routes.values()
                if r["pool"] == name and r["done"] is None and r.get("trace")
            })
        span_tags = {"trace_ids": trace_ids} if trace_ids else {}
        with _tracing.trace_span("igg.fleet.detect", pool=name,
                                 reason=reason, **span_tags):
            self.generations[name] = self.generations.get(name, 0) + 1
            _generation.publish_generation(
                self.generations[name], spec.workdir, pool=name, reason=reason
            )
            if handle is not None:
                handle.kill()
            self.router.unregister_pool(name)
            self.router.evacuate(name)
        self.launch_pool(name)
        deadline = time.monotonic() + 60.0
        while (
            self.discover_endpoint(name) is None
            and time.monotonic() < deadline
            and self.handles[name].poll() is None
        ):
            time.sleep(min(0.2, self.poll_s))
        # routes evacuation could not place (no surviving pool was
        # eligible) are re-homed onto the fresh incarnation
        self.router.evacuate(name, exclude=set())
        self._event(
            "fleet.recovered", pool=name, action="respawn",
            generation=self.generations[name],
            endpoint=self.handles[name].endpoint,
        )

    def _quarantine(self, name: str, decision) -> None:
        spec = self.specs[name]
        handle = self.handles.get(name)
        self.router.quarantine_pool(name)
        self.router.evacuate(name)
        if handle is not None:
            handle.kill()
        self._event(
            "fleet.quarantine", pool=name, devices=spec.devices,
            reason=decision.reason,
        )

    def _spill(self, name: str) -> None:
        """Clone the hot pool's spec onto fresh dirs/port and spawn it —
        growth WITHOUT resizing a live pool (the fleet answer to the
        autoscaler's checkpoint-restart cycle)."""
        base = self.specs[name]
        self._spill_serial += 1
        spill_name = f"{name}-spill{self._spill_serial}"
        spec = PoolSpec(
            name=spill_name,
            command_for=base.command_for,
            workdir=os.path.join(base.workdir, spill_name),
            telemetry_dir=os.path.join(base.telemetry_dir, spill_name),
            key=dict(base.key),
            devices=base.devices,
            env=dict(base.env),
        )
        self.specs[spill_name] = spec
        self.spilled.add(spill_name)
        self.launch_pool(spill_name)
        self._event("fleet.spill", pool=name, spill=spill_name)

    def _retire(self, name: str) -> None:
        handle = self.handles.get(name)
        self._retiring.add(name)
        if handle is not None and handle.endpoint is not None:
            self.router.transport(
                handle.endpoint, "POST", "/v1/shutdown", {}
            )
        self.router.unregister_pool(name)
        self._event("fleet.retire", pool=name)

    def execute(self, decision: "_policy.FleetDecision") -> None:
        """Apply one fleet-policy verdict (bookkeeping folded first, the
        `SupervisorState.apply` discipline)."""
        self.state.apply(decision)
        if decision.action == "respawn":
            self._respawn(decision.pool, decision.reason)
        elif decision.action == "quarantine":
            self._quarantine(decision.pool, decision)
        elif decision.action == "spill":
            self._spill(decision.pool)
        elif decision.action == "retire":
            self._retire(decision.pool)

    # - the poll loop -

    def poll_once(self) -> list:
        """One detect → classify → policy → execute sweep over every pool
        (+ one canary gate evaluation).  Returns the executed decisions."""
        executed = []
        for name in sorted(self.handles):
            if name in self._retiring:
                continue
            incident = self._pool_incident(name)
            if incident is None or incident.kind == "healthy":
                if incident is not None:
                    self.state.apply(_policy.FleetDecision(
                        action="none", pool=name, reason="healthy"
                    ))
                continue
            if (
                self.canary is not None
                and self.canary.state == "baking"
                and name == self.canary.pool
            ):
                # a dying/wedged BAKING canary is a breach of the config
                # under trial, not a pool to respawn under it: feed the
                # gate an unreachable observation and let the rollback
                # path (strike machinery) do the rest
                if incident.kind in ("died", "wedged"):
                    self._event("fleet.detect", pool=name, kind=incident.kind,
                                canary=True)
                    self.canary.observe(None)
                    self._publish_canary()
                    self._canary_rollback()
                continue
            if incident.kind in ("died", "wedged"):
                self._event(
                    "fleet.detect", pool=name, kind=incident.kind,
                    **{k: v for k, v in (incident.detail or {}).items()
                       if k != "pool"},
                )
            decision = _policy.decide_pool(
                incident, self.state, self.policy,
                spilled=name in self.spilled,
            )
            if decision.action != "none":
                self.execute(decision)
                executed.append(decision)
        if self.canary is not None and self.canary.state == "baking":
            self._canary_gate()
        return executed

    def run(self, *, until: Callable[[], bool], timeout: float = 600.0) -> None:
        """Poll at the fleet cadence until ``until()`` or ``timeout``."""
        deadline = time.monotonic() + timeout
        while not until() and time.monotonic() < deadline:
            self.poll_once()
            time.sleep(self.poll_s)

    # - canary rollout -

    def start_canary(self, spec: PoolSpec, candidate: dict) -> None:
        """Launch one canary pool under ``candidate`` (its config overlay
        rides ``spec.env`` — e.g. ``IGG_TUNE_CACHE`` pointing at the
        trial layer) and arm the SLO gate."""
        if self.canary is not None and self.canary.state == "baking":
            raise RuntimeError(
                f"a canary is already baking ({self.canary.pool})"
            )
        self.specs[spec.name] = spec
        self.spilled.add(spec.name)  # a rolled-back canary may retire
        self.canary = _canary.CanaryTracker(
            pool=spec.name, candidate=candidate, policy=self.policy
        )
        self.launch_pool(spec.name, canary=True)
        self._publish_canary()

    def _publish_canary(self) -> None:
        if self.canary is None:
            return
        spec = self.specs.get(self.canary.pool)
        if spec is not None:
            _canary.publish_canary_state(spec.workdir, self.canary.doc())

    def _canary_gate(self) -> None:
        """One canary observation: scrape the canary pool, feed the
        tracker, and execute promote/rollback."""
        tracker = self.canary
        name = tracker.pool
        endpoint = self.discover_endpoint(name)
        health = self.scrape(endpoint) if endpoint is not None else None
        if health is None and endpoint is None:
            return  # still booting — the gate starts at the first scrape
        verdict = tracker.observe(health)
        self._publish_canary()
        if verdict == "promoted":
            # the candidate is fleet-safe: non-canary pools pick the
            # overlay up on their next (re)launch
            for other in self.specs.values():
                if other.name != name:
                    other.env.update(self.specs[name].env)
        elif verdict == "rolled_back":
            self._event("fleet.detect", pool=name, kind="canary_breach",
                        breach=tracker.breach)
            self._canary_rollback()

    def _canary_rollback(self) -> None:
        """The strike machinery IS the rollback path: the canary pool is
        struck straight to its limit and quarantined, so the candidate
        never reaches a second pool."""
        tracker = self.canary
        name = tracker.pool
        self.state.respawns[name] = self.policy.respawn_limit
        incident = Incident(
            kind="died", ranks=(), rcs=(None,),
            detail={"pool": name,
                    "devices": self.specs[name].devices,
                    "canary_breach": tracker.breach},
        )
        decision = _policy.decide_pool(incident, self.state, self.policy)
        self.execute(decision)

    # - teardown -

    def shutdown(self) -> None:
        """Stop every pool (clean doors first, then the reap) and the
        router."""
        for name, handle in sorted(self.handles.items()):
            if handle.endpoint is not None and handle.poll() is None:
                self.router.transport(
                    handle.endpoint, "POST", "/v1/shutdown", {}
                )
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and any(
            h.poll() is None for h in self.handles.values()
        ):
            time.sleep(0.1)
        for handle in self.handles.values():
            handle.kill()
        self.router.close()
        self._event("fleet.shutdown", pools=sorted(self.handles))
