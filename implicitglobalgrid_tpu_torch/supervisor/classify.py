"""Failure classification: exit evidence -> a named failure class.

The port's copy of the JAX package's ``supervisor/classify.py``: the same
classes, precedence and incident records on the same evidence.

The supervisor's detect step yields raw evidence — per-rank exit statuses,
crash flight bundles (``flight_<rank>.json``), latched ``alert.*`` events
and checkpoint-integrity events from the per-rank JSONL logs, live
``/healthz`` scrapes.  This module turns that evidence into ONE of a small
closed set of failure classes the policy engine can act on.  Everything
here is a pure function of already-collected data: no processes, no
collectives, no clocks — the tier-1 contract (`tests/test_supervisor.py`
pins the matrix with synthetic evidence).

Classes (`FAILURE_KINDS`):

``healthy``            every rank exited 0.
``resize``             every rank exited `serving.RESIZE_STATUS` — not a
                       failure: the pool asked its supervisor for a new
                       topology (the autoscaler contract).
``guard_trip``         a rank's flight bundle says the NaN/Inf guard
                       tripped (``guard.trip``) — numerical fault.
``gather_tripwire``    a rank's flight bundle carries
                       ``reason=gather_tripwire``: the deterministic
                       3-round gloo gather regression fired (a watch
                       item) — a *transport* fault, distinct from a
                       generic crash, so it is escalated by name instead
                       of vanishing into one.
``corrupt_checkpoint`` integrity machinery engaged: ``checkpoint.fallback``
                       / ``checkpoint.verify_failed`` events next to a
                       failed rank — the newest generation is damaged.
``silent_corruption``  an integrity-plane detector (transport checksum or
                       shadow-step audit, the `integrity` package) caught
                       a FINITE wrong value in flight and dumped a
                       ``reason=sdc`` bundle.  The incident implicates the
                       rank the DETECTOR names (``info.implicated_rank`` —
                       the sender of a bad slab, not the receiver that
                       noticed), because that is whose silicon is lying;
                       policy must quarantine it, never restart-in-place.
``step_stall``         a latched ``alert.step_stall`` (live-plane rule) or
                       a watchdog flight bundle: the loop wedged.
``straggler``          ``skew.straggler`` / ``alert.skew_sustained``
                       evidence without a crash: slow, not dead.
``crash``              a rank died (nonzero exit) with no more specific
                       marker — includes the injected ``worker_crash``
                       (status 17), which carries its injection event as
                       detail.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
import re
from typing import Sequence

__all__ = [
    "FAILURE_KINDS",
    "Incident",
    "classify",
    "collect_evidence",
]

FAILURE_KINDS = (
    "healthy",
    "resize",
    "guard_trip",
    "gather_tripwire",
    "corrupt_checkpoint",
    "silent_corruption",
    "step_stall",
    "straggler",
    "crash",
)

from ..utils.resilience import FaultInjector as _FaultInjector

#: exit status of `utils.resilience.FaultInjector.maybe_crash` (canonical
#: definition imported)
CRASH_STATUS = _FaultInjector.CRASH_STATUS
#: exit status of `serving.frontdoor` after publishing a resize plan.  A
#: literal copy: importing the serving package would pull the models into
#: this host-only module; `tests/test_torch_supervisor.py` pins the
#: equality.
RESIZE_STATUS = 19

#: flight-bundle reasons mapped straight to a class (most-specific wins —
#: ``sdc`` first: an integrity trip often cascades into guard trips and
#: crashes on peer ranks, and the root cause must not vanish into those)
_BUNDLE_KINDS = (
    ("sdc", "silent_corruption"),
    ("gather_tripwire", "gather_tripwire"),
    ("guard.trip", "guard_trip"),
    ("watchdog.deadline_exceeded", "step_stall"),
)


@dataclasses.dataclass(frozen=True)
class Incident:
    """One classified failure: the policy engine's input."""

    kind: str
    #: ranks implicated (exit != 0, or named by the evidence)
    ranks: tuple[int, ...]
    #: per-rank exit statuses as observed (None = still running when killed)
    rcs: tuple[int | None, ...]
    #: free-form evidence trail (event types, bundle reasons, alert rules)
    detail: dict

    @property
    def failed(self) -> bool:
        return self.kind not in ("healthy", "resize")


def _read_jsonl_tail(path: str, offsets: dict | None) -> list[dict]:
    """Parse a JSONL file, resuming from ``offsets[path]`` when an offset
    map is given (the supervisor's incremental read: a shared telemetry
    directory accumulates every incarnation's history, and re-parsing it
    whole per incident would make evidence collection quadratic over a
    long run).  The offset only ever advances past COMPLETE lines, so a
    torn trailing line is re-read — never silently skipped — once its
    writer finishes it."""
    import json

    start = offsets.get(path, 0) if offsets is not None else 0
    try:
        with open(path, "rb") as f:
            f.seek(start)
            data = f.read()
    except OSError:
        return []
    end = data.rfind(b"\n")
    if end < 0:
        return []
    if offsets is not None:
        offsets[path] = start + end + 1
    out = []
    for line in data[: end + 1].splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


def collect_evidence(telemetry_dir: str | None, *,
                     offsets: dict | None = None) -> dict:
    """Gather the on-disk evidence of one incarnation: flight bundles per
    rank and the latched ``alert.*`` / checkpoint-integrity / fault events
    from every per-rank JSONL log.  Tolerant of absence — a run without
    telemetry classifies on exit statuses alone.  ``offsets`` (a mutable
    ``{path: byte offset}`` the caller keeps across calls) switches to
    incremental reads: only lines appended since the previous collection
    are parsed — `RunSupervisor` passes its own map so per-incident cost
    tracks the incident, not the run's whole history."""
    evidence: dict = {"bundles": {}, "alerts": [], "events": []}
    if not telemetry_dir or not os.path.isdir(telemetry_dir):
        return evidence
    for path in sorted(_glob.glob(os.path.join(telemetry_dir, "flight_*.json"))):
        try:
            rank = int(os.path.basename(path)[len("flight_"):-len(".json")])
        except ValueError:
            continue
        bundles = _read_jsonl_tail(path, offsets)
        if bundles:
            evidence["bundles"][rank] = bundles
    for path in sorted(_glob.glob(os.path.join(telemetry_dir, "events*.jsonl"))):
        evidence["events"].extend(_read_jsonl_tail(path, offsets))
    evidence["alerts"] = [
        e for e in evidence["events"]
        if str(e.get("type", "")).startswith("alert.")
    ]
    return evidence


def _shard_ranks(ckpt_events: Sequence[dict]) -> tuple[int, ...]:
    """The WRITER ranks the integrity evidence names: `verify_checkpoint`
    problems spell the damaged shard file (``shards_pN.npz``), and shard N
    is written by rank N — the rank whose storage keeps corrupting, which
    is who quarantine must target (the exit-failed ranks may be innocent
    collateral of the ensuing recovery)."""
    ranks = set()
    for e in ckpt_events:
        for m in re.finditer(r"shards_p(\d+)\.npz", str(e.get("problem", ""))):
            ranks.add(int(m.group(1)))
    return tuple(sorted(ranks))


def _bundle_class(bundles: dict) -> tuple[str, int, str, dict] | None:
    """Most specific (kind, rank, reason, record) across every rank's
    bundles."""
    for reason, kind in _BUNDLE_KINDS:
        for rank, recs in sorted(bundles.items()):
            for rec in recs:
                if rec.get("reason") == reason:
                    return kind, rank, reason, rec
    return None


def classify(
    rcs: Sequence[int | None],
    evidence: dict | None = None,
    *,
    since_ts: float | None = None,
) -> Incident:
    """Classify one incarnation's outcome (module docstring).

    ``rcs`` — per-rank exit statuses in rank order.  ``evidence`` — a
    `collect_evidence` dict (optional).  ``since_ts`` — ignore evidence
    older than this wall-clock timestamp (a shared telemetry dir carries
    every incarnation's history; each classification must only read its
    own).  A failure class is only ever assigned when some rank FAILED
    (nonzero-non-resize exit, or killed while running); within failures the
    precedence is specific bundle reasons > checkpoint integrity >
    stall/straggler (all implicated ranks killed, never self-exited) >
    generic crash.  On a clean exit (every rank 0/RESIZE_STATUS), mid-run
    evidence of transient-and-recovered faults — a latched stall alert, a
    guard trip whose rollback succeeded — rides as detail: classifying it
    as a failure would restart a finished job.
    """
    rcs = tuple(rcs)
    evidence = evidence or {"bundles": {}, "alerts": [], "events": []}

    def fresh(recs):
        if since_ts is None:
            return list(recs)
        return [r for r in recs if float(r.get("ts") or 0) >= since_ts]

    bundles = {
        rank: fresh(recs)
        for rank, recs in evidence.get("bundles", {}).items()
        if fresh(recs)
    }
    events = fresh(evidence.get("events", []))
    alerts = fresh(evidence.get("alerts", []))
    failed_ranks = tuple(
        i for i, rc in enumerate(rcs) if rc not in (0, RESIZE_STATUS)
    )
    detail: dict = {}

    specific = _bundle_class(bundles)
    ckpt_events = [
        e for e in events
        if e.get("type") in ("checkpoint.fallback", "checkpoint.verify_failed")
    ]
    fault_events = sorted(
        {str(e["type"]) for e in events
         if str(e.get("type", "")).startswith("fault.")}
    )
    if fault_events:
        detail["faults"] = fault_events
    stall = [a for a in alerts if a.get("type") == "alert.step_stall"]
    skew = [
        a for a in alerts if a.get("type") == "alert.skew_sustained"
    ] + [e for e in events if e.get("type") == "skew.straggler"]

    if failed_ranks:
        # Suspect kinds implicate the rank the EVIDENCE names (the strike
        # bookkeeping / quarantine target), not whichever ranks happened
        # to exit badly — a corrupting rank can take innocent peers down
        # with it.  The exit picture stays visible through ``rcs``.
        if specific is not None:
            kind, rank, reason, rec = specific
            detail["bundle_reason"] = reason
            detail["bundle_rank"] = rank
            ranks = (rank,)
            if kind == "silent_corruption":
                # The bundle-writing rank is the DETECTING rank (a transport
                # checksum trips on the receiver); the corruption lives on
                # the rank the detector names.  Quarantine must target the
                # liar, not the witness.
                info = rec.get("info") or {}
                if info.get("detector"):
                    detail["detector"] = info["detector"]
                imp = info.get("implicated_rank")
                if imp is not None:
                    ranks = (int(imp),)
                    detail["implicated_rank"] = int(imp)
            return Incident(kind=kind, ranks=ranks, rcs=rcs,
                            detail=detail)
        if ckpt_events:
            detail["checkpoint_problems"] = [
                e.get("problem") for e in ckpt_events
            ][:4]
            ranks = _shard_ranks(ckpt_events) or failed_ranks
            return Incident(kind="corrupt_checkpoint", ranks=ranks,
                            rcs=rcs, detail=detail)
        if stall:
            detail["alert"] = "step_stall"
            detail["stall_ranks"] = sorted({a.get("rank") for a in stall})
        if any(rc == CRASH_STATUS for rc in rcs):
            detail["injected"] = True
        # Every failed rank was KILLED rather than dying on its own —
        # rc None (unreaped) or -9 (the supervisor's SIGKILL after grace/
        # timeout) — so the run wedged (stall evidence) or crawled into
        # the deadline (skew evidence); any other status is a real crash.
        all_killed = all(
            rc is None or rc == -9
            for i, rc in enumerate(rcs) if i in failed_ranks
        )
        if all_killed and stall:
            kind = "step_stall"
        elif all_killed and skew:
            detail["alert"] = "straggler"
            kind = "straggler"
        else:
            kind = "crash"
        return Incident(kind=kind, ranks=failed_ranks, rcs=rcs, detail=detail)

    # Every rank exited 0 or RESIZE_STATUS: the incarnation ENDED cleanly,
    # so mid-run evidence that something transient happened and RECOVERED —
    # a latched stall alert, a guard trip whose rollback succeeded, a blown
    # watchdog deadline the loop outlived — is detail, never a failure
    # class of its own (classifying it as one would restart a finished
    # job).
    if specific is not None:
        detail["bundle_reason"] = specific[2]
        detail["bundle_rank"] = specific[1]
    if stall:
        detail["transient_alerts"] = sorted(
            {str(a.get("type")) for a in stall}
        )
    if rcs and all(rc == RESIZE_STATUS for rc in rcs):
        return Incident(kind="resize", ranks=(), rcs=rcs, detail=detail)
    if any(rc != 0 for rc in rcs):
        # a mixed 0/RESIZE exit: the resize broadcast did not reach every
        # rank — treat as a crash of the resize-exiting ranks
        ranks = tuple(i for i, rc in enumerate(rcs) if rc != 0)
        detail["mixed_resize"] = True
        return Incident(kind="crash", ranks=ranks, rcs=rcs, detail=detail)
    return Incident(kind="healthy", ranks=(), rcs=rcs, detail=detail)
