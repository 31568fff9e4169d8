"""Recovery policy: classified incident -> supervisor action.

The port's copy of the JAX package's ``supervisor/policy.py``: the same
verdicts on the same incidents, state and policy.

The decide step of the supervisor state machine (detect → classify →
**policy** → fence).  Split the `serving.autoscale`
way: `decide` is a PURE function of ``(incident, state, policy)`` —
deterministic, clock-free, pinned by synthetic-incident tests — and
`SupervisorState` is the bookkeeping shell (per-rank strike counts,
quarantine set, generation counter) `RunSupervisor` owns.

Actions (`ACTIONS`):

``restart``    relaunch the failed incarnation in place at the same
               topology, after the next `utils.resilience.backoff_schedule`
               delay — transient faults (a crash, a wedged loop) get
               ``IGG_SUPERVISE_MAX_RESTARTS`` strikes before escalation.
``shrink``     strikes exhausted (or a rank quarantined): drop to the next
               rung down the topology ladder and relaunch — the restart
               rides `restore_checkpoint`'s elastic resharding path, so
               the shrunk incarnation resumes the same physical run.
``scale_up``   the run is healthy below its preferred rung and spare
               capacity returned: move one rung up (again through the
               elastic checkpoint path).
``resize``     the workload itself asked (`serving.RESIZE_STATUS` + plan).
``quarantine`` the implicated rank keeps producing integrity failures
               (corrupt checkpoints) or tripwire faults: pin it out of
               every future incarnation and shrink around it.  A
               ``silent_corruption`` incident skips the strike bar and
               quarantines on the FIRST offense — restarting a rank whose
               silicon produced a finite wrong value hands it fresh state
               to corrupt.
``none``       healthy — nothing to do.
``give_up``    no rung fits (everything quarantined / ladder exhausted).

`recovery_plan` additionally states, per supervised RANK, the ordered
host-transport collective schedule that applying one in-band recovery
directive implies: a recovery decision keyed on rank identity or
rank-local fence state would split a collective between ranks, so the
schedule must not depend on either.
"""

from __future__ import annotations

import dataclasses

from ..utils import config as _config

__all__ = [
    "ACTIONS",
    "Decision",
    "RecoveryPolicy",
    "SupervisorState",
    "decide",
    "recovery_plan",
]

ACTIONS = (
    "none",
    "restart",
    "shrink",
    "scale_up",
    "resize",
    "quarantine",
    "give_up",
)

#: incident kinds that consume a restart strike (transient-looking faults)
_TRANSIENT = ("crash", "step_stall", "guard_trip", "straggler")
#: incident kinds that mark the implicated rank suspect (integrity class).
#: ``silent_corruption`` is in the suspect family for strike bookkeeping,
#: but `decide` short-circuits it to IMMEDIATE quarantine: the other
#: suspect kinds tolerate strikes because their damage is at rest and the
#: checkpoint fallback routes around it, while a rank whose silicon
#: produced a finite wrong value re-lies on restart — restart-in-place is
#: exactly the wrong verdict for a liar.
_SUSPECT = ("corrupt_checkpoint", "gather_tripwire", "silent_corruption")

DEFAULT_MAX_RESTARTS = 2


@dataclasses.dataclass(frozen=True)
class Decision:
    """One policy verdict: what to do, where to land, and why."""

    action: str
    #: topology-ladder rung index the next incarnation launches at
    rung: int
    #: backoff delay before the relaunch (seconds; 0 for none/resize)
    delay_s: float
    reason: str
    quarantined: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """The knobs of `decide` (kwarg > supervise env tier > default).

    ``max_restarts`` — in-place restarts per CONTINUOUS failure streak
    before the ladder drops a rung; ``backoff_s`` — base of the
    exponential relaunch backoff (`utils.resilience.backoff_schedule`
    semantics: delay i = min(base * 2**i, 30), deterministic under
    ``seed``); ``quarantine_after`` — suspect incidents implicating one
    rank before it is pinned out; ``scale_up_after`` — consecutive
    healthy-at-reduced-rung incarnations before a spare-return reattempt.
    """

    max_restarts: int = DEFAULT_MAX_RESTARTS
    backoff_s: float = 0.5
    quarantine_after: int = 2
    scale_up_after: int = 1
    seed: int = 0

    @classmethod
    def from_env(cls, **kw) -> "RecoveryPolicy":
        kw.setdefault("max_restarts", _config.supervise_max_restarts_env())
        kw.setdefault("backoff_s", _config.supervise_backoff_env())
        return cls(**{k: v for k, v in kw.items() if v is not None})

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0 (got {self.max_restarts})"
            )
        if self.backoff_s <= 0:
            raise ValueError(f"backoff_s must be > 0 (got {self.backoff_s})")
        if self.quarantine_after < 1 or self.scale_up_after < 1:
            raise ValueError(
                "quarantine_after and scale_up_after must be >= 1"
            )


@dataclasses.dataclass
class SupervisorState:
    """Mutable bookkeeping across incarnations (owned by `RunSupervisor`)."""

    rung: int = 0
    generation: int = 0
    #: in-place restarts consumed during the CURRENT failure streak
    restarts: int = 0
    #: suspect-incident count per implicated rank
    suspect_strikes: dict = dataclasses.field(default_factory=dict)
    quarantined: set = dataclasses.field(default_factory=set)
    #: consecutive healthy incarnations at a rung below the preferred one
    healthy_streak: int = 0

    def record_incident(self, incident) -> None:
        """Fold one classified incident into the bookkeeping BEFORE the
        decision: suspect kinds (integrity failures) charge a strike
        against every implicated rank — the counter `decide`'s quarantine
        bar reads.  Called by `RunSupervisor` right after classification;
        without it quarantine could never trigger (a fresh count per
        decision would always read 1)."""
        if incident.kind in _SUSPECT:
            for rank in incident.ranks:
                self.suspect_strikes[rank] = (
                    self.suspect_strikes.get(rank, 0) + 1
                )

    def apply(self, decision: Decision) -> None:
        """Advance the bookkeeping for an executed decision."""
        if decision.action in ("none",):
            self.restarts = 0
            self.healthy_streak += 1
            return
        self.generation += 1
        self.healthy_streak = 0
        if decision.action == "restart":
            self.restarts += 1
        else:
            self.restarts = 0
        self.rung = decision.rung
        self.quarantined.update(decision.quarantined)


def _backoff(policy: RecoveryPolicy, attempt: int) -> float:
    from ..utils.resilience import backoff_schedule

    sched = backoff_schedule(
        attempt + 1, base_s=policy.backoff_s, seed=policy.seed
    )
    return sched[attempt]


def decide(incident, state: SupervisorState, policy: RecoveryPolicy,
           *, ladder_len: int, preferred_rung: int = 0) -> Decision:
    """PURE verdict for one classified incident (module docstring).

    ``ladder_len`` — rungs available (rung 0 = the preferred/full
    topology, higher = smaller); ``preferred_rung`` — where scale-up
    reattempts aim.  Same inputs, same decision — no clocks, no globals.
    """
    if ladder_len < 1:
        raise ValueError("ladder_len must be >= 1")
    if incident.kind == "healthy":
        if (
            state.rung > preferred_rung
            and state.healthy_streak + 1 >= policy.scale_up_after
        ):
            return Decision(
                action="scale_up", rung=state.rung - 1, delay_s=0.0,
                reason=(
                    f"healthy x{state.healthy_streak + 1} below the "
                    f"preferred rung: reattempting rung {state.rung - 1}"
                ),
            )
        return Decision(action="none", rung=state.rung, delay_s=0.0,
                        reason="healthy")
    if incident.kind == "resize":
        return Decision(action="resize", rung=state.rung, delay_s=0.0,
                        reason="workload-requested resize")

    if incident.kind == "silent_corruption" and incident.ranks:
        # No strike bar: one proven finite wrong value is enough.  The
        # detector (transport checksum / shadow audit / lineage chain)
        # already localized the liar; giving it `quarantine_after` more
        # incarnations just feeds it more state to corrupt.
        doomed = tuple(incident.ranks)
        rung = state.rung + 1
        detector = (incident.detail or {}).get("detector", "integrity")
        if rung >= ladder_len:
            return Decision(
                action="give_up", rung=state.rung, delay_s=0.0,
                reason=(
                    f"rank(s) {doomed} caught corrupting data in flight "
                    f"({detector}) but no smaller rung exists"
                ),
                quarantined=doomed,
            )
        return Decision(
            action="quarantine", rung=rung, delay_s=_backoff(policy, 0),
            reason=(
                f"rank(s) {doomed} caught corrupting data in flight "
                f"({detector}): quarantined immediately, shrinking to "
                f"rung {rung}"
            ),
            quarantined=doomed,
        )

    if incident.kind in _SUSPECT:
        # strike counts maintained by `SupervisorState.record_incident`
        # (called before each decision), so repeated integrity failures
        # accumulate across incarnations
        doomed = tuple(
            r for r in incident.ranks
            if state.suspect_strikes.get(r, 0) >= policy.quarantine_after
        )
        if doomed:
            rung = state.rung + 1
            if rung >= ladder_len:
                return Decision(
                    action="give_up", rung=state.rung, delay_s=0.0,
                    reason=(
                        f"rank(s) {doomed} quarantined "
                        f"({incident.kind}) but no smaller rung exists"
                    ),
                    quarantined=doomed,
                )
            return Decision(
                action="quarantine", rung=rung,
                delay_s=_backoff(policy, 0),
                reason=(
                    f"rank(s) {doomed} failed integrity "
                    f"{policy.quarantine_after}x ({incident.kind}): "
                    f"quarantined, shrinking to rung {rung}"
                ),
                quarantined=doomed,
            )
        # suspect but under the quarantine bar: restart in place (the
        # integrity fallback already routed around the damage), counting
        # a restart strike like any transient
        if state.restarts < policy.max_restarts:
            return Decision(
                action="restart", rung=state.rung,
                delay_s=_backoff(policy, state.restarts),
                reason=(
                    f"{incident.kind} on rank(s) {incident.ranks}: restart "
                    f"{state.restarts + 1}/{policy.max_restarts} "
                    f"(integrity fallback handles the damaged generation)"
                ),
            )

    if incident.kind in _TRANSIENT and state.restarts < policy.max_restarts:
        return Decision(
            action="restart", rung=state.rung,
            delay_s=_backoff(policy, state.restarts),
            reason=(
                f"{incident.kind} on rank(s) {incident.ranks}: restart "
                f"in place {state.restarts + 1}/{policy.max_restarts}"
            ),
        )

    # strikes exhausted (or an un-enumerated kind): walk down the ladder
    rung = state.rung + 1
    if rung >= ladder_len:
        return Decision(
            action="give_up", rung=state.rung, delay_s=0.0,
            reason=(
                f"{incident.kind}: {state.restarts} restart(s) exhausted "
                f"and no smaller rung exists"
            ),
        )
    return Decision(
        action="shrink", rung=rung, delay_s=_backoff(policy, 0),
        reason=(
            f"{incident.kind}: {state.restarts} in-place restart(s) "
            f"exhausted (IGG_SUPERVISE_MAX_RESTARTS="
            f"{policy.max_restarts}); elastic shrink to rung {rung}"
        ),
    )


# -- the in-band control plan (analyzer contract) -----------------------------


def recovery_plan(is_root: bool, action: str, stale: bool) -> tuple:
    """The ordered host-transport collective schedule ONE SUPERVISED RANK
    follows when a recovery directive lands in-band.

    ``is_root`` exists precisely so a census can prove the schedule
    ignores rank identity.
    ``stale`` is the fence verdict — rank-uniform by construction
    (`supervisor.generation.fence_refusal`: per-incarnation env token vs
    the shared fence file), so a superseded incarnation refuses the
    directive on EVERY rank together (empty plan) instead of some ranks
    entering the checkpoint barriers their peers skip.

    Schedules: ``resize``/``shrink``/``scale_up`` = the front-door resize
    execution (`serving.frontdoor.FrontDoor._execute_resize`): one
    control broadcast, then `save_checkpoint`'s two barriers; ``restart``
    = out-of-band (the supervisor kills and relaunches; the fresh
    incarnation's restore is per-process reads) — no collective;
    ``quarantine``/``give_up``/``none`` = no in-band work.
    """
    del is_root  # rank identity must not shape the schedule
    if stale:
        return ()  # fenced: every rank refuses the directive together
    if action in ("resize", "shrink", "scale_up"):
        return (
            ("broadcast_control", "directive"),
            ("save_checkpoint", "shard-barrier"),
            ("save_checkpoint", "publish-barrier"),
        )
    return ()
