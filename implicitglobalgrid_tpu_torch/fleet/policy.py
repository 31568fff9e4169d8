"""Fleet recovery policy: classified pool incident -> fleet action.

The port's copy of the JAX package's ``fleet/policy.py``: the same verdicts
on the same incidents.

The decide step of the fleet state machine (detect → classify → **policy**
→ fence).  Same split as
`supervisor.policy`: `decide_pool` is a PURE function of
``(incident, state, policy)`` — deterministic, clock-free, pinned by
synthetic-incident tests — and `FleetState` is the bookkeeping shell
(per-pool strike counts, quarantined device subsets, idle streaks) the
`fleet.controller.FleetController` owns.

Actions (`FLEET_ACTIONS`):

``respawn``          the pool died or wedged: fence its superseded
                     generation, relaunch it on the same device subset,
                     and replay its unfinished request specs (requests
                     carry parameters, never arrays — replay is safe).
``quarantine``       respawn strikes exhausted — or an ``sdc`` incident
                     (silent data corruption proven by the `integrity`
                     plane), which skips the strikes entirely: pin the
                     pool's device subset out of the fleet and stop
                     routing to it.
``spill``            a pool is hot (sustained queue depth at/above
                     ``IGG_FLEET_SPILL_QUEUE``): spawn a FRESH pool and
                     route overflow there instead of resizing a live one.
``retire``           a spilled pool sat idle ``IGG_FLEET_IDLE_RETIRE``
                     observations in a row: drain and shut it down.
``canary_promote``   the canary pool's candidate config stayed healthy a
                     full ``IGG_FLEET_CANARY_STREAK`` streak: promote it.
``canary_rollback``  the canary breached its SLO gate: roll the candidate
                     back through the quarantine/strike machinery.
``none``             healthy — nothing to do.

`fleet_plan` states, per pool FRONT-DOOR RANK, the ordered host-transport
collective schedule that applying one fleet directive implies inside a
pool: a routing or canary decision keyed on rank identity would split a
collective between ranks, so the schedule depends on neither.
"""

from __future__ import annotations

import dataclasses

from ..utils import config as _config

__all__ = [
    "FLEET_ACTIONS",
    "FleetDecision",
    "FleetPolicy",
    "FleetState",
    "decide_pool",
    "fleet_plan",
]

FLEET_ACTIONS = (
    "none",
    "respawn",
    "quarantine",
    "spill",
    "retire",
    "canary_promote",
    "canary_rollback",
)

#: pool incident kinds that consume a respawn strike
_POOL_FAILED = ("died", "wedged")

DEFAULT_RESPAWN_LIMIT = 2
DEFAULT_CANARY_STREAK = 3


@dataclasses.dataclass(frozen=True)
class FleetDecision:
    """One fleet-policy verdict: what to do to which pool, and why."""

    action: str
    pool: str
    reason: str
    #: device subsets pinned out of the fleet by this decision
    quarantined: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """The knobs of `decide_pool` (kwarg > fleet env tier > default).

    ``respawn_limit`` — in-place pool respawns per CONTINUOUS failure
    streak before the pool's device subset is quarantined;
    ``spill_queue`` — scraped queue depth at/above which a hot pool
    spills to a fresh one (``None`` = spill off); ``idle_retire`` —
    consecutive idle observations before a spilled pool retires
    (``None`` = never); ``canary_streak`` — healthy canary observations
    before auto-promote; ``canary_p99_s`` — round-p99 breach bar for the
    canary gate (``None`` = alerts-only).
    """

    respawn_limit: int = DEFAULT_RESPAWN_LIMIT
    spill_queue: int | None = None
    idle_retire: int | None = None
    canary_streak: int = DEFAULT_CANARY_STREAK
    canary_p99_s: float | None = None

    @classmethod
    def from_env(cls, **kw) -> "FleetPolicy":
        kw.setdefault("respawn_limit", _config.fleet_respawn_limit_env())
        kw.setdefault("spill_queue", _config.fleet_spill_queue_env())
        kw.setdefault("idle_retire", _config.fleet_idle_retire_env())
        kw.setdefault("canary_streak", _config.fleet_canary_streak_env())
        kw.setdefault("canary_p99_s", _config.fleet_canary_p99_env())
        return cls(**{k: v for k, v in kw.items() if v is not None})

    def __post_init__(self):
        if self.respawn_limit < 0:
            raise ValueError(
                f"respawn_limit must be >= 0 (got {self.respawn_limit})"
            )
        if self.spill_queue is not None and self.spill_queue < 1:
            raise ValueError(
                f"spill_queue must be >= 1 (got {self.spill_queue})"
            )
        if self.idle_retire is not None and self.idle_retire < 1:
            raise ValueError(
                f"idle_retire must be >= 1 (got {self.idle_retire})"
            )
        if self.canary_streak < 1:
            raise ValueError(
                f"canary_streak must be >= 1 (got {self.canary_streak})"
            )
        if self.canary_p99_s is not None and self.canary_p99_s <= 0:
            raise ValueError(
                f"canary_p99_s must be > 0 (got {self.canary_p99_s})"
            )


@dataclasses.dataclass
class FleetState:
    """Mutable bookkeeping across pool incidents (owned by the controller)."""

    #: respawns consumed during each pool's CURRENT failure streak
    respawns: dict = dataclasses.field(default_factory=dict)
    #: quarantined device-subset labels (never handed to a new pool)
    quarantined_devices: set = dataclasses.field(default_factory=set)
    #: consecutive idle observations per pool
    idle_streaks: dict = dataclasses.field(default_factory=dict)
    #: consecutive hot observations per pool (spill hysteresis)
    hot_streaks: dict = dataclasses.field(default_factory=dict)

    def record_health(self, pool: str, *, queue_depth, active_members) -> None:
        """Fold one scraped health observation into the streak counters
        BEFORE the decision (the `SupervisorState.record_incident`
        discipline — without it spill/retire could never trigger)."""
        idle = (not queue_depth) and (not active_members)
        self.idle_streaks[pool] = (
            self.idle_streaks.get(pool, 0) + 1 if idle else 0
        )

    def apply(self, decision: FleetDecision) -> None:
        """Advance the bookkeeping for an executed decision."""
        if decision.action == "respawn":
            self.respawns[decision.pool] = (
                self.respawns.get(decision.pool, 0) + 1
            )
        elif decision.action == "none":
            self.respawns[decision.pool] = 0
        self.quarantined_devices.update(decision.quarantined)
        if decision.action in ("retire", "quarantine"):
            self.idle_streaks.pop(decision.pool, None)
            self.hot_streaks.pop(decision.pool, None)


def decide_pool(incident, state: FleetState, policy: FleetPolicy,
                *, spilled: bool = False) -> FleetDecision:
    """PURE verdict for one pool observation (module docstring).

    ``incident`` is a `supervisor.classify.Incident`-shaped object whose
    ``kind`` is a pool liveness verdict: ``died`` (process gone),
    ``wedged`` (alive but unreachable/stalled), ``sdc`` (an integrity-
    plane detector convicted a member of silent data corruption — device-
    subset quarantine, never a respawn strike), ``hot`` (sustained queue
    pressure), ``idle`` or ``healthy``.  ``spilled`` marks pools the
    fleet itself spawned (only those ever retire — the seed pools are the
    capacity floor).  Same inputs, same decision — no clocks, no globals.
    """
    pool = incident.detail.get("pool") if incident.detail else None
    if pool is None:
        raise ValueError("incident.detail must carry the pool name")
    if incident.kind == "sdc":
        # An integrity-plane detector (``reason=sdc`` bundle, the
        # `integrity` package) convicted a member of this pool of FINITE
        # wrong values.  No respawn strikes: a crashed pool gets its
        # devices back because crashes are usually software, but silent
        # corruption is the silicon itself lying — respawning on the same
        # device subset re-seats the liar under fresh state.  The subset
        # is pinned out immediately; capacity recovers through the normal
        # spill path on healthy devices.
        devices = incident.detail.get("devices")
        detector = incident.detail.get("detector", "integrity")
        return FleetDecision(
            action="quarantine", pool=pool,
            reason=(
                f"pool {pool} caught corrupting data in flight "
                f"({detector}, rank(s) {tuple(incident.ranks)}): "
                f"quarantining its device subset immediately — respawn "
                f"would re-seat the lying core"
            ),
            quarantined=(devices,) if devices else (),
        )
    if incident.kind in _POOL_FAILED:
        used = state.respawns.get(pool, 0)
        if used >= policy.respawn_limit:
            devices = incident.detail.get("devices")
            return FleetDecision(
                action="quarantine", pool=pool,
                reason=(
                    f"pool {pool} {incident.kind} with {used} respawn(s) "
                    f"exhausted (IGG_FLEET_RESPAWN_LIMIT="
                    f"{policy.respawn_limit}): quarantining its devices"
                ),
                quarantined=(devices,) if devices else (),
            )
        return FleetDecision(
            action="respawn", pool=pool,
            reason=(
                f"pool {pool} {incident.kind}: respawn "
                f"{used + 1}/{policy.respawn_limit} and replay its "
                f"unfinished request specs"
            ),
        )
    if incident.kind == "hot":
        if policy.spill_queue is not None:
            return FleetDecision(
                action="spill", pool=pool,
                reason=(
                    f"pool {pool} queue at/above "
                    f"IGG_FLEET_SPILL_QUEUE={policy.spill_queue}: "
                    f"spilling to a fresh pool"
                ),
            )
        return FleetDecision(action="none", pool=pool,
                             reason="hot but spill is off")
    if incident.kind == "idle":
        streak = state.idle_streaks.get(pool, 0)
        if (
            spilled
            and policy.idle_retire is not None
            and streak >= policy.idle_retire
        ):
            return FleetDecision(
                action="retire", pool=pool,
                reason=(
                    f"spilled pool {pool} idle x{streak} "
                    f"(IGG_FLEET_IDLE_RETIRE={policy.idle_retire}): retiring"
                ),
            )
        return FleetDecision(action="none", pool=pool, reason="idle")
    return FleetDecision(action="none", pool=pool, reason="healthy")


# -- the in-band control plan (analyzer contract) -----------------------------


def fleet_plan(is_root: bool, action: str, stale: bool) -> tuple:
    """The ordered host-transport collective schedule ONE POOL RANK
    follows when a fleet directive lands in-band.

    ``is_root`` exists precisely so the ``collective-consistency`` census
    can prove the schedule ignores rank identity (the
    `supervisor.policy.recovery_plan` contract).  ``stale`` is the fence
    verdict — rank-uniform by construction
    (`supervisor.generation.fence_refusal`), so a superseded pool
    incarnation refuses the directive on EVERY rank together (empty plan).

    Schedules: ``respawn``/``spill`` = the adopting pool's replay
    admission (`serving.frontdoor.broadcast_control` of the re-submitted
    specs) — one control broadcast, no checkpoint barrier (replayed
    requests restart from their parameters); ``canary_promote``/
    ``canary_rollback`` = one config-directive broadcast inside the
    affected pool; ``retire`` = a drain directive broadcast;
    ``quarantine``/``none`` = out-of-band (the controller stops routing /
    kills processes; no surviving rank does in-band work).
    """
    del is_root  # rank identity must not shape the schedule
    if stale:
        return ()  # fenced: every rank refuses the directive together
    if action in ("respawn", "spill"):
        return (("broadcast_control", "adopt-replay"),)
    if action in ("canary_promote", "canary_rollback"):
        return (("broadcast_control", "config-directive"),)
    if action == "retire":
        return (("broadcast_control", "drain"),)
    return ()
