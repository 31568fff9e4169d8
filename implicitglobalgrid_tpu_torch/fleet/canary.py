"""Canary rollout: a candidate config serves ONE pool before the fleet.

The port's copy of the JAX package's ``fleet/canary.py``.  A candidate
configuration — an environment overlay of the canary pool, such as a
tuned-config cache (``IGG_TUNE_CACHE``, carried through untouched: the
port has no tuner yet) or a code-version env — is given to
exactly one pool, and that pool's live SLO surface gates what happens
next: the SAME rolling ``slo.serving.round_seconds`` windows and active
CRITICAL alerts the admission gate reads (`serving.admission`,
`utils.liveplane.slo_view`), scraped off the canary's ``/healthz``.

State machine (every transition a structured ``fleet.canary.*`` event):

    baking --healthy x IGG_FLEET_CANARY_STREAK--> promoted
    baking --breach (p99 > IGG_FLEET_CANARY_P99_S | CRITICAL alert |
            unreachable)--> rolled_back

``promoted`` means the candidate is safe fleet-wide (the controller
re-points the remaining pools at the overlay on their next respawn);
``rolled_back`` routes through the strike machinery — the controller
strikes and retires the canary pool, and the overlay never reaches a
second pool.  One breach is enough: a canary exists precisely so the
blast radius of a bad config is one pool for one streak window.

`publish_canary_state` persists the machine's state next to the fence
file, gated on the generation fence like every durable fleet publish: a
superseded controller incarnation's write is refused
(`supervisor.generation.fence_refused` → ``fence.rejected``), so a
zombie controller can never flip a canary verdict under the live one.

Host-side only, the `supervisor/` discipline — never a device.
"""

from __future__ import annotations

import dataclasses
import os

from ..supervisor import generation as _generation
from ..utils import telemetry as _telemetry
from .policy import FleetPolicy
from .router import UNREACHABLE, pool_health_view

__all__ = [
    "CANARY_STATE",
    "CanaryTracker",
    "publish_canary_state",
]

#: the canary-state file (lives in the controller's fence/work dir)
CANARY_STATE = "canary.json"


def publish_canary_state(directory: str, doc: dict) -> bool:
    """Atomically persist one canary-state document; fence-gated.

    Returns False (refusing the write, ``fence.rejected`` already on the
    timeline) when this process' generation is superseded — the
    advisory-publish discipline of the front door's endpoint file.
    """
    if _generation.fence_refused("fleet.canary"):
        return False
    _telemetry.atomic_write_json(
        os.path.join(directory, CANARY_STATE), doc, fsync=False
    )
    return True


@dataclasses.dataclass
class CanaryTracker:
    """The per-rollout state machine (module docstring).

    ``pool`` — the canary pool's name; ``candidate`` — an opaque,
    JSON-serializable description of what is being trialed (an overlay
    dir, a code version); ``policy`` — the gate knobs
    (`fleet.policy.FleetPolicy`: ``canary_streak``, ``canary_p99_s``).
    `observe` folds one scraped ``/healthz`` document (or None for an
    unreachable canary) and returns the machine's state.
    """

    pool: str
    candidate: dict
    policy: FleetPolicy = dataclasses.field(default_factory=FleetPolicy)
    state: str = "baking"
    streak: int = 0
    observations: int = 0
    breach: dict | None = None

    def __post_init__(self):
        _telemetry.event(
            "fleet.canary.start", pool=self.pool, candidate=self.candidate,
            streak_needed=self.policy.canary_streak,
            p99_s=self.policy.canary_p99_s,
        )

    def _breach_of(self, view: dict) -> dict | None:
        if view["state"] == UNREACHABLE:
            return {"kind": "unreachable"}
        critical = [
            a for a in view["alerts"] if a is not None
        ] if view["state"] == "alerting" else []
        if critical:
            return {"kind": "alert", "rules": critical}
        p99, bar = view["round_p99_s"], self.policy.canary_p99_s
        if bar is not None and p99 is not None and p99 > bar:
            return {"kind": "slo", "round_p99_s": p99, "bar_s": bar}
        return None

    def observe(self, health: dict | None) -> str:
        """One gate evaluation; returns ``baking`` | ``promoted`` |
        ``rolled_back`` (terminal states are sticky)."""
        if self.state != "baking":
            return self.state
        self.observations += 1
        view = pool_health_view(health)
        breach = self._breach_of(view)
        if breach is not None:
            self.state = "rolled_back"
            self.breach = breach
            _telemetry.counter("fleet.canary.rollbacks_total").inc()
            _telemetry.event(
                "fleet.canary.rollback", pool=self.pool,
                candidate=self.candidate, observations=self.observations,
                **breach,
            )
            return self.state
        self.streak += 1
        _telemetry.event(
            "fleet.canary.observe", pool=self.pool, streak=self.streak,
            streak_needed=self.policy.canary_streak,
            round_p99_s=view["round_p99_s"],
        )
        if self.streak >= self.policy.canary_streak:
            self.state = "promoted"
            _telemetry.counter("fleet.canary.promotions_total").inc()
            _telemetry.event(
                "fleet.canary.promote", pool=self.pool,
                candidate=self.candidate, streak=self.streak,
            )
        return self.state

    def doc(self) -> dict:
        """The JSON-serializable snapshot `publish_canary_state` persists."""
        return {
            "pool": self.pool,
            "candidate": self.candidate,
            "state": self.state,
            "streak": self.streak,
            "observations": self.observations,
            "breach": self.breach,
            "generation": _generation.current_generation(),
        }
