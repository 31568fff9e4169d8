"""Elastic autoscaling policy for the serving plane (the JAX package's
``serving/autoscale.py``, host code copied into the port).

Capacity was frozen at `ServingLoop` construction; this module decides
when it should not be.  The mechanism is deliberately split:

* `decide` — a PURE function ``(view, policy, rung) -> "up"|"down"|"hold"``
  over the same gauge view admission control uses
  (`admission.gauge_view`): sustained queue growth or a round-p99 breach
  votes ``up``; an empty queue with occupancy that fits the next rung down
  votes ``down``.  Deterministic given a synthetic snapshot — the tier-1
  contract (`tests/test_torch_frontdoor.py` holds it to the JAX
  package's on identical views).
* `Autoscaler` — the stateful shell: a ladder of `Rung`\\ s (process count
  x slot capacity), a sustain counter (``IGG_AUTOSCALE_SUSTAIN``
  consecutive identical verdicts before anything moves — one bursty
  heartbeat must not resize a cluster), and the drain bookkeeping for
  scale-downs.  It subscribes to the `utils.liveplane` rule engine the
  same way `resilience.RunGuard` does (`FrontDoor` wires it), so anomaly
  alerts are visible in its status (``last_alert``) even though resize
  verdicts come only from the sustained gauge policy.

Execution is NOT here: a resize changes the process topology, which a
live process cannot do to itself.  The verdict travels rank-0 → everyone
through the front door's control-plane broadcast, every rank writes the
batched checkpoint (`utils.checkpoint.save_checkpoint`), rank 0 publishes
a ``resize.json`` plan, and all ranks exit with
`frontdoor.RESIZE_STATUS` for the supervisor to relaunch at the target
topology: the supervised-restart mechanism, pointed at growth instead of
failure.
"""

from __future__ import annotations

import dataclasses

from ..utils import config as _config

#: verdicts of `decide`
VERDICTS = ("up", "down", "hold")


@dataclasses.dataclass(frozen=True)
class Rung:
    """One capacity rung: process topology x slot-pool capacity."""

    nproc: int
    capacity: int


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The resize thresholds.

    ``ladder`` — ascending `Rung` tuple; the autoscaler only ever moves one
    rung at a time.  ``queue_high`` — queue depth that votes ``up`` (None =
    the live pool capacity).  ``p99_high_s`` — round-latency p99 that votes
    ``up`` (None = queue-only).  ``sustain`` — consecutive identical
    non-hold verdicts before the move commits.
    """

    ladder: tuple[Rung, ...]
    queue_high: int | None = None
    p99_high_s: float | None = None
    sustain: int = 2

    def __post_init__(self):
        if not self.ladder:
            raise ValueError("AutoscalePolicy needs a non-empty ladder")
        if self.sustain < 1:
            raise ValueError(f"sustain must be >= 1 (got {self.sustain})")

    @classmethod
    def from_env(cls, ladder, **kw) -> "AutoscalePolicy":
        """Env tier: ``IGG_AUTOSCALE_QUEUE_HIGH``, ``IGG_AUTOSCALE_SUSTAIN``
        (explicit kwargs win, the config precedence)."""
        kw.setdefault("queue_high", _config.autoscale_queue_high_env())
        kw.setdefault("sustain", _config.autoscale_sustain_env() or 2)
        return cls(ladder=tuple(ladder), **kw)


def decide(view: dict, policy: AutoscalePolicy, rung: int) -> str:
    """PURE one-observation verdict: ``"up"``, ``"down"`` or ``"hold"``.

    ``view`` is an `admission.gauge_view`-shaped dict (``queue_depth``,
    ``active_members``, ``capacity``, ``round_p99_s``).  ``up`` needs a
    higher rung to exist and either the queue at/above ``queue_high`` or
    the round p99 past ``p99_high_s``; ``down`` needs a lower rung, an
    empty queue, and occupancy that fits that rung's capacity.  No clocks,
    no globals — same inputs, same verdict.
    """
    if not 0 <= rung < len(policy.ladder):
        raise ValueError(
            f"rung {rung} outside the ladder (len {len(policy.ladder)})"
        )
    queue_depth = int(view.get("queue_depth") or 0)
    active = int(view.get("active_members") or 0)
    queue_high = policy.queue_high
    if queue_high is None:
        queue_high = max(1, int(view.get("capacity") or 1))
    p99 = view.get("round_p99_s")
    if rung + 1 < len(policy.ladder) and (
        queue_depth >= queue_high
        or (policy.p99_high_s is not None and p99 is not None
            and p99 > policy.p99_high_s)
    ):
        return "up"
    if (
        rung > 0
        and queue_depth == 0
        and active <= policy.ladder[rung - 1].capacity
    ):
        return "down"
    return "hold"


class Autoscaler:
    """Sustain-gated ladder walker (module docstring).

    `observe` is called at heartbeat cadence with a gauge view; once
    ``policy.sustain`` consecutive observations agree on a non-hold
    verdict it returns an action dict ``{"action", "target": Rung,
    "rung": target index, "evidence": view}`` — exactly once per episode
    (the streak resets after committing).  The caller owns execution and
    the drain handshake (`FrontDoor`); ``rung`` is fixed per process
    lifetime because a rung change IS a process restart.
    """

    def __init__(self, policy: AutoscalePolicy, rung: int = 0):
        if not 0 <= rung < len(policy.ladder):
            raise ValueError(
                f"rung {rung} outside the ladder (len {len(policy.ladder)})"
            )
        self.policy = policy
        self.rung = int(rung)
        self._streak_verdict = "hold"
        self._streak = 0
        self.last_verdict = "hold"
        self.last_alert: dict | None = None

    @property
    def current(self) -> Rung:
        return self.policy.ladder[self.rung]

    def on_alert(self, alert: dict) -> None:
        """Rule-engine subscription surface (the RunGuard mechanism):
        alerts inform the status view; resizes stay gauge-driven."""
        self.last_alert = alert

    def observe(self, view: dict) -> dict | None:
        verdict = decide(view, self.policy, self.rung)
        self.last_verdict = verdict
        if verdict == self._streak_verdict:
            self._streak += 1
        else:
            self._streak_verdict = verdict
            self._streak = 1
        if verdict == "hold" or self._streak < self.policy.sustain:
            return None
        self._streak_verdict, self._streak = "hold", 0
        target_rung = self.rung + (1 if verdict == "up" else -1)
        target = self.policy.ladder[target_rung]
        return {
            "action": verdict,
            "rung": target_rung,
            "target": {"nproc": target.nproc, "capacity": target.capacity},
            "evidence": dict(view),
        }

    def status(self) -> dict:
        # the incarnation's generation token rides the status view so a
        # supervisor (or /v1/status reader) can attribute a resize verdict
        # to the incarnation that produced it (`supervisor.generation`)
        return {
            "rung": self.rung,
            "generation": _config.generation_env(),
            "nproc": self.current.nproc,
            "capacity": self.current.capacity,
            "ladder": [
                {"nproc": r.nproc, "capacity": r.capacity}
                for r in self.policy.ladder
            ],
            "sustain": self.policy.sustain,
            "last_verdict": self.last_verdict,
            "streak": self._streak,
            "last_alert": self.last_alert,
        }
