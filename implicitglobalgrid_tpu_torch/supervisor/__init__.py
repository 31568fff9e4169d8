"""The run supervisor of the port: launch and own a multi-process run.

The port's copy of the JAX package's ``supervisor`` package, host-side
only (processes, files, HTTP scrapes), in four pieces forming the state
machine detect → classify → policy → fence:

* `generation` — generation tokens per incarnation and the fence at every
  durable publish (a superseded incarnation is refused);
* `classify` — exit statuses and evidence -> a named failure class;
* `policy` — pure incident -> action (restart with backoff, shrink a
  rung, scale up, quarantine, give up) and `recovery_plan`;
* `manager` — `RunSupervisor`, the loop that spawns, watches, classifies,
  decides, fences and relaunches.  Each rank it starts gets its own
  ``RANK``/``LOCAL_RANK``/``WORLD_SIZE`` and every incarnation a fresh
  rendezvous port.
"""

from .classify import FAILURE_KINDS, Incident, classify, collect_evidence
from .generation import (
    FenceError,
    authoritative_generation,
    check_fence,
    current_generation,
    fence_refused,
    publish_generation,
)
from .manager import Incarnation, RunSupervisor, SupervisorReport
from .policy import (
    ACTIONS,
    Decision,
    RecoveryPolicy,
    SupervisorState,
    decide,
    recovery_plan,
)

__all__ = [
    "FAILURE_KINDS",
    "ACTIONS",
    "Incident",
    "classify",
    "collect_evidence",
    "FenceError",
    "current_generation",
    "authoritative_generation",
    "publish_generation",
    "check_fence",
    "fence_refused",
    "Decision",
    "RecoveryPolicy",
    "SupervisorState",
    "decide",
    "recovery_plan",
    "Incarnation",
    "RunSupervisor",
    "SupervisorReport",
]
