"""igg.fleet — multi-pool failure domains over the serving tier.

The port's copy of the JAX package's ``fleet`` package.  One serving pool
is one topology behind one rank-0 HTTP thread: a single failure domain.
This package turns one self-healing pool into a self-healing fleet, in
four pieces forming the per-pool state machine
**detect → classify → policy → fence** one level above the run
supervisor:

* `router` — `FleetRouter`, the single public HTTP entry: routes
  ``POST /v1/submit`` on the request's (model, size, tenant) key and the
  pools' scraped ``/healthz`` state; ``GET /v1/result/<id>`` is sticky
  (the route remembers the owning pool and follows it through a replay),
  and the epoch-checked `FleetRouter.adopt_result` refuses a zombie
  pool's late answer (``fleet.zombie_result``).
* `policy` — pure pool incident → fleet action (`decide_pool`): died/
  wedged → respawn + replay, strikes exhausted → quarantine the pool's
  device subset, hot → spill to a fresh pool, idle spill → retire; plus
  `fleet_plan`, the per-rank in-band schedule of a fleet directive.
* `canary` — `CanaryTracker`, the SLO-gated rollout state machine:
  a candidate config (an environment overlay, e.g. a tuned-config
  cache) serves one pool,
  auto-promotes after a healthy streak, auto-rolls-back through the
  strike machinery on breach (``fleet.canary.*`` events throughout).
* `controller` — `FleetController`, the orchestration loop: launch N
  pools (per-pool generation fences, device subsets, telemetry dirs,
  front-door ports), watch, classify, decide, fence-then-execute.  A
  pool's device subset (`PoolSpec.devices`) becomes its process's
  ``CUDA_VISIBLE_DEVICES``, indices into the controller's own.

Host-side only, the `supervisor/` discipline: this package touches no
device — the fleet must keep routing while a pool's fabric is wedged.
"""

from .canary import CanaryTracker, publish_canary_state
from .controller import FleetController, PoolSpec
from .policy import (
    FLEET_ACTIONS,
    FleetDecision,
    FleetPolicy,
    FleetState,
    decide_pool,
    fleet_plan,
)
from .router import FleetRouter, choose_pool, scrape_health

__all__ = [
    "FLEET_ACTIONS",
    "CanaryTracker",
    "FleetController",
    "FleetDecision",
    "FleetPolicy",
    "FleetRouter",
    "FleetState",
    "PoolSpec",
    "choose_pool",
    "decide_pool",
    "fleet_plan",
    "publish_canary_state",
    "scrape_health",
]
