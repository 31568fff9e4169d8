"""Environment-variable configuration tier of the port.

The deploy-time tier below the kwargs tier (explicit kwargs > ``IGG_*`` env
> defaults), restricted to the keys the port reads: `init_global_grid`'s
and the halo exchange's:

========================  ====================================================
``IGG_QUIET``             nonzero suppresses the rank-0 banner
``IGG_REORDER``           default ``reorder`` flag (recorded on the grid)
``IGG_OVERLAP``           default overlap in every dimension (default 2)
``IGG_COALESCE``          0 sends each field's halo on its own; unset or
                          nonzero coalesces (read per exchange call)
``IGG_INIT_RETRIES``      bring-up retries after the first failure (>= 0)
``IGG_INIT_TIMEOUT_S``    overall bring-up deadline in seconds (> 0)
``IGG_INIT_BACKOFF_S``    base bring-up retry backoff in seconds (> 0)
``IGG_WATCHDOG_S``        bring-up hang watchdog in seconds (0 = off)
``IGG_GUARD_EVERY``       NaN/Inf guard cadence in steps (0 = off)
``IGG_GUARD_POLICY``      ``raise`` | ``warn`` | ``rollback``
``IGG_CHECKPOINT_EVERY``  checkpoint cadence in steps (0 = off)
``IGG_CHECKPOINT_DIR``    default checkpoint directory
``IGG_CHECKPOINT_KEEP``   newest generations kept after each save (0 = all)
``IGG_FAULT_INJECT``      fault spec (`utils.resilience.FaultInjector`)
``IGG_INTEGRITY``         integrity-plane master switch (1 = transport
                          checksums on; 0 = every detector off)
``IGG_INTEGRITY_EVERY``   shadow-step audit cadence in steps (0 = off)
``IGG_GENERATION``        this incarnation's generation token (fencing)
``IGG_FENCE_DIR``         directory of the authoritative ``generation.json``
``IGG_TELEMETRY``         0 turns the counter/event sink off (default on)
``IGG_TELEMETRY_DIR``     event-log directory (unset = no event files)
``IGG_TELEMETRY_MAX_TENANTS``  cap on distinct per-tenant series (>= 1)
``IGG_HEARTBEAT_EVERY``   serving-round cadence of the local heartbeat work
``IGG_SLO_WINDOW_S``      rolling SLO sub-window length in seconds (> 0)
``IGG_TRACE_RING``        capacity of the per-process host-span ring (>= 0)
``IGG_TRACE_SAMPLE``      head-based request-trace sampling rate in [0, 1]
``IGG_SKEW_WARN``         straggler threshold of the all-ranks skew probe
``IGG_METRICS_PORT``      live-plane scrape port (0 = ephemeral; unset = off)
``IGG_METRICS_HOST``      live-plane bind address (default loopback)
``IGG_GATHER_BATCH``      blocks per chunk of the multi-process `gather`
                          (clamped to >= 1, default 8; `ops.gather.
                          _gather_batch_size`): the root's device transient
                          is at most this many blocks
``IGG_BATCH``             default serving slot-pool capacity (>= 1)
``IGG_BATCH_ROUND_STEPS`` default steps per serving round (>= 1)
``IGG_SERVE_PORT``        front-door port (0 = ephemeral)
``IGG_SERVE_HOST``        front-door bind address (default loopback)
``IGG_SERVE_MAX_BODY``    front-door request-body bound in bytes
``IGG_TENANT_QUOTA``      per-tenant token bucket ``RATE[:BURST]``
``IGG_FRONTDOOR_QUEUE_MAX``  queue-depth backpressure threshold
``IGG_FRONTDOOR_SLO_P99_S``  round-latency p99 backpressure threshold
``IGG_AUTOSCALE_QUEUE_HIGH`` queue depth that votes for a scale-up
``IGG_AUTOSCALE_SUSTAIN`` consecutive verdicts before a resize commits
``IGG_RESULT_KEEP``       consumed serving results kept (0 = all)
``IGG_RESULT_TTL_S``      age bound on consumed serving results (> 0)
``IGG_PROFILE``           device-timeline capture window ``steps:A-B``
``IGG_PROFILE_DIR``       base directory of the per-rank capture dirs
``IGG_SUPERVISE_MAX_RESTARTS``  in-place restarts before a rung is dropped
``IGG_SUPERVISE_BACKOFF_S``  base of the supervisor's relaunch backoff (> 0)
``IGG_SUPERVISE_POLL_S``  supervisor polling cadence in seconds (> 0)
``IGG_FLEET_PORT``        fleet router port (0 = ephemeral)
``IGG_FLEET_POLL_S``      fleet controller polling cadence in seconds (> 0)
``IGG_FLEET_RESPAWN_LIMIT``  pool respawns before its devices are quarantined
``IGG_FLEET_SCRAPE_RETRIES``  per-endpoint health-scrape retry budget
``IGG_FLEET_SPILL_QUEUE`` hot-pool queue depth that spawns a spill pool
``IGG_FLEET_IDLE_RETIRE`` idle observations before a spilled pool retires
``IGG_FLEET_CANARY_STREAK``  healthy canary observations before promotion
``IGG_FLEET_CANARY_P99_S``  canary round-p99 breach threshold in seconds
``IGG_AUTOTUNE``          default for the models' ``make_multi_step``
                          ``autotune=`` kwarg (`implicitglobalgrid_tpu_torch.
                          tuning`; nonzero = on, unset/0 = off): on first
                          use of a (backend, topology, model, size, dtype,
                          batch) point, search the schedule-kwarg space
                          (cost-model-pruned, short measured runs) and
                          apply the cached winner on every later call —
                          a pure substitution of existing kwargs, resolved
                          before the step is built
``IGG_TUNE_CACHE``        primary directory of the autotuner's on-disk
                          winner table (unset = ``~/.cache/
                          implicitglobalgrid_tpu_torch/tune``); the committed
                          seed layer ``tuning/entries`` is always the
                          read-only fallback — read per resolve
``IGG_TUNE_TOPK``         total candidates measured per search (int >= 1,
                          default 4; `tuning.space.prune` — the default
                          config always counts among them, so ``1`` can
                          only ever confirm the default)
``IGG_TUNE_STEPS``        timed chunk calls per measured candidate (int >=
                          1, default 3; `tuning.search.measure_candidate`
                          — short by design: the tuner ranks configs)
========================  ====================================================

The resilience, serving, profiling, supervisor, fleet and autotuning knobs
are read per call, not snapshotted at init; their names, validation and
messages are the JAX package's (``utils/config.py``).  This table is the
port's env-var documentation: the ``knob-decl`` analyzer
(`analysis.knobs`) holds every ``IGG_*`` the package references to it.
"""

from __future__ import annotations

import os

#: Valid values for ``IGG_GUARD_POLICY`` / the models' ``guard_policy``.
GUARD_POLICIES = ("raise", "warn", "rollback")


def _int_env(name: str, *, minimum: int | None = None) -> int | None:
    """Read an integer env var; ``None`` when unset/empty.  The message
    names the variable, the accepted range and the obtained value."""
    val = os.environ.get(name)
    if val is None or val == "":
        return None
    try:
        parsed = int(val)
    except ValueError:
        raise ValueError(
            f"Environment variable {name} must be an integer"
            f"{_range_desc(minimum)} (format: a base-10 integer), got {val!r}."
        ) from None
    _check_range(name, parsed, minimum, val)
    return parsed


def _float_env(name: str, *, minimum: float | None = None,
               exclusive_minimum: float | None = None) -> float | None:
    """Read a float env var; ``None`` when unset/empty (`_int_env`'s
    error contract)."""
    val = os.environ.get(name)
    if val is None or val == "":
        return None
    try:
        parsed = float(val)
    except ValueError:
        raise ValueError(
            f"Environment variable {name} must be a number"
            f"{_range_desc(minimum, exclusive_minimum)} "
            f"(format: a decimal number of seconds, e.g. '2' or '0.5'), "
            f"got {val!r}."
        ) from None
    _check_range(name, parsed, minimum, val, exclusive_minimum)
    return parsed


def _choice_env(name: str, choices: tuple[str, ...]) -> str | None:
    """Read an enumerated env var; ``None`` when unset/empty."""
    val = os.environ.get(name)
    if val is None or val == "":
        return None
    if val not in choices:
        raise ValueError(
            f"Environment variable {name} must be one of "
            f"{', '.join(repr(c) for c in choices)}, got {val!r}."
        )
    return val


def _str_env(name: str) -> str | None:
    return os.environ.get(name) or None


def _range_desc(minimum, exclusive_minimum=None) -> str:
    if exclusive_minimum is not None:
        return f" > {exclusive_minimum}"
    if minimum == 0:
        return " >= 0 (non-negative)"
    if minimum is not None:
        return f" >= {minimum}"
    return ""


def _check_range(name, parsed, minimum, val, exclusive_minimum=None):
    if ((minimum is not None and parsed < minimum)
            or (exclusive_minimum is not None and parsed <= exclusive_minimum)):
        kind = "an integer" if isinstance(parsed, int) else "a number"
        raise ValueError(
            f"Environment variable {name} must be {kind}"
            f"{_range_desc(minimum, exclusive_minimum)}, got {val!r}."
        )


def coalesce_env() -> bool | None:
    """``IGG_COALESCE``: multi-field halo-exchange message combining.

    ``None`` = unset (auto: coalesce whenever >= 2 fields share a
    dimension's exchange), ``False`` = per-field messages, ``True`` = the
    auto behavior pinned explicitly.  Bit-identical either way (JAX
    ``utils/config.coalesce_env``).
    """
    val = _int_env("IGG_COALESCE")
    return None if val is None else val > 0


def env_config() -> dict:
    """Read the ``IGG_*`` environment tier (once per init)."""
    cfg: dict = {}
    quiet = _int_env("IGG_QUIET")
    if quiet is not None:
        cfg["quiet"] = quiet > 0
    reorder = _int_env("IGG_REORDER")
    if reorder is not None:
        cfg["reorder"] = reorder
    overlap = _int_env("IGG_OVERLAP")
    if overlap is not None:
        cfg["overlap"] = overlap
    return cfg


# -- Resilience knobs (read per call) -----------------------------------------


def init_retries_env() -> int | None:
    """``IGG_INIT_RETRIES``: retry attempts after the first bring-up failure."""
    return _int_env("IGG_INIT_RETRIES", minimum=0)


def init_timeout_env() -> float | None:
    """``IGG_INIT_TIMEOUT_S``: overall bring-up deadline in seconds (> 0)."""
    return _float_env("IGG_INIT_TIMEOUT_S", exclusive_minimum=0)


def init_backoff_env() -> float | None:
    """``IGG_INIT_BACKOFF_S``: base retry backoff in seconds (> 0)."""
    return _float_env("IGG_INIT_BACKOFF_S", exclusive_minimum=0)


def watchdog_env() -> float | None:
    """``IGG_WATCHDOG_S``: bring-up hang watchdog in seconds (>= 0; None =
    unset, the caller's default; 0 = explicitly off)."""
    return _float_env("IGG_WATCHDOG_S", minimum=0)


def guard_every_env() -> int | None:
    """``IGG_GUARD_EVERY``: NaN/Inf guard cadence in steps (>= 0; 0 = off)."""
    return _int_env("IGG_GUARD_EVERY", minimum=0)


def guard_policy_env() -> str | None:
    """``IGG_GUARD_POLICY``: ``raise`` | ``warn`` | ``rollback``."""
    return _choice_env("IGG_GUARD_POLICY", GUARD_POLICIES)


def checkpoint_every_env() -> int | None:
    """``IGG_CHECKPOINT_EVERY``: checkpoint cadence in steps (>= 0; 0 = off)."""
    return _int_env("IGG_CHECKPOINT_EVERY", minimum=0)


def checkpoint_dir_env() -> str | None:
    """``IGG_CHECKPOINT_DIR``: default checkpoint directory."""
    return _str_env("IGG_CHECKPOINT_DIR")


def checkpoint_keep_env() -> int | None:
    """``IGG_CHECKPOINT_KEEP``: retention depth in generations (>= 0;
    0 = keep every generation)."""
    return _int_env("IGG_CHECKPOINT_KEEP", minimum=0)


def fault_inject_env() -> str | None:
    """``IGG_FAULT_INJECT``: raw fault spec (parsed by `utils.resilience`)."""
    return _str_env("IGG_FAULT_INJECT")


def integrity_enabled_env() -> bool | None:
    """``IGG_INTEGRITY``: integrity-plane master switch (tri-state).

    ``None`` = unset (transport checksums off; ``IGG_INTEGRITY_EVERY``
    still honored), ``False`` = ``0`` (every detector off), ``True`` =
    armed.  Read at the exchange entry and at loop construction.
    """
    val = _int_env("IGG_INTEGRITY")
    return None if val is None else val > 0


def integrity_every_env() -> int | None:
    """``IGG_INTEGRITY_EVERY``: shadow-step audit cadence in steps
    (>= 0; 0 = off).  Ignored when ``IGG_INTEGRITY=0``."""
    return _int_env("IGG_INTEGRITY_EVERY", minimum=0)


def generation_env() -> int | None:
    """``IGG_GENERATION``: this incarnation's generation token (>= 0;
    None = unfenced, the default outside a supervised run)."""
    return _int_env("IGG_GENERATION", minimum=0)


def fence_dir_env() -> str | None:
    """``IGG_FENCE_DIR``: directory of the authoritative ``generation.json``
    fence file (unset = fence checks off)."""
    return _str_env("IGG_FENCE_DIR")


def telemetry_enabled_env() -> bool:
    """``IGG_TELEMETRY``: the counter/event sink's switch (default on)."""
    val = _int_env("IGG_TELEMETRY")
    return True if val is None else val > 0


def telemetry_dir_env() -> str | None:
    """``IGG_TELEMETRY_DIR``: event-log directory (unset = no files)."""
    return _str_env("IGG_TELEMETRY_DIR")


def telemetry_max_tenants_env() -> int | None:
    """``IGG_TELEMETRY_MAX_TENANTS``: cap on distinct per-tenant counter
    series (>= 1); overflow folds into ``serving.tenant.__other__.steps``."""
    return _int_env("IGG_TELEMETRY_MAX_TENANTS", minimum=1)


def heartbeat_every_env() -> int | None:
    """``IGG_HEARTBEAT_EVERY``: heartbeat cadence in steps (serving: in
    rounds) (>= 0; 0 = off)."""
    return _int_env("IGG_HEARTBEAT_EVERY", minimum=0)


def slo_window_env() -> float | None:
    """``IGG_SLO_WINDOW_S``: rolling SLO sub-window length in seconds
    (> 0; unset = the `utils.telemetry.SLO_WINDOW_S_DEFAULT` default)."""
    return _float_env("IGG_SLO_WINDOW_S", exclusive_minimum=0)


def trace_ring_env() -> int | None:
    """``IGG_TRACE_RING``: per-process span ring-buffer capacity (>= 0;
    0 disables span recording; unset = the `utils.tracing` default)."""
    return _int_env("IGG_TRACE_RING", minimum=0)


def trace_sample_env() -> float | None:
    """``IGG_TRACE_SAMPLE``: head-based request-trace sampling rate at the
    front door (in [0, 1]; 0 mints no contexts, unset/1 traces every
    request; inbound contexts are never re-sampled)."""
    return _float_env("IGG_TRACE_SAMPLE", minimum=0)


def skew_warn_env() -> float | None:
    """``IGG_SKEW_WARN``: straggler event threshold on max/min per-rank
    step wall time (>= 0; 0 disables the event, gauges still publish)."""
    return _float_env("IGG_SKEW_WARN", minimum=0)


def metrics_port_env() -> int | None:
    """``IGG_METRICS_PORT``: live-plane scrape port (>= 0; 0 = ephemeral).
    ``None`` = unset — the per-rank HTTP server never starts."""
    return _int_env("IGG_METRICS_PORT", minimum=0)


def metrics_host_env() -> str | None:
    """``IGG_METRICS_HOST``: live-plane bind address (the consumer falls
    back to ``127.0.0.1`` when unset)."""
    return _str_env("IGG_METRICS_HOST")


# -- Batched serving knobs (read per loop construction) -----------------------


def gather_batch_env() -> int | None:
    """``IGG_GATHER_BATCH``: blocks per chunk of the chunked gather.

    Clamped (not rejected) to >= 1 by the consumer, as in the JAX package.
    """
    return _int_env("IGG_GATHER_BATCH")


def batch_env() -> int | None:
    """``IGG_BATCH``: default serving slot-pool capacity B (>= 1)."""
    return _int_env("IGG_BATCH", minimum=1)


def batch_round_steps_env() -> int | None:
    """``IGG_BATCH_ROUND_STEPS``: default steps per serving round (>= 1)."""
    return _int_env("IGG_BATCH_ROUND_STEPS", minimum=1)


# -- Serving front-door knobs (read per construction) -------------------------


def serve_port_env() -> int | None:
    """``IGG_SERVE_PORT``: front-door port (>= 0; 0 = ephemeral).  ``None``
    = unset — `serving.frontdoor.FrontDoor` falls back to 0 (ephemeral)."""
    return _int_env("IGG_SERVE_PORT", minimum=0)


def serve_host_env() -> str | None:
    """``IGG_SERVE_HOST``: front-door bind address (default loopback —
    the consumer falls back to ``127.0.0.1`` when unset)."""
    return _str_env("IGG_SERVE_HOST")


def tenant_quota_env() -> tuple[float, float] | None:
    """``IGG_TENANT_QUOTA``: per-tenant token-bucket arrival limit as
    ``(rate_per_s, burst)``, or ``None`` when unset (= unlimited).

    Format ``RATE`` or ``RATE:BURST`` — sustained RATE requests/second per
    tenant with up to BURST (>= 1; default ``max(1, RATE)``) accumulated.
    """
    val = os.environ.get("IGG_TENANT_QUOTA")
    if val is None or val == "":
        return None
    parts = val.split(":")
    try:
        if len(parts) not in (1, 2):
            raise ValueError
        rate = float(parts[0])
        burst = float(parts[1]) if len(parts) == 2 else max(1.0, rate)
    except ValueError:
        raise ValueError(
            f"Environment variable IGG_TENANT_QUOTA must be 'RATE' or "
            f"'RATE:BURST' (decimal requests/second, e.g. '5' or '5:10'), "
            f"got {val!r}."
        ) from None
    if rate <= 0 or burst < 1:
        raise ValueError(
            f"Environment variable IGG_TENANT_QUOTA needs RATE > 0 and "
            f"BURST >= 1, got {val!r}."
        )
    return rate, burst


def frontdoor_queue_max_env() -> int | None:
    """``IGG_FRONTDOOR_QUEUE_MAX``: queue-depth backpressure threshold
    (>= 1; unset = the front door's 4x-capacity default)."""
    return _int_env("IGG_FRONTDOOR_QUEUE_MAX", minimum=1)


def frontdoor_slo_p99_env() -> float | None:
    """``IGG_FRONTDOOR_SLO_P99_S``: round-latency p99 backpressure
    threshold in seconds (> 0; unset = no p99 gate)."""
    return _float_env("IGG_FRONTDOOR_SLO_P99_S", exclusive_minimum=0)


def autoscale_queue_high_env() -> int | None:
    """``IGG_AUTOSCALE_QUEUE_HIGH``: queue depth that votes for a scale-up
    (>= 1; unset = the pool capacity)."""
    return _int_env("IGG_AUTOSCALE_QUEUE_HIGH", minimum=1)


def autoscale_sustain_env() -> int | None:
    """``IGG_AUTOSCALE_SUSTAIN``: consecutive non-hold autoscaler verdicts
    before a resize commits (>= 1, default 2)."""
    return _int_env("IGG_AUTOSCALE_SUSTAIN", minimum=1)


def serve_max_body_env() -> int | None:
    """``IGG_SERVE_MAX_BODY``: front-door request-body bound in bytes
    (>= 1; unset = the 1 MiB default, `serving.frontdoor.MAX_BODY_DEFAULT`)."""
    return _int_env("IGG_SERVE_MAX_BODY", minimum=1)


def result_keep_env() -> int | None:
    """``IGG_RESULT_KEEP``: retired-result retention depth (>= 0;
    0/unset = keep every result)."""
    return _int_env("IGG_RESULT_KEEP", minimum=0)


def result_ttl_env() -> float | None:
    """``IGG_RESULT_TTL_S``: age bound in seconds on consumed results
    (> 0; unset = no TTL)."""
    return _float_env("IGG_RESULT_TTL_S", exclusive_minimum=0)


# -- Device-timeline profiling knobs ------------------------------------------


def profile_env() -> str | None:
    """``IGG_PROFILE``: device-timeline capture window spec (``steps:A-B``
    or ``steps:N``); unset/empty = no capture.  Parsed and validated by
    `utils.profiling.parse_profile_window`."""
    return _str_env("IGG_PROFILE")


def profile_dir_env() -> str | None:
    """``IGG_PROFILE_DIR``: base directory for per-rank profiler capture
    dirs (unset = derive from ``IGG_TELEMETRY_DIR``)."""
    return _str_env("IGG_PROFILE_DIR")


# -- Fleet knobs (read per construction, host-side) ---------------------------


def fleet_port_env() -> int | None:
    """``IGG_FLEET_PORT``: fleet router public port (>= 0; 0 = ephemeral).
    ``None`` = unset — `fleet.router.FleetRouter` falls back to 0."""
    return _int_env("IGG_FLEET_PORT", minimum=0)


def fleet_poll_env() -> float | None:
    """``IGG_FLEET_POLL_S``: fleet controller polling cadence in seconds
    (> 0, default 0.5)."""
    return _float_env("IGG_FLEET_POLL_S", exclusive_minimum=0)


def fleet_respawn_limit_env() -> int | None:
    """``IGG_FLEET_RESPAWN_LIMIT``: pool respawns per failure streak before
    the policy quarantines the pool's device subset (>= 0, default 2)."""
    return _int_env("IGG_FLEET_RESPAWN_LIMIT", minimum=0)


def fleet_scrape_retries_env() -> int | None:
    """``IGG_FLEET_SCRAPE_RETRIES``: per-endpoint health-scrape retry budget
    (>= 0, default 2) before the endpoint is marked ``UNREACHABLE``."""
    return _int_env("IGG_FLEET_SCRAPE_RETRIES", minimum=0)


def fleet_spill_queue_env() -> int | None:
    """``IGG_FLEET_SPILL_QUEUE``: hot-pool queue depth that makes the policy
    spawn a spill pool (>= 1; unset = spill off)."""
    return _int_env("IGG_FLEET_SPILL_QUEUE", minimum=1)


def fleet_idle_retire_env() -> int | None:
    """``IGG_FLEET_IDLE_RETIRE``: consecutive idle observations before a
    spilled pool retires (>= 1; unset = pools never retire)."""
    return _int_env("IGG_FLEET_IDLE_RETIRE", minimum=1)


def fleet_canary_streak_env() -> int | None:
    """``IGG_FLEET_CANARY_STREAK``: consecutive healthy canary observations
    before auto-promote (>= 1, default 3)."""
    return _int_env("IGG_FLEET_CANARY_STREAK", minimum=1)


def fleet_canary_p99_env() -> float | None:
    """``IGG_FLEET_CANARY_P99_S``: canary round-p99 breach threshold in
    seconds (> 0; unset = alerts-only breach detection)."""
    return _float_env("IGG_FLEET_CANARY_P99_S", exclusive_minimum=0)


# -- Supervisor knobs -----------------------------------------------------------


def supervise_max_restarts_env() -> int | None:
    """``IGG_SUPERVISE_MAX_RESTARTS``: in-place restarts per failure streak
    before the supervisor shrinks a rung (>= 0, default 2)."""
    return _int_env("IGG_SUPERVISE_MAX_RESTARTS", minimum=0)


def supervise_backoff_env() -> float | None:
    """``IGG_SUPERVISE_BACKOFF_S``: base relaunch backoff in seconds
    (> 0, default 0.5)."""
    return _float_env("IGG_SUPERVISE_BACKOFF_S", exclusive_minimum=0)


def supervise_poll_env() -> float | None:
    """``IGG_SUPERVISE_POLL_S``: supervisor liveness/health polling cadence
    in seconds (> 0, default 0.5)."""
    return _float_env("IGG_SUPERVISE_POLL_S", exclusive_minimum=0)


# -- Autotuning knobs (read per resolve, before the step is built) -------------


def autotune_env() -> bool | None:
    """``IGG_AUTOTUNE``: default for ``make_multi_step(autotune=)``.

    ``None`` = unset (off unless the kwarg says otherwise); resolved when
    the step is built, so a step once built never changes its config.
    """
    val = _int_env("IGG_AUTOTUNE")
    return None if val is None else val > 0


def tune_cache_env() -> str | None:
    """``IGG_TUNE_CACHE``: primary winner-table directory (unset = the
    per-user default, `tuning.cache.default_cache_dir`)."""
    val = os.environ.get("IGG_TUNE_CACHE")
    return val or None


def tune_topk_env() -> int | None:
    """``IGG_TUNE_TOPK``: total candidates measured per search, the default
    config included (>= 1, default 4)."""
    return _int_env("IGG_TUNE_TOPK", minimum=1)


def tune_steps_env() -> int | None:
    """``IGG_TUNE_STEPS``: timed chunk calls per measured candidate (>= 1,
    default 3)."""
    return _int_env("IGG_TUNE_STEPS", minimum=1)
