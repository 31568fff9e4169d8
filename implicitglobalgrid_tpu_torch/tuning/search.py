"""Search orchestration of the autotuner: measure, decide, broadcast, cache.

Counterpart of the JAX package's ``tuning/search.py``.  One
``resolve_tuned_config`` call is the whole lifecycle of a tuning point:

1. **cache decision** — on multi-process grids RANK 0 ALONE consults the
   on-disk table and the decision rides the existing
   `serving.frontdoor.broadcast_control` host transport.  A rank-keyed
   cache lookup (every rank trusting its own disk) is exactly the
   SPMD-divergence class the ``collective-consistency`` analyzer pins: a
   rank whose local cache hit would skip the measurement collectives its
   peers enter, and the job hangs.  `control_plan` states the invariant
   (the per-rank collective schedule ignores rank identity and local cache
   state); the analyzer's census provider checks it
   (`analysis.collectives.tuning_plan_censuses`).
2. **search** (miss only) — every rank enumerates the SAME candidate list
   (`space.candidate_space` is a pure function of the shared grid
   geometry, the card model and env), prunes it with the static prior
   (`space.prune`, top ``IGG_TUNE_TOPK``), and measures the survivors
   TOGETHER with short runs of the model's own step (each exchanges halos:
   measurement itself is collective, so the rank-uniform candidate order
   is load-bearing).
3. **decide + publish** — rank 0's timings pick the winner, the winner
   broadcasts, rank 0 persists it (`cache.TuneCache.store`, atomic).
   Every rank applies the identical config; the second call at the same
   key is a pure cache hit (no measurement — pinned by the
   ``tune.cache_hit`` / ``tune.candidates_measured`` counters).

A candidate that fails to build or to launch on the card raises out of the
search: nothing turns it into a slow time or a skipped row.

Telemetry (no-op under ``IGG_TELEMETRY=0``): the ``igg.tune`` span around
the whole resolve, ``tune.cache_hit`` / ``tune.cache_miss``,
``tune.candidates_pruned`` / ``tune.candidates_measured``,
``tune.search_seconds``, and a rank-tagged ``tune.winner`` event carrying
the chosen config.
"""

from __future__ import annotations

import json
import time

from ..utils import telemetry as _telemetry
from ..utils import tracing as _tracing
from . import cache as _cache
from . import space as _space


def _topk() -> int:
    from ..utils.config import tune_topk_env

    val = tune_topk_env()
    return 4 if val is None else val


def _tune_steps() -> int:
    from ..utils.config import tune_steps_env

    val = tune_steps_env()
    return 3 if val is None else val


# -- the host-transport collective plan (analyzer contract) -------------------


def control_plan(is_root: bool, hit: bool, n_measured: int) -> tuple:
    """The ordered host-transport collective schedule of ONE resolve.

    ``is_root`` exists precisely so the ``collective-consistency`` census
    can prove the schedule ignores it: every rank issues the cache-decision
    broadcast, then — on a miss with admissible candidates — the identical
    measurement sequence and the winner broadcast.  ``n_measured == 0`` is
    the DEGENERATE miss (nothing admissible beyond the default): no
    measurement and no winner broadcast, a conclusion every rank reaches
    from the shared enumeration alone.  ``hit`` means the broadcast
    decision was APPLIED: an nsteps-incompatible hand-seeded winner (the
    `resolve_tuned_config` belt branch) follows the MISS-shaped schedule.
    ``hit``/``n_measured`` come from the BROADCAST decision and the shared
    enumeration, never from rank-local state.
    """
    del is_root  # rank identity must not shape the schedule
    plan = [("broadcast_control", "cache-decision")]
    if not hit and n_measured > 0:
        plan += [("measure_candidate", i) for i in range(int(n_measured))]
        plan.append(("broadcast_control", "winner"))
    return tuple(plan)


# -- measurement --------------------------------------------------------------


def measure_candidate(build_step, make_state, *, steps: int | None = None):
    """Seconds per chunk call of one candidate: build and warm once, then
    the median of ``steps`` timed calls (default ``IGG_TUNE_STEPS``, 3;
    short by design — the tuner ranks configs).  On CUDA tensors the
    state's device is synchronised before and after each timed call: a
    host clock without a sync reads the dispatch, not the card.  COLLECTIVE
    on multi-process grids: the step exchanges halos like the production
    one."""
    import torch

    steps = _tune_steps() if steps is None else steps
    step = build_step()
    state = step(*make_state())  # warm-up: kernel build, allocator
    cuda = state[0].is_cuda

    def sync():
        if cuda:
            torch.cuda.synchronize(state[0].device)

    times = []
    for _ in range(max(1, steps)):
        sync()
        t0 = time.perf_counter()
        state = step(*state)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _measure_model(module, params, nsteps: int, batch: int, config: dict,
                   base_kwargs: dict | None = None, steps: int | None = None):
    """Measure one candidate through the model's own entry point
    (``autotune=False``: a candidate build must never recurse into the
    search) on a synthetic ones-filled state (`module._tune_state` — linear
    first steps, no NaN risk, blocks on the grid's device)."""
    kwargs = dict(base_kwargs or {})
    kwargs.update(config)

    def build_step():
        return module.make_multi_step(
            params, nsteps, autotune=False, batch=bool(batch), **kwargs,
        )

    def make_state():
        state = module._tune_state(params)
        if batch:
            from ..models._batched import stack_states

            return stack_states([state] * int(batch))
        return state

    return measure_candidate(build_step, make_state, steps=steps)


# -- the resolve --------------------------------------------------------------


def _config_key(config: dict) -> str:
    return json.dumps(config, sort_keys=True)


def resolve_tuned_config(model: str, shape, dtype, *, nsteps: int,
                         batch: int = 0, gg=None, extra: dict | None = None,
                         cache: _cache.TuneCache | None = None,
                         measure=None, allow_search: bool = True) -> dict:
    """The tuned config for one point — cache hit, or search + persist.

    ``measure(config) -> seconds``: injected by `apply_tuned_config` (the
    models) and by tests (stubbed for determinism); must be rank-uniform in
    WHICH collectives it issues.  ``allow_search=False``: cache-only (a
    miss returns the default ``{}`` without measuring).  Returns a dict of
    ``make_multi_step`` kwargs (possibly empty = the default config won or
    nothing was searched).
    """
    from ..parallel import distributed as _dist

    if gg is None:
        from ..parallel.grid import global_grid

        gg = global_grid()
    key = _cache.make_key(model, shape, dtype, batch=batch, gg=gg,
                          extra=extra, nsteps=nsteps)
    cache = cache or _cache.TuneCache()
    multi = _telemetry.process_count() > 1
    is_root = _dist.process_index() == 0 if multi else True

    with _tracing.trace_span("igg.tune", model=model,
                             size="x".join(str(s) for s in key["size"])):
        t0 = time.perf_counter()
        # -- phase 1: the cache decision (rank 0's alone, broadcast) ------
        entry = cache.lookup(key) if is_root else None
        if multi:
            from ..serving.frontdoor import broadcast_control

            decision = broadcast_control(
                {"tune": {"hit": entry is not None,
                          "config": entry["config"] if entry else None,
                          "source": entry["source"] if entry else None}}
                if is_root else None
            )["tune"]
        else:
            decision = {"hit": entry is not None,
                        "config": entry["config"] if entry else None,
                        "source": entry["source"] if entry else None}
        store_winner = True
        if decision["hit"]:
            config = dict(decision["config"])
            projected = project_config(model, config, nsteps)
            if projected == config:
                _telemetry.counter("tune.cache_hit").inc()
                _telemetry.event("tune.winner", model=model, config=config,
                                 source=decision["source"], cache="hit")
                return config
            # BELT: the key's schedule class makes a resolve-written winner
            # always nsteps-compatible with its hits, so this branch only
            # fires on a hand-written entry whose cadence does not fit.
            # Applying the projected remainder would silently under-tune,
            # so fall through to a fresh search — WITHOUT overwriting the
            # entry (never thrash a hand-seeded winner).  Deterministic on
            # every rank (the decision and nsteps are shared); the
            # schedule is the miss-shaped `control_plan` row.
            store_winner = False
            _telemetry.event("tune.hit_incompatible", model=model,
                             stored=config, nsteps=nsteps)
        _telemetry.counter("tune.cache_miss").inc()
        if cache.last_refusal and is_root:
            # a refused entry (corrupt/stale-schema) degrades to a miss —
            # say so once rather than silently re-searching forever
            _telemetry.event("tune.cache_refused", reason=cache.last_refusal)
        if not allow_search:
            return {}

        # -- phase 2: enumerate + prune (pure, rank-uniform) --------------
        npt = (extra or {}).get("npt")
        candidates, rejected = _space.candidate_space(
            model, key["size"], key["dtype"], nsteps=nsteps, gg=gg, npt=npt,
        )
        survivors, cut = _space.prune(candidates, _topk())
        _telemetry.counter("tune.candidates_pruned").inc(
            len(rejected) + len(cut)
        )
        if len(survivors) <= 1:
            # Degenerate point: nothing admissible beyond the default —
            # there is nothing to measure and an empty winner is not worth
            # an entry.  No measurement, no winner broadcast: every rank
            # reaches this from the shared enumeration alone
            # (`control_plan(n_measured=0)`).
            _telemetry.event("tune.degenerate", model=model,
                             rejected=len(rejected))
            return {}

        # -- phase 3: measure the survivors TOGETHER ----------------------
        if measure is None:
            raise ValueError(
                f"tuning point {key['model']}/{key['size']} missed the "
                f"cache and no measure callable was provided — resolve "
                f"through the model's autotune= entry (or seed the cache)."
            )
        timed = []
        for cand in survivors:
            _telemetry.counter("tune.candidates_measured").inc()
            timed.append((measure(dict(cand["config"])), cand))

        # -- phase 4: rank 0 decides, everyone applies --------------------
        if multi:
            from ..serving.frontdoor import broadcast_control

            winner = broadcast_control(
                {"tune_winner": min(timed, key=lambda tc: tc[0])[1]["config"]}
                if is_root else None
            )["tune_winner"]
            t_by_cfg = {_config_key(c["config"]): t for t, c in timed}
            t_win = t_by_cfg.get(_config_key(winner))
        else:
            t_win, cand = min(timed, key=lambda tc: tc[0])
            winner = cand["config"]
        winner = dict(winner)
        elapsed = time.perf_counter() - t0
        _telemetry.counter("tune.search_seconds").inc(round(elapsed, 4))
        _telemetry.event("tune.winner", model=model, config=winner,
                         source="search", cache="miss",
                         search_seconds=round(elapsed, 3))
        if is_root and store_winner:
            modeled = next(
                (c["modeled"] for c in survivors
                 if _config_key(c["config"]) == _config_key(winner)), None,
            )
            cache.store(key, _cache.new_entry(
                key, winner, source="search", modeled=modeled,
                measured={"t_step_s": (t_win / nsteps)
                          if t_win is not None else None,
                          "teff_gbs": None, "steps": nsteps},
                tuner={"topk": _topk(), "candidates": len(candidates),
                       "pruned": len(rejected) + len(cut),
                       "measured": len(survivors)},
            ))
        return winner


# -- the model entry-point hook -----------------------------------------------

#: ``make_multi_step`` defaults per tunable kwarg: autotune substitutes a
#: field ONLY while the caller left it at this default (explicit kwargs
#: always win — the package's env-vs-kwarg precedence).
_KWARG_DEFAULTS = {"fused_k": None, "fused_tile": None, "exchange_every": 1,
                   "pipelined": None, "coalesce": None}


def autotune_requested(autotune) -> bool:
    """Kwarg > ``IGG_AUTOTUNE`` env > off (default) — resolved when the
    step is built."""
    if autotune is not None:
        return bool(autotune)
    from ..utils.config import autotune_env

    env = autotune_env()
    return False if env is None else env


def maybe_autotune(model: str, params, nsteps: int, autotune, *,
                   batch: bool = False, **kwargs) -> tuple:
    """The models' ONE-statement ``make_multi_step`` hook: resolve the five
    tunable kwargs through the winner cache when autotuning is requested
    (kwarg > ``IGG_AUTOTUNE`` > off), pass them through untouched otherwise.
    Returns ``(fused_k, fused_tile, exchange_every, pipelined, coalesce)``
    — one definition for the three models, so a new tunable field cannot
    be wired into one entry point and silently dropped from another (the
    diffusion cadence drops ``coalesce``: it exchanges one field).
    """
    kwargs = {k: kwargs.get(k, d) for k, d in _KWARG_DEFAULTS.items()}
    if autotune_requested(autotune):
        kwargs = apply_tuned_config(
            model, _space.model_module(model), params, nsteps, kwargs,
            batch=batch,
        )
    return tuple(kwargs[k] for k in _KWARG_DEFAULTS)


def apply_tuned_config(model: str, module, params, nsteps: int,
                       kwargs: dict, *, batch: bool = False) -> dict:
    """The ``make_multi_step`` hook: return ``kwargs`` with the tuned
    config substituted in, or unchanged.

    No substitution when the caller pinned ANY tunable kwarg away from its
    default — a half-tuned schedule is neither the caller's config nor the
    measured winner — and none on a ``hide_comm`` run: the overlap-scheduled
    per-step path conflicts with every cadence candidate by construction
    (the builders raise on the combination), so the tuner has nothing
    admissible to search there.  A cached winner whose cadence does not
    divide the live ``nsteps`` triggers a fresh (non-persisted) search
    inside the resolve; the projection below is pure belt — a resolve can
    only return nsteps-compatible configs.
    """
    explicit = [k for k, d in _KWARG_DEFAULTS.items() if kwargs.get(k, d) != d]
    if explicit:
        _telemetry.event("tune.skipped", model=model,
                         reason=f"explicit kwargs pin {explicit}")
        return kwargs
    if getattr(params, "hide_comm", False):
        _telemetry.event("tune.skipped", model=model,
                         reason="hide_comm schedules the per-step path; "
                                "the cadence candidates conflict with it")
        return kwargs
    from ..parallel.grid import global_grid

    gg = global_grid()
    extra = (
        {"npt": int(params.npt)} if model == "porous_convection3d" else None
    )
    config = resolve_tuned_config(
        model, gg.nxyz, params.dtype, nsteps=nsteps,
        batch=0 if not batch else 1, gg=gg, extra=extra,
        measure=lambda cfg: _measure_model(
            module, params, nsteps, 1 if batch else 0, cfg
        ),
    )
    config = project_config(model, config, nsteps)
    return {**kwargs, **config}


def project_config(model: str, config: dict, nsteps: int) -> dict:
    """Drop cached cadence fields the live ``nsteps`` cannot run (the
    porous cadence chunks ``npt``, not ``nsteps`` — exempt)."""
    out = dict(config)
    if model != "porous_convection3d":
        for field in ("fused_k", "exchange_every"):
            w = out.get(field)
            if isinstance(w, int) and w > 1 and nsteps % w != 0:
                _telemetry.counter("tune.config_projected").inc()
                out.pop(field)
                if field == "fused_k":
                    out.pop("fused_tile", None)
                    out.pop("pipelined", None)
    return out
