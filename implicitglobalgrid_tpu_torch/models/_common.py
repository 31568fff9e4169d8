"""Helpers the port's models share."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.grid import finalize_global_grid, grid_is_initialized


def params_from(cls, other):
    """A ``cls`` params record from any object with the same field names —
    e.g. the JAX package's ``Params`` of the same model (its numpy/JAX dtype
    becomes the matching torch dtype)."""
    kw = {f.name: getattr(other, f.name) for f in dataclasses.fields(cls)}
    if kw["dtype"] is not None and not isinstance(kw["dtype"], torch.dtype):
        kw["dtype"] = torch.from_numpy(np.zeros(0, np.dtype(kw["dtype"]))).dtype
    return cls(**kw)


def later(what: str, item: str):
    """Raise for a feature a later slice of the port brings."""
    raise NotImplementedError(
        f"{what} is not in the port yet; it comes with a later slice "
        f"(ROADMAP.md Queue A item {item})."
    )


#: What the models' ``run()`` docstrings say of the resilience hooks.
RUN_HOOKS_DOC = """
    Resilience hooks (kwarg > ``IGG_*`` env > off; `utils.resilience`):
    ``guard_every=N`` runs the `check_fields` NaN/Inf probe every ``N``
    steps under ``guard_policy`` (``raise`` | ``warn`` | ``rollback``);
    ``checkpoint_every=N`` writes restartable checkpoints to
    ``checkpoint_dir`` — a rerun pointing at the same directory resumes
    from the latest VALID one, even on another admissible topology (elastic
    restart); ``checkpoint_keep=N`` prunes to the newest N generations
    after each save, never deleting the only verified one;
    ``integrity_every=N`` re-executes every Nth step from a pre-step
    snapshot and bit-compares it (the shadow-step audit), so a finite
    silent corruption raises `integrity.IntegrityError` naming the rank.
    With every hook off the loop is the steps and nothing else.

    ``fused_k=k`` steps with the model's Hopper kernel
    (``make_multi_step(..., fused_k=k)``) one group per loop call; ``nt``
    and the hooks' cadences then count steps in whole groups.

    Telemetry (on unless ``IGG_TELEMETRY=0``; `utils.telemetry.step_loop`):
    ``<model>.steps``, ``.step_seconds``, ``.steps_per_s`` and ``T_eff``
    per step, ``run.start``/``heartbeat``/``run.complete`` events under
    ``IGG_TELEMETRY_DIR``, an ``igg.step`` span per loop call and an
    ``igg.run.setup`` span around the setup; ``IGG_METRICS_PORT`` brings
    up the live plane's scrape server before the setup.
"""


def run(setup, make_step, nt: int, nxyz, finalize: bool, setup_kwargs: dict, *,
        names, model: str, stream: int, make_multi_step=None, fused_k=None,
        group: int = 1, guard_every=None, guard_policy=None, checkpoint_every=None,
        checkpoint_dir=None, checkpoint_keep=None, integrity_every=None):
    """``nt`` steps of ``make_step(params)`` (or, with ``fused_k``, of
    ``make_multi_step(params, group, fused_k=fused_k)``, ``group`` steps a
    call) from ``setup(*nxyz, **setup_kwargs)`` through
    `utils.resilience.guarded_time_loop` under a `RunGuard` of the given
    knobs (``names``: the state's field names); returns this rank's first
    state field.  ``model`` names the step telemetry and ``stream`` counts
    the leading state fields of its bytes model (`telemetry.teff_bytes`:
    the fields every step must read and write).  A failed run finalizes the
    grid unless the caller had set it up."""
    from ..utils import liveplane, telemetry, tracing
    from ..utils.resilience import RunGuard, guarded_time_loop

    if not fused_k:
        group = 1
    if nt % group:
        raise ValueError(f"nt={nt} must be a multiple of the {group} steps of a "
                         f"fused_k={fused_k} group")
    caller_owns_grid = grid_is_initialized()
    try:
        # The live plane is up before the setup, so an operator can scrape
        # /healthz while the run is still building (no-op unless
        # IGG_METRICS_PORT is set).
        liveplane.ensure_server()
        with tracing.trace_span("igg.run.setup", model=model):
            state, params = setup(*nxyz, **setup_kwargs)
            step = (make_multi_step(params, group, fused_k=fused_k) if fused_k
                    else make_step(params))
        guard = RunGuard(
            guard_every=guard_every, policy=guard_policy,
            checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir,
            checkpoint_keep=checkpoint_keep, integrity_every=integrity_every,
            names=names,
        )
        state = guarded_time_loop(
            step, state, nt, guard=guard, model=model,
            bytes_per_step=telemetry.teff_bytes(state[:stream]), steps_per_call=group,
        )
        if state[0].is_cuda:
            torch.cuda.synchronize(state[0].device)
    except BaseException:
        if not caller_owns_grid and grid_is_initialized():
            finalize_global_grid()
        raise
    if finalize:
        finalize_global_grid()
    return state[0]
