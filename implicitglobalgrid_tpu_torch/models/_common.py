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
"""


def run(setup, make_step, nt: int, nxyz, finalize: bool, setup_kwargs: dict, *,
        names, guard_every=None, guard_policy=None, checkpoint_every=None,
        checkpoint_dir=None, checkpoint_keep=None, integrity_every=None):
    """``nt`` steps of ``make_step(params)`` from ``setup(*nxyz,
    **setup_kwargs)`` through `utils.resilience.guarded_time_loop` under a
    `RunGuard` of the given knobs (``names``: the state's field names);
    returns this rank's first state field.  A failed run finalizes the grid
    unless the caller had set it up."""
    from ..utils.resilience import RunGuard, guarded_time_loop

    caller_owns_grid = grid_is_initialized()
    try:
        state, params = setup(*nxyz, **setup_kwargs)
        step = make_step(params)
        guard = RunGuard(
            guard_every=guard_every, policy=guard_policy,
            checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir,
            checkpoint_keep=checkpoint_keep, integrity_every=integrity_every,
            names=names,
        )
        state = guarded_time_loop(step, state, nt, guard=guard)
        if state[0].is_cuda:
            torch.cuda.synchronize(state[0].device)
    except BaseException:
        if not caller_owns_grid and grid_is_initialized():
            finalize_global_grid()
        raise
    if finalize:
        finalize_global_grid()
    return state[0]
