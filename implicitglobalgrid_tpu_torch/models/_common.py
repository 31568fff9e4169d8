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


#: The JAX package's ``run`` resilience hooks (`utils/resilience.py`).
RESILIENCE_KWARGS = ("guard_every", "guard_policy", "checkpoint_every", "checkpoint_dir",
                     "checkpoint_keep", "integrity_every")


def run(setup, make_step, nt: int, nxyz, finalize: bool, setup_kwargs: dict):
    """``nt`` steps of ``make_step(params)`` from ``setup(*nxyz,
    **setup_kwargs)``; returns this rank's first state field.  A failed run
    finalizes the grid unless the caller had set it up."""
    for name in RESILIENCE_KWARGS:
        if setup_kwargs.pop(name, None) is not None:
            later(f"run({name}=...)", "12")
    caller_owns_grid = grid_is_initialized()
    try:
        state, params = setup(*nxyz, **setup_kwargs)
        step = make_step(params)
        for _ in range(nt):
            state = step(*state)
        if state[0].is_cuda:
            torch.cuda.synchronize(state[0].device)
    except BaseException:
        if not caller_owns_grid and grid_is_initialized():
            finalize_global_grid()
        raise
    if finalize:
        finalize_global_grid()
    return state[0]
