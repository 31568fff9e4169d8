"""Environment-variable configuration tier read by `init_global_grid`.

The deploy-time tier below the kwargs tier (explicit kwargs > ``IGG_*`` env
> defaults), restricted to the keys the port's `init_global_grid` reads:

========================  ====================================================
``IGG_QUIET``             nonzero suppresses the rank-0 banner
``IGG_REORDER``           default ``reorder`` flag (recorded on the grid)
``IGG_OVERLAP``           default overlap in every dimension (default 2)
========================  ====================================================
"""

from __future__ import annotations

import os


def _int_env(name: str) -> int | None:
    """Read an integer env var; ``None`` when unset/empty."""
    val = os.environ.get(name)
    if val is None or val == "":
        return None
    try:
        return int(val)
    except ValueError:
        raise ValueError(
            f"Environment variable {name} must be an integer (format: a "
            f"base-10 integer), got {val!r}."
        ) from None


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
