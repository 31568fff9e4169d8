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
