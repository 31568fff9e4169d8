"""Generation fencing: a superseded incarnation must not publish state.

A supervised run is a sequence of incarnations, each with a
monotonically increasing generation token (``IGG_GENERATION``, the same on
every rank of one incarnation); the supervisor publishes the authoritative
token as ``generation.json`` under ``IGG_FENCE_DIR``.  A zombie rank — a
process of an older incarnation that a kill missed — still believes it owns
the run, so every durable publish checks the fence first: a process whose
token is older than the authoritative one is refused (`FenceError`), and
the refusal lands as a ``fence.rejected`` event and the
``fence.rejected_total`` counter.

The verdict is rank-uniform (a per-incarnation token against a shared
file), so it can never split a collective save.  Unfenced runs
(``IGG_GENERATION`` unset, the default) skip every check.

The port's copy of the JAX package's ``supervisor/generation.py``: the
fence checks, and `publish_generation`, which `supervisor.manager` and
`fleet.controller` call.
"""

from __future__ import annotations

import json
import os
import time

from ..utils import config as _config
from ..utils import telemetry as _telemetry

__all__ = [
    "FenceError",
    "GENERATION_FILE",
    "current_generation",
    "authoritative_generation",
    "fence_dir",
    "publish_generation",
    "fence_refusal",
    "fence_refused",
    "check_fence",
]

#: the authoritative-token file the supervisor publishes under IGG_FENCE_DIR
GENERATION_FILE = "generation.json"


class FenceError(RuntimeError):
    """A write was refused because this process's generation is superseded."""

    def __init__(self, message: str, *, generation: int, authoritative: int):
        super().__init__(message)
        self.generation = generation
        self.authoritative = authoritative


def current_generation() -> int | None:
    """This incarnation's token (``IGG_GENERATION``; None = unfenced)."""
    return _config.generation_env()


def fence_dir() -> str | None:
    """Where the authoritative token lives (``IGG_FENCE_DIR``)."""
    return _config.fence_dir_env()


def authoritative_generation(directory: str | None = None) -> int | None:
    """The supervisor-published current token, or None when no fence file
    is readable.  A present but unparseable file also reads as None (a torn
    file must not wedge the run) and is recorded as a ``fence.corrupt``
    event."""
    directory = directory if directory is not None else fence_dir()
    if not directory:
        return None
    path = os.path.join(directory, GENERATION_FILE)
    try:
        with open(path) as f:
            return int(json.load(f)["generation"])
    except FileNotFoundError:
        return None
    except (OSError, ValueError, KeyError, TypeError):
        _telemetry.counter("fence.corrupt_total").inc()
        _telemetry.event("fence.corrupt", path=path)
        return None


def publish_generation(generation: int, directory: str | None = None, **info) -> str:
    """Supervisor side: atomically publish ``generation`` as the
    authoritative token.  Refuses to move the token backwards: the
    monotonicity that makes the stale-token refusal sound."""
    directory = directory if directory is not None else fence_dir()
    if not directory:
        raise ValueError(
            "publish_generation needs a fence directory (argument or "
            "IGG_FENCE_DIR)."
        )
    generation = int(generation)
    prev = authoritative_generation(directory)
    if prev is not None and generation < prev:
        raise ValueError(
            f"generation must be monotonic: refusing to publish "
            f"{generation} over the authoritative {prev}."
        )
    os.makedirs(directory, exist_ok=True)
    return _telemetry.atomic_write_json(
        os.path.join(directory, GENERATION_FILE),
        {"generation": generation, "ts": time.time(), **info},
    )


def fence_refusal(what: str) -> FenceError | None:
    """The fence decision for one publish attempt, without raising: a
    `FenceError` (already recorded) when this process carries a stale
    token, else None."""
    gen = current_generation()
    if gen is None:
        return None
    auth = authoritative_generation()
    if auth is None or auth <= gen:
        return None
    _telemetry.counter("fence.rejected_total").inc()
    _telemetry.event("fence.rejected", what=what, generation=gen, authoritative=auth)
    return FenceError(
        f"{what} refused: this process carries generation {gen} but the "
        f"supervisor has moved the run to generation {auth} — a superseded "
        f"(zombie) incarnation must not publish state.",
        generation=gen,
        authoritative=auth,
    )


def fence_refused(what: str) -> bool:
    """Non-raising fence check for advisory writes (endpoint files, the
    canary verdict): True = refuse (the refusal is already recorded)."""
    return fence_refusal(what) is not None


def check_fence(what: str) -> None:
    """Raising fence check for durable publishes (checkpoints)."""
    err = fence_refusal(what)
    if err is not None:
        raise err
