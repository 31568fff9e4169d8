"""Structured error type of the silent-data-corruption integrity plane.

The port's copy of the JAX package's ``integrity/errors.py``."""

from __future__ import annotations

__all__ = ["IntegrityError"]


class IntegrityError(RuntimeError):
    """A detector of the integrity plane caught silent data corruption.

    Carries enough structure for an escalation path to name the
    implicated rank without re-parsing the message:

    ``detector``         ``"transport_checksum"`` | ``"shadow_audit"`` |
                         ``"lineage_digest"``
    ``implicated_rank``  the rank whose data (or storage) is wrong — for a
                         transport mismatch the SENDER, not the receiver
                         that noticed; None when unattributable
    ``step``             1-based time-loop step (None outside a loop)
    ``dim``              exchange dimension of a transport mismatch
    ``direction``        ``"lo"`` | ``"hi"`` receive direction
    ``fields``           names/indices of the covered fields
    """

    def __init__(self, message, *, detector=None, implicated_rank=None,
                 step=None, dim=None, direction=None, fields=()):
        super().__init__(message)
        self.detector = detector
        self.implicated_rank = implicated_rank
        self.step = step
        self.dim = dim
        self.direction = direction
        self.fields = tuple(fields)
