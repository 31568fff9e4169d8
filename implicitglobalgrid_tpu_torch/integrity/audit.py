"""Shadow-step audit: bit-compare a re-executed step against its commit.

The detector of wrong *compute*: at the ``IGG_INTEGRITY_EVERY`` cadence,
`utils.resilience.guarded_time_loop` keeps a pre-step snapshot, re-executes
the just-committed step from it and bit-compares the two results here.  The
port's kernels and its plain versions are run-to-run deterministic on
healthy hardware (no atomics, fixed reduction orders, fixed stream order),
so ANY difference, one flipped mantissa bit included, is a finding.

Each rank compares its blocks over the word view (`ops.halo._flat_words`,
so NaN bit patterns count), writes one flag per field into a ``(nfields,
*dims)`` int32 one-hot at its block coordinates and all-reduces it: every
rank reads the same verdict and raises (or not) together, the discipline of
`utils.resilience.check_fields`.  The port's counterpart of the JAX
package's ``integrity/audit.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["AuditReport", "audit_fields"]


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """Outcome of one shadow-step bit-compare."""

    names: tuple[str, ...]
    #: field name -> block coords whose re-execution differed bitwise
    bad_blocks: dict
    #: ranks owning a differing block
    implicated_ranks: tuple[int, ...]

    @property
    def ok(self) -> bool:
        return not self.bad_blocks

    def summary(self) -> str:
        if self.ok:
            return f"bit-identical re-execution ({', '.join(self.names)})"
        parts = [
            f"{name}: block(s) {', '.join(str(c) for c in coords)}"
            for name, coords in self.bad_blocks.items()
        ]
        return (
            "re-execution differs bitwise in " + "; ".join(parts)
            + f" (implicated rank(s) {list(self.implicated_ranks)})"
        )


def audit_fields(committed: tuple, redone: tuple,
                 names: Sequence[str] | None = None) -> AuditReport:
    """Bit-compare a committed state tuple against its re-execution.

    Returns an `AuditReport` naming every field and block whose bits
    differ and the owning ranks.  Collective (the verdict is all-reduced):
    every rank must call it and sees the same report.  Batched fields
    ``(B, *block)`` report the block, not the member.
    """
    from ..ops.halo import _flat_words
    from ..parallel import grid as _grid
    from ..parallel import topology
    from ..utils.resilience import _block_flags_report, _field_names

    _grid.check_initialized()
    if len(committed) != len(redone):
        raise ValueError(
            f"audit_fields: committed has {len(committed)} fields, the "
            f"re-execution {len(redone)}."
        )
    names = _field_names(names, len(committed))
    for i, (a, b) in enumerate(zip(committed, redone)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(
                f"audit_fields: field {i} is {tuple(a.shape)} {a.dtype} committed but "
                f"{tuple(b.shape)} {b.dtype} re-executed."
            )
    flags = [(_flat_words(a) != _flat_words(b)).any() for a, b in zip(committed, redone)]
    gg = _grid.global_grid()
    bad = _block_flags_report(committed, flags, names)
    ranks = {topology.rank_of_coords(c, gg.dims) for coords in bad.values() for c in coords}
    return AuditReport(names=names, bad_blocks=bad, implicated_ranks=tuple(sorted(ranks)))

