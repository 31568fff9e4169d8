"""The integrity plane's rank-uniformity contract.

`integrity_plan` states, per RANK, the ordered collective schedule one
integrity-plane observation implies.  The plane's SPMD discipline has two
halves:

* the transport checksum adds NO collective: the checksum word rides the
  existing send/receive pair's payload, verification is a pure local
  recompute, and a mismatch raises LOCALLY — so the plan for an exchange
  is one entry per hop whether or not checksums are armed, identical on
  every rank;
* the shadow audit's one extra collective (the replicated bit-compare
  all-reduce) is keyed ONLY on the rank-uniform cadence
  (``IGG_INTEGRITY_EVERY`` arrives identically via the environment tier),
  never on a rank-local verdict — a rank-local verdict driving a
  collective would deadlock the ranks that did not see it.

The port's copy of the JAX package's ``integrity/plan.py`` (same entries,
so the two packages' plans compare equal).
"""

from __future__ import annotations

__all__ = ["integrity_plan"]


def integrity_plan(is_root: bool, *, checksums: bool, audit_every: int,
                   step: int, exchange_dims: int = 1) -> tuple:
    """The ordered host-transport schedule of ONE guarded step on one rank.

    ``is_root`` exists precisely so a census can prove the schedule
    ignores rank identity.
    ``checksums`` — transport checksums armed (``IGG_INTEGRITY=1``);
    ``audit_every`` — shadow-audit cadence (0 = off); ``step`` — 1-based
    committed step; ``exchange_dims`` — dimensions the step's halo
    exchange permutes.  All four are rank-uniform inputs: the env tier
    delivers the knobs identically, the step counter advances in lockstep.
    """
    del is_root  # rank identity must not shape the schedule
    plan = []
    for d in range(exchange_dims):
        # one ppermute pair per exchanged dimension, checksums or not —
        # the checksum word rides the same hop (payload-only delta)
        plan.append(
            ("ppermute_pair", d, "checksummed" if checksums else "plain")
        )
    if audit_every and step % audit_every == 0:
        # the replicated bit-compare reduction: cadence-keyed, never
        # verdict-keyed
        plan.append(("psum", "audit-compare"))
    return tuple(plan)
