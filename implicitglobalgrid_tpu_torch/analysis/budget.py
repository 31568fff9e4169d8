"""Collective-budget analyzer (``collective-budget``), the twin of the JAX
package's ``analysis/budget.py``.

The coalesced exchange's value is structural: one send/receive pair per
(dimension, side, dtype word width) whatever the number of fields.  A
regression that quietly sends one message per field (the coalescing lost)
costs latency on every exchange and no test of values notices, since both
are bit-identical.  This pass runs each model's exchange set through the
port's real exchange code as rank 0 of a simulated ``(2, 2, 2)`` grid,
periodic in every dimension, so that every dimension has two partners
other than the block itself, on a recording process group
(`analysis._sim`), and holds the ``P2POp``s per dimension to the
committed budget `BUDGET_PAIRS`.  Two controls keep the census honest: the
per-field exchange (``coalesce=False``) must count one pair per field, and
the batched ensemble exchange (`models._batched.update_halo`, B members)
must count what the unbatched one counts.
"""

from __future__ import annotations

from .core import Context, Finding

ANALYZER = "collective-budget"

#: Allowed send/receive PAIRS per exchanged dimension and side for each
#: model's exchange set (all fields of one dtype: one word width group).
#: Rank 0 of the simulated grid sends to and receives from each side, so a
#: pair is 4 ``P2POp``s per dimension.
BUDGET_PAIRS = {
    "diffusion": 1,  # T
    "acoustic": 1,   # P, Vx, Vy, Vz: 4 fields, one pair
    "porous": 1,     # Pf, qDx, qDy, qDz, T: 5 fields, one pair
}

#: Ensemble size of the batched census (the JAX package's).
BATCHED_CENSUS_B = 4

#: P2POps of one pair on a dimension with two partners.
OPS_PER_PAIR = 4


def model_fields(model: str, n: int, batch: int | None = None, dtype=None):
    """The exchange set of ``model`` on ``n^3`` blocks (zeros, float64 unless
    ``dtype``; the staggered faces ``n+1`` along their own axis), with a
    leading ensemble axis of ``batch`` members when given."""
    import torch

    faces = [tuple(n + (a == d) for a in range(3)) for d in range(3)]
    shapes = {"diffusion": [(n,) * 3], "acoustic": [(n,) * 3, *faces],
              "porous": [(n,) * 3, *faces, (n,) * 3]}[model]
    lead = () if batch is None else (batch,)
    return [torch.zeros(lead + s, dtype=dtype or torch.float64) for s in shapes]


def exchange_census(fields, *, coalesce, batched: bool = False) -> list[int]:
    """``P2POp``s per dimension of one exchange of ``fields`` on the current
    (simulated) grid."""
    from ..models import _batched
    from ..ops.halo import update_halo
    from ._sim import recording_group

    with recording_group() as (_, counts):
        (_batched.update_halo if batched else update_halo)(*fields, coalesce=coalesce)
    return counts[:3]


def budget_findings(n: int = 8, budget_pairs=None) -> list[Finding]:
    """Findings of one budget run (empty = clean).  Explicit
    ``coalesce=True`` pins the budget to the coalesced path whatever
    ``IGG_COALESCE`` says (the default production path)."""
    from ._sim import simulated_grid

    budget_pairs = BUDGET_PAIRS if budget_pairs is None else budget_pairs
    out = []
    with simulated_grid((n, n, n), (2, 2, 2), (1, 1, 1)):
        for model, pairs in budget_pairs.items():
            fields = model_fields(model, n)
            got = exchange_census(fields, coalesce=True)
            for d, ops in enumerate(got):
                if ops > OPS_PER_PAIR * pairs:
                    out.append(Finding(
                        analyzer=ANALYZER, code="budget-exceeded", severity="ERROR",
                        message=(
                            f"{model}: dimension {d} issues {ops} P2POps for {len(fields)} "
                            f"fields; the budget is {OPS_PER_PAIR * pairs} ({pairs} send/"
                            f"receive pair(s) per side).  The coalesced exchange regressed "
                            f"to per-field messages?"),
                        symbol=f"{model}/dim{d}", anchor=str(ops),
                        fix_hint="pack the fields of one word width into one buffer per side "
                                 "(ops/halo.py::_permute_fields)."))
            # The census must see the messages: per field, one pair each.
            ctrl = exchange_census(fields, coalesce=False)[0]
            if ctrl != OPS_PER_PAIR * len(fields):
                out.append(Finding(
                    analyzer=ANALYZER, code="census-broken", severity="ERROR",
                    message=(
                        f"{model}: the per-field control counted {ctrl} P2POps in dimension "
                        f"0, expected {OPS_PER_PAIR * len(fields)}: the census is broken."),
                    symbol=f"{model}/control", anchor=str(ctrl)))
            batched = exchange_census(model_fields(model, n, BATCHED_CENSUS_B), coalesce=True,
                                      batched=True)
            if batched != got:
                out.append(Finding(
                    analyzer=ANALYZER, code="batched-exceeds-unbatched", severity="ERROR",
                    message=(
                        f"{model}: the B={BATCHED_CENSUS_B} ensemble exchange issues "
                        f"{batched} P2POps per dimension, the unbatched one {got}: the "
                        f"ensemble axis went into per-member messages."),
                    symbol=f"{model}/batch{BATCHED_CENSUS_B}", anchor=str(batched)))
    return out


def run(ctx: Context) -> list[Finding]:
    return budget_findings()
