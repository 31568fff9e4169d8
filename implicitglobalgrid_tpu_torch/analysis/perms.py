"""Permutation-validity analyzer (``perm-validity``), the twin of the JAX
package's traced permutation checks (``analysis/collectives.py``).

In JAX every traced ``ppermute`` carries its (source, target) pairs, and
the pass requires each to be a partial permutation.  The port traces
nothing: a rank's exchange partners come from `parallel.topology`'s
neighbour table at run time.  So this pass evaluates the exchange's real
send and receive calls (`ops.halo._issue_permute`) on EVERY simulated rank
of small periodic, non-periodic and mixed grids (``disp`` 1 and 2), on a
recording process group (`analysis._sim`), and requires per dimension and
side:

* the sends form a partial permutation: no rank is the target of two
  ranks' messages, and every target is a rank of the grid;
* every send has its receive: rank ``t`` posts a receive from ``s`` with
  the same tag exactly when ``s`` sends to ``t`` (an unmatched message
  hangs both ranks).
"""

from __future__ import annotations

from collections import Counter

from .core import Context, Finding

ANALYZER = "perm-validity"

#: (dims, periods, disp) of the simulated grids.
GRIDS = (
    ((2, 1, 1), (0, 0, 0), 1),
    ((2, 1, 1), (1, 0, 0), 1),
    ((3, 2, 1), (1, 0, 1), 1),
    ((2, 2, 2), (1, 1, 1), 1),
    ((2, 2, 2), (0, 1, 0), 1),
    ((4, 3, 1), (0, 1, 0), 1),
    ((4, 1, 2), (1, 0, 0), 2),
    ((5, 1, 1), (0, 0, 0), 2),
)


def message_census(dims, periods, disp: int = 1, table=None):
    """``{(d, tag): [(kind, rank, peer), ...]}`` of the slab exchange's
    messages on every rank of ``dims`` (``table``: the neighbour table,
    `topology.neighbors_table`'s signature)."""
    import numpy as np
    import torch

    from ..ops.halo import _issue_permute, _partner_self
    from ..parallel import topology
    from ._sim import recording_group, set_rank, simulated_grid

    table = table or topology.neighbors_table
    out: dict = {}
    n = 6 * disp
    with simulated_grid((n, n, n), dims, periods, overlaps=(2 * disp,) * 3, disp=disp), \
            recording_group() as (log, _):
        for rank in range(int(np.prod(dims))):
            gg = set_rank(rank, dims, table)
            for d in range(3):
                if dims[d] == 1 and not periods[d] or _partner_self(gg, d):
                    continue
                del log[:]
                _issue_permute(d, gg, torch.zeros(1), torch.zeros(1))
                for kind, peer, tag, *_ in log:
                    out.setdefault((d, tag), []).append((kind, rank, peer))
    return out


def perm_findings(census, name: str, nprocs: int) -> list[Finding]:
    out = []
    for (d, tag), msgs in sorted(census.items()):
        sends = [(r, p) for kind, r, p in msgs if kind == "send"]
        recvs = {(p, r) for kind, r, p in msgs if kind == "recv"}
        bad = []
        dup = sorted(t for t, c in Counter(t for _, t in sends).items() if c > 1)
        if dup:
            bad.append(f"duplicate targets {dup} (two ranks write one rank's buffer)")
        if any(not 0 <= t < nprocs for _, t in sends):
            bad.append(f"a target outside the {nprocs} ranks")
        if bad:
            out.append(Finding(
                analyzer=ANALYZER, code="malformed-permute", severity="CRITICAL",
                message=(f"{name}: the dimension-{d} hop with tag {tag} sends {sorted(sends)}: "
                         f"{'; '.join(bad)}."),
                symbol=name, anchor=f"dim{d}-tag{tag}-perm",
                fix_hint="the neighbour table must map ranks one to one per dimension and "
                         "side (parallel/topology.py::neighbors_table)."))
        unmatched = sorted(set(sends) ^ recvs)
        if unmatched:
            out.append(Finding(
                analyzer=ANALYZER, code="unmatched-message", severity="CRITICAL",
                message=(f"{name}: the dimension-{d} hop with tag {tag} has (source, target) "
                         f"pairs {unmatched[:6]} sent without a matching receive or received "
                         f"without a matching send: both ranks wait forever."),
                symbol=name, anchor=f"dim{d}-tag{tag}-match"))
    return out


def run(ctx: Context, table=None) -> list[Finding]:
    out = []
    for dims, periods, disp in GRIDS:
        name = f"exchange[dims={dims},periods={periods},disp={disp}]"
        nprocs = dims[0] * dims[1] * dims[2]
        out.extend(perm_findings(message_census(dims, periods, disp, table), name, nprocs))
    return out
