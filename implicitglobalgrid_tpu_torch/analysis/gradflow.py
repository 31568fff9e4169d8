"""Grad-soundness analyzer (``grad-soundness``), the twin of the JAX
package's ``analysis/gradflow.py``.

The hazard is a cut autograd graph that crashes nothing: a gradient that is
silently zero.  In the port it takes two shapes.  A ``.detach()`` or an
integer cast on the tangent path disconnects an input from the loss; and an
exchange whose received planes enter autograd as constants drops every
cotangent that should travel back across a block boundary (the fault PR 7
fixed with `ops.halo._Exchange`; the kernels are forward-only and run under
`ops.overlap.fused_with_plain_grad`).  For each differentiable entry, each
model's coalesced exchange and each model's fused cadence, run as rank 0
of a simulated two-rank grid periodic in x (`analysis._sim`), on a
recording process group, this pass:

1. walks the loss's ``grad_fn`` graph and requires every input that
   requires grad to be reached (``detached-input``);
2. counts the ``P2POp``s the backward issues with the adjoint's tags and
   requires more than none: the primal sends planes to the other rank, so
   their cotangents must come back (``cotangent-sink``; the JAX census's
   "the VJP issues more collectives than its primal").
"""

from __future__ import annotations

from .core import Context, Finding

ANALYZER = "grad-soundness"


def _reaches(node, leaf) -> bool:
    # ``seen`` holds every visited node: a node's Python wrapper lives only
    # while referenced, so a freed wrapper's id could be reused by another
    # node, and the node would get a second wrapper on its next visit.
    seen, stack = {}, [node]
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen[id(fn)] = fn
        if getattr(fn, "variable", None) is leaf:
            return True
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return False


def entry_census(fn, inputs):
    """``(primal P2POps, adjoint P2POps, unreachable input indices)`` of
    ``fn`` on leaf copies of ``inputs`` (the current grid), loss = the sum
    of the squared outputs."""
    import torch

    from ._sim import recording_group

    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    with recording_group() as (_, counts):
        outs = fn(*leaves)
        primal = sum(counts[:3])
        loss = sum((o * o).sum() for o in outs)
        unreachable = [i for i, x in enumerate(leaves)
                       if loss.grad_fn is None or not _reaches(loss.grad_fn, x)]
        if loss.requires_grad:
            torch.autograd.backward(loss)
        adjoint = sum(counts[3:])
    return primal, adjoint, unreachable


def grad_entries():
    """``(name, grid kwargs, build)``: ``build()`` on the simulated grid
    returns ``(fn, inputs)`` of one differentiable entry."""
    import torch

    from ..models import acoustic3d, diffusion3d, porous_convection3d
    from ..ops.halo import update_halo
    from .budget import model_fields

    def exchange(model):
        def build():
            return (lambda *f: update_halo(*[a.clone() for a in f], coalesce=True),
                    [a.normal_() for a in model_fields(model, 8)])
        return build

    def cadence(module, **kw):
        def build():
            state, params = module.setup(16, 16, 16, init_grid=False, dtype=torch.float64, **kw)
            return module.make_multi_step(params, 2, fused_k=2), list(state)
        return build

    small = dict(nxyz=(8, 8, 8), overlaps=(2, 2, 2))
    deep = dict(nxyz=(16, 16, 16), overlaps=(4, 4, 4))
    for model in ("diffusion", "acoustic", "porous"):
        yield f"exchange/{model}[coalesce=True]", small, exchange(model)
    yield "cadence/diffusion[fused_k=2]", deep, cadence(diffusion3d)
    yield "cadence/acoustic[fused_k=2]", deep, cadence(acoustic3d)
    yield "cadence/porous[fused_k=2,npt=4]", deep, cadence(porous_convection3d, npt=4)


def grad_findings(entries=None) -> list[Finding]:
    from ._sim import simulated_grid

    out = []
    for name, grid, build in entries or grad_entries():
        with simulated_grid(grid["nxyz"], (2, 1, 1), (1, 0, 0), overlaps=grid["overlaps"]):
            fn, inputs = build()
            primal, adjoint, unreachable = entry_census(fn, inputs)
        for i in unreachable:
            out.append(Finding(
                analyzer=ANALYZER, code="detached-input", severity="CRITICAL",
                message=(f"{name}: input {i} is not on the loss's grad_fn graph: a detach or "
                         f"an integer cast cuts it, and its gradient is silently zero."),
                symbol=name, anchor=f"input{i}",
                fix_hint="keep the input's path differentiable, or route a forward-only "
                         "kernel through ops/overlap.py::fused_with_plain_grad."))
        if primal == 0:
            out.append(Finding(
                analyzer=ANALYZER, code="census-broken", severity="ERROR",
                message=f"{name}: the primal issued no P2POp; the census sees nothing.",
                symbol=name, anchor="primal0"))
        elif adjoint == 0:
            out.append(Finding(
                analyzer=ANALYZER, code="cotangent-sink", severity="CRITICAL",
                message=(f"{name}: the primal issues {primal} P2POps and the backward no "
                         f"adjoint message: the received planes' cotangents never travel "
                         f"back, and every gradient across a block boundary is silently "
                         f"zero."),
                symbol=name, anchor=f"{adjoint}<={primal}",
                fix_hint="exchange under autograd through ops/halo.py::_Exchange, whose "
                         "backward sends the cotangents back (ADJOINT_TAG)."))
    return out


def run(ctx: Context) -> list[Finding]:
    return grad_findings()
