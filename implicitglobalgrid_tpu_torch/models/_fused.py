"""The fused cadences' group schedules (diffusion, acoustic, porous).

Counterpart of the JAX package's ``models/_fused.py``.  A fused cadence runs
its steps in groups: one kernel launch of ``k`` steps, then one width-``w``
slab exchange.  `run_group_schedule` is that loop.  The pipelined group
schedule splits each launch into a ring pass over the tiles that own the
x/y slab exchange's send planes and a mid pass over the rest
(`ops.overlap`), and starts the exchange as soon as the ring pass is done,
while the mid pass still runs.  Its auto mode takes it only where an x/y
exchange crosses to another block: on one GPU every partner is the block
itself, there is no transfer to hide, and the split only costs time.

On the card the ring pass alone lasts about as long as a whole launch: every
block of a 256^3 launch fits in one or two waves, and a block marches its
whole x segment whichever pass it belongs to.  So the two passes run
concurrently, on two streams that both wait only for the group's input; the
exchange starts from the ring pass's completion on the communication stream
(`ops.halo.begin_slab_exchange`), and the compute stream joins both before
the received planes land and the next group starts.

One difference from the JAX package is by design: z.  JAX overlaps z
through its kernels' in-kernel z patch, which the Hopper kernels do not have
(the port exchanges z like x and y).  On a z-active grid the port therefore
splits x/y as JAX does and runs the z exchange of the combined output after
the x/y exchange finished, exactly the serialized order; JAX's "z-active grid
without the z-patch kernel" rejection does not apply.

Both schedules run an ensemble (``batch=True``: `models._batched`) as they
run one block: one launch per pass for all B members, one exchange per
dimension carrying all B.  The plan (split or not, tile) is taken from the
member's block and the grid, never from B.

Autodiff: the kernels are forward-only, as in JAX.  Under autograd each
group runs through `fused_with_plain_grad`: the forward is the group as it
runs without autograd (kernel launches, streams, early exchange), the
backward that of the model's own plain group (``ki`` plain updates, then
the differentiable exchange) recomputed from the group's inputs.  Per
group, not per cadence as in JAX, so the backward holds one group's
intermediates at a time.
"""

from __future__ import annotations

import warnings

import torch

from ..ops.halo import (
    _partner_self,
    begin_slab_exchange,
    dim_has_halo_activity,
    exchange as halo_exchange,
    exchange_dims,
    finish_slab_exchange,
    needs_grad,
    update_halo,
)
from ..ops.overlap import fused_with_plain_grad, tile_split_error, tile_split_sel
from ..parallel.grid import global_grid
from ..utils import profiling as _profiling
from . import _batched

_warned: set = set()

#: x segments of the pipelined split's default tile on a grid that
#: exchanges in x: 3 is the least the split admits, and 4 fills the card's
#: resident block slots in whole waves at 256^3 (2 blocks per SM for the
#: diffusion kernel, 1 for the staggered ones).
PIPELINED_X_SEGMENTS = 4


def run_group_schedule(chunks, body, carry):
    """Run ``carry = body(ki, carry)`` for each ``ki`` in ``chunks``.

    Every group runs eagerly in a Python loop: JAX's loop shaping
    (``unroll_limit``, ``fori_excess_only``) has nothing to act on here.
    """
    for ki in chunks:
        carry = body(ki, carry)
    return carry


#: The mid pass's stream per CUDA device.
_mid_streams: dict = {}


def _mid_stream(device):
    if device not in _mid_streams:
        _mid_streams[device] = torch.cuda.Stream(device)
    return _mid_streams[device]


def run_pipelined_group_schedule(chunks, boundary, interior, carry, *, width: int,
                                 z_exchange: bool = False, lead: int = 0, coalesce=None,
                                 wrap=None):
    """Boundary-first pipelined sibling of `run_group_schedule`.

    ``carry`` is a tuple of fields; per group ``ki`` of ``chunks``:

    * ``boundary(ki, carry) -> b_out`` runs the ring pass (``tile_sel=
      "ring*"``) on the compute stream;
    * ``interior(ki, carry, b_out) -> out`` runs the mid pass (``"mid*"``,
      ``carry_in=b_out``) on a second stream that waits only for the group's
      input;
    * the x/y slab exchange of width ``width`` starts from ``b_out`` on the
      communication stream once the ring pass is done
      (`ops.halo.begin_slab_exchange`: it reads only the ring-owned send
      planes), then the compute stream waits for the mid pass and the
      exchange, the received planes land (`ops.halo.finish_slab_exchange`)
      and, with ``z_exchange``, the z exchange of the combined output runs.

    Ring and mid write disjoint owned regions of the same tensors and
    together equal one ``"all"`` launch tile for tile, and the early
    exchange moves exactly the slabs the serialized exchange would (corner
    strips patched in), so every group is bit-identical to the serialized
    schedule.  On CPU tensors the steps run in order.  The passes open the
    profiler ranges ``igg_ring_pass`` and ``igg_interior_pass`` while a
    capture is live (`utils.profiling.scope`).  ``lead``: the
    fields' leading ensemble axes (1 for a batch); ``coalesce`` as in
    `ops.halo.update_halo`; ``wrap(group) -> group``: what each group runs
    through (the autodiff wrapper of `fused_groups`).
    """
    def group(ki, c):
        split = c[0].is_cuda
        if split:
            main = torch.cuda.current_stream(c[0].device)
            mid = _mid_stream(c[0].device)
            # The group's input is ready.  The ring pass allocates its
            # outputs right after this, with nothing enqueued in between, so
            # the mid pass may write into them too.
            mid.wait_stream(main)
        with _profiling.scope("igg_ring_pass"):
            b_out = boundary(ki, c)
        if split:
            for t in (*c, *b_out):
                t.record_stream(mid)
            with torch.cuda.stream(mid), _profiling.scope("igg_interior_pass"):
                out = interior(ki, c, b_out)
            # The compute stream holds only the ring pass since the fork.
            pend = begin_slab_exchange(b_out, (0, 1), width=width, lead=lead, coalesce=coalesce)
            main.wait_stream(mid)
        else:
            pend = begin_slab_exchange(b_out, (0, 1), width=width, lead=lead, coalesce=coalesce)
            with _profiling.scope("igg_interior_pass"):
                out = interior(ki, c, b_out)
        out = finish_slab_exchange(out, pend)
        if z_exchange:
            for A in out:
                exchange_dims(A, (2,), width=width, lead=lead)
        return out

    return run_group_schedule(chunks, wrap(group) if wrap else group, tuple(carry))


def group_plan(kernel_mod, model: str, shape, dtype, device, *, k: int, width: int, pipelined,
               fused_tile, stagger: int, gg):
    """``(pipelined?, selector suffix, tile)`` of a fused cadence's groups.

    The split is gated at ``k`` (`split_selector`) and resolved against
    ``pipelined`` (`resolve_pipelined`); its tile is pinned for every
    chunk, as is a given ``fused_tile``.  Without one the serialized
    launches take the kernel's own default tile (None).
    """
    if pipelined is False and fused_tile is None:
        return False, None, None
    active01 = tuple(d for d in (0, 1) if dim_has_halo_activity(gg, d))
    bx, by = fused_tile if fused_tile is not None else (None, None)
    sel, err, tile = split_selector(kernel_mod, shape, k, width, dtype, bx, by, active01, stagger,
                                    gg, device)
    split = any(dim_has_halo_activity(gg, d) for d in range(3)) and resolve_pipelined(
        pipelined, err, tuple(shape), k, model,
        remote=any(not _partner_self(gg, d) for d in active01),
    )
    return split, sel, tile if split or fused_tile is not None else None


def fused_groups(kernel_mod, model: str, chunks, *, k: int, width: int, pipelined, fused_tile,
                 stagger: int, gg, batch: bool = False, coalesce=None):
    """A fused cadence's group sequence, serialized or pipelined: the one
    dispatch of the three models.

    Returns ``run(kernel, plain, carry, aux=()) -> carry``.  ``carry``: a
    tuple of fields, the first cell-shaped (batched ``(B, *block)`` with
    ``batch``); ``aux``: read-only fields the groups also take (diffusion's
    Cp, porous T).  ``kernel(ki, carry, aux, tile, **subset) -> carry``
    launches one group of ``ki`` steps (``subset``: ``tile_sel`` and
    ``carry_in``); every group is followed by a width-``width`` exchange of
    all fields (``coalesce`` as in `ops.halo.update_halo`).  ``plain(ki,
    carry, aux) -> carry`` runs the same ``ki`` steps with the model's plain
    updates: under autograd (`ops.halo.needs_grad`) each group runs through
    `fused_with_plain_grad`, its backward that of ``plain`` followed by the
    differentiable exchange, ``carry`` and ``aux`` its explicit inputs.  The schedule and its tile (`group_plan`) are
    resolved once per block shape, dtype and device, at the first call that
    brings them.
    """
    active = any(dim_has_halo_activity(gg, d) for d in range(3))
    z_exchange = dim_has_halo_activity(gg, 2)
    lead = int(batch)
    exchange = _batched.update_halo if batch else update_halo
    plans: dict = {}

    def run(kernel, plain, carry, aux=()):
        c0 = carry[0]
        key = (tuple(c0.shape[lead:]), c0.dtype, c0.device)
        if key not in plans:
            plans[key] = group_plan(kernel_mod, model, *key, k=k, width=width,
                                    pipelined=pipelined, fused_tile=fused_tile, stagger=stagger,
                                    gg=gg)
        split, sel, tile = plans[key]
        n = len(carry)

        def plain_group(ki, *a):
            c = plain(ki, a[:n], a[n:])
            return halo_exchange(c, width=width, lead=lead, coalesce=coalesce) if active else c

        def wrap(group):
            def differentiable(ki, c):
                if not needs_grad((*c, *aux)):
                    return group(ki, c)
                return fused_with_plain_grad(lambda *a: group(ki, a[:n]),
                                             lambda *a: plain_group(ki, *a))(*c, *aux)

            return differentiable

        if split:
            return run_pipelined_group_schedule(
                chunks,
                lambda ki, c: kernel(ki, c, aux, tile, tile_sel="ring" + sel),
                lambda ki, c, b_out: kernel(ki, c, aux, tile, tile_sel="mid" + sel,
                                            carry_in=b_out),
                carry, width=width, z_exchange=z_exchange, lead=lead, coalesce=coalesce,
                wrap=wrap,
            )

        def group(ki, c):
            c = kernel(ki, c, aux, tile)
            # One slab exchange licenses the next k steps: the kernel's k-deep
            # stale rind is exactly what the width-k exchange refreshes, from
            # planes k steps still kept exact.
            if active:
                exchange(*c, width=width, coalesce=coalesce)
            return c

        return run_group_schedule(chunks, wrap(group), tuple(carry))

    return run


def resolve_pipelined(pipelined, split_err, shape, k, model: str, *, remote: bool) -> bool:
    """Resolve a cadence's ``pipelined`` knob against split admissibility.

    ``pipelined`` is the user knob (None = auto); ``split_err`` is
    `ops.overlap.tile_split_error`'s verdict (None = admissible);
    ``remote``: some x/y dimension that exchanges has a partner other than
    the block itself.  Auto turns the pipelined schedule on where the split
    is admissible and there is a transfer to hide: where every x/y partner
    is the block itself (one GPU) the exchange is a local copy and the split
    only adds launches and stream hops.  ``pipelined=True`` forces an
    admissible split either way; on an inadmissible config it warns once
    and runs the serialized schedule: the same kernel, bit-identical, so no
    fallback from the kernel.
    """
    if pipelined is False:
        return False
    if split_err is not None:
        if pipelined:
            warn_pipelined_fallback(shape, k, split_err, model)
        return False
    return bool(pipelined) or remote


def split_selector(kernel_mod, shape, k, width, dtype, bx, by, active01, stagger: int = 0,
                   gg=None, device=None):
    """(selector suffix, admissibility error, resolved tile) for a cadence.

    The one gate behind every model's pipelined path.  A config the
    kernel's envelope rejects is not admissible (no tile; the kernel call
    raises on it).  A missing tile
    resolves through the kernel's ladder: ``(by, bz)`` from ``tile_for``
    and ``bx`` from the kernel's default launch on ``device`` (None: the
    grid's device), cut to
    `PIPELINED_X_SEGMENTS` segments where x exchanges; a given ``(bx,
    by)`` takes its ``bz`` from the ladder.  The window halo ``H`` is ``k``
    (the port's kernels widen every window by ``k``; JAX's TPU sublane
    rounding does not apply), and ``stagger=1`` adds the staggered fields'
    one deeper shape-aware overlap.  The resolved ``(bx, by, bz)`` is
    returned so a ragged schedule pins every chunk's launches to the tile
    this gate validated (it stays legal for any ``ki <= k``).  JAX's
    ``zpatch`` argument has no counterpart: the port has no z patch.
    """
    if gg is None:
        gg = global_grid()
    if device is None:
        device = gg.device
    shape = tuple(shape)
    sel = tile_split_sel(active01)
    if (bx is None) != (by is None):
        raise ValueError(f"fused_tile={(bx, by)}: pass both bx and by, or neither")
    kerr = kernel_mod.fused_support_error(shape, k, dtype)
    if kerr is not None:
        return sel, f"kernel envelope rejects this config ({kerr})", None
    itemsize = torch.empty((), dtype=dtype).element_size()
    if bx is None:
        dbx, by, bz = kernel_mod.default_tile(shape, k, itemsize, device)
        bx = min(dbx, -(-shape[0] // PIPELINED_X_SEGMENTS)) if 0 in active01 else dbx
    else:
        bz = kernel_mod.tile_for(shape, k, itemsize, by=by)[2]
    err = tile_split_error(shape, k, width, bx, by, k, active01,
                           ox=gg.overlaps[0] + stagger, oy=gg.overlaps[1] + stagger)
    return sel, err, (bx, by, bz)


def pipelined_support_error(kernel_mod, shape, k, dtype=torch.float32, bx=None, by=None,
                            gg=None, stagger: int = 0, device=None) -> str | None:
    """Why the pipelined group schedule cannot split this config, or None.

    What ``pipelined=True`` needs in every model: the kernel must take the
    config (its envelope), then the split must clear `split_selector`.
    Auto also needs a partner other than the block itself in some x/y
    dimension (`resolve_pipelined`).  No z clause: see the module
    docstring.  The tiles are planned for ``device``, by default the
    grid's.
    """
    if gg is None:
        gg = global_grid()
    active = tuple(d for d in (0, 1) if dim_has_halo_activity(gg, d))
    return split_selector(kernel_mod, shape, k, k, dtype, bx, by, active, stagger, gg,
                          device)[1]


def warn_pipelined_fallback(shape, k, reason, model: str = "diffusion") -> None:
    """Warn once per (model, shape, k, reason) that pipelined=True runs the
    serialized group schedule."""
    key = ("pipelined", model, shape, k, reason)
    if key in _warned:
        return
    _warned.add(key)
    where = (
        f"{model}'s local block shape {shape}" if shape is not None
        else f"the {model} cadence"  # grid-level rejection, no shape to cite
    )
    warnings.warn(
        f"pipelined=True is not admissible for {where} at k={k} ({reason}); "
        "running the serialized group schedule.",
        RuntimeWarning,
        stacklevel=3,
    )
