"""Halo exchange: refresh each block's halo planes from its neighbours.

Semantics (0-based indices), as in the reference's `update_halo!`:

* Per dimension, my planes ``[o-w, o)`` refresh my lower neighbour's top
  planes ``[n-w, n)``, and my planes ``[n-o, n-o+w)`` refresh my upper
  neighbour's bottom planes ``[0, w)``; ``w = 1`` is the reference's
  exchange, ``w > 1`` the deep-halo slab exchange that licenses ``w``
  stencil steps between exchanges (needs ``ol >= 2w``).
* Dimensions run in sequence (x, then y, then z): the dim-``d`` slabs are
  cut from the array the dim-``d-1`` exchange already updated, so corners
  are right.
* The overlap is shape-aware: ``ol(d, A) = overlaps[d] + (size(A,d) -
  nxyz[d])``, so staggered ``n+1`` fields exchange the right planes; a
  dimension with ``ol < 2`` has no halo and is skipped.
* A non-periodic edge (PROC_NULL neighbour) keeps its old planes.
* When a block is its own partner (periodic with one block in a dimension)
  the exchange is a local copy.

Fields are updated IN PLACE (the reference's mutating API); `update_halo`
also returns them, like the JAX package's functional call.  The transport is
`torch.distributed.batch_isend_irecv` over contiguous send/receive slabs;
received slabs are written back with ``copy_``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from ..parallel import grid as _grid
from ..parallel.topology import NDIMS, PROC_NULL


def local_shape(A, gg=None) -> tuple[int, ...]:
    """Per-block (local) shape of a field: a field IS its local block."""
    return tuple(A.shape)


def ol(dim: int, A=None, shape: Sequence[int] | None = None, gg=None) -> int:
    """Shape-aware overlap of a field in ``dim``."""
    if gg is None:
        gg = _grid.global_grid()
    if shape is None:
        shape = local_shape(A)
    size_d = shape[dim] if dim < len(shape) else 1
    return gg.overlaps[dim] + (size_d - gg.nxyz[dim])


def halosize(dim: int, A, gg=None) -> tuple[int, ...]:
    """Shape of one halo plane of ``A`` in ``dim``."""
    shp = local_shape(A)
    if len(shp) > 1:
        return tuple(s for i, s in enumerate(shp) if i != dim)
    return (1,)


def _validate_fields(fields, gg) -> None:
    """Reject fields with no halo, duplicates, and fields off the grid's
    device.  Mixed dtypes are valid (every field has its own buffers)."""
    shapes = [local_shape(A) for A in fields]
    no_halo = [
        i
        for i, shp in enumerate(shapes)
        if all(ol(d, shape=shp, gg=gg) < 2 for d in range(len(shp)))
    ]
    if len(no_halo) > 1:
        pos = ", ".join(str(i + 1) for i in no_halo[:-1]) + f" and {no_halo[-1] + 1}"
        raise ValueError(f"The fields at positions {pos} have no halo; remove them from the call.")
    elif no_halo:
        raise ValueError(
            f"The field at position {no_halo[0] + 1} has no halo; remove it from the call."
        )
    dup = [
        (i, j)
        for i in range(len(fields))
        for j in range(i + 1, len(fields))
        if fields[i] is fields[j]
    ]
    if dup:
        i, j = dup[0]
        raise ValueError(
            f"The field at position {j + 1} is a duplicate of the one at the "
            f"position {i + 1}; remove the duplicate from the call."
        )
    for i, A in enumerate(fields):
        if A.device != gg.device:
            raise ValueError(
                f"The field at position {i + 1} lives on {A.device}, but the "
                f"grid's device is {gg.device}."
            )


def dim_has_halo_activity(gg, d: int) -> bool:
    """Whether dimension ``d`` exchanges anything at all on this grid:
    periodic dimensions always have partners (possibly self); non-periodic
    ones only when a distance-``disp`` shift stays on the grid."""
    if gg.periods[d]:
        return True
    return abs(int(gg.disp)) < gg.dims[d]


def require_deep_halo(w: int, gg=None, *, what: str = "exchange_every") -> None:
    """Validate that every dimension with halo activity has ``overlap >= 2w``
    (the sent slab planes must lie at distance >= ``w`` from the block
    edge, where ``w`` stencil steps are still exact)."""
    if gg is None:
        gg = _grid.global_grid()
    shallow = [
        d
        for d in range(NDIMS)
        if dim_has_halo_activity(gg, d) and gg.overlaps[d] < 2 * w
    ]
    if shallow:
        raise ValueError(
            f"{what}={w} on a communicating grid needs a deep halo: overlap >= "
            f"{2 * w} in every dimension with halo activity, but dims {shallow} "
            f"have overlaps {[gg.overlaps[d] for d in shallow]} (grid dims="
            f"{gg.dims}, periods={gg.periods}). Re-init with overlap"
            f"{'/'.join('xyz'[d] for d in shallow)}={2 * w}, or use the "
            "per-step exchange."
        )


def _partner_self(gg, d: int) -> bool:
    """Every block its own distance-``disp`` partner along ``d``?"""
    nd = gg.dims[d]
    disp = int(gg.disp)
    return (disp % nd == 0) if bool(gg.periods[d]) else (disp == 0)


def _slab_parts(A, d: int, gg, width: int = 1):
    """The slabs a ``d``-exchange of ``A`` involves, as views of ``A``.

    Returns ``None`` when the dimension exchanges nothing for this field,
    ``("self", src_lo, src_hi)`` on the self-partner path (the values for
    planes ``[0, w)`` and ``[n-w, n)``), or ``("permute", send_lo,
    send_hi)``: the slab for my lower partner's top planes and the one for
    my upper partner's bottom planes.
    """
    shp = tuple(A.shape)
    if d >= len(shp):
        return None  # grid validation forces dims[d]==1, period 0 here
    o = ol(d, shape=shp, gg=gg)
    if o < 2:
        return None  # no halo in this dimension
    n = shp[d]
    if not dim_has_halo_activity(gg, d):
        return None
    if o < 2 * width:
        raise ValueError(
            f"update_halo(width={width}) needs overlap >= {2 * width} in "
            f"dimension {d}; this field has ol={o}. Re-init the grid with "
            f"overlap{'xyz'[d]}={2 * width} (deep halo) or use width=1."
        )
    if _partner_self(gg, d):
        return ("self", A.narrow(d, n - o, width), A.narrow(d, o - width, width))
    return ("permute", A.narrow(d, o - width, width), A.narrow(d, n - o, width))


def _permute_slabs(A, d: int, gg, width: int, send_lo, send_hi) -> None:
    """Exchange two slabs with the distance-``disp`` partners along ``d``
    and write what arrives into ``A``'s halo planes (PROC_NULL sides keep
    their old planes).

    Message order is fixed so that both NCCL (which matches point-to-point
    messages between a pair of ranks in issue order) and gloo (which matches
    by tag) pair them right when both partners are the same rank (``dims[d]
    == 2``, periodic): every rank issues its sends as (to-lower, to-upper)
    and its receives as (from-upper, from-lower); what I send to my lower
    partner is what that partner receives from ITS upper partner.
    """
    n = A.shape[d]
    lower, upper = int(gg.neighbors[0, d]), int(gg.neighbors[1, d])
    tag_to_lower, tag_to_upper = 2 * d, 2 * d + 1
    ops, recvs = [], []
    if lower != PROC_NULL:
        ops.append(dist.P2POp(dist.isend, send_lo.contiguous(), lower, tag=tag_to_lower))
    if upper != PROC_NULL:
        ops.append(dist.P2POp(dist.isend, send_hi.contiguous(), upper, tag=tag_to_upper))
    if upper != PROC_NULL:
        buf = torch.empty_like(send_lo, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, buf, upper, tag=tag_to_lower))
        recvs.append((n - width, buf))
    if lower != PROC_NULL:
        buf = torch.empty_like(send_hi, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, buf, lower, tag=tag_to_upper))
        recvs.append((0, buf))
    if not ops:
        return
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for start, buf in recvs:
        A.narrow(d, start, width).copy_(buf)


def _exchange_dim(A, d: int, gg, width: int = 1) -> None:
    p = _slab_parts(A, d, gg, width)
    if p is None:
        return
    n = A.shape[d]
    if p[0] == "self":
        # Source and target slabs are disjoint (ol >= 2w), so both copies
        # read pre-exchange values.
        _, src_lo, src_hi = p
        A.narrow(d, 0, width).copy_(src_lo)
        A.narrow(d, n - width, width).copy_(src_hi)
        return
    _, send_lo, send_hi = p
    _permute_slabs(A, d, gg, width, send_lo, send_hi)


def update_halo(*fields, width: int = 1):
    """Update the halo planes of the given field(s) in place.

    Returns the field for one argument, a tuple for several (the JAX
    package's functional signature; the tensors themselves were updated).
    ``width``: halo planes refreshed per side (default 1); ``width=w`` on a
    deep-halo grid (``overlap >= 2w``) refreshes ``w`` planes per exchange,
    licensing ``w`` stencil steps between exchanges.
    """
    _grid.check_initialized()
    gg = _grid.global_grid()
    if not fields:
        raise ValueError("update_halo requires at least one field.")
    if width < 1:
        raise ValueError(f"width must be >= 1 (got {width})")
    _validate_fields(fields, gg)
    for d in range(NDIMS):
        for A in fields:
            _exchange_dim(A, d, gg, width)
    return fields[0] if len(fields) == 1 else tuple(fields)
