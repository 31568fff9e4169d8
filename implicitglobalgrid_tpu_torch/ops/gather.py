"""`gather` — assemble every rank's block on the root process.

The block layout of the reference's ``gather!``: the result has shape
``dims * local_shape`` with block ``(cx, cy, cz)`` at offset
``coords * local_shape`` (overlapping cells stored redundantly, halos kept).
``dedup=True`` returns the de-duplicated global grid instead, every overlap
cell taken from its owning block (`owned_range`): the ownership rule the
elastic checkpoint restore shares (`utils.checkpoint`), so the two cannot
disagree about which copy of an overlap cell wins.  The helpers are the
port's copy of the JAX package's (``ops/gather.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import grid as _grid
from ..parallel import topology
from ..utils import tracing as _tracing


def owned_range(c: int, nblocks: int, size: int, ol: int, periodic: bool) -> tuple[int, int]:
    """Local index range ``[a, b)`` of the cells block ``c`` owns in one dim.

    Adjacent blocks share ``ol`` overlap cells; the midpoint split gives the
    first ``ceil(ol/2)`` to the left block and the rest to the right one.
    Grid-edge cells of a non-periodic dim belong to the edge block whole;
    under periodicity every block has both neighbors, and the wrap seam
    follows the same midpoint rule.
    """
    if ol < 0:
        raise ValueError(
            f"owned_range: negative overlap {ol} — blocks would leave gaps; "
            f"this field does not follow the halo size convention."
        )
    a = 0 if (c == 0 and not periodic) else ol - ol // 2
    b = size if (c == nblocks - 1 and not periodic) else size - ol // 2
    return a, b


def dedup_length(nblocks: int, size: int, ol: int, periodic: bool) -> int:
    """De-duplicated global extent of one dim: ``nblocks*(size-ol)`` plus the
    boundary overlap when the dim is not periodic."""
    return nblocks * (size - ol) + (0 if periodic else ol)


def dedup_indices(c: int, lo: int, hi: int, size: int, ol: int, glen: int) -> np.ndarray:
    """Global de-dup indices of block ``c``'s local cells ``[lo, hi)`` in one
    dim: local cell ``j`` is global cell ``(c*(size-ol) + j) mod glen`` (the
    modulo realizes the periodic wrap)."""
    return (c * (size - ol) + np.arange(lo, hi)) % glen


def assemble_dedup(blocks, bshape, dims, ols, periods, dtype,
                   out: np.ndarray | None = None) -> np.ndarray:
    """Assemble the de-duplicated global array from ``{coords: block}``.

    ``blocks`` maps Cartesian block coordinates to numpy blocks of shape
    ``bshape``; ``dims``/``ols``/``periods`` are per-dim block counts,
    overlaps and periodicity flags.  Every global cell is written from its
    OWNING block only (`owned_range`).
    """
    gshape = tuple(
        dedup_length(d, s, o, bool(p)) for d, s, o, p in zip(dims, bshape, ols, periods)
    )
    if out is None:
        out = np.empty(gshape, dtype)
    for coords, block in blocks.items():
        sel, idxs = [], []
        for dim, c in enumerate(coords):
            a, b = owned_range(c, dims[dim], bshape[dim], ols[dim], bool(periods[dim]))
            sel.append(slice(a, b))
            idxs.append(dedup_indices(c, a, b, bshape[dim], ols[dim], gshape[dim]))
        out[np.ix_(*idxs)] = block[tuple(sel)]
    return out


def _field_ols(gg, bshape) -> tuple[int, ...]:
    """Per-dim overlap of a field with local shape ``bshape`` (shape-aware:
    staggered ``n+1`` fields carry overlap+1)."""
    from .halo import ol as _ol

    return tuple(_ol(d, shape=bshape, gg=gg) for d in range(len(bshape)))


def dedup_shape(A, gg=None) -> tuple[int, ...]:
    """De-duplicated global shape of field ``A`` (``nxyz_g`` adjusted for the
    field's own stagger and rank)."""
    if gg is None:
        gg = _grid.global_grid()
    bshape = tuple(A.shape)
    ols = _field_ols(gg, bshape)
    return tuple(
        dedup_length(gg.dims[d], bshape[d], ols[d], bool(gg.periods[d]))
        for d in range(len(bshape))
    )


def gather(A, A_global=None, *, root: int = 0, dedup: bool = False,
           member: int | None = None):
    """Gather field ``A`` to the host on process ``root``.

    Returns the assembled numpy array on the root and ``None`` elsewhere.
    With ``A_global`` (a numpy array of ``nprocs * A.numel()`` elements and
    ``A``'s dtype) the root fills it in place and returns ``None``.
    ``dedup=True`` returns the DE-DUPLICATED global grid (shape
    `dedup_shape(A)`, the ``nxyz_g`` view) instead of the blocks side by
    side: every overlap cell comes from its owning block (`owned_range`);
    ``A_global`` then holds `dedup_shape(A)` elements.
    ``member=k`` gathers ONE member of a batched (ensemble) field ``(B,
    *block)`` (`models._batched`): member ``k`` is sliced on the device
    first, then the ordinary path runs on it.  A batched field without
    ``member`` is rejected: its leading axis would be misread as grid
    dimension x.  Collective: every process must call it.
    """
    with _tracing.trace_span("igg.gather", root=root, dedup=dedup):
        return _gather(A, A_global, root=root, dedup=dedup, member=member)


def _gather(A, A_global, *, root: int, dedup: bool, member: int | None):
    gg = _grid.global_grid()
    if member is not None:
        if A.dim() <= topology.NDIMS:
            raise ValueError(
                f"gather(member={member}) needs a batched field (leading ensemble axis "
                f"over grid-rank blocks, i.e. rank > {topology.NDIMS}); got rank {A.dim()} "
                "— an unbatched grid field: drop member=."
            )
        nb = A.shape[0]
        if not (0 <= int(member) < nb):
            raise ValueError(
                f"member must be in [0, {nb}) for this batched field; got {member}."
            )
        A = A[int(member)]
    elif A.dim() > topology.NDIMS:
        raise ValueError(
            f"gather got a rank-{A.dim()} field but the grid has {topology.NDIMS} "
            "dimensions; for a batched ensemble field pass member=k to gather one member "
            "(the leading axis is the ensemble, not grid dimension x)."
        )
    if not (0 <= root < gg.nprocs):
        raise ValueError(
            f"root must be a valid process index in [0, {gg.nprocs}); got {root}."
        )
    bshape = tuple(A.shape)
    nd = len(bshape)
    if gg.nprocs == 1:
        blocks = [A.detach()]
    else:
        A = A.detach().contiguous()
        blocks = [torch.empty_like(A) for _ in range(gg.nprocs)] if gg.me == root else None
        dist.gather(A, blocks, dst=root)
    if gg.me != root:
        return None
    host = [blk.cpu().numpy() for blk in blocks]
    if dedup:
        byc = {}
        for r, blk in enumerate(host):
            byc.setdefault(topology.coords_of_rank(r, gg.dims)[:nd], blk)
        out = assemble_dedup(byc, bshape, gg.dims[:nd], _field_ols(gg, bshape),
                             gg.periods[:nd], host[0].dtype)
    else:
        out = np.empty(tuple(gg.dims[d] * bshape[d] for d in range(nd)), dtype=host[0].dtype)
        for r, blk in enumerate(host):
            c = topology.coords_of_rank(r, gg.dims)
            out[tuple(slice(c[d] * bshape[d], (c[d] + 1) * bshape[d]) for d in range(nd))] = blk
    if A_global is not None:
        if A_global.size != out.size:
            raise ValueError(
                "The input argument A_global must be of length nprocs*length(A)"
            )
        if A_global.dtype != out.dtype:
            raise ValueError(
                f"A_global has dtype {A_global.dtype} but A has dtype {out.dtype}; "
                "they must match."
            )
        np.copyto(A_global.reshape(out.shape), out)
        return None
    return out
