"""`gather` — assemble every rank's block on the root process.

The block layout of the reference's ``gather!``: the result has shape
``dims * local_shape`` with block ``(cx, cy, cz)`` at offset
``coords * local_shape`` (overlapping cells stored redundantly, halos kept).
``dedup=True`` returns the de-duplicated global grid instead, every overlap
cell taken from its owning block (`owned_range`): the ownership rule the
elastic checkpoint restore shares (`utils.checkpoint`), so the two cannot
disagree about which copy of an overlap cell wins.  The helpers are the
port's copy of the JAX package's (``ops/gather.py``).

Paths (`last_gather_stats` names the one a call took):

* one process: the block is the global array, copied to the host;
* several processes: the chunked plan (`collective_plan`).  The blocks
  travel to the root a chunk of at most ``IGG_GATHER_BATCH`` (default 8)
  at a time, point to point, and the root copies each chunk into the host
  output and frees its device buffers before the next one.  So the root
  holds the host output plus one chunk of blocks on the device, and
  every other rank moves nothing to the host: the reference's root-only
  memory bound (its ``gather!`` sends block by block).  A one-shot
  gather of every block would hold ``nprocs`` blocks on the root's card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import grid as _grid
from ..parallel import topology
from ..utils import tracing as _tracing
from .halo import _flat_words, _from_words

#: Point-to-point tag of the chunked gather's messages, clear of the halo
#: exchange's forward and adjoint tags (``0 .. 4 * NDIMS - 1``).
GATHER_TAG = 4 * topology.NDIMS

#: The last call's view: ``path`` (``"local"`` or ``"chunked"``),
#: ``host_bytes`` (bytes this process copied to the host), ``fetches``
#: (chunks), and on the chunked path ``blocks``, ``batch`` and
#: ``block_bytes``.  Reset to None at the START of every call, so a failed
#: gather never leaves the previous call's stats as its own.  The same
#: numbers fold into the telemetry registry's ``gather.*`` family.
last_gather_stats: dict | None = None


def _record_stats(stats: dict) -> None:
    """Publish one gather's stats: `last_gather_stats` and the registry."""
    global last_gather_stats
    last_gather_stats = stats
    from ..utils import telemetry as _telemetry

    if not _telemetry.enabled():
        return
    _telemetry.counter("gather.calls").inc()
    _telemetry.counter(f"gather.calls.{stats['path']}").inc()
    _telemetry.counter("gather.fetches").inc(stats.get("fetches", 0))
    _telemetry.counter("gather.host_bytes").inc(stats.get("host_bytes", 0))
    _telemetry.histogram("gather.call_host_bytes").record(stats.get("host_bytes", 0))


def _gather_batch_size() -> int:
    """Blocks per chunk of the chunked gather: ``IGG_GATHER_BATCH``, clamped
    to at least 1, default 8.  A chunk is one round of point-to-point
    messages and one host copy on the root; the root's device transient
    grows to ``batch`` blocks, the other ranks' stays at zero."""
    from ..utils.config import gather_batch_env

    val = gather_batch_env()
    return max(int(val), 1) if val is not None else 8


def collective_plan(dims, batch, *, is_root: bool = False):
    """Ordered chunk schedule of one chunked gather.

    Returns ``[("block_fetch", (sel, ...)), ...]``: one record per chunk,
    each carrying the row-major block indices over ``dims`` it moves to the
    root.  `_gather_chunked` walks exactly this list on every rank, and the
    ``collective-consistency`` analyzer evaluates it for every simulated
    rank and requires equality (`analysis.collectives.gather_plan_censuses`).

    ``is_root`` is accepted and ignored on purpose: the parameter exists so
    the analyzer can prove the schedule does not depend on it (root-ness may
    only change what a rank does with a chunk, never which chunks there
    are).  Do not branch on it here.
    """
    del is_root  # the invariant: the plan is rank-independent
    idxs = list(np.ndindex(*tuple(dims))) or [()]
    b = min(max(int(batch), 1), len(idxs))
    plan = []
    for start in range(0, len(idxs), b):
        chunk = idxs[start:start + b]
        plan.append(("block_fetch", tuple(
            int(np.ravel_multi_index(idx, dims)) if idx else 0 for idx in chunk)))
    return plan


def _chunk_messages(words, ranks, me: int, root: int):
    """The point-to-point ops of one chunk on rank ``me``: the root receives
    every other rank's block of the chunk (``ranks``), each of those ranks
    sends its own; the root's own block moves by no message.  Returns
    ``(ops, buffers)``: ``buffers[j]`` is the device buffer of ``ranks[j]``'s
    block on the root."""
    ops, bufs = [], {}
    for j, r in enumerate(ranks):
        if r == root:
            continue
        if me == root:
            bufs[j] = torch.empty_like(words)
            ops.append(dist.P2POp(dist.irecv, bufs[j], r, tag=GATHER_TAG))
        elif me == r:
            ops.append(dist.P2POp(dist.isend, words, root, tag=GATHER_TAG))
    return ops, bufs


def _complete(ops) -> None:
    """Issue one chunk's messages and wait for all of them."""
    for req in (dist.batch_isend_irecv(ops) if ops else []):
        req.wait()


def _gather_chunked(A, gg, out: np.ndarray | None, *, root: int, dedup: bool = False):
    """Chunk-by-chunk assembly on the root (`collective_plan`).

    Collective: every rank walks the same chunks, and waits for its
    messages of one chunk before it starts the next, so at most one chunk
    is in flight.  The source of block index ``idx`` over the field's own
    ``dims`` is the rank at coords ``idx`` padded with zeros (a field of
    lower rank than the grid is the same on every rank of the remaining
    dimensions).  The root (``out`` not None) copies each chunk's blocks
    into ``out`` and drops their device buffers before the next chunk; a
    root with ``out`` None (an argument error, raised by the caller after
    this returns) takes part in every chunk and assembles nothing.
    """
    nd = A.dim()
    bshape = tuple(A.shape)
    dims = tuple(gg.dims[:nd])
    A = A.detach()
    words = _flat_words(A)
    plan = collective_plan(dims, _gather_batch_size(), is_root=gg.me == root)
    host_bytes = 0
    for _op, sels in plan:
        idxs = [tuple(int(c) for c in np.unravel_index(s, dims)) if nd else () for s in sels]
        ranks = [topology.rank_of_coords(idx + (0,) * (topology.NDIMS - nd), gg.dims)
                 for idx in idxs]
        ops, bufs = _chunk_messages(words, ranks, gg.me, root)
        _complete(ops)
        if out is not None:
            blocks = {idx: (_from_words(bufs[j], bshape, A.dtype) if j in bufs else A)
                      .cpu().numpy() for j, idx in enumerate(idxs)}
            if dedup:
                assemble_dedup(blocks, bshape, dims, _field_ols(gg, bshape),
                               gg.periods[:nd], out.dtype, out=out)
            else:
                for idx, blk in blocks.items():
                    out[tuple(slice(c * b, (c + 1) * b) for c, b in zip(idx, bshape))] = blk
            host_bytes += sum(blk.nbytes for blk in blocks.values())
            del blocks
        del ops, bufs  # the chunk's buffers go before the next chunk's come
    _record_stats({
        "path": "chunked", "host_bytes": host_bytes, "fetches": len(plan),
        "blocks": sum(len(sels) for _, sels in plan), "batch": len(plan[0][1]),
        "block_bytes": A.numel() * A.element_size(),
    })
    return out


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
           member: int | None = None, _force_chunked: bool = False):
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
    dimension x.

    Collective: every process must call it (non-roots pass ``A_global=None``).
    With several processes the blocks reach the root a chunk at a time
    (`collective_plan`, ``IGG_GATHER_BATCH``); a root-side ``A_global``
    error is raised only after the root took part in every chunk, so that
    no other rank is left waiting in a send.  ``_force_chunked`` takes the
    chunked path on one process too (a test hook).
    """
    with _tracing.trace_span("igg.gather", root=root, dedup=dedup):
        return _gather(A, A_global, root=root, dedup=dedup, member=member,
                       force_chunked=_force_chunked)


def _check_out(A_global, size: int, dtype) -> None:
    if A_global.size != size:
        raise ValueError(
            "The input argument A_global must be of length nprocs*length(A)"
        )
    if A_global.dtype != dtype:
        raise ValueError(
            f"A_global has dtype {A_global.dtype} but A has dtype {dtype}; "
            "they must match."
        )


def _gather(A, A_global, *, root: int, dedup: bool, member: int | None, force_chunked: bool):
    global last_gather_stats
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
        from ..utils import telemetry as _telemetry

        if _telemetry.enabled():
            _telemetry.counter("gather.member_calls").inc()
    elif A.dim() > topology.NDIMS:
        raise ValueError(
            f"gather got a rank-{A.dim()} field but the grid has {topology.NDIMS} "
            "dimensions; for a batched ensemble field pass member=k to gather one member "
            "(the leading axis is the ensemble, not grid dimension x)."
        )
    last_gather_stats = None
    if not (0 <= root < gg.nprocs):
        raise ValueError(
            f"root must be a valid process index in [0, {gg.nprocs}); got {root}."
        )
    bshape = tuple(A.shape)
    nd = len(bshape)
    dtype = np.dtype(str(A.dtype).removeprefix("torch."))
    if gg.nprocs > 1 or force_chunked:
        if dedup:
            gshape = dedup_shape(A, gg)
        else:
            gshape = tuple(gg.dims[d] * bshape[d] for d in range(nd))
        err = out = None
        if gg.me == root:
            if A_global is None:
                out = np.empty(gshape, dtype)
            else:
                try:
                    _check_out(A_global, int(np.prod(gshape)), dtype)
                except ValueError as e:
                    err = e
                else:
                    out = A_global.reshape(gshape)
        out = _gather_chunked(A, gg, out, root=root, dedup=dedup)
        if err is not None:
            raise err
        return out if gg.me == root and A_global is None else None
    data = A.detach().cpu().numpy()
    _record_stats({"path": "local", "host_bytes": data.nbytes, "fetches": 0,
                   "block_bytes": data.nbytes})
    if dedup:
        data = assemble_dedup({(0,) * nd: data}, bshape, gg.dims[:nd], _field_ols(gg, bshape),
                              gg.periods[:nd], data.dtype)
    if A_global is not None:
        _check_out(A_global, data.size, data.dtype)
        np.copyto(A_global.reshape(data.shape), data)
        return None
    return data
