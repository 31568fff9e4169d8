"""Simulated ranks and a recording process group for the host passes.

The censuses of ``collective-budget``, ``grad-soundness`` and
``perm-validity`` run the port's real exchange code in this one process, as
one rank of a larger grid: `simulated_grid` brings up a one-process grid on
the CPU and then replaces its topology record with the one a rank of
``dims`` would hold (coordinates, neighbour table, global size), and
`recording_group` stands in for the transport: every `P2POp` that
`torch.distributed.batch_isend_irecv` would issue is recorded instead of
sent, and its receive buffer is filled with zeros.  Whatever grid the
caller had is restored on exit.  This module imports torch and the port only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch.distributed as dist

from ..parallel import grid as _grid
from ..parallel import topology


@contextlib.contextmanager
def simulated_grid(nxyz, dims, periods=(0, 0, 0), *, overlaps=None, disp: int = 1):
    """The grid of rank 0 of ``dims``, on the CPU, for the block ``nxyz``
    (``overlaps`` default 2); yields its `GlobalGrid` (`set_rank` moves it
    to another rank)."""
    saved = _grid._global_grid
    _grid.set_global_grid(None)
    try:
        ov = overlaps or (2, 2, 2)
        _grid.init_global_grid(*nxyz, periodx=periods[0], periody=periods[1],
                               periodz=periods[2], overlapx=ov[0], overlapy=ov[1],
                               overlapz=ov[2], disp=disp, quiet=True, device="cpu")
        yield set_rank(0, dims)
    finally:
        _grid.set_global_grid(saved)


def set_rank(me: int, dims, table=topology.neighbors_table):
    """Make the current grid rank ``me`` of ``dims`` (its neighbours from
    ``table``, `topology.neighbors_table`'s signature) and return it."""
    gg = _grid.global_grid()
    dims = tuple(int(d) for d in dims)
    coords = topology.coords_of_rank(me, dims)
    gg = gg.replace(
        dims=dims, nprocs=int(np.prod(dims)), me=int(me), coords=coords,
        neighbors=table(coords, dims, gg.periods, gg.disp),
        nxyz_g=topology.implied_global_shape(gg.nxyz, dims, gg.overlaps, gg.periods))
    _grid.set_global_grid(gg)
    return gg


@contextlib.contextmanager
def recording_group():
    """Record instead of send: yields ``(log, counts)``, both kept by the
    port's ``P2POp`` hook (`_workers._count_p2p`): ``log`` lists the
    ``(kind, peer, tag, nbytes, call)`` of every `P2POp` issued, ``counts``
    the exchange's messages per grid dimension x, y, z, then its
    adjoint's.  Receive buffers are zero-filled, and the ops
    complete at once.  A `P2POp` needs a default process group: without
    one, a one-rank gloo group over an in-memory store stands in (nothing
    is ever sent on it) and is destroyed on exit."""
    from .. import _workers

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)

    log, counts = [], [0] * (2 * topology.NDIMS)
    issue = dist.batch_isend_irecv

    def record(ops):
        for op in ops:
            if op.op is not dist.isend:
                op.tensor.zero_()
        return []

    dist.batch_isend_irecv = record
    restore = _workers._count_p2p(counts, log)
    try:
        yield log, counts
    finally:
        restore()
        dist.batch_isend_irecv = issue
        if own:
            dist.destroy_process_group()
