"""`gather` — assemble every rank's block on the root process.

The block layout of the reference's ``gather!``: the result has shape
``dims * local_shape`` with block ``(cx, cy, cz)`` at offset
``coords * local_shape`` (overlapping cells stored redundantly, halos kept).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import grid as _grid
from ..parallel import topology


def gather(A, A_global=None, *, root: int = 0):
    """Gather field ``A`` to the host on process ``root``.

    Returns the assembled numpy array on the root and ``None`` elsewhere.
    With ``A_global`` (a numpy array of ``nprocs * A.numel()`` elements and
    ``A``'s dtype) the root fills it in place and returns ``None``.
    Collective: every process must call it.
    """
    gg = _grid.global_grid()
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
