"""Cartesian process topology for the implicit global grid.

The port's own copy of the JAX package's pure-numpy topology math
(`implicitglobalgrid_tpu/parallel/topology.py`): ``MPI_Dims_create``
factoring, the implied global size, the C-order rank <-> coordinates map and
the ``MPI_Cart_shift`` neighbor table.  One process drives one GPU, so a rank
here is a process rank of `torch.distributed`, exactly the reference's MPI
rank.

Rank convention: the rank of the block at Cartesian coordinates
``(cx, cy, cz)`` is ``(cx * dims[1] + cy) * dims[2] + cz`` (dimension 0
varies slowest).
"""

from __future__ import annotations

import numpy as np

PROC_NULL = -1  # analogue of MPI.PROC_NULL
NDIMS = 3  # fixed internal dimensionality
NNEIGHBORS_PER_DIM = 2  # left + right


def _prime_factors(n: int) -> list[int]:
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.append(d)
            n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def dims_create(nprocs: int, dims: tuple[int, int, int]) -> tuple[int, int, int]:
    """Factor ``nprocs`` into a balanced Cartesian grid (``MPI_Dims_create``).

    Nonzero entries of ``dims`` stay fixed; zero entries are filled with a
    factorization of ``nprocs / prod(fixed)`` that is as balanced as
    possible, larger factors in earlier free dimensions.
    """
    dims = tuple(int(d) for d in dims)
    if any(d < 0 for d in dims):
        raise ValueError(f"dims entries must be >= 0, got {dims}")
    fixed_prod = 1
    for d in dims:
        if d > 0:
            fixed_prod *= d
    if nprocs % fixed_prod != 0:
        raise ValueError(
            f"The number of devices ({nprocs}) is not divisible by the product of "
            f"the fixed dims entries ({fixed_prod})."
        )
    free = [i for i, d in enumerate(dims) if d == 0]
    rem = nprocs // fixed_prod
    if not free:
        if fixed_prod != nprocs:
            raise ValueError(
                f"prod(dims)={fixed_prod} does not match the number of devices ({nprocs})."
            )
        return dims
    # Repeatedly multiply the currently-smallest slot by the largest
    # remaining prime factor, then order the free slots non-increasingly.
    slots = [1] * len(free)
    for f in sorted(_prime_factors(rem), reverse=True):
        slots[int(np.argmin(slots))] *= f
    slots.sort(reverse=True)
    out = list(dims)
    for i, s in zip(free, slots):
        out[i] = s
    return tuple(out)


def implied_global_shape(nxyz, dims, overlaps, periods) -> tuple[int, ...]:
    """``nxyz_g = dims*(nxyz - overlaps) + overlaps*(periods == 0)``."""
    return tuple(
        int(d) * (int(n) - int(o)) + int(o) * (int(p) == 0)
        for n, d, o, p in zip(nxyz, dims, overlaps, periods)
    )


def rank_of_coords(coords, dims) -> int:
    """Row-major (C-order) rank of Cartesian coordinates, dim 0 slowest."""
    cx, cy, cz = coords
    return (cx * dims[1] + cy) * dims[2] + cz


def coords_of_rank(rank: int, dims) -> tuple[int, int, int]:
    cz = rank % dims[2]
    cy = (rank // dims[2]) % dims[1]
    cx = rank // (dims[1] * dims[2])
    return (cx, cy, cz)


def neighbors_table(coords, dims, periods, disp: int = 1) -> np.ndarray:
    """Neighbor ranks, shape (NNEIGHBORS_PER_DIM, NDIMS).

    ``neighbors[0, d]`` is the lower neighbor in dimension ``d`` (the source
    of an ``MPI_Cart_shift(d, disp)``), ``neighbors[1, d]`` the upper one;
    ``PROC_NULL`` where the grid is non-periodic and the shift falls off.
    """
    nbrs = np.full((NNEIGHBORS_PER_DIM, NDIMS), PROC_NULL, dtype=np.int32)
    for d in range(NDIMS):
        for sgn, n in ((-1, 0), (+1, 1)):
            c = list(coords)
            c[d] += sgn * disp
            if periods[d]:
                c[d] %= dims[d]
            elif not (0 <= c[d] < dims[d]):
                continue
            nbrs[n, d] = rank_of_coords(c, dims)
    return nbrs
