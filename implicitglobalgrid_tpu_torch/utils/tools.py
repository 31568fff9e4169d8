"""Global-grid index math: global sizes and coordinates from local ones.

The "implicit" in implicit global grid: global sizes and physical coordinates
are computed from (local size, dims, coords, overlap, period), never stored.
Element indices are 0-based.  A field is this rank's local block, so its
local size is simply its shape; coordinates default to this process's block
``coords``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import grid as _grid


def _local_size(A, dim: int) -> int:
    shp = tuple(A.shape) if isinstance(A, torch.Tensor) else np.shape(A)
    return shp[dim] if dim < len(shp) else 1


def _n_g(dim: int, A):
    gg = _grid.global_grid()
    if A is None:
        return gg.nxyz_g[dim]
    return gg.nxyz_g[dim] + (_local_size(A, dim) - gg.nxyz[dim])


def nx_g(A=None):
    """Global grid size in x; with ``A``, the global size of array ``A``
    (staggering-aware: ``nx_g + (size(A,0) - nx)``)."""
    return _n_g(0, A)


def ny_g(A=None):
    """Global grid size in y; with ``A``, the global size of array ``A``."""
    return _n_g(1, A)


def nz_g(A=None):
    """Global grid size in z; with ``A``, the global size of array ``A``."""
    return _n_g(2, A)


def _coord_g(i, d, A, dim: int, coords):
    """Shared implementation of x_g/y_g/z_g.

    Periodic wrap: the first cell of the periodic global problem is a ghost
    cell, so coordinates shift by one spacing and wrap into the domain.  The
    wrap CONDITIONS are decided in exact integer index space: float
    comparisons at the domain seam can double-wrap or false-fire (one seam
    plane then lands a full period out of the domain, breaking the periodic
    plane-pair invariant the halo exchange relies on).  ``j2`` is the
    doubled half-spacing index (``x/d == j2/2`` exactly, the staggering
    offset being a half-integer); the wrapped VALUES keep the float formula.
    """
    gg = _grid.global_grid()
    n = gg.nxyz[dim]
    o = gg.overlaps[dim]
    n_g = gg.nxyz_g[dim]
    size_d = _local_size(A, dim) if A is not None else n
    c = gg.coords[dim] if coords is None else coords[dim]

    xp = torch if isinstance(i, torch.Tensor) else np
    if xp is np:
        i = np.asarray(i)
    x0 = 0.5 * (n - size_d) * d
    x = (c * (n - o) + i) * d + x0
    if gg.periods[dim]:
        x = x - d
        j2 = 2 * (c * (n - o) + i) + (n - size_d) - 2
        x = xp.where(
            j2 > 2 * (n_g - 1),
            x - n_g * d,
            xp.where(j2 < 0, x + n_g * d, x),
        )
    if xp is np and x.ndim == 0:
        return float(x)
    return x


def x_g(ix, dx, A=None, *, coords=None):
    """Global x-coordinate of local element ``ix`` (0-based) of array ``A``.

    ``ix`` may be a scalar, a numpy index array or a float64 torch tensor of
    indices.  Staggered arrays (e.g. size ``nx+1``) are offset by
    ``0.5*(nx-size)*dx``.  ``coords`` overrides this process's block
    coordinates (to compute another block's coordinates).
    """
    return _coord_g(ix, dx, A, 0, coords)


def y_g(iy, dy, A=None, *, coords=None):
    """Global y-coordinate of local element ``iy`` (0-based) of array ``A``."""
    return _coord_g(iy, dy, A, 1, coords)


def z_g(iz, dz, A=None, *, coords=None):
    """Global z-coordinate of local element ``iz`` (0-based) of array ``A``."""
    return _coord_g(iz, dz, A, 2, coords)
