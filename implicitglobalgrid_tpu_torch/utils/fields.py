"""Field constructors: this rank's local block tensors on the grid's device.

A field is a plain tensor of the local block shape ``(nx, ny, nz)`` (or a
staggered variant such as ``(nx+1, ny, nz)``) on the grid's device.
`coord_fields` replaces the reference's per-element comprehension idiom for
initial conditions: it returns this block's global-coordinate tensors so ICs
are plain vectorized torch expressions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import grid as _grid


def _shape(local_shape) -> tuple[int, ...]:
    return (int(local_shape),) if np.ndim(local_shape) == 0 else tuple(int(s) for s in local_shape)


def zeros(local_shape, dtype=None):
    """A zero field of block shape ``local_shape`` (1-, 2- or 3-D)."""
    return full(local_shape, 0, dtype if dtype is not None else torch.get_default_dtype())


def ones(local_shape, dtype=None):
    return full(local_shape, 1, dtype if dtype is not None else torch.get_default_dtype())


def full(local_shape, fill_value, dtype=None):
    gg = _grid.global_grid()
    return torch.full(_shape(local_shape), fill_value, dtype=dtype, device=gg.device)


def from_block_fn(fn, local_shape, dtype=None):
    """Build this rank's block as ``fn(coords)``.

    ``fn`` receives the block's Cartesian coordinates ``(cx, cy, cz)`` as
    Python ints and must return an array or tensor of shape ``local_shape``.
    """
    gg = _grid.global_grid()
    local_shape = _shape(local_shape)
    out = torch.as_tensor(fn(tuple(gg.coords)), dtype=dtype, device=gg.device)
    if tuple(out.shape) != local_shape:
        raise ValueError(
            f"from_block_fn: fn returned shape {tuple(out.shape)}, expected {local_shape}."
        )
    return out


def coord_fields(A, spacings, dtype=None):
    """Global-coordinate tensors matching field ``A``'s shape.

    Returns one tensor per dimension of ``A`` — ``XG, YG, ZG =
    coord_fields(T, (dx, dy, dz))`` with ``XG[i,j,k] == x_g(i, dx, T)`` —
    computed in float64 and cast to ``dtype`` (default: ``A``'s dtype).
    Staggering offsets and the periodic wrap follow `x_g` exactly.
    """
    from . import tools

    gg = _grid.global_grid()
    shp = tuple(A.shape)
    nd = len(shp)
    spacings = (spacings,) * nd if np.ndim(spacings) == 0 else tuple(spacings)
    dtype = A.dtype if dtype is None else dtype
    coord_g = (tools.x_g, tools.y_g, tools.z_g)
    outs = []
    for dim in range(nd):
        idx = torch.arange(shp[dim], dtype=torch.float64, device=gg.device)
        vec = coord_g[dim](idx, spacings[dim], A)
        bshape = [1] * nd
        bshape[dim] = shp[dim]
        outs.append(vec.reshape(bshape).expand(shp).to(dtype).contiguous())
    return tuple(outs)


def block_from_numpy(arr, local_shape=None, *, coords=None, device=None):
    """This rank's block of a numpy field, as a tensor.

    ``arr`` is either ONE block (shape ``local_shape``) or the JAX
    package's global-block layout (shape ``dims*local_shape``, one block per
    rank side by side), from which the block at ``coords`` (default: this
    process's) is cut.  ``local_shape`` defaults to the grid's ``nxyz``
    truncated to ``arr``'s rank; ``device`` to the grid's.
    """
    gg = _grid.global_grid()
    arr = np.asarray(arr)
    if local_shape is None:
        local_shape = tuple(gg.nxyz[: arr.ndim])
    local_shape = _shape(local_shape)
    coords = gg.coords if coords is None else tuple(coords)
    if arr.shape == local_shape:
        block = arr
    elif arr.shape == tuple(gg.dims[d] * s for d, s in enumerate(local_shape)):
        block = arr[tuple(slice(c * s, (c + 1) * s) for c, s in zip(coords, local_shape))]
    else:
        raise ValueError(
            f"block_from_numpy: shape {arr.shape} is neither one block "
            f"{local_shape} nor the global-block layout dims*{local_shape} "
            f"with dims={gg.dims}."
        )
    t = torch.from_numpy(np.array(block, order="C"))  # a writable copy
    return t.to(gg.device if device is None else device)


def block_slice(A, slices):
    """This rank's block ``A`` sliced with ``slices``, as a new tensor.

    The JAX package's ``block_slice`` slices every local block of a global
    array; a port field is its rank's block, so this is ``A[slices]``, with
    the JAX package's check that the rank is kept.  ``block_slice(T,
    (slice(1, -1),) * 3)`` is the block's interior: the idiom the reference
    uses before `gather!`, where the halo is stripped locally before
    gathering.
    """
    _grid.check_initialized()
    slices = (slices,) if isinstance(slices, slice) else tuple(slices)
    out = A[slices]
    if out.dim() != A.dim():
        raise ValueError("block_slice: slices must preserve the number of dimensions.")
    return out.clone()
