"""Temporally blocked staggered leapfrog steps: ``k`` steps per memory pass.

Counterpart of the JAX package's ``ops/pallas_leapfrog.py``.  Two versions
of one function live here:

* `fused_leapfrog_steps` launches the hand-written CUDA kernel
  ``csrc/fused_leapfrog.cu`` for CUDA tensors and runs the plain version for
  CPU tensors.  It raises on anything the kernel does not take; it has no
  fallback for a CUDA tensor.
* `fused_leapfrog_steps_reference` is the plain PyTorch version: ``k``
  applications of the TPU kernel's step with its exact constant folding,
  ``V -= ca*(P[i]-P[i-1])`` at interior faces, then ``P -= b*(((dVx)*idx +
  (dVy)*idy) + (dVz)*idz)`` at every cell from the new V — deliberately not
  the model's ``-(a/dx)*diff`` and ``diff/dx`` (same math, other rounding).

Fields are the real staggered arrays: ``P`` ``(n0, n1, n2)``, ``Vx``
``(n0+1, n1, n2)``, ``Vy`` ``(n0, n1+1, n2)``, ``Vz`` ``(n0, n1, n2+1)``.
The TPU kernel's padded face layout (`pad_faces`) exists only because
Mosaic needs aligned DMA extents; the helpers stay here for API parity, and
the padding never enters the CUDA kernel.  The kernel is built with
``--fmad=false`` and does the plain version's operations in its order, so on
the card the two agree bit for bit.

Both versions take a launch tile and a subset launch (``tile``,
``tile_sel``, ``carry_in``; see `ops.fused_stencil` and `ops.overlap`), and
a batch of B independent blocks (every field with a leading ``B`` axis, an
ensemble: `models._batched`), advanced by one launch.  The staggered
kernels march all of x in one segment, so a batch adds blocks to the grid
and cuts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels
from . import overlap as _overlap
from .fused_stencil import (  # one envelope and launch grid for every kernel
    _DTYPES,
    _SMEM_PER_BLOCK,
    check_grid,
    fused_support_error,
)

#: Launches of the CUDA kernel in this process (CPU calls of the plain
#: version do not count).
launches = 0

#: Owned ``(by, bz)`` tiles of the x-marching kernels, in order of
#: preference; a block owns one and marches along all of x.  The first whose
#: plane ring fits a block's shared memory and whose window plane fits the
#: threads' slots is used.  (16, 32) puts 128 blocks on the 132 SMs at 256^3.
_TILES = ((16, 32), (8, 32), (8, 16), (8, 8), (4, 8), (4, 4))

#: Mirrors of ``csrc/staggered.cuh``: threads per block, plane positions per
#: thread by item size, and x planes stepped (and loaded, one iteration
#: ahead) per iteration.
THREADS, SLOTS, PLANES = 512, {4: 3, 8: 2}, 2

#: Padded-axis extents of the TPU kernel's `pad_faces` layout, relative to
#: the cell size (x/y: Mosaic sublane alignment, z: lane-tile alignment).
PADS = (8, 8, 128)


def face_shapes(cell_shape) -> tuple[tuple[int, int, int], ...]:
    """The shapes of the x, y and z face fields of a cell-shaped block."""
    n0, n1, n2 = cell_shape
    return (n0 + 1, n1, n2), (n0, n1 + 1, n2), (n0, n1, n2 + 1)


def padded_face_shapes(cell_shape) -> tuple[tuple[int, int, int], ...]:
    """The three `pad_faces` array shapes for a given cell shape."""
    n0, n1, n2 = cell_shape
    return (n0 + PADS[0], n1, n2), (n0, n1 + PADS[1], n2), (n0, n1, n2 + PADS[2])


def pad_faces(Vx, Vy, Vz):
    """Face fields ``(n+1)`` -> the TPU kernel's padded layout: each field's
    own axis zero-padded to ``n + PADS[axis]``."""
    pad = torch.nn.functional.pad
    return (
        pad(Vx, (0, 0, 0, 0, 0, PADS[0] - 1)),
        pad(Vy, (0, 0, 0, PADS[1] - 1)),
        pad(Vz, (0, PADS[2] - 1)),
    )


def unpad_faces(Vxp, Vyp, Vzp):
    """Inverse of `pad_faces`: the ``n+1`` real faces, as views."""
    return Vxp[: 1 - PADS[0]], Vyp[:, : 1 - PADS[1]], Vzp[:, :, : 1 - PADS[2]]


def ring_depth(k: int) -> int:
    """x planes per field in a block's ring: an iteration steps ``k +
    PLANES`` of them while the next iteration's ``PLANES`` load."""
    return k + 2 * PLANES


def window_plane(shape, k: int, tile) -> tuple[int, int]:
    """The largest window's ``(ey, ez)``: the owned ``(by, bz)`` of the tile
    ``(bx, by, bz)`` plus ``k`` cells a side, clipped to the block."""
    return min(tile[1] + 2 * k, shape[1]), min(tile[2] + 2 * k, shape[2])


def window_bytes(shape, k: int, tile, itemsize: int) -> int:
    """Shared memory of one block: a ring of `ring_depth` x planes of each of
    the four fields, every plane ``(ey+1) x (ez+1)`` (room for the y and z
    faces' extra row)."""
    ey, ez = window_plane(shape, k, tile)
    return 4 * ring_depth(k) * (ey + 1) * (ez + 1) * itemsize


def tile_fits(shape, k: int, tile, itemsize: int) -> bool:
    """Whether a block's plane rings fit its shared memory and its window
    plane the threads' slots at this tile."""
    ey, ez = window_plane(shape, k, tile)
    return (window_bytes(shape, k, tile, itemsize) <= _SMEM_PER_BLOCK
            and (ey + 1) * (ez + 1) <= SLOTS[itemsize] * THREADS)


def tile_for(shape, k: int, itemsize: int, by: int | None = None) -> tuple[int, int, int]:
    """The kernel's tile ``(bx, by, bz)`` for this block shape, ``k`` and
    item size: ``bx`` is all of x (one segment); ``by`` given: the first
    ladder ``bz`` that fits beside it."""
    for tby, bz in _TILES:
        tile = (shape[0], by or tby, bz)
        if tile_fits(shape, k, tile, itemsize):
            return tile
    raise ValueError(f"no kernel tile fits shared memory for k={k}, itemsize={itemsize}"
                     + (f", by={by}" if by else ""))


def default_tile(shape, k: int, itemsize: int, device=None) -> tuple[int, int, int]:
    """The tile a launch takes when none is given (`tile_for` on every
    device)."""
    return tile_for(shape, k, itemsize)


def check_tile(shape, k: int, tile, itemsize: int) -> tuple[int, int, int]:
    """An explicit launch tile ``(bx, by, bz)``, validated."""
    tile = tuple(int(b) for b in tile)
    if len(tile) != 3 or min(tile) < 1:
        raise ValueError(f"tile must be three positive extents (bx, by, bz), got {tile}")
    if not tile_fits(shape, k, tile, itemsize):
        raise ValueError(f"tile {tile} does not fit the kernel at k={k}, itemsize={itemsize}")
    return tile


def grid(shape, tile) -> tuple[int, int, int]:
    """The launch grid ``(x, y, z)`` = tiles along (z, y, x) of the block."""
    return tuple(-(-n // b) for n, b in zip(shape[::-1], tile[::-1]))


def resident_blocks(source: str, shape, k: int, itemsize: int) -> int:
    """Blocks of kernel ``csrc/<source>.cu`` resident per SM at this shape's
    tile (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; needs the card)."""
    _, by, bz = tile_for(shape, k, itemsize)
    return _kernels.resident_blocks(source, itemsize, shape[1], shape[2], k, by, bz)


def validate(cells, faces, k: int, what: str, *, tile=None, tile_sel: str = "all",
             carry_in=None):
    """Check the cell fields (one shape) and the x/y/z face fields of a
    staggered kernel call and its launch request; raise `ValueError` on
    what the kernel does not take, and on a call autograd would have to
    record (`ops.overlap.check_forward_only`).  Every field may carry one
    leading batch axis, the same for all.  Returns ``(tile, carry)``: the
    launch tile (None: the default one) and ``carry_in`` as a tuple (or
    None)."""
    fields = (*cells, *faces)
    _overlap.check_forward_only(what, fields)
    if len({a.dtype for a in fields}) != 1:
        raise ValueError(f"{what}: the fields must share a dtype (got {[a.dtype for a in fields]})")
    if len({a.device for a in fields}) != 1:
        raise ValueError(
            f"{what}: the fields must share a device (got {[a.device for a in fields]})"
        )
    shape = tuple(cells[0].shape)
    err = fused_support_error(shape, k, cells[0].dtype)
    if err is not None:
        raise ValueError(err)
    if any(tuple(a.shape) != shape for a in cells):
        raise ValueError(
            f"{what}: the cell fields must share a shape (got {[tuple(a.shape) for a in cells]})"
        )
    lead, block = shape[:-3], shape[-3:]
    want = tuple(lead + f for f in face_shapes(block))
    if tuple(tuple(a.shape) for a in faces) != want:
        raise ValueError(
            f"{what}: the face fields must have shapes {want} for cells "
            f"{shape} (got {[tuple(a.shape) for a in faces]})"
        )
    itemsize = cells[0].element_size()
    if tile is not None:
        tile = check_tile(block, k, tile, itemsize)
    carry = None
    if tile_sel != "all":
        tile = tile or tile_for(block, k, itemsize)
        carry = _overlap.check_tile_subset(tile_sel, carry_in, block[:2], tile,
                                           (cells[0], *faces))
    device = cells[0].device
    if device.type == "cpu":
        return tile, carry
    if device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {device}")
    if not all(a.is_contiguous() for a in fields):
        raise ValueError(f"{what} needs contiguous fields")
    check_grid(shape[0] if lead else 1, block[:2], tile or tile_for(block, k, itemsize),
               tile_sel)
    return tile, carry


def launch(source: str, inputs, like, k: int, coeffs, tile, tile_sel: str, carry):
    """Launch ``csrc/<source>.cu``'s kernel (a staggered wrapper's CUDA
    half): ``inputs`` in its argument order, outputs shaped like ``like``
    (or ``carry``, a ``mid*`` launch's ring outputs), the launch tile
    (default `tile_for`) and the subset selector; a batched ``like[0]``
    ``(B, n0, n1, n2)`` launches once for all B members.  Returns the
    outputs."""
    shape = tuple(like[0].shape)
    block, nb = shape[-3:], shape[0] if len(shape) == 4 else 1
    tile = tile or tile_for(block, k, like[0].element_size())
    suffix, cfloat = _DTYPES[like[0].dtype]
    fn = _kernels.entry(
        source, f"igg_{source}_{suffix}",
        [ctypes.c_void_p] * (len(inputs) + len(like)) + [ctypes.c_int] * 5
        + [cfloat] * len(coeffs) + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    outs = carry if carry is not None else tuple(torch.empty_like(a) for a in like)
    with torch.cuda.device(like[0].device):
        stream = torch.cuda.current_stream(like[0].device).cuda_stream
        code = fn(*(a.data_ptr() for a in (*inputs, *outs)), nb, *block, k, *coeffs, *tile,
                  _overlap.TILE_SELS.index(tile_sel), stream)
    _kernels.check(source, code, f"{source} launch")
    return outs


def fused_leapfrog_steps_reference(P, Vx, Vy, Vz, k: int, cax: float, cay: float,
                                   caz: float, b: float, idx: float, idy: float, idz: float,
                                   *, tile=None, tile_sel: str = "all", carry_in=None):
    """``k`` leapfrog steps with the kernel's constant folding (plain
    PyTorch), on a block or a batch of them; a subset launch copies the
    subset's owned region of the full result into ``carry_in`` (or fresh
    tensors)."""
    for _ in range(k):
        Vx, Vy, Vz = Vx.clone(), Vy.clone(), Vz.clone()
        Vx[..., 1:-1, 1:-1, 1:-1] -= cax * (P[..., 1:, 1:-1, 1:-1] - P[..., :-1, 1:-1, 1:-1])
        Vy[..., 1:-1, 1:-1, 1:-1] -= cay * (P[..., 1:-1, 1:, 1:-1] - P[..., 1:-1, :-1, 1:-1])
        Vz[..., 1:-1, 1:-1, 1:-1] -= caz * (P[..., 1:-1, 1:-1, 1:] - P[..., 1:-1, 1:-1, :-1])
        P = P - b * divergence(Vx, Vy, Vz, idx, idy, idz)
    return subset_of((P, Vx, Vy, Vz), k, tile, tile_sel, carry_in)


def divergence(Vx, Vy, Vz, idx: float, idy: float, idz: float):
    """The kernels' cell divergence of face fields, ``((dVx)*idx +
    (dVy)*idy) + (dVz)*idz``, on blocks or batches of them."""
    return (
        (Vx[..., 1:, :, :] - Vx[..., :-1, :, :]) * idx
        + (Vy[..., :, 1:, :] - Vy[..., :, :-1, :]) * idy
    ) + (Vz[..., :, :, 1:] - Vz[..., :, :, :-1]) * idz


def subset_of(full, k: int, tile, tile_sel: str, carry_in):
    """A plain staggered version's result for its launch request: ``full``
    itself for ``"all"``, else the subset's owned region of it (``full[0]``
    holds the cells, batched or not)."""
    if tile_sel == "all":
        return full
    block = tuple(full[0].shape[-3:])
    tile = tile or tile_for(block, k, full[0].element_size())
    return _overlap.copy_subset(full, tile_sel, carry_in, block[:2], tile)


def fused_leapfrog_steps(P, Vx, Vy, Vz, k: int, cax: float, cay: float, caz: float,
                         b: float, idx: float, idy: float, idz: float, *, tile=None,
                         tile_sel: str = "all", carry_in=None):
    """Advance ``k`` (even, 2..8) leapfrog steps in one pass; returns new
    ``(P, Vx, Vy, Vz)``.

    ``cax = dt/(rho*dx)`` (likewise ``cay``, ``caz``), ``b = dt*K``, ``idx =
    1/dx`` (likewise ``idy``, ``idz``).  CUDA tensors go through the kernel
    (contiguous, float32 or float64, every extent >= 3); CPU tensors through
    `fused_leapfrog_steps_reference`.  ``tile``, ``tile_sel`` and
    ``carry_in`` as in `ops.fused_stencil.fused_diffusion_steps`.
    """
    global launches
    tile, carry = validate((P,), (Vx, Vy, Vz), k, "fused_leapfrog_steps", tile=tile,
                           tile_sel=tile_sel, carry_in=carry_in)
    coeffs = (cax, cay, caz, b, idx, idy, idz)
    if P.device.type == "cpu":
        return fused_leapfrog_steps_reference(P, Vx, Vy, Vz, k, *coeffs, tile=tile,
                                              tile_sel=tile_sel, carry_in=carry)
    outs = launch("fused_leapfrog", (P, Vx, Vy, Vz), (P, Vx, Vy, Vz), k, coeffs, tile,
                  tile_sel, carry)
    launches += 1
    return outs
