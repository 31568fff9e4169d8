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
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels
from .fused_stencil import (  # one envelope for every kernel
    _DTYPES,
    _SMEM_PER_BLOCK,
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


def tile_for(shape, k: int, itemsize: int) -> tuple[int, int, int]:
    """The kernel's tile ``(bx, by, bz)`` for this block shape, ``k`` and
    item size: ``bx`` is all of x (one segment)."""
    for by, bz in _TILES:
        tile = (shape[0], by, bz)
        ey, ez = window_plane(shape, k, tile)
        if (window_bytes(shape, k, tile, itemsize) <= _SMEM_PER_BLOCK
                and (ey + 1) * (ez + 1) <= SLOTS[itemsize] * THREADS):
            return tile
    raise ValueError(f"no kernel tile fits shared memory for k={k}, itemsize={itemsize}")


def grid(shape, tile) -> tuple[int, int, int]:
    """The launch grid ``(x, y, z)`` = tiles along (z, y, x) of the block."""
    return tuple(-(-n // b) for n, b in zip(shape[::-1], tile[::-1]))


def resident_blocks(source: str, shape, k: int, itemsize: int) -> int:
    """Blocks of kernel ``csrc/<source>.cu`` resident per SM at this shape's
    tile (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; needs the card)."""
    _, by, bz = tile_for(shape, k, itemsize)
    return _kernels.resident_blocks(source, itemsize, shape[1], shape[2], k, by, bz)


def validate(cells, faces, k: int, what: str) -> None:
    """Check the cell fields (one shape) and the x/y/z face fields of a
    staggered kernel call; raise `ValueError` on what the kernel does not
    take."""
    fields = (*cells, *faces)
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
    if tuple(tuple(a.shape) for a in faces) != face_shapes(shape):
        raise ValueError(
            f"{what}: the face fields must have shapes {face_shapes(shape)} for cells "
            f"{shape} (got {[tuple(a.shape) for a in faces]})"
        )
    device = cells[0].device
    if device.type == "cpu":
        return
    if device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {device}")
    if not all(a.is_contiguous() for a in fields):
        raise ValueError(f"{what} needs contiguous fields")
    _, gy, gz = grid(shape, tile_for(shape, k, cells[0].element_size()))
    if gy > 65535 or gz > 65535:
        raise ValueError(f"block {shape} exceeds the kernel's launch grid")


def fused_leapfrog_steps_reference(P, Vx, Vy, Vz, k: int, cax: float, cay: float,
                                   caz: float, b: float, idx: float, idy: float, idz: float):
    """``k`` leapfrog steps with the kernel's constant folding (plain PyTorch)."""
    for _ in range(k):
        Vx, Vy, Vz = Vx.clone(), Vy.clone(), Vz.clone()
        Vx[1:-1, 1:-1, 1:-1] -= cax * (P[1:, 1:-1, 1:-1] - P[:-1, 1:-1, 1:-1])
        Vy[1:-1, 1:-1, 1:-1] -= cay * (P[1:-1, 1:, 1:-1] - P[1:-1, :-1, 1:-1])
        Vz[1:-1, 1:-1, 1:-1] -= caz * (P[1:-1, 1:-1, 1:] - P[1:-1, 1:-1, :-1])
        div = (
            (Vx[1:] - Vx[:-1]) * idx + (Vy[:, 1:] - Vy[:, :-1]) * idy
        ) + (Vz[:, :, 1:] - Vz[:, :, :-1]) * idz
        P = P - b * div
    return P, Vx, Vy, Vz


def fused_leapfrog_steps(P, Vx, Vy, Vz, k: int, cax: float, cay: float, caz: float,
                         b: float, idx: float, idy: float, idz: float):
    """Advance ``k`` (even, 2..8) leapfrog steps in one pass; returns new
    ``(P, Vx, Vy, Vz)``.

    ``cax = dt/(rho*dx)`` (likewise ``cay``, ``caz``), ``b = dt*K``, ``idx =
    1/dx`` (likewise ``idy``, ``idz``).  CUDA tensors go through the kernel
    (contiguous, float32 or float64, every extent >= 3); CPU tensors through
    `fused_leapfrog_steps_reference`.
    """
    global launches
    validate((P,), (Vx, Vy, Vz), k, "fused_leapfrog_steps")
    coeffs = (cax, cay, caz, b, idx, idy, idz)
    if P.device.type == "cpu":
        return fused_leapfrog_steps_reference(P, Vx, Vy, Vz, k, *coeffs)
    suffix, cfloat = _DTYPES[P.dtype]
    fn = _kernels.entry(
        "fused_leapfrog", f"igg_fused_leapfrog_{suffix}",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [cfloat] * 7 + [ctypes.c_int] * 3
        + [ctypes.c_void_p],
    )
    outs = tuple(torch.empty_like(a) for a in (P, Vx, Vy, Vz))
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        code = fn(*(a.data_ptr() for a in (P, Vx, Vy, Vz, *outs)), *P.shape, k, *coeffs,
                  *tile_for(P.shape, k, P.element_size()), stream)
    _kernels.check("fused_leapfrog", code, "fused_leapfrog_steps launch")
    launches += 1
    return outs
