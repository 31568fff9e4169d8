"""Temporally blocked fused diffusion steps: ``k`` steps per memory pass.

Counterpart of the JAX package's ``ops/pallas_stencil.py``.  Two versions of
one function live here:

* `fused_diffusion_steps` launches the hand-written CUDA kernel
  ``csrc/fused_diffusion.cu`` for CUDA tensors and runs the plain version for
  CPU tensors.  It raises on anything the kernel does not take; it has no
  fallback for a CUDA tensor.
* `fused_diffusion_steps_reference` is the plain PyTorch version: ``k``
  applications of the TPU kernel's step with its exact constant folding,
  ``lap = (T[2:]-2T+T[:-2])*cx + (..)*cy + (..)*cz`` and ``T_inner += lap *
  (1/Cp)`` — deliberately not the model's ``lap/dx^2`` and ``(dt*lam)/Cp``
  (same math, different rounding).  The outermost ring is frozen.

Both take a subset launch (``tile_sel``, ``carry_in``; `ops.overlap`): the
ring or mid pass of the pipelined group schedule runs the blocks of only
the subset's (x segment, y tile) pairs, each still stepping its whole
window and writing only what it owns, so ring and mid together equal one
``"all"`` launch tile for tile.  Both take a batch of B independent blocks
``(B, n0, n1, n2)`` (T and Cp, an ensemble: `models._batched`): one launch
advances all B members, each exactly as a launch of its own would.

The kernel is built with ``--fmad=false`` and does the same operations in
the same order, so on the card it equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels
from . import overlap as _overlap

#: Launches of the CUDA kernel in this process (the main path's evidence
#: that it went through the kernel; CPU calls of the plain version do not
#: count).
launches = 0

#: Owned ``(by, bz)`` tiles of the x-marching kernel, in order of
#: preference; a block owns one and marches along all of x.  The first whose
#: window plane fits the threads' slots (and whose buffers fit a block's
#: shared memory) is used.
_TILES = ((16, 32), (16, 16), (8, 32), (8, 16), (8, 8), (4, 8), (4, 4))
_SMEM_PER_BLOCK = 232448  # bytes of dynamic shared memory a Hopper block can use
_DTYPES = {torch.float32: ("f32", ctypes.c_float), torch.float64: ("f64", ctypes.c_double)}

#: Mirrors of ``csrc/fused_diffusion.cu``: threads per block, x planes of T
#: and Cp loaded ahead, and the depth of their rings.
THREADS, AHEAD = 512, 2
RING = AHEAD + 2


def elems(itemsize: int, k: int) -> int:
    """z-adjacent plane positions per slot (``kElems``): two, read and
    written as one float2/double2, except float64 at k >= 6."""
    return 1 if itemsize == 8 and k >= 6 else 2


def slots(itemsize: int, k: int) -> int:
    """Slots per thread (``kSlots``): each position holds ``3k + 2`` values
    in registers, and more slots than these spill."""
    return 2 if itemsize == 4 and k == 6 else 1


def window_plane(shape, k: int, tile) -> tuple[int, int]:
    """The largest window's ``(ey, ez)``: the owned ``(by, bz)`` of the tile
    ``(bx, by, bz)`` plus ``k`` cells a side, clipped to the block."""
    return min(tile[1] + 2 * k, shape[1]), min(tile[2] + 2 * k, shape[2])


def row_stride(ez: int, e: int) -> int:
    """A shared-memory plane's row stride (``row_stride``): ``ez`` rounded
    up to whole slots of ``e`` positions."""
    return -(-ez // e) * e


def plane_slots(shape, k: int, tile, itemsize: int) -> int:
    """Slots of the largest window plane (at most ``slots * THREADS``)."""
    ey, ez = window_plane(shape, k, tile)
    e = elems(itemsize, k)
    return ey * row_stride(ez, e) // e


def window_bytes(shape, k: int, tile, itemsize: int) -> int:
    """Shared memory of one block (C++ ``smem_bytes``): rings of `RING` x
    planes of T and of Cp, two planes for each level 1 .. k-1, and a guard
    of one row and one slot before the planes and after them."""
    ey, ez = window_plane(shape, k, tile)
    e = elems(itemsize, k)
    rz = row_stride(ez, e)
    return ((2 * RING + 2 * (k - 1)) * ey * rz + 2 * (rz + e)) * itemsize


def tile_fits(shape, k: int, tile, itemsize: int) -> bool:
    """Whether a block's buffers fit its shared memory and its window plane
    the threads' slots at this tile."""
    return (window_bytes(shape, k, tile, itemsize) <= _SMEM_PER_BLOCK
            and plane_slots(shape, k, tile, itemsize) <= slots(itemsize, k) * THREADS)


def tile_for(shape, k: int, itemsize: int, by: int | None = None) -> tuple[int, int, int]:
    """The kernel's tile ``(bx, by, bz)`` for this block shape, ``k`` and
    item size, with ``bx`` all of x (a launch may cut x: `launch_tile`);
    ``by`` given: the first ladder ``bz`` that fits beside it."""
    for tby, bz in _TILES:
        tile = (shape[0], by or tby, bz)
        if tile_fits(shape, k, tile, itemsize):
            return tile
    raise ValueError(f"no kernel tile fits shared memory for k={k}, itemsize={itemsize}"
                     + (f", by={by}" if by else ""))


def grid(shape, tile) -> tuple[int, int, int]:
    """The launch grid ``(x, y, z)`` = tiles along (z, y, x) of the block."""
    return tuple(-(-n // b) for n, b in zip(shape[::-1], tile[::-1]))


def resident_blocks(shape, k: int, itemsize: int) -> int:
    """Blocks of the kernel resident per SM at this shape's tile
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; needs the card)."""
    _, by, bz = tile_for(shape, k, itemsize)
    return _kernels.resident_blocks("fused_diffusion", itemsize, shape[1], shape[2], k, by, bz)


#: The shortest x segment, in multiples of k planes: a segment recomputes k
#: planes past each interior end, at most a quarter of its own at 8k.
_MIN_SEGMENT = 8


def segments(shape, k: int, itemsize: int, resident: int, sms: int, nb: int = 1) -> int:
    """x segments per (y, z) tile of a launch over ``nb`` blocks of
    ``shape``: as many as fill the card's resident block slots
    (``resident`` blocks on each of ``sms`` SMs) with the ``nb`` blocks'
    grids, none shorter than ``_MIN_SEGMENT * k`` planes (an ensemble's
    members fill the card before x segments do, and each segment re-reads
    its halo planes)."""
    gz, gy, _ = grid(shape, tile_for(shape, k, itemsize))
    return max(1, min(resident * sms // (nb * gy * gz), shape[0] // (_MIN_SEGMENT * k)))


_occupancy: dict = {}


def launch_tile(shape, k: int, itemsize: int, device, nb: int = 1) -> tuple[int, int, int]:
    """The tile of a launch over ``nb`` blocks of ``shape`` on CUDA
    ``device``: `tile_for`'s (y, z) tile with x cut into `segments`, from
    the card's resident blocks per SM and SM count (asked once per device,
    (n1, n2), k and item size)."""
    key = (device, tuple(shape[1:]), k, itemsize)
    if key not in _occupancy:
        with torch.cuda.device(device):
            _occupancy[key] = (resident_blocks(shape, k, itemsize),
                               torch.cuda.get_device_properties(device).multi_processor_count)
    _, by, bz = tile_for(shape, k, itemsize)
    return -(-shape[0] // segments(shape, k, itemsize, *_occupancy[key], nb)), by, bz


def default_tile(shape, k: int, itemsize: int, device) -> tuple[int, int, int]:
    """The tile a launch takes when none is given: `launch_tile` on a CUDA
    device, `tile_for` elsewhere (the plain version's subsets)."""
    if torch.device(device).type == "cuda":
        return launch_tile(shape, k, itemsize, device)
    return tile_for(shape, k, itemsize)


def fused_support_error(shape, k: int, dtype) -> str | None:
    """Why the kernel cannot run this config, or None if it can.  ``shape``:
    a block's, or a batch's ``(B, n0, n1, n2)``."""
    if k % 2 or not 2 <= k <= 8:
        return f"k must be even and in [2, 8] (got {k})"
    if len(shape) not in (3, 4) or min(shape[-3:]) < 3 or min(shape) < 1:
        return (f"the block must be 3-D, or a batch (B, n0, n1, n2) of them, with every "
                f"extent >= 3 (got {tuple(shape)})")
    if dtype not in _DTYPES:
        return f"dtype {dtype} is not float32 or float64"
    return None


def fused_diffusion_steps_reference(T, Cp, k: int, cx: float, cy: float, cz: float, *,
                                    tile=None, tile_sel: str = "all", carry_in=None):
    """``k`` diffusion steps with the kernel's constant folding (plain
    PyTorch), on a block or a batch of them; a subset launch copies the
    subset's owned region of the full result into ``carry_in`` (or a fresh
    tensor)."""
    block = tuple(T.shape[-3:])
    minv = (1 / Cp)[..., 1:-1, 1:-1, 1:-1]
    for _ in range(k):
        c = T[..., 1:-1, 1:-1, 1:-1]
        lap = (
            (T[..., 2:, 1:-1, 1:-1] - 2 * c + T[..., :-2, 1:-1, 1:-1]) * cx
            + (T[..., 1:-1, 2:, 1:-1] - 2 * c + T[..., 1:-1, :-2, 1:-1]) * cy
            + (T[..., 1:-1, 1:-1, 2:] - 2 * c + T[..., 1:-1, 1:-1, :-2]) * cz
        )
        T = T.clone()
        T[..., 1:-1, 1:-1, 1:-1] = c + lap * minv
    if tile_sel == "all":
        return T
    tile = tile or tile_for(block, k, T.element_size())
    return _overlap.copy_subset((T,), tile_sel, carry_in, block[:2], tile)[0]


def _entry(dtype):
    """The kernel's C entry for ``dtype``: pointers, members, (n0, n1, n2),
    k, coefficients, tile, selector code, stream."""
    suffix, cfloat = _DTYPES[dtype]
    return _kernels.entry(
        "fused_diffusion", f"igg_fused_diffusion_{suffix}",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [cfloat] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p],
    )


def check_grid(nb: int, n01, tile, tile_sel: str) -> None:
    """Raise if a launch over ``nb`` members of ``n01 = (n0, n1)`` blocks at
    ``tile`` exceeds the launch grid (65535 blocks along y and z; an
    ``"all"`` launch folds the members into its x segments, ``nb *
    segments``, a subset launch has one z entry per member), or the
    kernels' int x-plane index (member ``m``'s plane ``p`` is ``m * n0 +
    p``)."""
    if nb * (n01[0] + 1) >= 2**31:
        raise ValueError(f"{nb} members of {n01[0]} x planes exceed the kernels' int plane index")
    gy, gx = -(-n01[1] // tile[1]), -(-n01[0] // tile[0])
    if tile_sel == "all":
        ny, nz = gy, nb * gx
    else:
        ny, nz = _overlap.tile_subset_count(tile_sel, gx, gy), nb
    if ny > 65535 or nz > 65535:
        raise ValueError(
            f"{nb} member(s) of ({n01[0]}, {n01[1]}, ...) blocks at tile {tuple(tile)} need a "
            f"launch grid of ({ny}, {nz}) along y and z; the card takes at most 65535 each"
        )


def _validate(T, Cp, k):
    if T.dtype != Cp.dtype:
        raise ValueError(f"T and Cp must share a dtype (got {T.dtype} and {Cp.dtype})")
    if T.shape != Cp.shape:
        raise ValueError(f"T and Cp must share a shape (got {tuple(T.shape)} and {tuple(Cp.shape)})")
    if T.device != Cp.device:
        raise ValueError(f"T and Cp must share a device (got {T.device} and {Cp.device})")
    err = fused_support_error(tuple(T.shape), k, T.dtype)
    if err is not None:
        raise ValueError(err)


def check_tile(shape, k: int, tile, itemsize: int) -> tuple[int, int, int]:
    """An explicit launch tile ``(bx, by, bz)``, validated."""
    tile = tuple(int(b) for b in tile)
    if len(tile) != 3 or min(tile) < 1:
        raise ValueError(f"tile must be three positive extents (bx, by, bz), got {tile}")
    if not tile_fits(shape, k, tile, itemsize):
        raise ValueError(f"tile {tile} does not fit the kernel at k={k}, itemsize={itemsize}")
    return tile


def fused_diffusion_steps(T, Cp, k: int, cx: float, cy: float, cz: float, *, tile=None,
                          tile_sel: str = "all", carry_in=None):
    """Advance ``k`` (even, 2..8) diffusion steps in one pass; returns a new T.

    ``cx = dt*lam/dx^2`` (likewise ``cy``, ``cz``).  ``T`` and ``Cp``: one
    block ``(n0, n1, n2)``, or a batch of B ``(B, n0, n1, n2)`` advanced in
    one launch.  CUDA tensors go through the kernel (contiguous, float32 or
    float64, every extent >= 3); CPU tensors through
    `fused_diffusion_steps_reference`.  ``tile``: the launch tile ``(bx,
    by, bz)`` of a block (default `default_tile`; a batch's default cuts x
    into fewer segments, `launch_tile`).  ``tile_sel``: a subset of the (x
    segment, y tile) pairs (`ops.overlap.TILE_SELS`), in every member; a
    ``mid*`` launch writes into ``carry_in``, the matching ``ring*``
    launch's output, and returns it.  Forward-only: under grad mode with an
    input that requires grad it raises (`ops.overlap.check_forward_only`).
    """
    global launches
    _validate(T, Cp, k)
    _overlap.check_forward_only("fused_diffusion_steps", (T, Cp))
    block, nb = tuple(T.shape[-3:]), T.shape[0] if T.dim() == 4 else 1
    if tile is not None:
        tile = check_tile(block, k, tile, T.element_size())
    carry = None
    if tile_sel != "all":
        tile = tile or default_tile(block, k, T.element_size(), T.device)
        carry = _overlap.check_tile_subset(tile_sel, carry_in, block[:2], tile, (T,))
    if T.device.type == "cpu":
        return fused_diffusion_steps_reference(T, Cp, k, cx, cy, cz, tile=tile,
                                               tile_sel=tile_sel, carry_in=carry)
    if T.device.type != "cuda":
        raise ValueError(f"fused_diffusion_steps runs on CUDA or CPU tensors, not {T.device}")
    if not (T.is_contiguous() and Cp.is_contiguous()):
        raise ValueError("fused_diffusion_steps needs contiguous T and Cp")
    tile = tile or launch_tile(block, k, T.element_size(), T.device, nb)
    check_grid(nb, block[:2], tile, tile_sel)
    out = carry[0] if carry is not None else torch.empty_like(T)
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        code = _entry(T.dtype)(T.data_ptr(), Cp.data_ptr(), out.data_ptr(), nb, *block, k,
                               cx, cy, cz, *tile, _overlap.TILE_SELS.index(tile_sel), stream)
    _kernels.check("fused_diffusion", code, "fused_diffusion_steps launch")
    launches += 1
    return out
