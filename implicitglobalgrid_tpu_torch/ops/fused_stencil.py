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

The kernel is built with ``--fmad=false`` and does the same operations in
the same order, so on the card it equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

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


def tile_for(shape, k: int, itemsize: int) -> tuple[int, int, int]:
    """The kernel's tile ``(bx, by, bz)`` for this block shape, ``k`` and
    item size, with ``bx`` all of x (a launch may cut x: `launch_tile`)."""
    for by, bz in _TILES:
        tile = (shape[0], by, bz)
        if (window_bytes(shape, k, tile, itemsize) <= _SMEM_PER_BLOCK
                and plane_slots(shape, k, tile, itemsize) <= slots(itemsize, k) * THREADS):
            return tile
    raise ValueError(f"no kernel tile fits shared memory for k={k}, itemsize={itemsize}")


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


def segments(shape, k: int, itemsize: int, resident: int, sms: int) -> int:
    """x segments per (y, z) tile: as many as fill the card's resident
    block slots (``resident`` blocks on each of ``sms`` SMs) with the grid,
    none shorter than ``_MIN_SEGMENT * k`` planes."""
    gz, gy, _ = grid(shape, tile_for(shape, k, itemsize))
    return max(1, min(resident * sms // (gy * gz), shape[0] // (_MIN_SEGMENT * k)))


_occupancy: dict = {}


def launch_tile(shape, k: int, itemsize: int, device) -> tuple[int, int, int]:
    """The tile of a launch on CUDA ``device``: `tile_for`'s (y, z) tile
    with x cut into `segments`, from the card's resident blocks per SM and
    SM count (asked once per device, (n1, n2), k and item size)."""
    key = (device, tuple(shape[1:]), k, itemsize)
    if key not in _occupancy:
        with torch.cuda.device(device):
            _occupancy[key] = (resident_blocks(shape, k, itemsize),
                               torch.cuda.get_device_properties(device).multi_processor_count)
    _, by, bz = tile_for(shape, k, itemsize)
    return -(-shape[0] // segments(shape, k, itemsize, *_occupancy[key])), by, bz


def fused_support_error(shape, k: int, dtype) -> str | None:
    """Why the kernel cannot run this config, or None if it can."""
    if k % 2 or not 2 <= k <= 8:
        return f"k must be even and in [2, 8] (got {k})"
    if len(shape) != 3 or min(shape) < 3:
        return f"the block must be 3-D with every extent >= 3 (got {tuple(shape)})"
    if dtype not in _DTYPES:
        return f"dtype {dtype} is not float32 or float64"
    return None


def fused_diffusion_steps_reference(T, Cp, k: int, cx: float, cy: float, cz: float):
    """``k`` diffusion steps with the kernel's constant folding (plain PyTorch)."""
    minv = (1 / Cp)[1:-1, 1:-1, 1:-1]
    for _ in range(k):
        c = T[1:-1, 1:-1, 1:-1]
        lap = (
            (T[2:, 1:-1, 1:-1] - 2 * c + T[:-2, 1:-1, 1:-1]) * cx
            + (T[1:-1, 2:, 1:-1] - 2 * c + T[1:-1, :-2, 1:-1]) * cy
            + (T[1:-1, 1:-1, 2:] - 2 * c + T[1:-1, 1:-1, :-2]) * cz
        )
        T = T.clone()
        T[1:-1, 1:-1, 1:-1] = c + lap * minv
    return T


def _entry(dtype):
    """The kernel's C entry for ``dtype``."""
    suffix, cfloat = _DTYPES[dtype]
    return _kernels.entry(
        "fused_diffusion", f"igg_fused_diffusion_{suffix}",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [cfloat] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p],
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


def fused_diffusion_steps(T, Cp, k: int, cx: float, cy: float, cz: float):
    """Advance ``k`` (even, 2..8) diffusion steps in one pass; returns a new T.

    ``cx = dt*lam/dx^2`` (likewise ``cy``, ``cz``).  CUDA tensors go through
    the kernel (contiguous, float32 or float64, every extent >= 3); CPU
    tensors through `fused_diffusion_steps_reference`.
    """
    global launches
    _validate(T, Cp, k)
    if T.device.type == "cpu":
        return fused_diffusion_steps_reference(T, Cp, k, cx, cy, cz)
    if T.device.type != "cuda":
        raise ValueError(f"fused_diffusion_steps runs on CUDA or CPU tensors, not {T.device}")
    if not (T.is_contiguous() and Cp.is_contiguous()):
        raise ValueError("fused_diffusion_steps needs contiguous T and Cp")
    n0, n1, n2 = T.shape
    bx, by, bz = tile = launch_tile(T.shape, k, T.element_size(), T.device)
    if grid(T.shape, tile)[1] > 65535:
        raise ValueError(f"block {tuple(T.shape)} exceeds the kernel's launch grid")
    fn = _entry(T.dtype)
    out = torch.empty_like(T)
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        code = fn(T.data_ptr(), Cp.data_ptr(), out.data_ptr(), n0, n1, n2, k,
                  cx, cy, cz, bx, by, bz, stream)
    _kernels.check("fused_diffusion", code, "fused_diffusion_steps launch")
    launches += 1
    return out
