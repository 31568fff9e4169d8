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

#: Output tiles ``(bx, by, bz)`` in order of preference; the first whose
#: three shared-memory windows (T twice, 1/Cp once, each ``(b+2k)^3``-ish)
#: fit a block's 227 KB is used.
_TILES = ((8, 8, 32), (8, 8, 16), (4, 8, 16), (4, 4, 16), (4, 4, 8))
_SMEM_PER_BLOCK = 232448  # bytes of dynamic shared memory a Hopper block can use
_DTYPES = {torch.float32: ("f32", ctypes.c_float), torch.float64: ("f64", ctypes.c_double)}


def fused_support_error(shape, k: int, dtype) -> str | None:
    """Why the kernel cannot run this config, or None if it can."""
    if k % 2 or not 2 <= k <= 8:
        return f"k must be even and in [2, 8] (got {k})"
    if len(shape) != 3 or min(shape) < 3:
        return f"the block must be 3-D with every extent >= 3 (got {tuple(shape)})"
    if dtype not in _DTYPES:
        return f"dtype {dtype} is not float32 or float64"
    return None


def tile_for(shape, k: int, itemsize: int) -> tuple[int, int, int]:
    """The kernel's output tile for this block shape, ``k`` and item size."""
    for t in _TILES:
        window = 1
        for b, n in zip(t, shape):
            window *= min(b + 2 * k, n)
        if 3 * window * itemsize <= _SMEM_PER_BLOCK:
            return t
    raise ValueError(f"no kernel tile fits shared memory for k={k}, itemsize={itemsize}")


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
    bx, by, bz = tile_for(T.shape, k, T.element_size())
    if -(-n0 // bx) > 65535 or -(-n1 // by) > 65535:
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
