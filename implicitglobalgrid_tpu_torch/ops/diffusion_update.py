"""The diffusion model's per-step update in one pass: ``csrc/diffusion_update.cu``.

One step of `models.diffusion3d` without its exchange: the Laplacian of T
times ``dt*lam / Cp`` added to every cell but the block's outermost ring,
which is copied.  The JAX package leaves this update to XLA, which fuses it
into one pass; in plain PyTorch it is about a dozen elementwise kernels and a
clone over whole fields.  Two versions of one function live here:

* `diffusion_update` launches the hand-written CUDA kernel for CUDA tensors
  of float32, float64, bfloat16 or float16 and runs the plain version for
  CPU tensors (and for meta tensors, which
  carry shapes only: `ops.overlap` learns its output shapes from them).
  For a CUDA tensor it launches the kernel or raises (`support_error`): it
  has no fallback.
* `diffusion_update_reference` is the plain PyTorch version, the model's
  update as it was written before the kernel.

Both take a block ``(n0, n1, n2)`` or a batch of B ``(B, n0, n1, n2)`` (T
and Cp alike: `models._batched`), and views: the kernel reads T and Cp
through their strides (z must be unit-stride), so `ops.overlap`'s boundary
windows and interior need no copy.  The result is a new contiguous tensor.

The kernel is built with ``--fmad=false``, does the plain version's
operations in its order and takes its constants rounded as torch rounds
them on the card (`coefficients`), so there the two agree bit for bit:
bfloat16 and float16 compute as torch's elementwise kernels do, each
operation in float32 and its result rounded to the field's type.  On
the CPU torch divides by ``dx*dx`` where the card multiplies by its
reciprocal, so the plain version itself differs between the two devices by
ULPs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _kernels
from . import overlap as _overlap

#: Launches of the CUDA kernel in this process (CPU calls of the plain
#: version do not count).
launches = 0

#: The dtypes the kernel takes: its entry's suffix and the C type of its
#: coefficients (float32 for the half types, which compute in it).
DTYPES = {torch.float32: ("f32", ctypes.c_float), torch.float64: ("f64", ctypes.c_double),
          torch.bfloat16: ("bf16", ctypes.c_float), torch.float16: ("f16", ctypes.c_float)}


def diffusion_update_reference(T, Cp, lam: float, dt: float, dx: float, dy: float, dz: float):
    """The update in plain PyTorch: the interior's Laplacian times ``dt*lam
    / Cp`` added to the interior, the outermost ring copied (the JAX
    package's padded-delta form ``T + pad(delta, 1)``)."""
    c = T[..., 1:-1, 1:-1, 1:-1]
    lap = (
        (T[..., 2:, 1:-1, 1:-1] - 2 * c + T[..., :-2, 1:-1, 1:-1]) / (dx * dx)
        + (T[..., 1:-1, 2:, 1:-1] - 2 * c + T[..., 1:-1, :-2, 1:-1]) / (dy * dy)
        + (T[..., 1:-1, 1:-1, 2:] - 2 * c + T[..., 1:-1, 1:-1, :-2]) / (dz * dz)
    )
    # A true division of the scalar by Cp (``scalar / tensor`` in torch
    # is a reciprocal times the scalar, which rounds differently).
    delta = torch.div(torch.tensor(dt * lam, dtype=T.dtype), Cp[..., 1:-1, 1:-1, 1:-1]) * lap
    out = T.clone()
    out[..., 1:-1, 1:-1, 1:-1] = c + delta
    return out


@functools.lru_cache(maxsize=64)
def coefficients(dtype, lam: float, dt: float, dx: float, dy: float,
                 dz: float) -> tuple[float, float, float, float]:
    """``(ix, iy, iz, s)`` as the plain version's CUDA ops use them: ``1 /
    (dx*dx)`` taken in double precision and rounded to the type torch
    computes ``dtype`` in (float32 for bfloat16 and float16; torch's CUDA
    division of a tensor by a Python scalar multiplies by that reciprocal),
    and ``dt*lam`` rounded to ``dtype``."""
    opmath = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
    return (*(float(torch.tensor(1.0 / (d * d), dtype=opmath)) for d in (dx, dy, dz)),
            float(torch.tensor(dt * lam, dtype=dtype)))


def support_error(T, Cp) -> str | None:
    """Why the kernel cannot take this pair of CUDA tensors, or None."""
    if T.dtype not in DTYPES:
        return f"dtype {T.dtype} is not float32, float64, bfloat16 or float16"
    if Cp.dtype != T.dtype:
        return f"T and Cp must share a dtype (got {T.dtype} and {Cp.dtype})"
    if T.shape != Cp.shape:
        return f"T and Cp must share a shape (got {tuple(T.shape)} and {tuple(Cp.shape)})"
    if T.device != Cp.device:
        return f"T and Cp must share a device (got {T.device} and {Cp.device})"
    if T.dim() not in (3, 4):
        return f"a block is (n0, n1, n2) or a batch (B, n0, n1, n2), not {tuple(T.shape)}"
    for name, a in (("T", T), ("Cp", Cp)):
        if a.shape[-1] > 1 and a.stride(-1) != 1:
            return (f"{name}'s z axis must be unit-stride (got strides {a.stride()}): the "
                    f"kernel reads rows along z")
    if max(T.shape) >= 2**31:
        return f"an extent of {tuple(T.shape)} exceeds the kernel's int indices"
    return None


def _strides(a) -> tuple[int, int, int]:
    """A field's (member, x, y) strides in elements (member 0 for a block)."""
    s = a.stride()
    return (0, *s[:2]) if a.dim() == 3 else s[:3]


def vector_width(T, Cp) -> int:
    """Cells a thread accesses at once: 16 bytes' worth where every pointer
    is 16-byte aligned and every stride and the z extent are multiples of
    it, else 1."""
    v = 16 // T.element_size()
    fits = T.shape[-1] % v == 0 and all(
        a.data_ptr() % 16 == 0 and all(s % v == 0 for s in _strides(a)) for a in (T, Cp))
    return v if fits else 1


def _entry(dtype):
    """The kernel's C entry for ``dtype``: pointers, members, (n0, n1, n2),
    T's and Cp's strides, vector width, coefficients, stream."""
    suffix, cfloat = DTYPES[dtype]
    return _kernels.entry(
        "diffusion_update", f"igg_diffusion_update_{suffix}",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_int]
        + [cfloat] * 4 + [ctypes.c_void_p],
    )


def diffusion_update(T, Cp, lam: float, dt: float, dx: float, dy: float, dz: float):
    """One diffusion update of T (no exchange); returns a new T.

    CUDA tensors go through the kernel (float32, float64, bfloat16 or
    float16, T and Cp of one shape, z unit-stride; anything else raises
    `ValueError`), CPU and meta
    tensors through `diffusion_update_reference`.  Forward-only: under grad
    mode with an input that requires grad it raises
    (`ops.overlap.check_forward_only`); the model differentiates it through
    `ops.overlap.fused_with_plain_grad`.
    """
    global launches
    _overlap.check_forward_only("diffusion_update", (T, Cp))
    if T.device.type in ("cpu", "meta"):
        return diffusion_update_reference(T, Cp, lam, dt, dx, dy, dz)
    if T.device.type != "cuda":
        raise ValueError(f"diffusion_update runs on CUDA or CPU tensors, not {T.device}")
    err = support_error(T, Cp)
    if err is not None:
        raise ValueError(f"diffusion_update: {err}")
    out = torch.empty(T.shape, dtype=T.dtype, device=T.device)
    if out.numel() == 0:
        return out
    nb = T.shape[0] if T.dim() == 4 else 1
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        code = _entry(T.dtype)(T.data_ptr(), Cp.data_ptr(), out.data_ptr(), nb, *T.shape[-3:],
                               *_strides(T), *_strides(Cp), vector_width(T, Cp),
                               *coefficients(T.dtype, lam, dt, dx, dy, dz), stream)
    _kernels.check("diffusion_update", code, "diffusion_update launch")
    launches += 1
    return out
