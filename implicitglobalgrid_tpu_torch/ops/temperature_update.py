"""The porous model's temperature update in one pass: ``csrc/temperature_update.cu``.

The T update of `models.porous_convection3d` without its exchange: upwind
advection by the face fluxes qDx, qDy, qDz plus diffusion, added to every
cell but the block's outermost ring, which is copied.  The JAX package
leaves this update to XLA, which fuses it into one pass; in plain PyTorch it
is about twenty elementwise kernels and a clone over whole fields.  Two
versions of one function live here:

* `temperature_update` launches the hand-written CUDA kernel for CUDA
  tensors of float32, float64, bfloat16 or float16 and runs the plain
  version for CPU tensors (and for meta tensors, which carry shapes only).
  For a CUDA tensor it launches the kernel or raises (`support_error`): it
  has no fallback.
* `temperature_update_reference` is the plain PyTorch version, the model's
  update as it was written before the kernel.

Both take a block, T ``(n0, n1, n2)`` with qDx ``(n0+1, n1, n2)``, qDy
``(n0, n1+1, n2)`` and qDz ``(n0, n1, n2+1)``, or a batch of B of them
(a leading B axis on every field: `models._batched`), and views: the kernel
reads every field through its strides (z must be unit-stride).  The result
is a new contiguous tensor.

The kernel is built with ``--fmad=false``, does the plain version's
operations in its order and takes its constants rounded as torch rounds
them on the card (`coefficients`), so there the two agree bit for bit:
bfloat16 and float16 compute as torch's elementwise kernels do, each
operation in float32 and its result rounded to the field's type.
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

_NAMES = ("T", "qDx", "qDy", "qDz")


def temperature_update_reference(T, qDx, qDy, qDz, lam: float, iphi: float, dt: float,
                                 dx: float, dy: float, dz: float):
    """The update in plain PyTorch: explicit upwind advection + diffusion
    of the interior, the outermost ring copied (frozen walls)."""
    c = T[..., 1:-1, 1:-1, 1:-1]
    lap = (
        (T[..., 2:, 1:-1, 1:-1] - 2 * c + T[..., :-2, 1:-1, 1:-1]) / (dx * dx)
        + (T[..., 1:-1, 2:, 1:-1] - 2 * c + T[..., 1:-1, :-2, 1:-1]) / (dy * dy)
        + (T[..., 1:-1, 1:-1, 2:] - 2 * c + T[..., 1:-1, 1:-1, :-2]) / (dz * dz)
    )
    # Upwind advective derivatives at interior cells from face fluxes.
    qxm, qxp = qDx[..., 1:-2, 1:-1, 1:-1], qDx[..., 2:-1, 1:-1, 1:-1]
    qym, qyp = qDy[..., 1:-1, 1:-2, 1:-1], qDy[..., 1:-1, 2:-1, 1:-1]
    qzm, qzp = qDz[..., 1:-1, 1:-1, 1:-2], qDz[..., 1:-1, 1:-1, 2:-1]
    adv = (
        qxm.clamp_min(0.0) * ((c - T[..., :-2, 1:-1, 1:-1]) / dx)
        + qxp.clamp_max(0.0) * ((T[..., 2:, 1:-1, 1:-1] - c) / dx)
        + qym.clamp_min(0.0) * ((c - T[..., 1:-1, :-2, 1:-1]) / dy)
        + qyp.clamp_max(0.0) * ((T[..., 1:-1, 2:, 1:-1] - c) / dy)
        + qzm.clamp_min(0.0) * ((c - T[..., 1:-1, 1:-1, :-2]) / dz)
        + qzp.clamp_max(0.0) * ((T[..., 1:-1, 1:-1, 2:] - c) / dz)
    )
    delta = dt * (lam * lap - iphi * adv)
    T = T.clone()
    T[..., 1:-1, 1:-1, 1:-1].add_(delta)
    return T


@functools.lru_cache(maxsize=64)
def coefficients(dtype, lam: float, iphi: float, dt: float, dx: float, dy: float,
                 dz: float) -> tuple[float, ...]:
    """``(rx2, ry2, rz2, rx, ry, rz, lam, iphi, dt)`` as the plain
    version's CUDA ops use them, in the type torch computes ``dtype`` in
    (float32 for bfloat16 and float16): torch's CUDA division of a tensor by
    a Python scalar ``d`` multiplies by ``1 / d`` taken in double precision
    and rounded to that type (``rx2`` is that of ``dx*dx``, ``rx`` of
    ``dx``), and a Python scalar multiplier is rounded to it."""
    rounded = DTYPES[dtype][1]  # ctypes rounds a double to the nearest float32
    return tuple(rounded(v).value for v in (*(1.0 / (d * d) for d in (dx, dy, dz)),
                                            *(1.0 / d for d in (dx, dy, dz)), lam, iphi, dt))


def support_error(T, qDx, qDy, qDz) -> str | None:
    """Why the kernel cannot take these CUDA tensors, or None."""
    fields = (T, qDx, qDy, qDz)
    if T.dtype not in DTYPES:
        return f"dtype {T.dtype} is not float32, float64, bfloat16 or float16"
    if T.dim() not in (3, 4):
        return f"a block is (n0, n1, n2) or a batch (B, n0, n1, n2), not {tuple(T.shape)}"
    for name, a in zip(_NAMES[1:], fields[1:]):
        if a.dtype != T.dtype:
            return f"T and {name} must share a dtype (got {T.dtype} and {a.dtype})"
        if a.device != T.device:
            return f"T and {name} must share a device (got {T.device} and {a.device})"
    lead, (n0, n1, n2) = tuple(T.shape[:-3]), tuple(T.shape[-3:])
    want = ((n0 + 1, n1, n2), (n0, n1 + 1, n2), (n0, n1, n2 + 1))
    for name, a, w in zip(_NAMES[1:], fields[1:], want):
        if tuple(a.shape) != lead + w:
            return (f"{name} of T {tuple(T.shape)} must be {lead + w} (the staggered face "
                    f"field), not {tuple(a.shape)}")
    for name, a in zip(_NAMES, fields):
        if a.shape[-1] > 1 and a.stride(-1) != 1:
            return (f"{name}'s z axis must be unit-stride (got strides {a.stride()}): the "
                    f"kernel reads rows along z")
    if max(max(a.shape) for a in fields) >= 2**31:
        return f"an extent of {tuple(T.shape)} exceeds the kernel's int indices"
    return None


def _strides(a) -> tuple[int, int, int]:
    """A field's (member, x, y) strides in elements (member 0 for a block)."""
    s = a.stride()
    return (0, *s[:2]) if a.dim() == 3 else s[:3]


def vector_width(T, qDx, qDy) -> int:
    """Cells a thread accesses at once: 16 bytes' worth where T's, qDx's and
    qDy's pointers are 16-byte aligned and their strides and the z extent
    are multiples of it, else 1.  qDz is read a cell at a time: its rows
    are n2 + 1 long."""
    v = 16 // T.element_size()
    fits = T.shape[-1] % v == 0 and all(
        a.data_ptr() % 16 == 0 and all(s % v == 0 for s in _strides(a)) for a in (T, qDx, qDy))
    return v if fits else 1


def _entry(dtype):
    """The kernel's C entry for ``dtype``: pointers, members, (n0, n1, n2),
    the 12 strides, vector width, the 9 coefficients, stream."""
    suffix, cfloat = DTYPES[dtype]
    return _kernels.entry(
        "temperature_update", f"igg_temperature_update_{suffix}",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.POINTER(cfloat),
           ctypes.c_void_p],
    )


def _launch(out, T, qDx, qDy, qDz, co) -> None:
    """One launch of the kernel into ``out`` (a new contiguous tensor)."""
    cfloat = DTYPES[T.dtype][1]
    strides = (ctypes.c_longlong * 12)(*(s for a in (T, qDx, qDy, qDz) for s in _strides(a)))
    nb = T.shape[0] if T.dim() == 4 else 1
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        code = _entry(T.dtype)(T.data_ptr(), qDx.data_ptr(), qDy.data_ptr(), qDz.data_ptr(),
                               out.data_ptr(), nb, *T.shape[-3:], strides,
                               vector_width(T, qDx, qDy), (cfloat * 9)(*co), stream)
    _kernels.check("temperature_update", code, "temperature_update launch")


def temperature_update(T, qDx, qDy, qDz, lam: float, iphi: float, dt: float, dx: float,
                       dy: float, dz: float):
    """One temperature update of T (no exchange); returns a new T.

    CUDA tensors go through the kernel (float32, float64, bfloat16 or
    float16, the four fields of one dtype and device with the face fields'
    staggered shapes, z unit-stride; anything else raises `ValueError`), CPU
    and meta tensors through `temperature_update_reference`.  Forward-only:
    under grad mode with an input that requires grad it raises
    (`ops.overlap.check_forward_only`); the model differentiates it through
    `ops.overlap.fused_with_plain_grad`.
    """
    global launches
    fields = (T, qDx, qDy, qDz)
    _overlap.check_forward_only("temperature_update", fields)
    if T.device.type in ("cpu", "meta"):
        return temperature_update_reference(*fields, lam, iphi, dt, dx, dy, dz)
    if T.device.type != "cuda":
        raise ValueError(f"temperature_update runs on CUDA or CPU tensors, not {T.device}")
    err = support_error(*fields)
    if err is not None:
        raise ValueError(f"temperature_update: {err}")
    out = torch.empty(T.shape, dtype=T.dtype, device=T.device)
    if out.numel() == 0:
        return out
    _launch(out, *fields, coefficients(T.dtype, lam, iphi, dt, dx, dy, dz))
    launches += 1
    return out
