"""Temporally blocked pseudo-transient iterations: ``k`` per memory pass.

Counterpart of the JAX package's ``ops/pallas_pt.py``, the porous sibling of
`ops.fused_leapfrog` (same staggered fields, envelope, frozen faces and
tiles; one more read-only cell input ``T``, and the PT flux formula):

* `fused_pt_iterations` launches the hand-written CUDA kernel
  ``csrc/fused_pt.cu`` for CUDA tensors and runs the plain version for CPU
  tensors.  It raises on anything the kernel does not take; it has no
  fallback for a CUDA tensor.
* `fused_pt_iterations_reference` is the plain PyTorch version: ``k``
  applications of the TPU kernel's iteration with its exact constant
  folding — ``f = -idx*(dPf)`` (z faces: ``-idz*(dPf) + ralam*(0.5*(T[k] +
  T[k-1]))``), ``q += th*(f - q)`` at interior faces, then ``Pf -=
  bp*div(q)`` at every cell — deliberately not the model's ``/dx`` form.

The kernel is built with ``--fmad=false`` and does the plain version's
operations in its order, so on the card the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels
from .fused_leapfrog import (  # noqa: F401  (re-export: one envelope and layout)
    _DTYPES,
    face_shapes,
    fused_support_error,
    pad_faces,
    padded_face_shapes,
    tile_for,
    unpad_faces,
    validate,
)

#: Launches of the CUDA kernel in this process (CPU calls of the plain
#: version do not count).
launches = 0


def fused_pt_iterations_reference(T, Pf, qDx, qDy, qDz, k: int, th: float, idx: float,
                                  idy: float, idz: float, ralam: float, bp: float):
    """``k`` PT iterations with the kernel's constant folding (plain PyTorch)."""
    buoyancy = ralam * (0.5 * (T[1:-1, 1:-1, 1:] + T[1:-1, 1:-1, :-1]))
    for _ in range(k):
        fx = -idx * (Pf[1:, 1:-1, 1:-1] - Pf[:-1, 1:-1, 1:-1])
        fy = -idy * (Pf[1:-1, 1:, 1:-1] - Pf[1:-1, :-1, 1:-1])
        fz = -idz * (Pf[1:-1, 1:-1, 1:] - Pf[1:-1, 1:-1, :-1]) + buoyancy
        qDx, qDy, qDz = qDx.clone(), qDy.clone(), qDz.clone()
        for q, f in ((qDx, fx), (qDy, fy), (qDz, fz)):
            inner = q[1:-1, 1:-1, 1:-1]
            inner += th * (f - inner)
        div = (
            (qDx[1:] - qDx[:-1]) * idx + (qDy[:, 1:] - qDy[:, :-1]) * idy
        ) + (qDz[:, :, 1:] - qDz[:, :, :-1]) * idz
        Pf = Pf - bp * div
    return Pf, qDx, qDy, qDz


def fused_pt_iterations(T, Pf, qDx, qDy, qDz, k: int, th: float, idx: float, idy: float,
                        idz: float, ralam: float, bp: float):
    """Advance ``k`` (even, 2..8) PT iterations in one pass; returns new
    ``(Pf, qDx, qDy, qDz)`` (``T`` is read-only).

    ``th`` = flux relaxation, ``idx = 1/dx`` (likewise ``idy``, ``idz``),
    ``ralam = Ra*lam_T`` (buoyancy), ``bp`` = pressure relaxation.  CUDA
    tensors go through the kernel (contiguous, float32 or float64, every
    extent >= 3); CPU tensors through `fused_pt_iterations_reference`.
    """
    global launches
    validate((Pf, T), (qDx, qDy, qDz), k, "fused_pt_iterations")
    coeffs = (th, idx, idy, idz, ralam, bp)
    if Pf.device.type == "cpu":
        return fused_pt_iterations_reference(T, Pf, qDx, qDy, qDz, k, *coeffs)
    suffix, cfloat = _DTYPES[Pf.dtype]
    fn = _kernels.entry(
        "fused_pt", f"igg_fused_pt_{suffix}",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [cfloat] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_void_p],
    )
    outs = tuple(torch.empty_like(a) for a in (Pf, qDx, qDy, qDz))
    with torch.cuda.device(Pf.device):
        stream = torch.cuda.current_stream(Pf.device).cuda_stream
        code = fn(*(a.data_ptr() for a in (T, Pf, qDx, qDy, qDz, *outs)), *Pf.shape, k,
                  *coeffs, *tile_for(Pf.shape, k, Pf.element_size()), stream)
    _kernels.check("fused_pt", code, "fused_pt_iterations launch")
    launches += 1
    return outs
