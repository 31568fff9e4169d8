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
operations in its order, so on the card the two agree bit for bit.  Both
versions take a launch tile and a subset launch (``tile``, ``tile_sel``,
``carry_in``; see `ops.fused_stencil` and `ops.overlap`).
"""

from __future__ import annotations

from .fused_leapfrog import (  # noqa: F401  (re-export: one envelope and layout)
    default_tile,
    divergence,
    face_shapes,
    fused_support_error,
    launch,
    pad_faces,
    padded_face_shapes,
    subset_of,
    tile_for,
    unpad_faces,
    validate,
)

#: Launches of the CUDA kernel in this process (CPU calls of the plain
#: version do not count).
launches = 0


def fused_pt_iterations_reference(T, Pf, qDx, qDy, qDz, k: int, th: float, idx: float,
                                  idy: float, idz: float, ralam: float, bp: float, *,
                                  tile=None, tile_sel: str = "all", carry_in=None):
    """``k`` PT iterations with the kernel's constant folding (plain
    PyTorch), on a block or a batch of them; a subset launch copies the
    subset's owned region of the full result into ``carry_in`` (or fresh
    tensors)."""
    buoyancy = ralam * (0.5 * (T[..., 1:-1, 1:-1, 1:] + T[..., 1:-1, 1:-1, :-1]))
    for _ in range(k):
        fx = -idx * (Pf[..., 1:, 1:-1, 1:-1] - Pf[..., :-1, 1:-1, 1:-1])
        fy = -idy * (Pf[..., 1:-1, 1:, 1:-1] - Pf[..., 1:-1, :-1, 1:-1])
        fz = -idz * (Pf[..., 1:-1, 1:-1, 1:] - Pf[..., 1:-1, 1:-1, :-1]) + buoyancy
        qDx, qDy, qDz = qDx.clone(), qDy.clone(), qDz.clone()
        for q, f in ((qDx, fx), (qDy, fy), (qDz, fz)):
            inner = q[..., 1:-1, 1:-1, 1:-1]
            inner += th * (f - inner)
        Pf = Pf - bp * divergence(qDx, qDy, qDz, idx, idy, idz)
    return subset_of((Pf, qDx, qDy, qDz), k, tile, tile_sel, carry_in)


def fused_pt_iterations(T, Pf, qDx, qDy, qDz, k: int, th: float, idx: float, idy: float,
                        idz: float, ralam: float, bp: float, *, tile=None,
                        tile_sel: str = "all", carry_in=None):
    """Advance ``k`` (even, 2..8) PT iterations in one pass; returns new
    ``(Pf, qDx, qDy, qDz)`` (``T`` is read-only).  Every field may carry
    one leading batch axis (B members, one launch).

    ``th`` = flux relaxation, ``idx = 1/dx`` (likewise ``idy``, ``idz``),
    ``ralam = Ra*lam_T`` (buoyancy), ``bp`` = pressure relaxation.  CUDA
    tensors go through the kernel (contiguous, float32 or float64, every
    extent >= 3); CPU tensors through `fused_pt_iterations_reference`.
    ``tile``, ``tile_sel`` and ``carry_in`` as in
    `ops.fused_stencil.fused_diffusion_steps`.
    """
    global launches
    tile, carry = validate((Pf, T), (qDx, qDy, qDz), k, "fused_pt_iterations", tile=tile,
                           tile_sel=tile_sel, carry_in=carry_in)
    coeffs = (th, idx, idy, idz, ralam, bp)
    if Pf.device.type == "cpu":
        return fused_pt_iterations_reference(T, Pf, qDx, qDy, qDz, k, *coeffs, tile=tile,
                                             tile_sel=tile_sel, carry_in=carry)
    outs = launch("fused_pt", (T, Pf, qDx, qDy, qDz), (Pf, qDx, qDy, qDz), k, coeffs, tile,
                  tile_sel, carry)
    launches += 1
    return outs
