"""3-D heat diffusion — the flagship model (reference `examples/diffusion3D_*.jl`).

Heat diffusion with spatially variable heat capacity and two Gaussian
anomalies, solved with a conservative finite-difference stencil on the
implicit global grid:

    q      = -lam * grad(T)              (Fourier's law)
    dT/dt  = -(1/Cp) * div(q)            (conservation of energy)
    T     += dt * dT/dt                  (explicit Euler, interior points only)

Each process advances its own local block; `update_halo` refreshes the
overlap.  ``make_multi_step(fused_k=k)`` runs ``k`` steps per memory pass in
the hand-written CUDA kernel (`ops.fused_stencil`), then exchanges a
width-``k`` slab on a deep-halo grid (``overlap >= 2k``).

Usage::

    import implicitglobalgrid_tpu_torch.models.diffusion3d as m
    state, params = m.setup(256, 256, 256)
    step = m.make_multi_step(params, 16, fused_k=4)
    T, Cp = step(*state)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.fused_stencil import fused_diffusion_steps
from ..ops.halo import dim_has_halo_activity, require_deep_halo, update_halo
from ..parallel.grid import global_grid, init_global_grid
from ..utils.fields import block_from_numpy, coord_fields, zeros
from ..utils.tools import nx_g, ny_g, nz_g
from . import _common


@dataclasses.dataclass(frozen=True)
class Params:
    """Physics + numerics of the run."""

    lam: float = 1.0  # thermal conductivity
    cp_min: float = 1.0  # minimal heat capacity
    lx: float = 10.0
    ly: float = 10.0
    lz: float = 10.0
    dx: float = 0.0
    dy: float = 0.0
    dz: float = 0.0
    dt: float = 0.0
    dtype: Any = None  # a torch dtype
    hide_comm: bool = False


def params_from(other) -> Params:
    """A `Params` from any object with the same field names — e.g. the JAX
    package's ``diffusion3d.Params`` (its numpy/JAX dtype becomes the
    matching torch dtype)."""
    return _common.params_from(Params, other)


def state_from_numpy(T, Cp, *, coords=None, device=None):
    """This rank's ``(T, Cp)`` block tensors from numpy fields, given either
    as one block or in the JAX package's global-block layout (see
    `utils.fields.block_from_numpy`)."""
    return (
        block_from_numpy(T, coords=coords, device=device),
        block_from_numpy(Cp, coords=coords, device=device),
    )


def _gaussians(X, Y, Z, params: Params):
    """The reference's two pairs of Gaussian anomalies."""
    lx, ly, lz = params.lx, params.ly, params.lz
    cp = params.cp_min + (
        5 * torch.exp(-((X - lx / 1.5) ** 2) - (Y - ly / 2) ** 2 - (Z - lz / 1.5) ** 2)
        + 5 * torch.exp(-((X - lx / 3.0) ** 2) - (Y - ly / 2) ** 2 - (Z - lz / 1.5) ** 2)
    )
    t = 100 * torch.exp(
        -(((X - lx / 2) / 2) ** 2) - ((Y - ly / 2) / 2) ** 2 - ((Z - lz / 3.0) / 2) ** 2
    ) + 50 * torch.exp(
        -(((X - lx / 2) / 2) ** 2) - ((Y - ly / 2) / 2) ** 2 - ((Z - lz / 1.5) / 2) ** 2
    )
    return cp, t


def setup(
    nx: int = 128,
    ny: int = 128,
    nz: int = 128,
    *,
    lam: float = 1.0,
    cp_min: float = 1.0,
    lx: float = 10.0,
    ly: float = 10.0,
    lz: float = 10.0,
    dtype=None,
    hide_comm: bool = False,
    init_grid: bool = True,
    ic_scale: float = 1.0,
    **grid_kwargs,
):
    """Initialize the global grid (unless ``init_grid=False``) and the fields.

    Returns ``(state, params)`` with ``state = (T, Cp)``, this rank's blocks
    holding the reference's initial conditions.  ``dtype`` defaults to
    torch's default dtype; ``ic_scale`` scales the initial temperature
    anomaly.
    """
    if hide_comm:
        _common.later("hide_comm", "9")
    if init_grid:
        init_global_grid(nx, ny, nz, **grid_kwargs)
    if dtype is None:
        dtype = torch.get_default_dtype()
    dx = lx / (nx_g() - 1)
    dy = ly / (ny_g() - 1)
    dz = lz / (nz_g() - 1)
    dt = min(dx * dx, dy * dy, dz * dz) * cp_min / lam / 8.1
    params = Params(
        lam=lam, cp_min=cp_min, lx=lx, ly=ly, lz=lz,
        dx=dx, dy=dy, dz=dz, dt=dt, dtype=dtype, hide_comm=hide_comm,
    )
    T = zeros((nx, ny, nz), dtype)
    X, Y, Z = coord_fields(T, (dx, dy, dz), dtype=dtype)
    cp, t = _gaussians(X, Y, Z, params)
    return ((ic_scale * t).to(dtype), cp.to(dtype)), params


def _diffusion_update(params: Params):
    """Per-block T update without exchange: the Laplacian of the interior
    added to the interior, the outermost ring frozen (the JAX package's
    padded-delta form ``T + pad(delta, 1)``)."""
    lam, dt = params.lam, params.dt
    dx, dy, dz = params.dx, params.dy, params.dz

    def update(T, Cp):
        c = T[1:-1, 1:-1, 1:-1]
        lap = (
            (T[2:, 1:-1, 1:-1] - 2 * c + T[:-2, 1:-1, 1:-1]) / (dx * dx)
            + (T[1:-1, 2:, 1:-1] - 2 * c + T[1:-1, :-2, 1:-1]) / (dy * dy)
            + (T[1:-1, 1:-1, 2:] - 2 * c + T[1:-1, 1:-1, :-2]) / (dz * dz)
        )
        # A true division of the scalar by Cp (``scalar / tensor`` in torch
        # is a reciprocal times the scalar, which rounds differently).
        delta = torch.div(torch.tensor(dt * lam, dtype=T.dtype), Cp[1:-1, 1:-1, 1:-1]) * lap
        out = T.clone()
        out[1:-1, 1:-1, 1:-1] = c + delta
        return out

    return update


def make_step(params: Params, *, batch: bool = False):
    """One time step ``(T, Cp) -> (T, Cp)``: stencil update + halo exchange."""
    if batch:
        _common.later("batch=True", "10")
    if params.hide_comm:
        _common.later("hide_comm", "9")
    update = _diffusion_update(params)

    def step(T, Cp):
        return update_halo(update(T, Cp)), Cp

    return step


def make_multi_step(
    params: Params,
    nsteps: int,
    *,
    fused_k: int | None = None,
    exchange_every: int = 1,
    pipelined: bool | None = None,
    batch: bool = False,
    autotune: bool | None = None,
):
    """``(T, Cp) -> (T, Cp)`` advanced by ``nsteps`` steps.

    ``exchange_every=w``: on a deep-halo grid (``overlap >= 2w`` in every
    dimension with halo activity) run ``w`` stencil steps between halo
    exchanges and exchange a width-``w`` slab — the ``w``-deep stale rind
    each block accumulates is exactly the slab the exchange replaces.

    ``fused_k=k``: advance ``k`` steps per memory pass with the CUDA kernel
    (`ops.fused_stencil.fused_diffusion_steps`), then exchange one
    width-``k`` slab (``overlap >= 2k`` in every dimension with halo
    activity); on a grid with no halo activity the kernel runs alone.
    Requires ``nsteps % k == 0``.  A ``k``, dtype or block the kernel does
    not take raises `ValueError`: there is no plain-cadence fallback.

    ``pipelined=True``, ``batch=True`` and ``autotune`` come with later
    slices and raise `NotImplementedError`.
    """
    if batch:
        _common.later("batch=True", "10")
    if autotune:
        _common.later("autotune", "15")
    if pipelined:
        _common.later("pipelined=True", "9")
    if params.hide_comm:
        _common.later("hide_comm", "9")
    update = _diffusion_update(params)
    gg = global_grid()

    def slab_cadence(T, Cp, w):
        for _ in range(nsteps // w):
            for _ in range(w):
                T = update(T, Cp)
            T = update_halo(T, width=w)
        return T, Cp

    if fused_k:
        if nsteps % fused_k != 0:
            raise ValueError(f"nsteps={nsteps} must be a multiple of fused_k={fused_k}")
        if exchange_every not in (1, fused_k):
            raise ValueError(
                f"fused_k={fused_k} already exchanges every fused_k steps; "
                f"exchange_every={exchange_every} conflicts."
            )
        require_deep_halo(fused_k, gg, what="fused_k")
        active = any(dim_has_halo_activity(gg, d) for d in range(3))
        cx = params.dt * params.lam / (params.dx * params.dx)
        cy = params.dt * params.lam / (params.dy * params.dy)
        cz = params.dt * params.lam / (params.dz * params.dz)

        def fused_multi_step(T, Cp):
            for _ in range(nsteps // fused_k):
                T = fused_diffusion_steps(T, Cp, fused_k, cx, cy, cz)
                # One slab exchange licenses the next k steps: the kernel's
                # k-deep stale rind is exactly what the width-k exchange
                # refreshes, from planes k steps still kept exact.
                if active:
                    T = update_halo(T, width=fused_k)
            return T, Cp

        return fused_multi_step

    if exchange_every < 1:
        raise ValueError(f"exchange_every must be >= 1 (got {exchange_every})")
    if exchange_every > 1:
        if nsteps % exchange_every != 0:
            raise ValueError(
                f"nsteps={nsteps} must be a multiple of exchange_every={exchange_every}"
            )
        require_deep_halo(exchange_every, gg)
    return lambda T, Cp: slab_cadence(T, Cp, exchange_every)


def run(nt: int, nx: int = 128, ny: int = 128, nz: int = 128, *,
        finalize: bool = True, **setup_kwargs):
    """End-to-end run (the reference's ``diffusion3D()`` without
    visualization): ``nt`` steps of `make_step`; returns this rank's final T.
    The JAX package's resilience hooks (``guard_every``, ``checkpoint_*``,
    ...) come with a later slice and raise `NotImplementedError`."""
    return _common.run(setup, make_step, nt, (nx, ny, nz), finalize, setup_kwargs)


def temperature(state):
    return state[0]
