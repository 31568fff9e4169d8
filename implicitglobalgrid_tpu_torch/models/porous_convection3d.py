"""3-D porous convection (the JAX package's BASELINE config 4, the
HydroMech3D weak-scaling analogue).

Darcy flow with Boussinesq buoyancy plus temperature advection-diffusion:

* **Pseudo-transient pressure solve**: each time step runs ``npt``
  relaxation iterations of the Darcy flux / fluid pressure pair, with a
  halo exchange of ``Pf`` (one cell field) per iteration; one 3-field flux
  exchange at the end of the loop restores the all-duplicated-cells-agree
  invariant for the frozen face rings.
* **Staggered fields**: Darcy fluxes live on cell faces (``n+1`` shapes).
* **Buoyancy**: ``qD = -k/eta * (grad(Pf) - Ra_hat * T * e_z)``.
* **Temperature**: explicit upwind advection + diffusion of the interior,
  then a halo exchange; frozen boundary planes are the walls.

State: ``(T, Pf, qDx, qDy, qDz)``.  ``make_multi_step(fused_k=w)`` runs the
PT iterations between slab exchanges in the hand-written CUDA kernel
(`ops.fused_pt`).

Usage::

    import implicitglobalgrid_tpu_torch.models.porous_convection3d as m
    state, params = m.setup(256, 256, 256, npt=12, periodz=1,
                            overlapx=14, overlapy=14, overlapz=14)
    state = m.make_multi_step(params, 2, fused_k=6)(*state)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.fused_pt import fused_pt_iterations
from ..ops.halo import dim_has_halo_activity, require_deep_halo, update_halo
from ..parallel.grid import global_grid, init_global_grid
from ..utils.fields import block_from_numpy, coord_fields, zeros
from ..utils.tools import nx_g, ny_g, nz_g
from . import _common


@dataclasses.dataclass(frozen=True)
class Params:
    Ra: float = 1000.0  # Rayleigh number
    lx: float = 2.0
    ly: float = 1.0
    lz: float = 1.0
    dT: float = 1.0  # temperature contrast bottom-top
    phi: float = 0.1  # porosity
    lam_T: float = 1.0 / 1000.0  # effective thermal diffusivity (1/Ra)
    dx: float = 0.0
    dy: float = 0.0
    dz: float = 0.0
    dt: float = 0.0
    theta_q: float = 0.5  # PT relaxation for fluxes
    beta_p: float = 0.0  # PT relaxation for pressure (set in setup)
    npt: int = 20  # PT iterations per time step
    dtype: Any = None  # a torch dtype
    hide_comm: bool = False


def params_from(other) -> Params:
    """A `Params` from any object with the same field names — e.g. the JAX
    package's ``porous_convection3d.Params``."""
    return _common.params_from(Params, other)


def state_from_numpy(T, Pf, qDx, qDy, qDz, *, coords=None, device=None):
    """This rank's ``(T, Pf, qDx, qDy, qDz)`` block tensors from numpy
    fields, each given either as one block or in the JAX package's
    global-block layout (see `utils.fields.block_from_numpy`)."""
    nx, ny, nz = global_grid().nxyz
    shapes = ((nx, ny, nz),) * 2 + ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    return tuple(
        block_from_numpy(a, s, coords=coords, device=device)
        for a, s in zip((T, Pf, qDx, qDy, qDz), shapes)
    )


def _inn(A):
    return A[1:-1, 1:-1, 1:-1]


def setup(
    nx: int = 32,
    ny: int = 32,
    nz: int = 32,
    *,
    Ra: float = 1000.0,
    lx: float = 2.0,
    ly: float = 1.0,
    lz: float = 1.0,
    dT: float = 1.0,
    npt: int = 20,
    dtype=None,
    hide_comm: bool = False,
    init_grid: bool = True,
    ic_scale: float = 1.0,
    **grid_kwargs,
):
    """Initialize the grid (unless ``init_grid=False``) and the fields: a
    linear conductive T profile with a central Gaussian perturbation, zero
    pressure and fluxes.  Returns ``(state, params)``.  ``ic_scale`` scales
    the perturbation."""
    if hide_comm:
        _common.later("hide_comm", "9")
    if init_grid:
        init_global_grid(nx, ny, nz, **grid_kwargs)
    if dtype is None:
        dtype = torch.get_default_dtype()
    dx = lx / (nx_g() - 1)
    dy = ly / (ny_g() - 1)
    dz = lz / (nz_g() - 1)
    lam_T = 1.0 / Ra
    dmin = min(dx, dy, dz)
    # Fixed dt bounded by the diffusive and the advective limit, with the
    # buoyancy-limited flux scale q_scale = Ra*lam_T*dT.
    phi = 0.1
    q_scale = Ra * lam_T * dT
    dt = min(dmin**2 / lam_T / 8.1, phi * dmin / (3.0 * q_scale))
    # Pressure relaxation: beta*theta*k^2 <= 2 with the 3-D staggered
    # Laplacian's spectral bound k^2 <= 4*(1/dx^2 + 1/dy^2 + 1/dz^2).
    theta_q = 0.5
    k2_max = 4.0 * (1.0 / dx**2 + 1.0 / dy**2 + 1.0 / dz**2)
    beta_p = 0.9 * 2.0 / (theta_q * k2_max)
    params = Params(
        Ra=Ra, lx=lx, ly=ly, lz=lz, dT=dT, phi=phi, lam_T=lam_T,
        dx=dx, dy=dy, dz=dz, dt=dt, theta_q=theta_q, beta_p=beta_p,
        npt=int(npt), dtype=dtype, hide_comm=hide_comm,
    )
    T0 = zeros((nx, ny, nz), dtype)
    X, Y, Z = coord_fields(T0, (dx, dy, dz), dtype=dtype)
    prof = dT / 2 - dT * Z / lz  # hot bottom (+dT/2) to cold top (-dT/2)
    pert = 0.1 * dT * torch.exp(
        -(((X - lx / 2) / 0.1) ** 2) - ((Y - ly / 2) / 0.1) ** 2 - ((Z - lz / 2) / 0.1) ** 2
    )
    T = (prof + ic_scale * pert).to(dtype)
    Pf = zeros((nx, ny, nz), dtype)
    qDx = zeros((nx + 1, ny, nz), dtype)
    qDy = zeros((nx, ny + 1, nz), dtype)
    qDz = zeros((nx, ny, nz + 1), dtype)
    return (T, Pf, qDx, qDy, qDz), params


def _flux_update(params: Params):
    """Per-block Darcy flux relaxation without exchange: interior faces only
    (boundary faces frozen, the no-flow walls)."""
    th = params.theta_q
    dx, dy, dz = params.dx, params.dy, params.dz

    def update(T, Pf, qDx, qDy, qDz):
        # Relaxation toward -grad(Pf) + Ra*lam_T * T (averaged onto z faces).
        fx = -torch.diff(Pf[:, 1:-1, 1:-1], dim=0) / dx
        fy = -torch.diff(Pf[1:-1, :, 1:-1], dim=1) / dy
        tz = 0.5 * (T[1:-1, 1:-1, 1:] + T[1:-1, 1:-1, :-1])
        fz = -torch.diff(Pf[1:-1, 1:-1, :], dim=2) / dz + params.Ra * params.lam_T * tz
        out = []
        for q, f in ((qDx, fx), (qDy, fy), (qDz, fz)):
            delta = th * (f - _inn(q))
            q = q.clone()
            _inn(q).add_(delta)
            out.append(q)
        return tuple(out)

    return update


def _pressure_update(params: Params):
    """Per-block pressure relaxation: all cells, from fresh fluxes (halo
    cells get overwritten by the ``Pf`` exchange)."""
    bp = params.beta_p
    dx, dy, dz = params.dx, params.dy, params.dz

    def update(Pf, qDx, qDy, qDz):
        div = (
            torch.diff(qDx, dim=0) / dx
            + torch.diff(qDy, dim=1) / dy
            + torch.diff(qDz, dim=2) / dz
        )
        return Pf - bp * div

    return update


def _pt_iteration(params: Params):
    """One PT relaxation: flux update (+buoyancy) on interior faces,
    pressure update at all cells, halo exchange of ``Pf`` alone (the fluxes'
    interior faces are recomputed from post-exchange ``Pf`` each
    iteration)."""
    flux_update = _flux_update(params)
    p_update = _pressure_update(params)

    def iteration(T, Pf, qDx, qDy, qDz):
        qDx, qDy, qDz = flux_update(T, Pf, qDx, qDy, qDz)
        return update_halo(p_update(Pf, qDx, qDy, qDz)), qDx, qDy, qDz

    return iteration


def _temperature_update(params: Params):
    """Explicit upwind advection + diffusion of T (interior), frozen walls."""
    dx, dy, dz = params.dx, params.dy, params.dz
    lam = params.lam_T
    iphi = 1.0 / params.phi
    dt = params.dt

    def update(T, qDx, qDy, qDz):
        c = _inn(T)
        lap = (
            (T[2:, 1:-1, 1:-1] - 2 * c + T[:-2, 1:-1, 1:-1]) / (dx * dx)
            + (T[1:-1, 2:, 1:-1] - 2 * c + T[1:-1, :-2, 1:-1]) / (dy * dy)
            + (T[1:-1, 1:-1, 2:] - 2 * c + T[1:-1, 1:-1, :-2]) / (dz * dz)
        )
        # Upwind advective derivatives at interior cells from face fluxes.
        qxm, qxp = qDx[1:-2, 1:-1, 1:-1], qDx[2:-1, 1:-1, 1:-1]
        qym, qyp = qDy[1:-1, 1:-2, 1:-1], qDy[1:-1, 2:-1, 1:-1]
        qzm, qzp = qDz[1:-1, 1:-1, 1:-2], qDz[1:-1, 1:-1, 2:-1]
        adv = (
            qxm.clamp_min(0.0) * ((c - T[:-2, 1:-1, 1:-1]) / dx)
            + qxp.clamp_max(0.0) * ((T[2:, 1:-1, 1:-1] - c) / dx)
            + qym.clamp_min(0.0) * ((c - T[1:-1, :-2, 1:-1]) / dy)
            + qyp.clamp_max(0.0) * ((T[1:-1, 2:, 1:-1] - c) / dy)
            + qzm.clamp_min(0.0) * ((c - T[1:-1, 1:-1, :-2]) / dz)
            + qzp.clamp_max(0.0) * ((T[1:-1, 1:-1, 2:] - c) / dz)
        )
        delta = dt * (lam * lap - iphi * adv)
        T = T.clone()
        _inn(T).add_(delta)
        return T

    return update


def _build_block_step(params: Params):
    """One whole time step at the per-iteration exchange cadence: ``npt``
    PT iterations (each exchanging ``Pf``), the once-per-step 3-field flux
    exchange, then the T update and its exchange."""
    pt_iter = _pt_iteration(params)
    t_update = _temperature_update(params)

    def block_step(T, Pf, qDx, qDy, qDz):
        for _ in range(params.npt):
            Pf, qDx, qDy, qDz = pt_iter(T, Pf, qDx, qDy, qDz)
        qDx, qDy, qDz = update_halo(qDx, qDy, qDz)
        T = update_halo(t_update(T, qDx, qDy, qDz))
        return T, Pf, qDx, qDy, qDz

    return block_step


def make_step(params: Params, *, batch: bool = False):
    """One time step: ``npt`` PT pressure iterations + the T update (see
    `_build_block_step`)."""
    if batch:
        _common.later("batch=True", "10")
    if params.hide_comm:
        _common.later("hide_comm", "9")
    return _build_block_step(params)


def _pt_schedule(npt: int, w: int, *, even: bool = True):
    """Chunk ``npt`` PT iterations into groups of at most ``w``: ``(lead,
    chunks)``.

    ``even=True`` (the fused cadence — the kernel takes even k): ``lead``
    (0 or 1) per-iteration-exchanged plain iterations for odd ``npt``, then
    greedy even chunks; ``w < 2`` admits no kernel chunk at all.
    ``even=False`` (the plain ``exchange_every`` cadence): plain greedy
    chunks.  Every chunk is followed by a width-``w`` exchange.
    """
    if even and w < 2:
        return npt, []
    lead = npt % 2 if even else 0
    rem = npt - lead
    chunks = []
    while rem > 0:
        ki = min(w, rem)
        if even and ki % 2:
            ki -= 1
        chunks.append(ki)
        rem -= ki
    return lead, chunks


def make_multi_step(
    params: Params,
    nsteps: int,
    *,
    exchange_every: int = 1,
    fused_k: int | None = None,
    pipelined: bool | None = None,
    batch: bool = False,
    coalesce: bool | None = None,
    autotune: bool | None = None,
):
    """``(T, Pf, qDx, qDy, qDz)`` advanced by ``nsteps`` (<= 64) time steps.

    ``exchange_every=w`` (deep-halo grids, ``overlap >= 2w``): the PT loop
    runs up to ``w`` iterations between exchanges, then slab-exchanges all
    four PT fields (``Pf`` and the fluxes, whose relaxation history goes
    stale in the rind) at width ``w``; ``npt`` is chunked greedily
    (`_pt_schedule` with ``even=False``).

    ``fused_k=w``: the same cadence with the PT iterations between
    exchanges run by the CUDA kernel (`ops.fused_pt.fused_pt_iterations`):
    ``lead`` (``npt % 2``) plain iterations, each followed by a width-1
    exchange of the four PT fields, then even kernel chunks of at most ``w``
    iterations, each followed by a width-``w`` exchange of all four fields
    (even when the chunk is shorter), then the T update and its exchange.
    On a grid with no halo activity the kernel runs alone.  A dtype or block
    the kernel does not take, or an ``npt`` that leaves no even chunk,
    raises `ValueError`: there is no plain-cadence fallback.

    ``pipelined=True``, ``batch=True``, ``coalesce=True`` and ``autotune``
    come with later slices and raise `NotImplementedError`.
    """
    if batch:
        _common.later("batch=True", "10")
    if autotune:
        _common.later("autotune", "15")
    if pipelined:
        _common.later("pipelined=True", "9")
    if coalesce:
        _common.later("coalesce=True", "2")
    t_update = _temperature_update(params)
    flux_update = _flux_update(params)
    p_update = _pressure_update(params)
    npt = params.npt
    gg = global_grid()

    def pt_iterate(T, s):
        qDx, qDy, qDz = flux_update(T, *s)
        return p_update(s[0], qDx, qDy, qDz), qDx, qDy, qDz

    def cadence_block_step(w, lead, chunks, kernel=None, active=True):
        """One time step: ``lead`` per-iteration-exchanged iterations, then
        per chunk its iterations (``kernel``, or the plain ones) and a
        width-``w`` exchange of the four PT fields, then the T update."""

        def block_step(T, Pf, qDx, qDy, qDz):
            s = (Pf, qDx, qDy, qDz)
            for _ in range(lead):
                s = pt_iterate(T, s)
                if active:
                    s = update_halo(*s)
            for ki in chunks:
                if kernel is None:
                    for _ in range(ki):
                        s = pt_iterate(T, s)
                else:
                    s = kernel(T, *s, ki)
                if active:
                    s = update_halo(*s, width=w)
            T = t_update(T, *s[1:])
            if active:
                T = update_halo(T)
            return (T, *s)

        return block_step

    if fused_k:
        if params.hide_comm:
            raise ValueError(
                "fused_k and hide_comm are mutually exclusive: the fused "
                "kernel's slab exchange is already amortized over k "
                "iterations; overlap scheduling applies to the per-iteration "
                "XLA path."
            )
        if exchange_every not in (1, fused_k):
            raise ValueError(
                f"fused_k={fused_k} already exchanges every fused_k PT "
                f"iterations; exchange_every={exchange_every} conflicts."
            )
        require_deep_halo(fused_k, gg, what="fused_k")
        lead, chunks = _pt_schedule(npt, fused_k)
        if not chunks:
            raise ValueError(
                f"npt={npt} leaves no even kernel chunk for fused_k={fused_k}"
            )
        th = params.theta_q
        idx, idy, idz = 1.0 / params.dx, 1.0 / params.dy, 1.0 / params.dz
        ralam = params.Ra * params.lam_T
        bp = params.beta_p

        def kernel(T, Pf, qDx, qDy, qDz, ki):
            return fused_pt_iterations(T, Pf, qDx, qDy, qDz, ki, th, idx, idy, idz, ralam, bp)

        active = any(dim_has_halo_activity(gg, d) for d in range(3))
        block_step = cadence_block_step(fused_k, lead, chunks, kernel, active)
    elif exchange_every < 1:
        raise ValueError(f"exchange_every must be >= 1 (got {exchange_every})")
    elif exchange_every > 1:
        if params.hide_comm:
            raise ValueError(
                "exchange_every and hide_comm are mutually exclusive: overlap "
                "scheduling hides the per-iteration exchange; a slab cadence "
                "replaces it."
            )
        require_deep_halo(exchange_every)
        block_step = cadence_block_step(
            exchange_every, *_pt_schedule(npt, exchange_every, even=False)
        )
    else:
        block_step = make_step(params)

    if nsteps > 64:
        raise ValueError(
            f"nsteps={nsteps} would unroll {nsteps} whole time steps into one "
            "program (the outer loop is unrolled by measurement — a nested "
            "fori_loop costs ~35% on v5e); keep chunks <= 64 and call the "
            "step function repeatedly instead"
        )

    def multi(*s):
        for _ in range(nsteps):
            s = block_step(*s)
        return s

    return multi


def run(nt: int, nx: int = 32, ny: int = 32, nz: int = 32, *,
        finalize: bool = True, **setup_kwargs):
    """End-to-end run: ``nt`` steps of `make_step`; returns this rank's final
    temperature.  The JAX package's resilience hooks (``guard_every``,
    ``checkpoint_*``, ...) come with a later slice and raise
    `NotImplementedError`."""
    return _common.run(setup, make_step, nt, (nx, ny, nz), finalize, setup_kwargs)


def temperature(state):
    return state[0]
