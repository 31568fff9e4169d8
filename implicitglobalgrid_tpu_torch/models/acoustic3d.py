"""3-D acoustic wave on a staggered grid (the JAX package's BASELINE config 3).

Velocity–pressure leapfrog, the canonical staggered application of the
grid machinery.  Grid layout (one cell = one pressure point):

* ``P``  at cell centers, local shape ``(nx,   ny,   nz)``
* ``Vx`` on x-faces,      local shape ``(nx+1, ny,   nz)``
* ``Vy`` on y-faces,      local shape ``(nx,   ny+1, nz)``
* ``Vz`` on z-faces,      local shape ``(nx,   ny,   nz+1)``

Update (explicit leapfrog)::

    V  -= dt/rho * grad(P)      (interior face points; boundary faces frozen)
    P  -= dt*K   * div(V)       (all cell centers)

On the per-step path only the velocities exchange halos: ``P`` is recomputed
everywhere from post-exchange velocities.  The slab cadences
(``exchange_every`` and ``fused_k``) exchange all four fields, because ``P``'s
stale rind is never recomputed between exchanges.  ``fused_k=k`` runs ``k``
steps per memory pass in the hand-written CUDA kernel
(`ops.fused_leapfrog`).

Usage::

    import implicitglobalgrid_tpu_torch.models.acoustic3d as m
    state, params = m.setup(256, 256, 256, periodz=1, overlapx=12, overlapy=12, overlapz=12)
    step = m.make_multi_step(params, 24, fused_k=6)
    P, Vx, Vy, Vz = step(*state)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.fused_leapfrog import fused_leapfrog_steps
from ..ops.halo import dim_has_halo_activity, require_deep_halo, update_halo
from ..parallel.grid import global_grid, init_global_grid
from ..utils.fields import block_from_numpy, coord_fields, zeros
from ..utils.tools import nx_g, ny_g, nz_g
from . import _common


@dataclasses.dataclass(frozen=True)
class Params:
    K: float = 1.0  # bulk modulus
    rho: float = 1.0  # density
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
    package's ``acoustic3d.Params``."""
    return _common.params_from(Params, other)


def state_from_numpy(P, Vx, Vy, Vz, *, coords=None, device=None):
    """This rank's ``(P, Vx, Vy, Vz)`` block tensors from numpy fields, each
    given either as one block or in the JAX package's global-block layout
    (see `utils.fields.block_from_numpy`)."""
    nx, ny, nz = global_grid().nxyz
    shapes = ((nx, ny, nz), (nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    return tuple(
        block_from_numpy(a, s, coords=coords, device=device)
        for a, s in zip((P, Vx, Vy, Vz), shapes)
    )


def setup(
    nx: int = 64,
    ny: int = 64,
    nz: int = 64,
    *,
    K: float = 1.0,
    rho: float = 1.0,
    lx: float = 10.0,
    ly: float = 10.0,
    lz: float = 10.0,
    dtype=None,
    hide_comm: bool = False,
    init_grid: bool = True,
    ic_scale: float = 1.0,
    **grid_kwargs,
):
    """Initialize the grid (unless ``init_grid=False``) and the fields: a
    Gaussian pressure pulse at the domain center, velocities at rest.

    Returns ``(state, params)`` with ``state = (P, Vx, Vy, Vz)``.
    ``dtype`` defaults to torch's default dtype; ``ic_scale`` scales the
    initial pulse.
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
    c = (K / rho) ** 0.5
    dt = min(dx, dy, dz) / c / 2.0  # CFL (3-D bound is 1/sqrt(3); 1/2 for margin)
    params = Params(
        K=K, rho=rho, lx=lx, ly=ly, lz=lz, dx=dx, dy=dy, dz=dz, dt=dt,
        dtype=dtype, hide_comm=hide_comm,
    )
    P = zeros((nx, ny, nz), dtype)
    X, Y, Z = coord_fields(P, (dx, dy, dz), dtype=dtype)
    p0 = 100 * torch.exp(
        -(((X - lx / 2) / 1.0) ** 2) - ((Y - ly / 2) / 1.0) ** 2 - ((Z - lz / 2) / 1.0) ** 2
    )
    P = (ic_scale * p0).to(dtype)
    Vx = zeros((nx + 1, ny, nz), dtype)
    Vy = zeros((nx, ny + 1, nz), dtype)
    Vz = zeros((nx, ny, nz + 1), dtype)
    return (P, Vx, Vy, Vz), params


def _velocity_update(params: Params):
    """Per-block velocity update without exchange: interior face points only
    (boundary faces frozen, the rigid-wall condition)."""
    a = params.dt / params.rho

    def update(P, Vx, Vy, Vz):
        Vx, Vy, Vz = Vx.clone(), Vy.clone(), Vz.clone()
        Vx[1:-1, 1:-1, 1:-1] += -(a / params.dx) * torch.diff(P[:, 1:-1, 1:-1], dim=0)
        Vy[1:-1, 1:-1, 1:-1] += -(a / params.dy) * torch.diff(P[1:-1, :, 1:-1], dim=1)
        Vz[1:-1, 1:-1, 1:-1] += -(a / params.dz) * torch.diff(P[1:-1, 1:-1, :], dim=2)
        return Vx, Vy, Vz

    return update


def _pressure_update(params: Params):
    """Per-block pressure update: all centers, from fresh velocities."""
    b = params.dt * params.K

    def update(P, Vx, Vy, Vz):
        div = (
            torch.diff(Vx, dim=0) / params.dx
            + torch.diff(Vy, dim=1) / params.dy
            + torch.diff(Vz, dim=2) / params.dz
        )
        return P - b * div

    return update


def make_step(params: Params, *, batch: bool = False):
    """One leapfrog step ``(P, Vx, Vy, Vz) -> (P, Vx, Vy, Vz)``: velocity
    update, one 3-field `update_halo`, then P from the fresh velocities."""
    if batch:
        _common.later("batch=True", "10")
    if params.hide_comm:
        _common.later("hide_comm", "9")
    v_update = _velocity_update(params)
    p_update = _pressure_update(params)

    def step(P, Vx, Vy, Vz):
        Vx, Vy, Vz = update_halo(*v_update(P, Vx, Vy, Vz))
        return p_update(P, Vx, Vy, Vz), Vx, Vy, Vz

    return step


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
    """``(P, Vx, Vy, Vz)`` advanced by ``nsteps`` leapfrog steps.

    ``exchange_every=w``: on a deep-halo grid (``overlap >= 2w`` in every
    dimension with halo activity) run ``w`` steps between exchanges, then
    exchange width-``w`` slabs of ALL four fields (``P``'s stale rind is
    never recomputed from fresh velocities, so its slab must ride along).

    ``fused_k=k``: ``k`` steps per memory pass with the CUDA kernel
    (`ops.fused_leapfrog.fused_leapfrog_steps`), then one width-``k`` slab
    exchange of all four fields (``overlap >= 2k`` in every dimension with
    halo activity); on a grid with no halo activity the kernel runs alone.
    Requires ``nsteps % k == 0``.  A ``k``, dtype or block the kernel does
    not take raises `ValueError`: there is no plain-cadence fallback.

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
    v_update = _velocity_update(params)
    p_update = _pressure_update(params)
    gg = global_grid()

    def leapfrog(s):
        Vx, Vy, Vz = v_update(*s)
        return p_update(s[0], Vx, Vy, Vz), Vx, Vy, Vz

    if fused_k:
        if params.hide_comm:
            raise ValueError(
                "fused_k and hide_comm are mutually exclusive: the fused "
                "kernel's slab exchange is already amortized over k steps; "
                "overlap scheduling applies to the per-step XLA path."
            )
        if nsteps % fused_k != 0:
            raise ValueError(f"nsteps={nsteps} must be a multiple of fused_k={fused_k}")
        if exchange_every not in (1, fused_k):
            raise ValueError(
                f"fused_k={fused_k} already exchanges every fused_k steps; "
                f"exchange_every={exchange_every} conflicts."
            )
        require_deep_halo(fused_k, gg, what="fused_k")
        active = any(dim_has_halo_activity(gg, d) for d in range(3))
        cax = params.dt / params.rho / params.dx
        cay = params.dt / params.rho / params.dy
        caz = params.dt / params.rho / params.dz
        b = params.dt * params.K
        idx, idy, idz = 1.0 / params.dx, 1.0 / params.dy, 1.0 / params.dz

        def fused_multi_step(*s):
            for _ in range(nsteps // fused_k):
                s = fused_leapfrog_steps(*s, fused_k, cax, cay, caz, b, idx, idy, idz)
                # One all-field slab exchange licenses the next k steps: the
                # kernel's k-deep stale rind is exactly what it refreshes.
                if active:
                    s = update_halo(*s, width=fused_k)
            return s

        return fused_multi_step

    if exchange_every < 1:
        raise ValueError(f"exchange_every must be >= 1 (got {exchange_every})")
    if exchange_every > 1:
        if params.hide_comm:
            raise ValueError(
                "exchange_every and hide_comm are mutually exclusive: overlap "
                "scheduling hides the per-step exchange; a slab cadence "
                "replaces it."
            )
        if nsteps % exchange_every != 0:
            raise ValueError(
                f"nsteps={nsteps} must be a multiple of exchange_every={exchange_every}"
            )
        require_deep_halo(exchange_every, gg)
        w = exchange_every

        def slab_multi_step(*s):
            for _ in range(nsteps // w):
                for _ in range(w):
                    s = leapfrog(s)
                s = update_halo(*s, width=w)
            return s

        return slab_multi_step

    step = make_step(params)

    def multi_step(*s):
        for _ in range(nsteps):
            s = step(*s)
        return s

    return multi_step


def run(nt: int, nx: int = 64, ny: int = 64, nz: int = 64, *,
        finalize: bool = True, **setup_kwargs):
    """End-to-end run: ``nt`` steps of `make_step`; returns this rank's final
    pressure.  The JAX package's resilience hooks (``guard_every``,
    ``checkpoint_*``, ...) come with a later slice and raise
    `NotImplementedError`."""
    return _common.run(setup, make_step, nt, (nx, ny, nz), finalize, setup_kwargs)


def pressure(state):
    return state[0]
