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
(`ops.fused_leapfrog`), on the pipelined group schedule where the grid
exchanges in x or y with another block (`models._fused`).  ``hide_comm=True`` overlaps the
per-step velocity exchange with the interior velocity update
(`ops.overlap.hide_communication`).  ``batch=True`` advances an ensemble of
B members (every field with a leading B axis; `models._batched`) on every
cadence: one kernel launch and one exchange per dimension for all B.

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

from ..ops import fused_leapfrog
from ..ops.fused_leapfrog import fused_leapfrog_steps
from ..parallel.grid import global_grid, init_global_grid
from ..utils.fields import block_from_numpy, coord_fields, ones, zeros
from ..utils.tools import nx_g, ny_g, nz_g
from . import _batched, _common, _fused


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
    (boundary faces frozen, the rigid-wall condition).  Blocks or batches of
    them."""
    a = params.dt / params.rho

    def update(P, Vx, Vy, Vz):
        Vx, Vy, Vz = Vx.clone(), Vy.clone(), Vz.clone()
        Vx[..., 1:-1, 1:-1, 1:-1] += -(a / params.dx) * torch.diff(P[..., :, 1:-1, 1:-1], dim=-3)
        Vy[..., 1:-1, 1:-1, 1:-1] += -(a / params.dy) * torch.diff(P[..., 1:-1, :, 1:-1], dim=-2)
        Vz[..., 1:-1, 1:-1, 1:-1] += -(a / params.dz) * torch.diff(P[..., 1:-1, 1:-1, :], dim=-1)
        return Vx, Vy, Vz

    return update


def _pressure_update(params: Params):
    """Per-block pressure update: all centers, from fresh velocities."""
    b = params.dt * params.K

    def update(P, Vx, Vy, Vz):
        div = (
            torch.diff(Vx, dim=-3) / params.dx
            + torch.diff(Vy, dim=-2) / params.dy
            + torch.diff(Vz, dim=-1) / params.dz
        )
        return P - b * div

    return update


def make_step(params: Params, *, batch: bool = False):
    """One leapfrog step ``(P, Vx, Vy, Vz) -> (P, Vx, Vy, Vz)``: velocity
    update, one 3-field `update_halo` (overlapped with the interior velocity
    update when ``params.hide_comm``), then P from the fresh velocities.
    ``batch=True``: the ensemble step over batched fields (`models._batched`),
    member for member bit-identical to the unbatched step."""
    return _batched.checked(_leapfrog_step(params, batch), batch)


def _leapfrog_step(params: Params, batch: bool, coalesce=None):
    """`make_step`'s step, its velocity exchange coalesced as ``coalesce``
    says (`ops.halo.update_halo`)."""
    v_exchanged = _fused.exchanged(_velocity_update(params), params.hide_comm, batch, coalesce)
    p_update = _pressure_update(params)

    def step(P, Vx, Vy, Vz):
        Vx, Vy, Vz = v_exchanged(P, Vx, Vy, Vz)
        return p_update(P, Vx, Vy, Vz), Vx, Vy, Vz

    return step


def pipelined_support_error(shape, k, dtype=torch.float32, bx=None, by=None, gg=None,
                            device=None) -> str | None:
    """Why the pipelined group schedule cannot split this config, or None
    (`models._fused.pipelined_support_error` over the leapfrog kernel;
    ``stagger=1``: the face fields' shape-aware overlap is one deeper than
    the grid overlap, and their send planes must fit the ring tiles too)."""
    return _fused.pipelined_support_error(fused_leapfrog, shape, k, dtype, bx, by, gg,
                                          stagger=1, device=device)


def _tune_state(params: Params):
    """Synthetic ones-filled state for autotuner candidate measurement
    (`tuning.search`): linear updates on ones stay finite, and the fields
    are this rank's blocks (staggered ``n+1`` faces) on the grid's device,
    so a measured candidate runs the production step."""
    nx, ny, nz = global_grid().nxyz
    return (ones((nx, ny, nz), params.dtype), ones((nx + 1, ny, nz), params.dtype),
            ones((nx, ny + 1, nz), params.dtype), ones((nx, ny, nz + 1), params.dtype))


def make_multi_step(
    params: Params,
    nsteps: int,
    *,
    exchange_every: int = 1,
    fused_k: int | None = None,
    fused_tile: tuple[int, int] | None = None,
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
    ``fused_tile=(bx, by)``: the kernel's x segment and y tile (``bz`` from
    its ladder).

    ``pipelined`` (default auto): the fused groups' pipelined schedule, as
    in `models.diffusion3d.make_multi_step` (`pipelined_support_error`).

    ``batch=True``: every cadence over batched fields (`models._batched`),
    one kernel launch per group and one exchange per dimension for all B
    members.  ``coalesce`` (None: ``IGG_COALESCE``, default on): every
    multi-field exchange of the cadence sends one message per side and
    dtype word width instead of one per field (`ops.halo.update_halo`),
    bit-identical either way.

    ``autotune``: the tuner's cached winner config for the kwargs left at
    their defaults, as in `models.diffusion3d.make_multi_step`.

    Differentiable on every cadence (`torch.autograd`); ``fused_k`` runs
    the kernel in the forward and the ``exchange_every=k`` cadence's groups
    in the backward (`models._fused`).
    """
    v_update = _velocity_update(params)
    p_update = _pressure_update(params)
    co = (params.dt / params.rho / params.dx, params.dt / params.rho / params.dy,
          params.dt / params.rho / params.dz, params.dt * params.K,
          1.0 / params.dx, 1.0 / params.dy, 1.0 / params.dz)

    def leapfrog(s, aux):
        Vx, Vy, Vz = v_update(*s)
        return p_update(s[0], Vx, Vy, Vz), Vx, Vy, Vz

    # Every group exchanges all four fields: P's stale rind must ride along.
    return _fused.make_cadence(
        "acoustic3d", params, nsteps, family="acoustic", kernel=fused_leapfrog, stagger=1,
        launch=lambda ki, c, aux, tile, **subset: fused_leapfrog_steps(*c, ki, *co, tile=tile,
                                                                        **subset),
        advance=leapfrog, per_step=_leapfrog_step, fused_k=fused_k, fused_tile=fused_tile,
        exchange_every=exchange_every, pipelined=pipelined, batch=batch, coalesce=coalesce,
        autotune=autotune,
    )


def run(nt: int, nx: int = 64, ny: int = 64, nz: int = 64, *,
        finalize: bool = True, guard_every: int | None = None,
        guard_policy: str | None = None, checkpoint_every: int | None = None,
        checkpoint_dir: str | None = None, checkpoint_keep: int | None = None,
        integrity_every: int | None = None, fused_k: int | None = None,
        **setup_kwargs):
    """End-to-end run: ``nt`` steps of `make_step`; returns this rank's final
    pressure.
    """
    return _common.run(
        setup, make_step, nt, (nx, ny, nz), finalize, setup_kwargs,
        names=("P", "Vx", "Vy", "Vz"),
        guard_every=guard_every, guard_policy=guard_policy,
        checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir,
        checkpoint_keep=checkpoint_keep, integrity_every=integrity_every,
        model="acoustic3d", stream=4, make_multi_step=make_multi_step, fused_k=fused_k,
        group=fused_k)


run.__doc__ += _common.RUN_HOOKS_DOC


def pressure(state):
    return state[0]
