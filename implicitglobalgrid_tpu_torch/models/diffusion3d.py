"""3-D heat diffusion — the flagship model (reference `examples/diffusion3D_*.jl`).

Heat diffusion with spatially variable heat capacity and two Gaussian
anomalies, solved with a conservative finite-difference stencil on the
implicit global grid:

    q      = -lam * grad(T)              (Fourier's law)
    dT/dt  = -(1/Cp) * div(q)            (conservation of energy)
    T     += dt * dT/dt                  (explicit Euler, interior points only)

Each process advances its own local block; `update_halo` refreshes the
overlap.  The per-step update is one pass of a hand-written CUDA kernel
(`ops.diffusion_update`).  ``make_multi_step(fused_k=k)`` runs ``k`` steps
per memory pass in another (`ops.fused_stencil`), then exchanges a
width-``k`` slab on a deep-halo grid (``overlap >= 2k``); on a grid that
exchanges in x or y with another block the groups run on the pipelined
schedule (`models._fused`).  ``hide_comm=True`` overlaps the per-step exchange with
the interior update (`ops.overlap.hide_communication`).  ``batch=True``
advances an ensemble of B members ``(B, nx, ny, nz)`` (T and Cp batched;
`models._batched`) on every cadence: one kernel launch and one exchange per
dimension for all B.

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

from ..ops import diffusion_update, fused_stencil
from ..ops.fused_stencil import fused_diffusion_steps
from ..ops.overlap import _routed_update
from ..parallel.grid import global_grid, init_global_grid
from ..utils import profiling as _profiling
from ..utils.fields import block_from_numpy, coord_fields, ones, zeros
from ..utils.tools import nx_g, ny_g, nz_g
from . import _batched, _common, _fused


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


def _plain_update(params: Params):
    """The plain PyTorch update (`ops.diffusion_update.diffusion_update_reference`)
    inside the profiler range ``igg_diffusion_update``: what the fused
    cadence's backward recomputes."""
    coeffs = (params.lam, params.dt, params.dx, params.dy, params.dz)

    def plain(T, Cp):
        with _profiling.scope("igg_diffusion_update"):
            return diffusion_update.diffusion_update_reference(T, Cp, *coeffs)

    return plain


def _diffusion_update(params: Params):
    """Per-block T update without exchange: the Laplacian of the interior
    added to the interior, the outermost ring frozen (the JAX package's
    padded-delta form ``T + pad(delta, 1)``).  Blocks or batches of them.

    The update is `ops.diffusion_update.diffusion_update` (one pass of the
    CUDA kernel on the card, the plain version on the CPU); under autograd
    the kernel runs in the forward and the plain version in the backward
    (`ops.overlap.fused_with_plain_grad`).  The update is the profiler range
    ``igg_diffusion_update`` while a capture is live."""
    coeffs = (params.lam, params.dt, params.dx, params.dy, params.dz)
    return _routed_update(
        lambda T, Cp: diffusion_update.diffusion_update(T, Cp, *coeffs),
        lambda T, Cp: diffusion_update.diffusion_update_reference(T, Cp, *coeffs),
        "igg_diffusion_update",
    )


def _one_step(params: Params, batch: bool = False, coalesce=None):
    """``(T, Cp) -> T``: the update and its exchange, overlapped with
    ``params.hide_comm`` (bit-identical either way); ``batch``: of a batch."""
    return _fused.exchanged(_diffusion_update(params), params.hide_comm, batch, coalesce)


def make_step(params: Params, *, batch: bool = False):
    """One time step ``(T, Cp) -> (T, Cp)``: stencil update + halo exchange
    (overlapped with the interior update when ``params.hide_comm``).
    ``batch=True``: the ensemble step over ``(B, nx, ny, nz)`` batched
    fields (`models._batched`), member for member bit-identical to the
    unbatched step, with one exchange per dimension for all B members."""
    one = _one_step(params, batch)
    return _batched.checked(lambda T, Cp: (one(T, Cp), Cp), batch)


def pipelined_support_error(shape, k, dtype=torch.float32, bx=None, by=None, gg=None,
                            device=None) -> str | None:
    """Why the pipelined group schedule cannot split this config, or None
    (`models._fused.pipelined_support_error` over the diffusion kernel)."""
    return _fused.pipelined_support_error(fused_stencil, shape, k, dtype, bx, by, gg,
                                          stagger=0, device=device)


def _tune_state(params: Params):
    """Synthetic ones-filled state for autotuner candidate measurement
    (`tuning.search`): the first steps are linear on ones (lap(1) = 0 — no
    NaN risk) and the fields are this rank's blocks on the grid's device,
    so a measured candidate runs the production step."""
    shape = tuple(global_grid().nxyz)
    return ones(shape, params.dtype), ones(shape, params.dtype)


def make_multi_step(
    params: Params,
    nsteps: int,
    *,
    fused_k: int | None = None,
    fused_tile: tuple[int, int] | None = None,
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
    ``fused_tile=(bx, by)``: the kernel's x segment and y tile (``bz`` from
    its ladder).

    ``pipelined`` (default auto): run the fused groups on the boundary-first
    pipelined schedule (`models._fused.run_pipelined_group_schedule`):
    each launch splits into a ring pass that starts the slab exchange early
    and a mid pass that runs meanwhile.  Bit-identical to the serialized
    schedule (``pipelined=False``); auto turns it on where the tile split is
    admissible (`pipelined_support_error`) and some x/y dimension exchanges
    with a partner other than the block itself (on one GPU every partner is
    the block itself, and auto stays serialized); ``pipelined=True`` forces
    an admissible split, and on an inadmissible config warns once and runs
    the serialized schedule.  It applies to the
    fused groups; the plain ``exchange_every`` cadence exchanges serialized
    either way, and the per-step path raises.

    ``batch=True``: every cadence over ``(B, nx, ny, nz)`` batched T and Cp
    (`models._batched`): one kernel launch per group and one exchange per
    dimension for all B members, member for member bit-identical to the
    unbatched cadence.

    ``autotune`` (None = ``IGG_AUTOTUNE`` env, default off): substitute the
    cached winner config of this (backend, topology, model, local size,
    dtype, batch) point into the kwargs above — searching (cost-model
    pruned, short runs measured on the grid's device) and persisting it on
    first use (`implicitglobalgrid_tpu_torch.tuning`).  A pure schedule
    substitution: results stay those of the default config, bit for bit
    wherever the two cadences round alike.  Explicitly-set kwargs always
    win — autotune only fills fields left at their defaults.

    Differentiable on every cadence (`torch.autograd`, w.r.t. T and Cp);
    ``fused_k`` runs the kernel in the forward and the ``exchange_every=k``
    cadence's groups in the backward (`models._fused`).
    """
    update = _diffusion_update(params)
    plain = _plain_update(params)
    c3 = tuple(params.dt * params.lam / (d * d) for d in (params.dx, params.dy, params.dz))
    return _fused.make_cadence(
        "diffusion3d", params, nsteps, family="diffusion", kernel=fused_stencil, stagger=0,
        launch=lambda ki, c, aux, tile, **subset: (
            fused_diffusion_steps(c[0], aux[0], ki, *c3, tile=tile, **subset),),
        advance=lambda c, aux: (update(c[0], aux[0]),),
        plain=lambda c, aux: (plain(c[0], aux[0]),),
        per_step=_one_step, read_only=1, fused_k=fused_k, fused_tile=fused_tile,
        exchange_every=exchange_every, pipelined=pipelined, batch=batch, autotune=autotune,
    )


def run(nt: int, nx: int = 128, ny: int = 128, nz: int = 128, *,
        finalize: bool = True, guard_every: int | None = None,
        guard_policy: str | None = None, checkpoint_every: int | None = None,
        checkpoint_dir: str | None = None, checkpoint_keep: int | None = None,
        integrity_every: int | None = None, fused_k: int | None = None,
        **setup_kwargs):
    """End-to-end run (the reference's ``diffusion3D()`` without
    visualization): ``nt`` steps of `make_step`; returns this rank's final T.
    """
    return _common.run(
        setup, make_step, nt, (nx, ny, nz), finalize, setup_kwargs, names=("T", "Cp"),
        guard_every=guard_every, guard_policy=guard_policy,
        checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir,
        checkpoint_keep=checkpoint_keep, integrity_every=integrity_every,
        model="diffusion3d", stream=1, make_multi_step=make_multi_step, fused_k=fused_k,
        group=fused_k)


run.__doc__ += _common.RUN_HOOKS_DOC


def temperature(state):
    return state[0]
