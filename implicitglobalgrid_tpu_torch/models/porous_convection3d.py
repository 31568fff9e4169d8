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
  then a halo exchange; frozen boundary planes are the walls.  On the card
  the update is one hand-written CUDA pass (`ops.temperature_update`) on
  every cadence.

State: ``(T, Pf, qDx, qDy, qDz)``.  ``make_multi_step(fused_k=w)`` runs the
PT iterations between slab exchanges in the hand-written CUDA kernel
(`ops.fused_pt`), on the pipelined group schedule where the grid exchanges
in x or y with another block (`models._fused`).  ``hide_comm=True`` overlaps each PT
iteration's ``Pf`` exchange with the interior pressure update
(`ops.overlap.hide_communication`).  ``batch=True`` advances an ensemble of
B members (every field with a leading B axis; `models._batched`) on every
cadence: one kernel launch and one exchange per dimension for all B;
`make_batched_residual` is its per-member convergence probe.

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
import torch.distributed as dist

from ..ops import fused_pt, temperature_update
from ..ops.fused_pt import fused_pt_iterations
from ..ops.halo import update_halo
from ..ops.overlap import _routed_update
from ..parallel.grid import global_grid, init_global_grid
from ..utils.fields import block_from_numpy, coord_fields, ones, zeros
from ..utils.tools import nx_g, ny_g, nz_g
from . import _batched, _common, _fused


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
    return A[..., 1:-1, 1:-1, 1:-1]


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
    (boundary faces frozen, the no-flow walls).  Blocks or batches of them."""
    th = params.theta_q
    dx, dy, dz = params.dx, params.dy, params.dz

    def update(T, Pf, qDx, qDy, qDz):
        # Relaxation toward -grad(Pf) + Ra*lam_T * T (averaged onto z faces).
        fx = -torch.diff(Pf[..., :, 1:-1, 1:-1], dim=-3) / dx
        fy = -torch.diff(Pf[..., 1:-1, :, 1:-1], dim=-2) / dy
        tz = 0.5 * (T[..., 1:-1, 1:-1, 1:] + T[..., 1:-1, 1:-1, :-1])
        fz = -torch.diff(Pf[..., 1:-1, 1:-1, :], dim=-1) / dz + params.Ra * params.lam_T * tz
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

    def update(Pf, qDx, qDy, qDz):
        return Pf - bp * _divergence(qDx, qDy, qDz, params)

    return update


def _divergence(qDx, qDy, qDz, params: Params):
    """The cell divergence of the fluxes, ``diff/dx`` per axis (the model's
    form, not the kernel's folded one)."""
    return (
        torch.diff(qDx, dim=-3) / params.dx
        + torch.diff(qDy, dim=-2) / params.dy
        + torch.diff(qDz, dim=-1) / params.dz
    )


def _temperature_update(params: Params):
    """Explicit upwind advection + diffusion of T (interior), frozen walls.
    Blocks or batches of them.

    The update is `ops.temperature_update.temperature_update` (one pass of
    the CUDA kernel on the card, the plain version on the CPU); under
    autograd the kernel runs in the forward and the plain version in the
    backward (`ops.overlap.fused_with_plain_grad`).  The update is the
    profiler range ``igg_temperature_update`` while a capture is live."""
    coeffs = (params.lam_T, 1.0 / params.phi, params.dt, params.dx, params.dy, params.dz)
    return _routed_update(
        lambda *f: temperature_update.temperature_update(*f, *coeffs),
        lambda *f: temperature_update.temperature_update_reference(*f, *coeffs),
        "igg_temperature_update",
    )


def _pt_iterations(params: Params, batch: bool = False, coalesce=None):
    """The per-iteration cadence's PT loop ``(s, (T,)) -> s`` over ``s =
    (Pf, qDx, qDy, qDz)``: ``npt`` relaxations, each the flux update
    (+buoyancy) on interior faces, then the pressure update at all cells
    and the exchange of ``Pf`` alone (the fluxes' interior faces are
    recomputed from post-exchange ``Pf`` each iteration), overlapped with
    ``params.hide_comm`` (`hide_communication`); then the once-per-step
    3-field flux exchange.  ``batch``: of a batch; ``coalesce`` as in
    `ops.halo.update_halo`."""
    flux_update = _flux_update(params)
    p_exchanged = _fused.exchanged(_pressure_update(params), params.hide_comm, batch, coalesce)
    halo = _batched.update_halo if batch else update_halo

    def iterations(s, aux):
        for _ in range(params.npt):
            qDx, qDy, qDz = flux_update(*aux, *s)
            s = (p_exchanged(s[0], qDx, qDy, qDz), qDx, qDy, qDz)
        return (s[0], *halo(*s[1:], coalesce=coalesce))

    return iterations


def _time_step(params: Params, iterations, halo):
    """One time step ``(T, Pf, qDx, qDy, qDz) -> state``: ``iterations(s,
    (T,))`` advances the PT fields ``s``, then the T update and, unless
    ``halo`` is None, its exchange."""
    t_update = _temperature_update(params)

    def block_step(T, *s):
        s = iterations(s, (T,))
        T = t_update(T, *s[1:])
        return (T if halo is None else halo(T), *s)

    return block_step


def make_step(params: Params, *, batch: bool = False):
    """One time step: ``npt`` PT pressure iterations + the T update (see
    `_pt_iterations`).  ``batch=True``: the ensemble step over batched
    fields (`models._batched`), member for member bit-identical to the
    unbatched step."""
    halo = _batched.update_halo if batch else update_halo
    return _batched.checked(_time_step(params, _pt_iterations(params, batch), halo), batch)


def pipelined_support_error(shape, k, dtype=torch.float32, bx=None, by=None, gg=None,
                            npt=None, device=None) -> str | None:
    """Why the pipelined group schedule cannot split this config, or None
    (`models._fused.pipelined_support_error` over the PT kernel;
    ``stagger=1``: the flux fields' shape-aware overlap is one deeper than
    the grid overlap).  ``npt``: when given, also require the PT schedule to
    admit a kernel chunk at all."""
    if npt is not None and not _pt_schedule(int(npt), k)[1]:
        return f"npt={npt} leaves no even kernel chunk"
    return _fused.pipelined_support_error(fused_pt, shape, k, dtype, bx, by, gg, stagger=1,
                                          device=device)


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


def _tune_state(params: Params):
    """Synthetic ones-filled state for autotuner candidate measurement
    (`tuning.search`): finite on ones (linear relaxations), this rank's
    blocks on the grid's device — a measured candidate runs the production
    step.  ``npt`` is part of the cache KEY (it changes numerics), so the
    state carries no tuned physics."""
    nx, ny, nz = global_grid().nxyz
    cells = (nx, ny, nz)
    return (ones(cells, params.dtype), ones(cells, params.dtype),
            ones((nx + 1, ny, nz), params.dtype), ones((nx, ny + 1, nz), params.dtype),
            ones((nx, ny, nz + 1), params.dtype))


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
    ``fused_tile=(bx, by)``: the kernel's x segment and y tile (``bz`` from
    its ladder).

    ``pipelined`` (default auto): the kernel chunks' pipelined schedule, as
    in `models.diffusion3d.make_multi_step` (`pipelined_support_error`);
    the split is gated at ``k = w`` and its tile pinned for every chunk of
    a ragged schedule.

    ``batch=True``, ``coalesce``: as in `models.acoustic3d.make_multi_step`
    (one kernel launch per chunk for all B members).

    ``autotune``: the tuner's cached winner config for the kwargs left at
    their defaults, as in `models.diffusion3d.make_multi_step`.

    Differentiable on every cadence (`torch.autograd`); ``fused_k`` runs
    the kernel in the forward and the plain PT chunks in the backward
    (`models._fused`), with T an explicit input of every chunk, so dL/dT
    takes the buoyancy term's path through the PT iterations.
    """
    flux_update = _flux_update(params)
    p_update = _pressure_update(params)
    npt = params.npt
    co = (params.theta_q, 1.0 / params.dx, 1.0 / params.dy, 1.0 / params.dz,
          params.Ra * params.lam_T, params.beta_p)

    def pt_iterate(s, aux):
        qDx, qDy, qDz = flux_update(aux[0], *s)
        return p_update(s[0], qDx, qDy, qDz), qDx, qDy, qDz

    def schedule(w, fused):
        lead, chunks = _pt_schedule(npt, w, even=fused)
        if fused and not chunks:
            raise ValueError(f"npt={npt} leaves no even kernel chunk for fused_k={w}")
        return lead, chunks

    def frame(iterations, halo):
        if nsteps > 64:
            raise ValueError(
                f"nsteps={nsteps} would unroll {nsteps} whole time steps into one "
                "program (the outer loop is unrolled by measurement — a nested "
                "fori_loop costs ~35% on v5e); keep chunks <= 64 and call the "
                "step function repeatedly instead"
            )
        return _time_step(params, iterations, halo)

    # T is the chunks' explicit input (aux), not a closure: the kernel reads
    # it through the buoyancy term, and autograd must see it to carry dL/dT
    # through the PT iterations.
    return _fused.make_cadence(
        "porous_convection3d", params, nsteps, family="porous", kernel=fused_pt, stagger=1,
        launch=lambda ki, c, aux, tile, **subset: fused_pt_iterations(
            aux[0], *c, ki, *co, tile=tile, **subset),
        advance=pt_iterate, per_step=_pt_iterations, schedule=schedule, frame=frame,
        unit=("iteration", "PT iterations"), fused_k=fused_k, fused_tile=fused_tile,
        exchange_every=exchange_every, pipelined=pipelined, batch=batch, coalesce=coalesce,
        autotune=autotune,
    )


def run(nt: int, nx: int = 32, ny: int = 32, nz: int = 32, *,
        finalize: bool = True, guard_every: int | None = None,
        guard_policy: str | None = None, checkpoint_every: int | None = None,
        checkpoint_dir: str | None = None, checkpoint_keep: int | None = None,
        integrity_every: int | None = None, fused_k: int | None = None,
        **setup_kwargs):
    """End-to-end run: ``nt`` steps of `make_step`; returns this rank's final
    temperature.  With ``fused_k=w`` each step runs its PT iterations in
    kernel chunks of ``w`` (``make_multi_step(params, 1, fused_k=w)``, one
    step a call).
    """
    return _common.run(
        setup, make_step, nt, (nx, ny, nz), finalize, setup_kwargs,
        names=("T", "Pf", "qDx", "qDy", "qDz"),
        guard_every=guard_every, guard_policy=guard_policy,
        checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir,
        checkpoint_keep=checkpoint_keep, integrity_every=integrity_every,
        model="porous_convection3d", stream=5, make_multi_step=make_multi_step, fused_k=fused_k,
        group=1)


run.__doc__ += _common.RUN_HOOKS_DOC


def temperature(state):
    return state[0]


def make_batched_residual(params: Params):
    """Per-member PT residual of a batched state: ``(B,)`` tensor.

    Member ``b``'s residual is the global max of its block defects, ``max
    |div(qD)|`` over interior cells (the pressure equation's residual, the
    criterion the PT relaxation drives to zero; the outermost ring evolves
    under frozen faces and is left out), then one ``all_reduce(MAX)`` of the
    ``(B,)`` vector across ranks, so every rank masks the same members (the
    serving loop's convergence criterion; JAX ``make_batched_residual``).
    """

    def residual(T, Pf, qDx, qDy, qDz):
        _batched.check_batched((T, Pf, qDx, qDy, qDz))
        res = _inn(_divergence(qDx, qDy, qDz, params)).abs().flatten(1).amax(1)
        if global_grid().nprocs > 1:
            dist.all_reduce(res, op=dist.ReduceOp.MAX)
        return res

    return residual
