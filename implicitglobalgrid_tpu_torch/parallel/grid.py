"""Global-grid state: the `GlobalGrid` record and its singleton.

One process drives one device (the reference's MPI model).  A field is this
rank's local block tensor of shape ``(nx, ny, nz)`` on the grid's device;
neighbouring blocks overlap by ``overlaps`` cells, stored redundantly exactly
like the reference's per-process arrays.  The implicit global size is
``nxyz_g = dims*(nxyz-overlaps) + overlaps*(periods==0)``.

The grid is a module-level singleton guarded by `check_initialized` with the
reference's error contract, so user code keeps the three-function promise
(`init_global_grid` / `update_halo` / `finalize_global_grid`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from . import distributed as _distributed
from . import topology
from .topology import NDIMS


@dataclasses.dataclass(frozen=True)
class GlobalGrid:
    """Immutable snapshot of the grid topology.

    ``nprocs`` counts blocks (= processes = devices); ``me`` and ``coords``
    are this process's rank and Cartesian block coordinates.
    """

    nxyz_g: tuple[int, int, int]
    nxyz: tuple[int, int, int]
    dims: tuple[int, int, int]
    overlaps: tuple[int, int, int]
    nprocs: int
    me: int
    coords: tuple[int, int, int]
    neighbors: Any  # np.ndarray (2, 3), PROC_NULL where absent
    periods: tuple[int, int, int]
    disp: int
    reorder: int
    device: torch.device
    quiet: bool
    # monotonically increasing across init/finalize cycles
    epoch: int = 0

    def replace(self, **kw) -> "GlobalGrid":
        return dataclasses.replace(self, **kw)

    def checkpoint_meta(self) -> dict:
        """Topology metadata a checkpoint must match to be restorable here
        (`utils.checkpoint`): the implicit global grid's identity — local
        sizes, dims, overlaps, periods — with the JAX package's keys, so
        either package reads the other's manifests.  ``device_type`` is
        ``"cuda"`` or ``"cpu"`` and informational."""
        return {
            "dims": list(self.dims),
            "nxyz": list(self.nxyz),
            "nxyz_g": list(self.nxyz_g),
            "overlaps": list(self.overlaps),
            "periods": list(self.periods),
            "disp": int(self.disp),
            "nprocs": int(self.nprocs),
            "device_type": self.device.type,
        }


def elastic_topology_error(saved: dict, current: dict) -> str | None:
    """Why ``current`` cannot elastically restore a checkpoint written under
    ``saved``, or None when it can.

    Both arguments are `GlobalGrid.checkpoint_meta` dicts.  The implicit
    global grid makes topology a derived quantity: any ``(nxyz, dims,
    overlaps, periods)`` implying the same de-duplicated global size
    (`topology.implied_global_shape`) describes the same physical grid.
    Periodicity must match: it is part of the physical problem, not of the
    decomposition.  The messages are the JAX package's.
    """
    mismatches = []
    if tuple(saved.get("periods", ())) != tuple(current.get("periods", ())):
        mismatches.append(
            f"periods: checkpoint {list(saved.get('periods', []))} vs "
            f"current {list(current.get('periods', []))} (periodicity is "
            f"part of the physical problem, not of the decomposition)"
        )
    saved_g = topology.implied_global_shape(
        saved["nxyz"], saved["dims"], saved["overlaps"], saved["periods"]
    )
    cur_g = topology.implied_global_shape(
        current["nxyz"], current["dims"], current["overlaps"], current["periods"]
    )
    if saved_g != cur_g:
        mismatches.append(
            f"implied global size nxyz_g = dims*(nxyz-overlaps) + "
            f"overlaps*(periods==0): checkpoint "
            f"{list(saved.get('nxyz_g', saved_g))} (from nxyz="
            f"{list(saved['nxyz'])}, dims={list(saved['dims'])}, overlaps="
            f"{list(saved['overlaps'])}) vs current {list(cur_g)} (from "
            f"nxyz={list(current['nxyz'])}, dims={list(current['dims'])}, "
            f"overlaps={list(current['overlaps'])}) — adjust the local "
            f"sizes so the target topology spans the same global grid"
        )
    if mismatches:
        return "; ".join(mismatches)
    return None


_global_grid: GlobalGrid | None = None
_epoch = 0


def grid_is_initialized() -> bool:
    return _global_grid is not None


def check_initialized() -> None:
    if not grid_is_initialized():
        raise RuntimeError(
            "No function of the module can be called before init_global_grid() "
            "or after finalize_global_grid()."
        )


def global_grid() -> GlobalGrid:
    check_initialized()
    return _global_grid


get_global_grid = global_grid


def set_global_grid(gg: GlobalGrid | None) -> None:
    global _global_grid
    _global_grid = gg


def _resolve_device(device) -> torch.device:
    """The grid's device: ``cuda:<LOCAL_RANK>`` by default, never a silent
    CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_global_grid: no CUDA device is available. The port runs "
                "on the GPU by default; pass device='cpu' to run the grid on "
                "the CPU explicitly."
            )
        return torch.device("cuda", _distributed.local_rank())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _distributed.local_rank())
    return device


def init_global_grid(
    nx: int,
    ny: int = 1,
    nz: int = 1,
    *,
    dimx: int = 0,
    dimy: int = 0,
    dimz: int = 0,
    periodx: int = 0,
    periody: int = 0,
    periodz: int = 0,
    overlapx: int | None = None,
    overlapy: int | None = None,
    overlapz: int | None = None,
    disp: int = 1,
    reorder: int | None = None,
    distributed_kwargs: dict | None = None,
    select_device: bool = True,
    quiet: bool | None = None,
    device=None,
):
    """Initialize the Cartesian process topology, implicitly defining a global grid.

    ``nx, ny, nz`` are the LOCAL block sizes.  The process count is factored
    into ``dims`` (fixed entries honoured, zeros filled balanced), this
    process's block sits at ``coords_of_rank(rank, dims)``, and the global
    size is ``dims*(nxyz-overlaps) + overlaps*(periods==0)``.

    Processes: with ``WORLD_SIZE`` unset the grid is this one process; with
    ``RANK``/``WORLD_SIZE`` (and ``MASTER_ADDR``/``MASTER_PORT``) set, the
    `torch.distributed` group is brought up here — NCCL for CUDA devices,
    gloo for the CPU — unless the caller already did.  ``distributed_kwargs``
    pass through to `torch.distributed.init_process_group`.

    ``device=None`` means ``cuda:<LOCAL_RANK>`` and raises without CUDA;
    pass ``device="cpu"`` to run on the CPU.  ``reorder`` is recorded for
    API parity (ranks map to coordinates in C order).

    Returns ``(me, dims, nprocs, coords, device)``.
    """
    global _epoch
    from ..utils.config import env_config

    if grid_is_initialized():
        raise RuntimeError("The global grid has already been initialized.")
    env = env_config()
    env_overlap = env.get("overlap", 2)
    overlapx = env_overlap if overlapx is None else overlapx
    overlapy = env_overlap if overlapy is None else overlapy
    overlapz = env_overlap if overlapz is None else overlapz
    reorder = env.get("reorder", 1) if reorder is None else reorder
    quiet = env.get("quiet", False) if quiet is None else quiet
    nxyz = [int(nx), int(ny), int(nz)]
    dims = [int(dimx), int(dimy), int(dimz)]
    periods = [int(periodx), int(periody), int(periodz)]
    overlaps = [int(overlapx), int(overlapy), int(overlapz)]

    if nxyz[0] == 1:
        raise ValueError("Invalid arguments: nx can never be 1.")
    if nxyz[1] == 1 and nxyz[2] > 1:
        raise ValueError("Invalid arguments: ny cannot be 1 if nz is greater than 1.")
    if any(n == 1 and d > 1 for n, d in zip(nxyz, dims)):
        raise ValueError(
            "Incoherent arguments: if nx, ny, or nz is 1, then the corresponding "
            "dimx, dimy or dimz must not be set (or set 0 or 1)."
        )
    if any(n < 2 * o - 1 and p > 0 for n, o, p in zip(nxyz, overlaps, periods)):
        raise ValueError(
            "Incoherent arguments: if nx, ny, or nz is smaller than 2*overlapx-1, "
            "2*overlapy-1 or 2*overlapz-1, respectively, then the corresponding "
            "periodx, periody or periodz must not be set (or set 0)."
        )
    for d in range(NDIMS):
        if nxyz[d] == 1 and dims[d] == 0:
            dims[d] = 1

    device = _resolve_device(device)
    if _distributed.env_world_size() is not None:
        _distributed.init_distributed(device, **(distributed_kwargs or {}))
    nprocs = _distributed.process_count()
    me = _distributed.process_index()
    dims = topology.dims_create(nprocs, tuple(dims))
    coords = topology.coords_of_rank(me, dims)
    neighbors = topology.neighbors_table(coords, dims, periods, disp)
    nxyz_g = topology.implied_global_shape(nxyz, dims, overlaps, periods)

    _epoch += 1
    set_global_grid(
        GlobalGrid(
            nxyz_g=nxyz_g,
            nxyz=tuple(nxyz),
            dims=dims,
            overlaps=tuple(overlaps),
            nprocs=nprocs,
            me=me,
            coords=coords,
            neighbors=neighbors,
            periods=tuple(periods),
            disp=int(disp),
            reorder=int(reorder),
            device=device,
            quiet=bool(quiet),
            epoch=_epoch,
        )
    )
    if not quiet and me == 0:
        print(
            f"Global grid: {nxyz_g[0]}x{nxyz_g[1]}x{nxyz_g[2]} "
            f"(nprocs: {nprocs}, dims: {dims[0]}x{dims[1]}x{dims[2]})"
        )
    if select_device:
        _bind_device()
    init_timing_functions()
    # Cross-rank clock sync: one more barrier, every rank's wall and perf
    # clocks sampled right at its exit — the shared instant
    # `utils.tracing.dump_trace` merges per-rank timelines on, with the
    # barrier's duration as the alignment's uncertainty.  One process needs
    # no barrier: its one clock aligns with itself.
    from ..utils import tracing as _tracing

    _tracing.record_clock_sync(
        (lambda: _distributed.sync_all_processes(device)) if nprocs > 1 else None,
        epoch=_epoch,
    )
    return me, dims, nprocs, coords, device


def finalize_global_grid(*, finalize_distributed: bool = True) -> None:
    """Tear down the grid singleton; destroy the process group if
    `init_global_grid` created it (``finalize_distributed=False`` keeps it
    for a re-init in the same process)."""
    check_initialized()
    set_global_grid(None)
    _t0[0] = None
    if finalize_distributed and _distributed.owns_runtime():
        _distributed.shutdown_distributed()


def select_device() -> torch.device:
    """Bind this process to its device and return it (the reference's
    ``select_device``: ``cuda:<local rank>`` becomes the current device)."""
    return _bind_device()


def _bind_device() -> torch.device:
    gg = global_grid()
    if gg.device.type == "cuda":
        torch.cuda.set_device(gg.device)
    return gg.device


# -- Timing tools -------------------------------------------------------------

# None = no user tic() yet: toc() must raise instead of measuring from an
# arbitrary epoch (init_timing_functions primes the barrier but resets this).
_t0: list[float | None] = [None]


def _barrier() -> None:
    """Wait for this device's queued work, then for every process."""
    gg = global_grid()
    if gg.device.type == "cuda":
        torch.cuda.synchronize(gg.device)
    _distributed.sync_all_processes(gg.device)


def tic() -> None:
    """Start the chronometer once every device and process reached this point."""
    check_initialized()
    _barrier()
    _t0[0] = time.perf_counter()


def toc() -> float:
    """Elapsed seconds since `tic`, once every device and process got here."""
    check_initialized()
    if _t0[0] is None:
        raise RuntimeError(
            "toc() called before tic(): the chronometer was never started "
            "(call igg.tic() at the start of the timed section)."
        )
    _barrier()
    return time.perf_counter() - _t0[0]


def init_timing_functions() -> None:
    # Prime the barrier, then reset: the priming tic must not masquerade as
    # a user tic.
    tic()
    toc()
    _t0[0] = None
