"""implicitglobalgrid_tpu_torch — the PyTorch/CUDA port of implicitglobalgrid_tpu.

One process drives one GPU (the reference's MPI model): a field is this
rank's local block tensor, `update_halo` exchanges overlap slabs with the
neighbouring ranks over `torch.distributed`, and the diffusion model's
temporally blocked kernel is hand-written CUDA for Hopper
(``csrc/fused_diffusion.cu``).  The package imports torch and numpy only.

The three-function promise::

    import implicitglobalgrid_tpu_torch as igg

    igg.init_global_grid(nx, ny, nz)   # topology + implicit global grid
    igg.update_halo(T)                 # per-step boundary exchange (in place)
    igg.finalize_global_grid()         # teardown

Resilience (`utils.resilience`, `utils.checkpoint`, the `integrity`
subpackage): NaN/Inf guards, fault injection, checkpoints in the JAX
package's on-disk format with elastic restore, and the integrity plane;
the models' ``run()`` takes the JAX package's resilience knobs.

Serving (`serving`, imported on first use): a slot pool of ensemble
members over one batched step, admission, autoscaling and an HTTP front
door.

Observability: `telemetry` (metrics registry, event log, the models' step
telemetry; `telemetry_snapshot`, `dump_metrics`), `tracing` (host spans
`trace_span`, per-rank dumps `dump_trace` mergeable into one Chrome trace,
request traces, the skew probe and the flight recorder) and `liveplane`
(imported on first use: per-rank ``/metrics``/``/healthz``/``/spans``
endpoints and the anomaly rule engine).
"""

from .ops.gather import gather
from .ops.halo import halosize, local_shape, ol, update_halo
from .ops.overlap import hide_communication
from .ops.stencil import stencil
from .parallel import distributed
from .parallel.grid import (
    GlobalGrid,
    check_initialized,
    finalize_global_grid,
    get_global_grid,
    global_grid,
    grid_is_initialized,
    init_global_grid,
    select_device,
    set_global_grid,
    tic,
    toc,
)
from .parallel.topology import NDIMS, NNEIGHBORS_PER_DIM, PROC_NULL
from .utils.checkpoint import (
    latest_checkpoint,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
from .utils.fields import (
    block_from_numpy,
    block_slice,
    coord_fields,
    from_block_fn,
    full,
    ones,
    zeros,
)
from .utils import telemetry, tracing
from .utils.resilience import FieldReport, GuardError, RunGuard, check_fields, watchdog
from .utils.telemetry import dump_metrics, telemetry_snapshot
from .utils.tools import nx_g, ny_g, nz_g, x_g, y_g, z_g
from .utils.tracing import dump_trace, trace_span

__all__ = [
    "FieldReport",
    "GlobalGrid",
    "GuardError",
    "NDIMS",
    "NNEIGHBORS_PER_DIM",
    "PROC_NULL",
    "RunGuard",
    "block_from_numpy",
    "block_slice",
    "check_fields",
    "check_initialized",
    "coord_fields",
    "distributed",
    "dump_metrics",
    "dump_trace",
    "finalize_global_grid",
    "from_block_fn",
    "full",
    "gather",
    "get_global_grid",
    "global_grid",
    "grid_is_initialized",
    "halosize",
    "hide_communication",
    "init_global_grid",
    "latest_checkpoint",
    "liveplane",
    "local_shape",
    "nx_g",
    "ny_g",
    "nz_g",
    "ol",
    "ones",
    "prune_checkpoints",
    "restore_checkpoint",
    "save_checkpoint",
    "select_device",
    "serving",
    "set_global_grid",
    "stencil",
    "telemetry",
    "telemetry_snapshot",
    "tic",
    "toc",
    "trace_span",
    "tracing",
    "update_halo",
    "verify_checkpoint",
    "watchdog",
    "x_g",
    "y_g",
    "z_g",
    "zeros",
]


def __getattr__(name):
    # Lazy: the serving subsystem pulls the models in, and the live plane
    # its HTTP server; importing the package itself stays light (the JAX
    # package's ``__getattr__``).
    if name == "serving":
        import importlib

        return importlib.import_module(f".{name}", __name__)
    if name == "liveplane":
        from .utils import liveplane

        return liveplane
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
