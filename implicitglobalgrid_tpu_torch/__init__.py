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
"""

from .ops.gather import gather
from .ops.halo import halosize, local_shape, ol, update_halo
from .ops.stencil import stencil
from .parallel import distributed
from .parallel.grid import (
    GlobalGrid,
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
from .parallel.topology import NDIMS, PROC_NULL
from .utils.fields import block_from_numpy, coord_fields, from_block_fn, full, ones, zeros
from .utils.tools import nx_g, ny_g, nz_g, x_g, y_g, z_g

__all__ = [
    "GlobalGrid",
    "NDIMS",
    "PROC_NULL",
    "block_from_numpy",
    "coord_fields",
    "distributed",
    "finalize_global_grid",
    "from_block_fn",
    "full",
    "gather",
    "get_global_grid",
    "global_grid",
    "grid_is_initialized",
    "halosize",
    "init_global_grid",
    "local_shape",
    "nx_g",
    "ny_g",
    "nz_g",
    "ol",
    "ones",
    "select_device",
    "set_global_grid",
    "stencil",
    "tic",
    "toc",
    "update_halo",
    "x_g",
    "y_g",
    "z_g",
    "zeros",
]
