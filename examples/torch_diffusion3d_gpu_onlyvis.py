"""Visualization pattern only, the solver lines elided (PyTorch).

The port's twin of ``diffusion3d_tpu_onlyvis.py``, which documents just the
in-situ visualization recipe: every ``nvis`` steps, strip the halo locally,
gather the blocks to process 0, and render the mid-plane.  The solver is
elided (see ``torch_diffusion3d_multidevice.py`` for the complete program),
but the recipe runs: one field stands in for the solver state.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import implicitglobalgrid_tpu_torch as igg


def diffusion3d(nx=8, ny=8, nz=8, nt=3, nvis=1, **grid_kwargs):
    """The recipe on a grid of ``nx * ny * nz`` blocks; ``grid_kwargs`` go
    to `init_global_grid` (``device="cpu"`` runs it without a GPU)."""
    # Physics
    # (...)

    # Numerics
    # (...)
    me, dims, nprocs, coords, device = igg.init_global_grid(nx, ny, nz, **grid_kwargs)

    # Array initializations and initial conditions (solver arrays elided:
    # one field suffices to demonstrate the visualization recipe)
    T = igg.zeros((nx, ny, nz))

    # Preparation of visualization: the gathered array is the halo-stripped
    # blocks side by side, (n-2)*dims cells per dimension.
    frames = []
    ny_v = (ny - 2) * dims[1]

    # Time loop
    for it in range(nt):
        if it % nvis == 0:  # visualize every nvis-th step
            T_nohalo = igg.block_slice(T, (slice(1, -1),) * 3)  # strip the halo locally
            T_v = igg.gather(T_nohalo)  # gather on process 0
            if me == 0:
                frames.append(np.array(T_v[:, ny_v // 2, :]).T)  # mid-plane heatmap frame
        # (... stencil update + update_halo ...)

    # Postprocessing: write frames to GIF/MP4 on process 0.
    # (...)
    igg.finalize_global_grid()
    return frames


if __name__ == "__main__":
    n = len(diffusion3d())
    print(f"onlyvis recipe produced {n} frame(s)")
