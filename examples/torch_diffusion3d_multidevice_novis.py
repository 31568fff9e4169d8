"""3-D heat diffusion on the implicit global grid, no visualization (PyTorch).

The port's twin of ``diffusion3d_multidevice_novis.py``: a single-block
stencil solver plus `init_global_grid` / `update_halo` /
`finalize_global_grid` runs on every process of the job, one process per
GPU.  The field is this process's block, a tensor on its card.

Run on one GPU, or on several with ``torchrun``::

    python examples/torch_diffusion3d_multidevice_novis.py [--nx 128] [--nt 1000]
    torchrun --nproc-per-node 4 examples/torch_diffusion3d_multidevice_novis.py
    python examples/torch_diffusion3d_multidevice_novis.py --device cpu --nx 16 --nt 10
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import implicitglobalgrid_tpu_torch as igg


def diffusion3d(nx=128, ny=None, nz=None, nt=1000, device=None, dtype=None, quiet=False):
    """Run ``nt`` steps on a block of ``nx * ny * nz`` cells per process and
    return this process's final temperature block.  ``device=None`` is
    ``cuda:<local rank>``; ``dtype=None`` is torch's default dtype."""
    # Physics
    lam = 1.0          # thermal conductivity
    cp_min = 1.0       # minimal heat capacity
    lx, ly, lz = 10.0, 10.0, 10.0

    # Numerics
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    me, dims, nprocs, coords, device = igg.init_global_grid(nx, ny, nz, device=device,
                                                            quiet=quiet)
    dx = lx / (igg.nx_g() - 1)  # global grid spacing
    dy = ly / (igg.ny_g() - 1)
    dz = lz / (igg.nz_g() - 1)
    if dtype is None:
        dtype = torch.get_default_dtype()

    # Initial conditions: heat capacity and temperature with two Gaussian
    # anomalies each, from global coordinates.
    T = igg.zeros((nx, ny, nz), dtype)
    X, Y, Z = igg.coord_fields(T, (dx, dy, dz), dtype=dtype)
    Cp = cp_min + (
        5 * torch.exp(-((X - lx / 1.5) ** 2) - (Y - ly / 2) ** 2 - (Z - lz / 1.5) ** 2)
        + 5 * torch.exp(-((X - lx / 3.0) ** 2) - (Y - ly / 2) ** 2 - (Z - lz / 1.5) ** 2)
    )
    T = 100 * torch.exp(
        -(((X - lx / 2) / 2) ** 2) - ((Y - ly / 2) / 2) ** 2 - ((Z - lz / 3.0) / 2) ** 2
    ) + 50 * torch.exp(
        -(((X - lx / 2) / 2) ** 2) - ((Y - ly / 2) / 2) ** 2 - ((Z - lz / 1.5) / 2) ** 2
    )

    # Time step for 3-D heat diffusion
    dt = min(dx * dx, dy * dy, dz * dz) * cp_min / lam / 8.1

    def inn(A):
        return A[1:-1, 1:-1, 1:-1]

    def step(T, Cp):
        # Fourier's law and conservation of energy, fused: with scalar lam
        # the flux divergence is the Laplacian.
        lap = (
            (T[2:, 1:-1, 1:-1] - 2 * inn(T) + T[:-2, 1:-1, 1:-1]) / (dx * dx)
            + (T[1:-1, 2:, 1:-1] - 2 * inn(T) + T[1:-1, :-2, 1:-1]) / (dy * dy)
            + (T[1:-1, 1:-1, 2:] - 2 * inn(T) + T[1:-1, 1:-1, :-2]) / (dz * dz)
        )
        T = T + torch.nn.functional.pad(dt * lam / inn(Cp) * lap, (1, 1) * 3)
        T = igg.update_halo(T)
        return T, Cp

    igg.tic()
    for _ in range(nt):
        T, Cp = step(T, Cp)
    wtime = igg.toc()
    if me == 0 and not quiet:
        print(f"nt={nt} steps, global {igg.nx_g()}x{igg.ny_g()}x{igg.nz_g()}, "
              f"{nprocs} process(es) on {device}, time {wtime:.3f} s "
              f"({wtime / nt * 1e3:.3f} ms/step)")

    igg.finalize_global_grid()
    return T


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--nt", type=int, default=1000)
    p.add_argument("--device", default=None, help="default: cuda:<local rank>")
    a = p.parse_args()
    diffusion3d(nx=a.nx, nt=a.nt, device=a.device)
