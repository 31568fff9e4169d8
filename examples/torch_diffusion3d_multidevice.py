"""3-D heat diffusion with in-situ visualization on process 0 (PyTorch).

The port's twin of ``diffusion3d_multidevice.py``.  Every ``nvis`` steps the
halo-stripped temperature blocks are gathered to the root process (`gather`,
a chunk of blocks at a time across processes) and a mid-plane heatmap frame
is kept; at the end the frames become a GIF, or a ``.npy`` stack when no
plotting package is installed.

Run on one GPU, or on several with ``torchrun``::

    python examples/torch_diffusion3d_multidevice.py [--nx 64] [--nt 2000] [--nvis 500]
    torchrun --nproc-per-node 4 examples/torch_diffusion3d_multidevice.py
    python examples/torch_diffusion3d_multidevice.py --device cpu --nx 16 --nt 20 --nvis 10
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import implicitglobalgrid_tpu_torch as igg


def diffusion3d_vis(nx=64, nt=2000, nvis=500, device=None, outdir=".", dtype=None,
                    quiet=False):
    """Run ``nt`` steps on ``nx^3`` cells per process, keeping a mid-plane
    frame every ``nvis`` steps; returns the frames (process 0; an empty
    list elsewhere).  ``device=None`` is ``cuda:<local rank>``."""
    lam, cp_min = 1.0, 1.0
    lx, ly, lz = 10.0, 10.0, 10.0
    ny = nz = nx
    me, dims, nprocs, coords, device = igg.init_global_grid(nx, ny, nz, device=device,
                                                            quiet=quiet)
    dx = lx / (igg.nx_g() - 1)
    dy = ly / (igg.ny_g() - 1)
    dz = lz / (igg.nz_g() - 1)
    if dtype is None:
        dtype = torch.get_default_dtype()

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
    dt = min(dx * dx, dy * dy, dz * dz) * cp_min / lam / 8.1

    def inn(A):
        return A[1:-1, 1:-1, 1:-1]

    def step(T, Cp):
        lap = (
            (T[2:, 1:-1, 1:-1] - 2 * inn(T) + T[:-2, 1:-1, 1:-1]) / (dx * dx)
            + (T[1:-1, 2:, 1:-1] - 2 * inn(T) + T[1:-1, :-2, 1:-1]) / (dy * dy)
            + (T[1:-1, 1:-1, 2:] - 2 * inn(T) + T[1:-1, 1:-1, :-2]) / (dz * dz)
        )
        T = T + torch.nn.functional.pad(dt * lam / inn(Cp) * lap, (1, 1) * 3)
        return igg.update_halo(T), Cp

    # Preparation of visualization: the gathered array is the halo-stripped
    # blocks side by side, (nx-2)*dims cells per dimension.
    frames = []
    ny_v = (ny - 2) * dims[1]

    for it in range(nt):
        if it % nvis == 0:  # visualize every nvis-th step
            T_nohalo = igg.block_slice(T, (slice(1, -1),) * 3)  # strip the halo
            T_v = igg.gather(T_nohalo)  # gather on process 0
            if me == 0:
                frames.append(np.array(T_v[:, ny_v // 2, :]).T)  # mid-plane
        T, Cp = step(T, Cp)

    if me == 0 and frames:
        write_frames(frames, outdir, quiet=quiet)
    igg.finalize_global_grid()
    return frames


def write_frames(frames, outdir, quiet=False):
    """Write heatmap frames: a GIF when matplotlib is installed, else the
    raw frames as one ``.npy`` stack."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import animation
    except ImportError as e:
        path = os.path.join(outdir, "diffusion3d_frames.npy")
        np.save(path, np.stack(frames))
        if not quiet:
            print(f"matplotlib unavailable ({e!r}); wrote {path}")
        return path
    fig, ax = plt.subplots()
    im = ax.imshow(frames[0], origin="lower", aspect="equal", cmap="inferno")
    fig.colorbar(im, ax=ax)

    def update(i):
        im.set_data(frames[i])
        im.autoscale()
        ax.set_title(f"frame {i}")
        return (im,)

    ani = animation.FuncAnimation(fig, update, frames=len(frames))
    path = os.path.join(outdir, "diffusion3d.gif")
    ani.save(path, writer=animation.PillowWriter(fps=15))
    plt.close(fig)
    if not quiet:
        print(f"wrote {path} ({len(frames)} frames)")
    return path


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=64)
    p.add_argument("--nt", type=int, default=2000)
    p.add_argument("--nvis", type=int, default=500)
    p.add_argument("--device", default=None, help="default: cuda:<local rank>")
    p.add_argument("--outdir", default=".")
    a = p.parse_args()
    diffusion3d_vis(a.nx, a.nt, a.nvis, a.device, a.outdir)
